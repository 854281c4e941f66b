"""The LM trainer's optimizer and gradient sync (counterpart of
``repro.optim``)."""
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim import powersync  # noqa: F401
