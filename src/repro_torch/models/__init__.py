"""Architecture zoo in plain PyTorch (counterpart of ``repro.models``).

Families: dense GQA decoders, MLA+MoE (DeepSeek-style), pure MoE, Mamba2
(SSD), hybrid SSM+attention (Zamba2-style), cross-attention VLM backbones,
and encoder-decoder audio backbones.  Every model module exposes:

  init(cfg, *, seed, device)                   -> params tree
  forward(params, tokens, cfg, ...)            -> (logits, caches, aux)
  decode_step(params, token, caches, pos, cfg) -> (logits, caches)

Params are nested dicts of tensors with the reference's keys and stacked
[n_layers, ...] leading axes; a Python loop walks the layers.
"""

from repro_torch.models import (  # noqa: F401
    attention, common, encdec, lm, mlp, moe, ssm)
from repro_torch.models.registry import MODEL_FAMILIES, build  # noqa: F401
