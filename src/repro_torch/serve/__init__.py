"""Serving layer of the port: the continuous-batching `SlabEngine`, the
bucket-ladder `FoldInEngine` and the per-tenant theta cache."""

from repro_torch.serve.cache import ThetaCache, doc_digest  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    FoldInEngine,
    OOVTrigger,
    ServeResult,
    Shed,
    SlabEngine,
)
