"""The power-topic selection (each power word's top Pk topics by
residual): the CUDA kernel's wrapper and its plain version (``ops``).  A
kernel the port adds; the JAX package leaves the selection to XLA's
``lax.top_k``."""
