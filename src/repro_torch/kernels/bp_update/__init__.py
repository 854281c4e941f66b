"""Dense BP message update (the t=1 sweep of training): the CUDA kernel's
wrapper and its plain version (``ops``)."""
