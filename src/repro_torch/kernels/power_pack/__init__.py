"""Power-submatrix row scatter-add (the phi fold of training): the CUDA
kernel's wrapper and its plain version (``ops``)."""
