"""Power-submatrix row gather (the phi pack of the packed sweep) and row
scatter-add (the phi fold of training): the CUDA kernels' wrappers and
their plain versions (``ops``)."""
