"""Carry-resident selective sweep (serving and training modes): the CUDA
kernel's wrapper and its plain version (``ops``)."""
