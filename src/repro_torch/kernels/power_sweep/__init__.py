"""Carry-resident fold-in sweep (serving mode): the CUDA kernel's wrapper
and its plain version (``ops``)."""
