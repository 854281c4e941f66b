"""The selective sweeps: the carry-resident sweep in serving and training
modes (``ops``) and the packed-stream sweep (``packed``), each a CUDA
kernel's wrapper beside its plain version."""
