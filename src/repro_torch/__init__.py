"""PyTorch/CUDA port of the POBP topic-modeling system.

A second package beside the JAX reference ``repro``, with the same
layout (``core/``, ``data/``, ``dist/``, ``kernels/``, ``serve/``,
``launch/``, and the LM lab's ``configs/`` and ``models/``) so each module
sits beside its counterpart.  It imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.  Every
entry point takes a ``device`` (default ``"cuda"``) and raises when no card
is present unless the caller asks for the CPU.  The hand-written CUDA
sources live in ``csrc/`` and are built at first use
(``kernels/build.py``).
"""
