"""Fixed-order segmented sums of the training step (the word-row scatter
and the per-topic sum of the phi_tot refresh): the CUDA kernels' wrappers
and their plain versions (``ops``).  Kernels the port adds; the JAX
package has no TPU kernel for them."""
