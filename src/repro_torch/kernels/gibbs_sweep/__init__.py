"""The collapsed Gibbs chain of LDA (one sequential sweep over the tokens):
the CUDA kernel's wrapper, its plain version and the Philox noise it draws
(``ops``).  A kernel the port adds in place of the reference's
``lax.scan``; the JAX package has no TPU kernel for it."""
