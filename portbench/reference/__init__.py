"""The benchmark's plain reference: the decoders of its configuration
files and a training step, in plain PyTorch.  It imports neither ``jax``
nor the JAX package nor anything of the port."""
