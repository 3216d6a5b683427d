"""The plain reference: plain PyTorch, float64 (or the control's TF32),
importing nothing of the program, of ``jax`` or of the JAX package."""
