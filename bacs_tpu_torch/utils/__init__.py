"""Weight conversion from the JAX package, checkpoints and logging."""
