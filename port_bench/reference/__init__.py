"""The plain reference renderer of the benchmark (plain torch; nothing of
the port, of jax or of the JAX package)."""
