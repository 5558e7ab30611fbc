"""NumPy specs the port needs (copies of the JAX package's)."""
