"""The plain reference: imports nothing of the program or of JAX."""
