"""The benchmark of speedy_tpu_torch (run.py); it imports nothing of JAX or
of the JAX package speedy_tpu."""
