"""Plain PyTorch and NumPy reference of the codec, the container and the
conversion. Imports nothing of the program under test and nothing of JAX."""
