"""viewer layer of the PyTorch/CUDA port: BMP export and terminal preview
(numpy only; see the package docstring)."""
