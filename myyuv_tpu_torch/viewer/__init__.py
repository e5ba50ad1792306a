"""viewer layer of the PyTorch/CUDA port: BMP export and terminal preview
(numpy only; see the package docstring), and the spinning-shapes demo
(``cube.py``: numpy camera and geometry, the rasteriser in PyTorch)."""
