"""Measurement scripts of the PyTorch/CUDA port; each runs on a CUDA card
(see its docstring)."""
