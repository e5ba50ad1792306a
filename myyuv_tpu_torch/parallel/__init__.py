"""parallel layer of the PyTorch/CUDA port: the (data, block) device mesh
and the multi-process gather on torch.distributed (gloo)."""
