"""Hand-written Hopper kernels (Triton and CUDA C++) with their plain
PyTorch versions; :mod:`.ops` dispatches by the tensor's device."""
