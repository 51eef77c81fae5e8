"""Device sweep engines and their kernels (PyTorch + CUDA)."""
