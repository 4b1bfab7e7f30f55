"""train layer of the PyTorch/CUDA port."""
