"""data layer of the PyTorch/CUDA port."""
