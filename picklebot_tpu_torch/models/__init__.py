"""models layer of the PyTorch/CUDA port."""
