"""utils layer of the PyTorch/CUDA port."""
