"""core layer of the PyTorch/CUDA port."""
