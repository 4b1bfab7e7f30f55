"""parallel layer of the PyTorch/CUDA port: data parallelism and ZeRO."""
