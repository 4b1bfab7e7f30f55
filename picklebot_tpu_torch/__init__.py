"""PyTorch/CUDA port of picklebot_tpu for NVIDIA Hopper.

Imports torch and numpy only: never jax, and nothing of picklebot_tpu.
Activations keep the JAX package's channels-last layout (B, T, H, W, C);
state dicts use the reference torch keys and layouts. Entry points run on
``cuda`` unless the caller asks for the CPU, and raise when no card is
present.
"""
