"""Tensor ops of the PyTorch port; ``flash_attention`` holds a CUDA kernel."""
