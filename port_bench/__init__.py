"""The benchmark of the PyTorch + CUDA port (``remap_tpu_torch``): one
command runs one cell once (``run.py``); configurations, cells and
per-layer metrics are files found by name (README.md).  Nothing here
imports JAX or the JAX package."""
