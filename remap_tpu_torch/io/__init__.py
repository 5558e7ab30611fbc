"""Map output (the port's copy of remap_tpu/io/png.py)."""
