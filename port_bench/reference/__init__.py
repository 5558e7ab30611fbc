"""The benchmark's reference: what the program's outputs must be, worked
out from the generated inputs in plain NumPy and PyTorch.  Imports
nothing of the program (``remap_tpu_torch``)."""
