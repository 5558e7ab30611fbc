"""remap_tpu_torch — the PyTorch + CUDA port of ``remap_tpu``.

The port runs on one NVIDIA GPU, with a hand-written CUDA kernel
(``csrc/*.cu``, built by ``nvcc`` for ``sm_90a`` at first use) in place of
each Pallas kernel of the JAX package.  Two paths are ported: the
streaming align+stitch step, and the foreground stage fed by collect's
tail (stream step -> blit pass -> foreground filter).

- ``ops.kpe``       keypoint/median extraction (kernel ``csrc/extract.cu``)
- ``ops.tables``    per-region keypoint tables (kernel ``csrc/tables.cu``)
- ``ops.kpm``       sort-merge code join, vote counting, Borda declare
- ``ops.kernels.blit``  the colour-vote blit (kernel ``csrc/blit.cu``)
- ``ops.cc``, ``ops.kernels.cc``  component labels and stats (kernel
  ``csrc/cc.cu``)
- ``ops.fde``       foreground masks; ``ops.atlas`` fragment canvases
- ``parallel.sharded``  the streaming step itself
- ``pipeline.state``, ``pipeline.collect``, ``pipeline.foreground``  the
  frame store and fragments, the blit pass, the foreground filter
- ``convert``       carries JAX stream state and fragments into the port
  and back

Dispatch follows the tensors: CUDA tensors run the kernels, CPU tensors
run each kernel's plain PyTorch version.  The JAX package stays the
reference; this package imports its JAX-free modules (``config``,
``core``, ``pipeline.state``) and never imports ``jax``.
"""

__version__ = "0.1.0"
