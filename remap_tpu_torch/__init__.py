"""remap_tpu_torch — the PyTorch + CUDA port of ``remap_tpu``.

The port runs on one NVIDIA GPU, with a hand-written CUDA kernel
(``csrc/*.cu``, built by ``nvcc`` for ``sm_90a`` at first use) in place of
each Pallas kernel of the JAX package.  Ported: the streaming
align+stitch step, the multi-clip step, the three matcher families, the
whole map build as the JAX package's
``pipeline.builder`` runs it (window scan -> crop -> collect -> splice ->
foreground -> clean, with stage checkpoints and resume), which writes
maps (``io.png``), and its command line, ``python -m
remap_tpu_torch.cli <frames-dir>``.

- ``ops.kpe``       keypoint/median extraction, and its medians-only
  instantiation (kernel ``csrc/extract.cu``)
- ``ops.tables``    per-region keypoint tables (kernel ``csrc/tables.cu``;
  table mode "sort2" in torch ops)
- ``ops.kpm``       sort-merge code join, vote counting, Borda declare
- ``ops.kernels.blit``  the colour-vote blit (kernel ``csrc/blit.cu``)
- ``ops.cc``, ``ops.kernels.cc``  component labels and stats (kernel
  ``csrc/cc.cu``)
- ``ops.aws``, ``ops.fde``  window heatmaps, foreground masks;
  ``ops.atlas`` fragment canvases
- ``ops.splice``, ``ops.arf``  the cellular fragment matcher, the
  artifact filter (plain tensor code)
- ``ops.correlate``, ``models``  the correlation matchers on ``torch.fft``;
  the three matcher families and the alignment core (``models.family``)
- ``ops.motion``    contour motion detection (labels by ``csrc/cc.cu``)
- ``parallel.sharded``  the streaming step and the multi-clip step
- ``pipeline.window``, ``pipeline.collect``, ``pipeline.stream``,
  ``pipeline.splice``, ``pipeline.foreground``, ``pipeline.clean``,
  ``pipeline.builder``  the stages and the orchestrator;
  ``pipeline.state``  the frame store and fragments
- ``io.png``        map output and the PNG frame reader
- ``io.frames``, ``io.codec``, ``io.checkpoint``  frame feeds (the native
  packed reader ``native/feed.cpp``), the RLE codec (``native/codec.cpp``),
  stage checkpoints in the JAX package's format; ``io.native`` builds
  ``native/`` at first use
- ``cli``           the command line
- ``convert``       carries JAX stream state, fragments and configs (as
  numpy and plain values) into the port, and numpy back
- ``config``, ``core.regions``, ``core.palette``, ``core.geometry``,
  ``spec``, ``utils.clips``, ``utils.gameplay``, ``utils.wear``  the
  port's own copies of the JAX package's config, grid layout, palette,
  geometry helpers, NumPy executable spec (``spec.pipeline.build`` is
  the oracle on a host without JAX), clip makers, session simulator and
  capture-wear models

Dispatch follows the tensors: CUDA tensors run the kernels, CPU tensors
run each kernel's plain PyTorch version.  The entry points run on the
card unless the caller asks for the CPU (``device="cpu"``, or CPU tensors
passed in); with no CUDA device and no device named they raise.  The JAX
package stays the reference, which the tests hold the port to; this
package imports nothing of it (not even its JAX-free modules) and never
imports ``jax``.
"""

__version__ = "0.1.0"
