"""Pure-NumPy executable specification of the reference pipeline (the
port's copy of the JAX package's ``remap_tpu.spec``).

Every module here re-states, in plain NumPy, the exact observable semantics
of the corresponding C++ module of the reference -- including its quirks
(off-by-one processing bounds, exclusive bbox fills, wrap-around counts).
Each is a line-for-line copy of its JAX-package original with only the
import paths rewritten (tests/test_torch_core.py holds each copy equal to
it), so it imports neither JAX nor the JAX package and runs wherever the
port does.  ``spec.pipeline.build(frames)`` is the port's oracle on a host
without JAX: the map build of ``pipeline.builder.build_from_frames`` on the
card must equal it byte for byte.  Nothing on the port's own path calls it.

The spec is written for clarity and testability, not speed.
"""
