"""Carry state between the JAX package and the port.

There are no weights here: what persists across batches is the
``StreamState`` (atlas, carried tables, running position, started flag,
anchor), and across stages the fragments (vote canvas, frame records,
frame store).  The JAX side is handed over as numpy arrays
(``jax.tree.map(np.asarray, state)``; a JAX ``Fragment`` materialises its
canvas on ``.dots``) and read by field name, so this module needs no JAX.
Dtypes map as: atlas uint16 <-> int32, codes uint32 <-> int32 bit
patterns, the rest unchanged; canvases ``[h, w, 16]`` <-> the port's
padded ``[16, AH', AW']`` (``ops.atlas``).
"""

from __future__ import annotations

import numpy as np
import torch

from remap_tpu.pipeline import state as host_state
from remap_tpu_torch.device import get_device
from remap_tpu_torch.ops import atlas as atlas_ops
from remap_tpu_torch.ops.tables import RegionTables
from remap_tpu_torch.parallel.sharded import StreamState
from remap_tpu_torch.pipeline import state as port_state


def _tensor(a, dtype, device) -> torch.Tensor:
    # np.array copies: JAX hands out read-only buffers
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def tables_from_numpy(tables, device=None) -> RegionTables:
    """JAX RegionTables with numpy leaves -> the port's RegionTables."""
    dev = get_device(device)
    return RegionTables(
        codes=_tensor(np.asarray(tables.codes, np.uint32).view(np.int32),
                      np.int32, dev),
        pos=_tensor(tables.pos, np.int32, dev),
        valid=_tensor(tables.valid, bool, dev),
        wcounts=_tensor(tables.wcounts, np.int32, dev),
        overflow=_tensor(tables.overflow, bool, dev),
    )


def tables_to_numpy(tables: RegionTables) -> RegionTables:
    """The port's RegionTables -> numpy leaves with the JAX dtypes."""
    return RegionTables(
        codes=tables.codes.cpu().numpy().view(np.uint32),
        pos=tables.pos.cpu().numpy(),
        valid=tables.valid.cpu().numpy(),
        wcounts=tables.wcounts.cpu().numpy(),
        overflow=tables.overflow.cpu().numpy(),
    )


def stream_state_from_numpy(state, device=None) -> StreamState:
    """JAX ``StreamState`` with numpy leaves -> the port's state on
    ``device``."""
    dev = get_device(device)
    dots = np.asarray(state.dots)
    if dots.dtype != np.uint16:
        raise TypeError(f"expected a uint16 atlas, got {dots.dtype}")
    return StreamState(
        dots=_tensor(dots, np.int32, dev),
        carry=tables_from_numpy(state.carry, dev),
        position=_tensor(state.position, np.int32, dev),
        started=_tensor(state.started, bool, dev),
        anchor=_tensor(state.anchor, np.int32, dev),
    )


def stream_state_to_numpy(state: StreamState) -> StreamState:
    """The port's state -> numpy leaves with the JAX dtypes (atlas
    uint16, codes uint32), field for field as the JAX ``StreamState``."""
    return StreamState(
        dots=state.dots.cpu().numpy().astype(np.uint16),
        carry=tables_to_numpy(state.carry),
        position=state.position.cpu().numpy(),
        started=state.started.cpu().numpy(),
        anchor=state.anchor.cpu().numpy(),
    )


def _copy_store(src, dst):
    """Copy the host rows (packed frames and medians) of ``src`` into
    ``dst``; device mirrors are not carried over."""
    numbers = sorted(src._images)
    if numbers:
        dst.put_packed_batch(
            numbers, src.packed_images_batch(numbers),
            src.packed_medians_batch(numbers) if src.has_medians else None)
    return dst


def store_from_numpy(store, device=None) -> port_state.FrameStore:
    """A JAX ``FrameStore`` -> the port's store on ``device``, with the
    same host rows and device budget."""
    return _copy_store(store, port_state.FrameStore(
        store.height, store.width, store.device_budget, device))


def fragment_from_numpy(frag, device=None,
                        store=None) -> port_state.Fragment:
    """A JAX ``Fragment`` -> the port's, its canvas on ``device``.
    ``store`` (a port store) stands in for the fragment's own, so that
    fragments sharing a store keep sharing one."""
    dev = get_device(device)
    if store is None and frag.store is not None:
        store = store_from_numpy(frag.store, dev)
    dots = np.asarray(frag.dots)
    return port_state.Fragment(
        dots_dev=atlas_ops.from_host(dots, dev), shape=dots.shape[:2],
        zero=tuple(frag.zero),
        frames=[host_state.FrameRef(number=r.number, position=r.position)
                for r in frag.frames],
        store=store,
    )


def fragment_to_numpy(frag: port_state.Fragment) -> host_state.Fragment:
    """The port's ``Fragment`` -> a JAX ``Fragment`` with a host canvas
    (``[h, w, 16]`` uint16) and a host ``FrameStore`` of the same rows."""
    store = None
    if frag.store is not None:
        src = frag.store
        store = _copy_store(src, host_state.FrameStore(
            src.height, src.width, src.device_budget))
    return host_state.Fragment(
        dots=frag.dots.copy(), zero=tuple(frag.zero),
        frames=[host_state.FrameRef(number=r.number, position=r.position)
                for r in frag.frames],
        store=store,
    )
