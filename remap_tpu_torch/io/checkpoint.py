"""Fragment checkpoints: stage-boundary dumps and reloads (port of
remap_tpu/io/checkpoint.py; ful.hpp made real).

The reference ships fragment serialisation (ful.hpp:11-102) but never
calls it; here it is a resume point between pipeline stages.  The
on-disk format is the JAX package's exactly, so a checkpoint written by
either package resumes in the other: under ``<dir>/<tag>/``,
``meta.json`` (``count``, and ``height``/``width`` with a store),
``store.npz`` (``numbers``, packed ``images``, optional ``medians``) and
``fragment<i>.npz`` (``dots`` ``[h, w, 16]`` uint16, ``zero``,
``numbers``, ``positions``), deflated at level 1.

A save is two halves.  :func:`snapshot` runs on the caller's thread at
the stage boundary: it queues each device canvas's copy into pinned host
memory behind an event (``device.HostCopy``) and copies the frame
numbers, positions and the store's row list, so nothing a later stage
does to the fragments reaches the files.  :func:`write` then needs only
host arrays, and may run on a worker thread while the device goes on.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import List, Optional, Union

import numpy as np

from remap_tpu_torch.device import HostCopy
from remap_tpu_torch.pipeline.state import Fragment, FrameRef, FrameStore


def _savez_fast(path: str, **arrays) -> None:
    """An npz writer at deflate level 1: ``np.savez_compressed`` pins
    zlib's level 6, several times slower on a session's store for a few
    percent of size; ``np.load`` reads any level, so the format is
    unchanged."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1, allowZip64=True) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.ascontiguousarray(arr),
                                          allow_pickle=False)


@dataclasses.dataclass
class Snapshot:
    """One checkpoint's contents, detached from the live fragments."""

    meta: dict
    #: the store's frame numbers and row lists (None without a store)
    numbers: Optional[List[int]]
    images: Optional[List[np.ndarray]]
    medians: Optional[List[np.ndarray]]
    #: per fragment: the canvas (a host array, or its pending copy),
    #: zero, frame numbers and positions
    dots: List[Union[np.ndarray, HostCopy]]
    zeros: List[np.ndarray]
    frame_numbers: List[np.ndarray]
    positions: List[np.ndarray]


def snapshot(fragments: List[Fragment], include_store: bool = True
             ) -> Snapshot:
    """Detach what a checkpoint of ``fragments`` holds.  A device canvas
    is copied to pinned host memory without waiting (its logical
    ``[h, w, 16]`` block, int32); a host canvas is taken as it is, since
    nothing writes into one.  ``include_store=False`` leaves out the
    frame store: a resume from such a tag rebuilds fragments with
    ``store=None``."""
    meta = {"count": len(fragments)}
    store = fragments[0].store if fragments else None
    numbers = images = medians = None
    if store is not None and include_store:
        meta["height"] = store.height
        meta["width"] = store.width
        numbers = sorted(store._images)
        images = [store._images[k] for k in numbers]
        if store.has_medians:
            medians = [store._medians[k] for k in sorted(store._medians)]
    dots: List[Union[np.ndarray, HostCopy]] = []
    for frag in fragments:
        if frag.dots_dev is None:
            dots.append(frag.dots)
        else:
            h, w = frag.shape
            dots.append(HostCopy(
                frag.dots_dev[:, :h, :w].permute(1, 2, 0).contiguous()))
    return Snapshot(
        meta=meta, numbers=numbers, images=images, medians=medians,
        dots=dots,
        zeros=[np.array(f.zero, np.int64) for f in fragments],
        frame_numbers=[np.array([r.number for r in f.frames], np.int64)
                       for f in fragments],
        positions=[np.array([r.position for r in f.frames],
                            np.int64).reshape(-1, 2) for f in fragments])


def write(directory: str, tag: str, snap: Snapshot) -> None:
    """Write a :func:`snapshot` under ``<directory>/<tag>/`` (host work
    alone: waits for the canvases' copies, then compresses)."""
    root = os.path.join(directory, tag)
    os.makedirs(root, exist_ok=True)
    if snap.numbers is not None:
        payload = dict(numbers=np.array(snap.numbers, np.int64),
                       images=np.stack(snap.images))
        if snap.medians is not None:
            payload["medians"] = np.stack(snap.medians)
        _savez_fast(os.path.join(root, "store.npz"), **payload)
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(snap.meta, f)
    for i, dots in enumerate(snap.dots):
        if isinstance(dots, HostCopy):
            dots = dots.wait()[0].astype(np.uint16)
        _savez_fast(os.path.join(root, f"fragment{i}.npz"), dots=dots,
                    zero=snap.zeros[i], numbers=snap.frame_numbers[i],
                    positions=snap.positions[i])


def save(directory: str, tag: str, fragments: List[Fragment],
         include_store: bool = True) -> None:
    """Checkpoint ``fragments`` under ``<directory>/<tag>/`` now."""
    write(directory, tag, snapshot(fragments, include_store))


def load(directory: str, tag: str, device=None) -> List[Fragment]:
    """The fragments of a checkpoint, with host canvases and a host
    frame store on ``device`` (CUDA unless the caller asks for the CPU)
    when the checkpoint holds one."""
    root = os.path.join(directory, tag)
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    store = None
    store_path = os.path.join(root, "store.npz")
    if os.path.exists(store_path):
        store = FrameStore(meta["height"], meta["width"], device=device)
        data = np.load(store_path)
        # read each member once: NpzFile inflates the whole member on
        # every access
        numbers, images = data["numbers"], data["images"]
        medians = data["medians"] if "medians" in data else None
        for k, num in enumerate(numbers):
            store._images[int(num)] = images[k]
            if medians is not None:
                store._medians[int(num)] = medians[k]
    fragments = []
    for i in range(meta["count"]):
        data = np.load(os.path.join(root, f"fragment{i}.npz"))
        fragments.append(Fragment(
            dots=data["dots"],
            zero=tuple(int(v) for v in data["zero"]),
            frames=[FrameRef(int(n), (int(p[0]), int(p[1])))
                    for n, p in zip(data["numbers"], data["positions"])],
            store=store))
    return fragments
