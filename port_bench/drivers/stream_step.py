"""Entry driver: the live streaming loop over ``make_streaming_step``, one
stream (a closed loop).

Set-up renders the clip from the seed, packs each batch two pixels a
byte on the host (``pipeline.state.pack_nibbles_batch``), builds the
step, and runs every batch once through a throw-away stream.  Each step
of the window uploads its packed batch (``device.upload``), unpacks it
on the card (``unpack_nibbles_device``), calls ``step``, and queues the
copy of its offsets, matched flags, flags and strayed flag to the host
(``device.HostCopy``); the host waits for a step's copy after it has
queued the next step, as collect drains.  The clip plays over and over
from a fresh stream.

A batch's latency runs from just before its upload is queued to the end
of its copy to the host, on CUDA events.  Traced runs add the host's
time inside each ``step()`` call, CUDA events around each step, and,
after the window, steps under ``torch.profiler``.

Observations of a traced run (``Driver.observations``): ``steps``;
``enqueue_s``, the host's seconds inside each ``step()``;
``step_device_ms`` and ``ingest_ms``, CUDA-event times of each step and
of each upload with its unpack; ``profile``, the profiled steps
(``trace.profiled``) with ``steps`` and ``bytes_per_step`` of each
kernel (``roofline.py``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import roofline, stats
from port_bench import traffic as traffic_mod
from port_bench import trace as trace_mod
from port_bench.reference import keypoints as ref_kp
from port_bench.reference import stream as ref

#: steps of a fresh stream under the profiler in a traced run
PROFILE_STEPS = 32


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 workdir: str, trace: bool,
                 profile_steps: int = PROFILE_STEPS):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.trace = trace
        self.observations: Dict[str, object] = {}
        self.profile_steps = profile_steps
        self.setup_marks: List[tuple] = []

    def _mark(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.setup_marks.append((name, now - since))
        return now

    def setup(self) -> None:
        t = time.perf_counter()
        from remap_tpu_torch.config import PipelineConfig
        from remap_tpu_torch.core.regions import make_layout
        from remap_tpu_torch.parallel.sharded import make_streaming_step
        from remap_tpu_torch.pipeline.state import pack_nibbles_batch

        t = self._mark("imports", t)
        self.session = traffic_mod.make(self.config, self.traffic, self.seed)
        t = self._mark("session", t)
        frames = self.session.frames
        self.cfg = PipelineConfig(**self.config["pipeline"])
        b = self.cfg.frame_batch
        n, h, w = frames.shape
        if n % b:
            raise ValueError("the clip must hold whole batches")
        self.packed = [pack_nibbles_batch(frames[i:i + b])
                       for i in range(0, n, b)]
        self.layout = make_layout(w, h, self.cfg.grid_width,
                                  self.cfg.grid_height, self.cfg.grid_overlap)
        self.pad = self.config["atlas_pad"]
        self.init_state, self.step = make_streaming_step(
            self.layout, self.cfg, atlas_pad=self.pad, device=self.dev)
        t = self._mark("pack and step", t)
        state = self.init_state()
        for i in range(len(self.packed)):
            state = self._enqueue(i, state)[1][-1]
        self._sync()
        self._mark("warm pass", t)

    def close(self) -> None:
        pass

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _event(self):
        if self.dev.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _enqueue(self, i: int, state, enqueue: List[float] = None,
                 step_events: list = None):
        """Queue batch ``i``'s upload, unpack, step and copy back; returns
        (start event, step outputs, copy, end event)."""
        from remap_tpu_torch import device as device_mod
        from remap_tpu_torch.pipeline.state import unpack_nibbles_device

        start = self._event()
        images = unpack_nibbles_device(
            device_mod.upload(self.packed[i], self.dev),
            self.config["pipeline"]["screen_width"])
        if step_events is not None:
            step_events.append(self._event())
        t0 = time.perf_counter()
        out = self.step(images, state)
        if enqueue is not None:
            enqueue.append(time.perf_counter() - t0)
        if step_events is not None:
            step_events.append(self._event())
        offs, matched, flags, strayed, _ = out
        copy = device_mod.HostCopy(offs, matched, flags.table, flags.join,
                                   flags.range, strayed)
        return start, out, copy, self._event()

    @staticmethod
    def _landed(copy) -> list:
        """A step's outputs once on the host, copied out of the pinned
        buffers so that those go back to the allocator, as a drain that
        reads its results and lets them go does."""
        return [np.array(a) for a in copy.wait()]

    def window(self, seconds: float) -> dict:
        n_batches = len(self.packed)
        b = self.cfg.frame_batch
        enqueue = [] if self.trace else None
        step_events = [] if self.trace else None
        marks = []
        done: List[float] = []
        self.outputs = []
        state = self.init_state()
        pending = None
        steps = 0
        start = time.perf_counter()
        while steps == 0 or time.perf_counter() - start < seconds:
            s, out, copy, e = self._enqueue(steps % n_batches, state,
                                            enqueue, step_events)
            state = out[-1]
            marks.append((s, e))
            done.append(time.perf_counter())
            if pending is not None:
                self.outputs.append(self._landed(pending))
            pending = copy
            steps += 1
        self.outputs.append(self._landed(pending))
        elapsed = time.perf_counter() - start
        self.state = state
        self.steps = steps
        self.per_second = np.bincount(
            (np.asarray(done) - start).astype(np.int64))
        result = {"stream_fps": steps * b / elapsed, "steps": steps}
        if marks[0][0] is not None:
            result["batch_p95_ms"] = stats.nearest_rank(
                [a.elapsed_time(z) for a, z in marks], 95)
        if self.trace:
            obs = {"steps": steps, "enqueue_s": enqueue}
            if step_events and step_events[0] is not None:
                obs["step_device_ms"] = [
                    a.elapsed_time(z)
                    for a, z in zip(step_events[::2], step_events[1::2])]
                obs["ingest_ms"] = [
                    s.elapsed_time(a)
                    for (s, _), a in zip(marks, step_events[::2])]
            self.observations.update(obs)
        return result

    def notes(self) -> List[str]:
        return ["setup seconds " + " ".join(
            f"{k} {v:.3f}" for k, v in self.setup_marks),
            f"steps {self.steps}, a second: "
                + " ".join(str(int(c)) for c in self.per_second)]

    def profile(self) -> None:
        """``profile_steps`` more steps of a fresh stream under the
        profiler, drained as in the window, with the bytes each kernel
        must move on the batches they took."""
        n_batches = len(self.packed)

        def run():
            state = self.init_state()
            pending = None
            for i in range(self.profile_steps):
                _, out, copy, _ = self._enqueue(i % n_batches, state)
                state = out[-1]
                if pending is not None:
                    pending.wait()
                pending = copy
            pending.wait()

        _, prof = trace_mod.profiled(run, self.dev)
        prof["steps"] = self.profile_steps
        per_batch = [self._kernel_bytes(i) for i in range(n_batches)]
        prof["bytes_per_step"] = {
            k: sum(p[k] for p in per_batch) / n_batches
            for k in per_batch[0]}
        self.observations["profile"] = prof

    def _kernel_bytes(self, i: int) -> dict:
        """K1's, K2's and K3's bytes on batch ``i`` (roofline.py), from
        the frames, the configuration and the reference's keypoints."""
        p = self.config["pipeline"]
        b = self.cfg.frame_batch
        frames = torch.as_tensor(self.session.frames[i * b:(i + 1) * b],
                                 device=self.dev)
        spans = ref_kp.region_spans(p["screen_width"], p["screen_height"],
                                    p["grid_width"], p["grid_height"],
                                    p["grid_overlap"])
        counts = ref_kp.region_counts(ref_kp.keypoints(frames), spans)
        path = np.asarray(self.session.path[i * b:(i + 1) * b], np.int64)
        return {"extract": roofline.extract_bytes(frames.shape),
                "tables": roofline.tables_bytes(
                    frames.numel(), counts, p["region_capacity"]),
                "blit": roofline.blit_bytes(frames, path)}

    def check(self, bits: int = 16) -> Dict[str, int]:
        """Each number compared, with limit 0: every step's outputs
        against the clip's camera path, and the final atlas, anchor and
        position against the reference stream.  ``bits`` narrows the
        reference's vote counters (the control)."""
        s = self.session
        b = self.cfg.frame_batch
        total = self.steps * b
        want = ref.stream(s.path, total, b, self.pad,
                          self.config["pipeline"]["screen_width"],
                          self.config["pipeline"]["screen_height"])
        out = {"offsets_wrong": 0, "flags_set": 0}
        bad_steps = 0
        for k, got in enumerate(self.outputs):
            offs, matched, table, join, rng, strayed = got
            lo = k * b
            w_off = want.offsets[lo:lo + b]
            w_m = want.matched[lo:lo + b]
            if offs.shape != w_off.shape or matched.shape != w_m.shape:
                wrong = b
            else:
                bad = (matched != w_m) | (w_m & np.any(offs != w_off, axis=1))
                wrong = int(bad.sum())
            flagged = int(np.count_nonzero(table | join | rng)) + int(
                bool(strayed))
            out["offsets_wrong"] += wrong
            out["flags_set"] += flagged
            bad_steps += bool(wrong or flagged)
        atlas = ref.atlas(s.frames, want, self.dev, bits=bits)
        st = self.state
        ah, aw = atlas.shape[1:]
        got = st.dots[:, :ah, :aw].to(torch.int64)
        out["atlas_bins_wrong"] = int((got != atlas).sum()) + int(
            got.shape != atlas.shape) * atlas.numel()
        out["anchor_wrong"] = int(
            tuple(st.anchor.tolist()) != tuple(want.anchor)
            or tuple(st.position.tolist()) != tuple(want.position))
        self.failed_steps = bad_steps + int(
            bool(out["atlas_bins_wrong"] or out["anchor_wrong"]))
        return out
