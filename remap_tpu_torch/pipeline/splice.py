"""The fragment splicing stage (port of remap_tpu/pipeline/splice.py,
fgs.hpp).

Each fragment is blended and keypoint-extracted with a whole-canvas 1x1
grid (fgs.hpp:17/80-103: K1 on the canvas padded to 256-multiples, the
weights cut to the true canvas's interior, then K2 with a capacity sized
to the keypoint count), matched all-pairs with the cellular matcher
(``ops.splice``, cells of 15x15, fgs.hpp:119-140; a round's pairs in
batches, one code sort and one cellular vote a batch), then a host
greedy loop merges the highest-vote pair (ties -> first in snippet
order, then edge order, fgs.hpp:142-163), re-extracts the merged snippet
(list front), re-matches it against the rest, and repeats until no edges
remain.
Canvas merges replay fgm's step-quantised growth exactly.

Under the correlation families (``cfg.matcher`` "xcorr" / "pyramid") a
snippet is the blended canvas alone, and pairs are aligned by the
family's canvas matcher (``models.family(cfg).canvas_matcher``: the dense
masked-agreement correlation ``ops.correlate.match_canvases``, or its
pyramid), whose peak agreement count takes the cellular vote count's
place in the greedy merge order.

Everything runs on the fragments' device, except the initial snippet
extraction when the caller gives more than one device and more than one
fragment exists: it round-robins over the devices
(:func:`_extract_snippets`), and each snippet comes back to its
fragment's device for the greedy loop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from remap_tpu_torch import models
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.device import current, upload
from remap_tpu_torch.ops import atlas as atlas_ops
from remap_tpu_torch.ops import kpe as kpe_ops
from remap_tpu_torch.ops import splice as splice_ops
from remap_tpu_torch.ops import tables as table_ops
from remap_tpu_torch.parallel import fragments as frag_par
from remap_tpu_torch.pipeline.state import Fragment, FrameRef
from remap_tpu_torch.utils import profiling

#: the mask bucket of a snippet (the JAX package's ``_BUCKET``)
_BUCKET = 128
#: the extraction canvas's bucket (``_SHAPE_BUCKET``): the canvas pads
#: bottom/right with empty pixels to multiples of this, and the weights
#: are cut to the TRUE canvas's processed interior, so the tables equal
#: exact-canvas extraction (every interior keypoint's windows lie inside
#: the true canvas)
_SHAPE_BUCKET = 256


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(eq=False)
class _Edge:
    primary: bool
    offset: Tuple[int, int]
    count: int
    other: "_Snippet"


@dataclasses.dataclass(eq=False)
class _Snippet:
    fragment: Fragment
    mask_bucket: torch.Tensor      # [HB, WB] uint8 zero-padded blend mask
    dims: Tuple[int, int]          # (w, h) true canvas dims
    codes: torch.Tensor            # [K, 4] int32 bit patterns
    pos: torch.Tensor              # [K, 2] int32
    valid: torch.Tensor            # [K] bool
    edges: List[_Edge] = dataclasses.field(default_factory=list)
    #: [HB, WB] uint8 zero-padded blended canvas (correlation families)
    image_bucket: Optional[torch.Tensor] = None


def _snippet_dispatch(frag: Fragment, cfg: PipelineConfig, device=None,
                      on=None):
    """Blend; for grid_vote, then K1 over the canvas padded to
    256-multiples under the 1x1 layout, with the weights cut to the true
    canvas's processed interior (``x in [kh, w-kh)``, ``y in [kh,
    h-kh-2)``, the reference's bottom quirk included).  Returns (image,
    mask, weight, codes, keypoint count), all on the device; the last three
    None for the correlation families.  With ``on``, on that device (a
    copy of the canvas), else on the canvas's."""
    ch, cw = frag.shape
    dots = (frag.device_dots(device) if on is None
            else frag.canvas_on(on))[:, :ch, :cw]
    image, mask = atlas_ops.blend(dots)
    if models.family(cfg).canvas_matcher is not None:
        return image, mask, None, None, None
    hb2, wb2 = _round_up(ch, _SHAPE_BUCKET), _round_up(cw, _SHAPE_BUCKET)
    image = F.pad(image, (0, wb2 - cw, 0, hb2 - ch))
    layout = make_layout(wb2, hb2, 1, 1, 0)
    dense = kpe_ops.extract_dense(image[None], layout)
    kh = cfg.kernel_half
    interior = torch.zeros((hb2, wb2), dtype=torch.uint8, device=dots.device)
    interior[kh:max(ch - kh - 2, 0), kh:max(cw - kh, 0)] = 1
    weight = dense.weight * interior
    return image, mask, weight, dense.codes, (weight > 0).sum()


def _snippet_finalize(frag: Fragment, pend, cfg: PipelineConfig) -> _Snippet:
    image, mask, weight, codes, total = pend
    ch, cw = frag.shape

    def bucketed(plane):
        return F.pad(plane, (0, _round_up(cw, _BUCKET) - cw,
                             0, _round_up(ch, _BUCKET) - ch))

    mask_b = bucketed(mask)
    if weight is None:
        # the correlation families match blended canvases: no tables
        dev = mask.device
        return _Snippet(
            fragment=frag, mask_bucket=mask_b, dims=(cw, ch),
            codes=torch.zeros((0, 4), dtype=torch.int32, device=dev),
            pos=torch.zeros((0, 2), dtype=torch.int32, device=dev),
            valid=torch.zeros((0,), dtype=torch.bool, device=dev),
            image_bucket=bucketed(image))
    # the reference keeps EVERY keypoint of the blended canvas
    # (fgs.hpp:80-103): size the table to the true count, in x4 steps
    total = int(total)
    cap = cfg.splice_capacity
    while cap < total:
        cap *= 4
    hb2, wb2 = weight.shape[1:]
    tabs = table_ops.build_tables(weight, codes,
                                  make_layout(wb2, hb2, 1, 1, 0), cap)
    if bool(tabs.overflow.any()):
        raise AssertionError(
            "splice table overflow despite count-sized capacity")
    return _Snippet(fragment=frag, mask_bucket=mask_b, dims=(cw, ch),
                    codes=tabs.codes[0, 0], pos=tabs.pos[0, 0],
                    valid=tabs.valid[0, 0])


def _extract_snippet(frag: Fragment, cfg: PipelineConfig,
                     device=None) -> _Snippet:
    return _snippet_finalize(frag, _snippet_dispatch(frag, cfg, device), cfg)


def _extract_snippets(fragments: List[Fragment], cfg: PipelineConfig,
                      device=None, devices=None) -> List[_Snippet]:
    """The initial snippets, in order.  Given more than one device
    (``devices``) and more than one fragment, the reference's parallel
    transform (fgs.hpp:91-103) as a round robin: every fragment's blend
    and K1 are queued on its device before the first host wait, K2 and
    the count checks follow per snippet, and each snippet's tensors go
    back to its fragment's device, where the serial path keeps them.
    (The greedy loop's re-extraction of a merged snippet stays on the
    fragments' device.)"""
    if frag_par.round_robin(fragments, devices):
        devs = frag_par.fragment_devices(len(fragments), devices)
        homes = [f.device_dots(device).device for f in fragments]
        pending = []
        for frag, dev in zip(fragments, devs):
            with current(dev):
                pending.append(_snippet_dispatch(frag, cfg, on=dev))
        snippets = []
        for frag, dev, home, pend in zip(fragments, devs, homes, pending):
            with current(dev):
                snip = _snippet_finalize(frag, pend, cfg)
            snippets.append(_moved(snip, home))
        return snippets
    return [_extract_snippet(f, cfg, device) for f in fragments]


def _moved(s: _Snippet, device: torch.device) -> _Snippet:
    """The snippet with its tensors on ``device``."""
    return dataclasses.replace(
        s, mask_bucket=s.mask_bucket.to(device), codes=s.codes.to(device),
        pos=s.pos.to(device), valid=s.valid.to(device),
        image_bucket=(None if s.image_bucket is None
                      else s.image_bucket.to(device)))


def _canon_dim(n: int) -> int:
    """Power-of-two mask-bucket dims (floor 128): the pad state's dims fix
    the offset and cell key strides, and with them the tie order, as in
    the JAX package."""
    return max(_BUCKET, 1 << (int(n) - 1).bit_length())


class _PadState:
    """The splice-wide table capacity (rolling maximum) and power-of-two
    mask bucket every pair is matched at, as the JAX package pads them:
    extra table rows are invalid, the mask bucket enters only as zero
    padding and key strides, and the validation spans use the true dims."""

    def __init__(self) -> None:
        self.cap = 0
        self.hb = 0
        self.wb = 0

    def update(self, snippets: List[_Snippet]) -> None:
        for s in snippets:
            self.cap = max(self.cap, s.codes.shape[0])
            self.hb = max(self.hb, _canon_dim(s.mask_bucket.shape[0]))
            self.wb = max(self.wb, _canon_dim(s.mask_bucket.shape[1]))

    def _padded(self, plane: torch.Tensor) -> torch.Tensor:
        return F.pad(plane, (0, self.wb - plane.shape[1],
                             0, self.hb - plane.shape[0]))

    def mask(self, s: _Snippet) -> torch.Tensor:
        return self._padded(s.mask_bucket)

    def image(self, s: _Snippet) -> torch.Tensor:
        return self._padded(s.image_bucket)


#: join slots (pairs x multiplicity x 2K sorted rows) that one batched
#: cellular vote enumerates: 16 pairs at multiplicity 4 and K = 131,072.
#: A round's pairs run in chunks of as many pairs as fit (at least one),
#: so the vote's ``[N, m, 2K]`` int64 tensors stay near 128 MB each
JOIN_SLOTS = 1 << 24


def _batch_pairs(multiplicity: int, k: int) -> int:
    """Pairs one vote at ``multiplicity`` (0: dense, one pair) takes at
    table capacity ``k`` under :data:`JOIN_SLOTS`."""
    if multiplicity == 0:
        return 1
    return max(1, JOIN_SLOTS // (multiplicity * 2 * k))


def _needed_multiplicity(tables: splice_ops.SortedTables) -> List[int]:
    """The join's ``needed_multiplicity`` of each pair, read from their
    code sort on the tables' device in one host read: the most valid
    ``head`` rows sharing one code quadruple that ``other`` also holds."""
    return tables.need.tolist()


def _padded_tables(s: _Snippet, k: int):
    extra = k - s.codes.shape[0]
    if extra == 0:
        return s.codes, s.pos, s.valid
    return (F.pad(s.codes, (0, 0, 0, extra)), F.pad(s.pos, (0, 0, 0, extra)),
            F.pad(s.valid, (0, extra)))


def _stacked(planes: List[torch.Tensor]) -> torch.Tensor:
    """``planes`` on a new leading axis; one plane repeated (a merge
    round's head) is expanded, not copied."""
    if all(p is planes[0] for p in planes):
        return planes[0][None].expand(len(planes), *planes[0].shape)
    return torch.stack(planes)


def _match(head: _Snippet, other: _Snippet, cfg: PipelineConfig,
           pad: Optional[_PadState] = None
           ) -> Optional[Tuple[Tuple[int, int], int]]:
    """(offset, count) of an accepted match of ``other`` against ``head``,
    or None: :func:`_match_pairs` of the one pair (with a pad state of
    the two snippets unless ``pad`` is given)."""
    if pad is None:
        pad = _PadState()
        pad.update([head, other])
    return _match_pairs([(head, other)], cfg, pad)[0]


def _match_pairs(pairs: List[Tuple[_Snippet, _Snippet]], cfg: PipelineConfig,
                 pad: _PadState
                 ) -> List[Optional[Tuple[Tuple[int, int], int]]]:
    """(offset, count) of each accepted match of ``other`` against
    ``head`` among ``pairs``, else None, in the pairs' order.  Under
    grid_vote the pairs are matched in chunks of :func:`_batch_pairs` at
    ``cfg.join_multiplicity`` (:func:`_match_tables`); the correlation
    families align each pair's pad-state canvases on their own (the zero
    padding is masked out, so offsets are exact).  Each chunk (each pair,
    under a correlation family) is a ``splice.match`` span with its
    ``pairs``, under grid_vote also the ``multiplicity`` the joins ended
    at (the largest, 0 where one went dense); counter ``splice.matches``
    counts pairs, ``splice.rejects`` the matches not accepted."""
    if models.family(cfg).canvas_matcher is not None:
        return [_match_canvases(h, o, cfg, pad) for h, o in pairs]
    step = _batch_pairs(cfg.join_multiplicity, pad.cap)
    votes = []
    for i in range(0, len(pairs), step):
        chunk = pairs[i:i + step]
        with profiling.span("splice.match", pairs=len(chunk)) as sp:
            profiling.count("splice.matches", len(chunk))
            rows, mults = _match_tables(chunk, cfg, pad)
            sp.set(multiplicity=0 if 0 in mults else max(mults))
            for ok, count, dx, dy in rows:
                if not ok:
                    profiling.count("splice.rejects")
                votes.append(((dx, dy), count) if ok else None)
    return votes


def _match_canvases(head: _Snippet, other: _Snippet, cfg: PipelineConfig,
                    pad: _PadState
                    ) -> Optional[Tuple[Tuple[int, int], int]]:
    """One pair through the family's canvas matcher, a ``splice.match``
    span of its own (with the accepted count)."""
    with profiling.span("splice.match", pairs=1) as sp:
        profiling.count("splice.matches")
        res = models.family(cfg).canvas_matcher(
            pad.image(head), pad.mask(head), pad.image(other),
            pad.mask(other), min_overlap=cfg.splice_min_overlap,
            ratio=cfg.splice_xcorr_ratio)
        if not bool(res.ok):
            profiling.count("splice.rejects")
            return None
        count = int(res.count)
        sp.set(count=count)
        return tuple(int(v) for v in res.offset.tolist()), count


def _match_tables(pairs: List[Tuple[_Snippet, _Snippet]],
                  cfg: PipelineConfig, pad: _PadState):
    """The cellular matcher on the pad state's tables of ``pairs``: each
    pair's (ok, count, dx, dy) and the multiplicity it ended at.  The
    pairs' tables are sorted once, in one batch, before any join: the
    sort gives each pair's need (one host read, a ``splice.need`` span),
    and every join takes its rows.  Pairs whose need passes
    ``cfg.join_multiplicity`` run at the power of two over it (counter
    ``splice.jumps``), or dense where that join is no smaller
    (``4 * m >= K``); the pairs at one multiplicity are voted on together
    in chunks of :func:`_batch_pairs`, each a ``splice.vote`` span whose
    results come back in one host read.  A pair whose join still
    overflows retries alone at the join's own measure (counter
    ``splice.retries``); counter ``splice.batches`` counts every vote,
    retries included.  Both spans record CUDA events on the tables'
    device."""
    k = pad.cap
    n = len(pairs)
    # each snippet padded once, so a repeated head stacks as one plane
    tabs, masks = {}, {}
    for h, o in pairs:
        for s in (h, o):
            if id(s) not in tabs:
                tabs[id(s)] = _padded_tables(s, k)
        if id(h) not in masks:
            masks[id(h)] = pad.mask(h)
    h_tabs = [_stacked([tabs[id(h)][i] for h, _ in pairs]) for i in range(3)]
    o_tabs = [_stacked([tabs[id(o)][i] for _, o in pairs]) for i in range(3)]
    mask = _stacked([masks[id(h)] for h, _ in pairs])
    dev = mask.device
    dims = upload(np.array([[h.dims, o.dims] for h, o in pairs]), dev)
    with profiling.span("splice.need", device=dev):
        tables = splice_ops.sort_tables(*h_tabs, *o_tabs)
        needs = _needed_multiplicity(tables)

    def vote(idx: List[int], mult: int):
        every = len(idx) == n
        sel = None if every else upload(np.array(idx), dev)

        def take(t):
            return t if every else t.index_select(0, sel)

        rows = type(tables.rows)(*(take(t) for t in tables.rows))
        profiling.count("splice.batches")
        with profiling.span("splice.vote", device=dev):
            res = splice_ops.match_fragments(
                *(take(t) for t in h_tabs + o_tabs), take(mask),
                take(dims[:, 0]), take(dims[:, 1]),
                cell_w=cfg.splice_cell[0], cell_h=cfg.splice_cell[1],
                ratio=cfg.splice_cell_ratio, multiplicity=mult, rows=rows)
            # ok, count, dx, dy, overflow, need: one host read
            return torch.stack(
                [res.ok.long(), res.count, res.offset[:, 0],
                 res.offset[:, 1], res.overflow.long(),
                 res.needed_multiplicity.long()], dim=1).tolist()

    mults = []
    for est in needs:
        mult = cfg.join_multiplicity
        if est > mult:
            profiling.count("splice.jumps")
            nm = 1 << (est - 1).bit_length()
            mult = 0 if 4 * nm >= k else nm
        mults.append(mult)
    out: List[list] = [[] for _ in range(n)]
    for mult in dict.fromkeys(mults):
        group = [i for i in range(n) if mults[i] == mult]
        step = _batch_pairs(mult, k)
        for j in range(0, len(group), step):
            idx = group[j:j + step]
            for i, row in zip(idx, vote(idx, mult)):
                out[i] = row
    for i in range(n):
        while out[i][4] and mults[i] != 0:
            profiling.count("splice.retries")
            needed, nm = out[i][5], max(2 * mults[i], 2)
            while nm < needed:
                nm *= 2
            mults[i] = 0 if 4 * nm >= k else nm
            out[i] = vote([i], mults[i])[0]
    return [(bool(r[0]), r[1], r[2], r[3]) for r in out], mults


def _match_round(pairs: List[Tuple[_Snippet, _Snippet]], cfg: PipelineConfig,
                 pad: _PadState) -> None:
    """Match ``pairs`` (head, other) and give each accepted pair its two
    edges, in the pairs' order (the greedy loop's tie order)."""
    for (head, other), vote in zip(pairs, _match_pairs(pairs, cfg, pad)):
        if vote is not None:
            off, count = vote
            head.edges.append(_Edge(True, off, count, other))
            other.edges.append(_Edge(False, (-off[0], -off[1]), count, head))


def _unbind(snippet: _Snippet) -> None:
    for e in snippet.edges:
        e.other.edges = [x for x in e.other.edges if x.other is not snippet]
    snippet.edges = []


def _merge_canvas(left: torch.Tensor, lshape: Tuple[int, int],
                  right: torch.Tensor, rshape: Tuple[int, int],
                  grow: Tuple[int, int, int, int],
                  at: Tuple[int, int]) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """A new padded canvas: the left canvas grown by ``grow`` (top, bottom,
    left, right) with the right canvas histogram-added at ``at`` (x, y),
    wrapping at 2**16 (fgm.hpp:99-113).  Raises where the right canvas
    does not fit, rather than clamping it elsewhere."""
    gt, gb, gl, gr = grow
    lh, lw = lshape
    rh, rw = rshape
    ax, ay = at
    h, w = lh + gt + gb, lw + gl + gr
    if min(grow) < 0 or ax < 0 or ay < 0 or ay + rh > h or ax + rw > w:
        raise ValueError(f"a {rw}x{rh} canvas at {at} does not fit the "
                         f"grown {w}x{h} canvas")
    out = atlas_ops.empty_canvas(h, w, left.device)
    out[:, gt:gt + lh, gl:gl + lw] = left[:, :lh, :lw]
    view = out[:, ay:ay + rh, ax:ax + rw]
    view.copy_((view + right[:, :rh, :rw]) & 0xFFFF)
    return out, (h, w)


def merge_fragments(left: Fragment, right: Fragment, offset: Tuple[int, int],
                    step: Tuple[int, int]) -> Fragment:
    """fgm::fragment::blit(zero + offset, other) + normalize
    (fgs.hpp:165-183, fgm.hpp:99-113,190-233): histogram-add the right
    canvas into the left at ``left.zero + offset`` with step-quantised
    growth, and remap the right's frame records."""
    pos = (left.zero[0] + offset[0], left.zero[1] + offset[1])
    rh, rw = right.shape
    lh, lw = left.shape

    def round_step(change: int, s: int) -> int:
        rest = change % s
        return change - rest + (s if rest else 0)

    zx, zy = left.zero
    grow_l = round_step(zx - pos[0], step[0]) if pos[0] < zx else 0
    grow_r = (round_step(pos[0] + rw - (zx + lw), step[0])
              if pos[0] + rw > zx + lw else 0)
    grow_t = round_step(zy - pos[1], step[1]) if pos[1] < zy else 0
    grow_b = (round_step(pos[1] + rh - (zy + lh), step[1])
              if pos[1] + rh > zy + lh else 0)
    zero = (zx - grow_l, zy - grow_t)
    at = (pos[0] - zero[0], pos[1] - zero[1])
    dots, shape = _merge_canvas(
        left.device_dots(), left.shape, right.device_dots(), right.shape,
        (grow_t, grow_b, grow_l, grow_r), at)

    frames = [FrameRef(f.number, f.position) for f in left.frames]
    for f in right.frames:
        frames.append(FrameRef(f.number, (
            f.position[0] - right.zero[0] + pos[0],
            f.position[1] - right.zero[1] + pos[1])))
    merged = Fragment(dots_dev=dots, shape=shape, zero=zero, frames=frames,
                      store=left.store)
    merged.normalize()
    return merged


def splice(fragments: List[Fragment], cfg: PipelineConfig,
           frame_dims: Optional[Tuple[int, int]] = None,
           device=None, devices=None) -> List[Fragment]:
    """The spliced fragments.  ``frame_dims`` = (width, height), the growth
    step (frc fragments carry step = frame dims, fgm.hpp:49-52).  Canvases
    already on a device stay there; host canvases go to ``device`` (CUDA
    unless the caller asks for the CPU).  ``devices``: the devices of the
    initial extraction's round robin (:func:`_extract_snippets`)."""
    if not fragments:
        return []
    if frame_dims is None:
        assert fragments[0].store is not None
        frame_dims = (fragments[0].store.width, fragments[0].store.height)

    profiling.count("splice.fragments", len(fragments))
    with profiling.span("splice.extract"):
        snippets = _extract_snippets(fragments, cfg, device, devices)
    pad = _PadState()
    pad.update(snippets)
    # the first round: every pair i < j, in the order of the loops over
    # i, then j
    _match_round([(h, o) for i, h in enumerate(snippets)
                  for o in snippets[i + 1:]], cfg, pad)

    while True:
        best: Optional[Tuple[_Snippet, _Edge]] = None
        for s in snippets:
            for e in s.edges:
                # strict >: the first maximal edge in snippet, then edge,
                # order wins
                if e.primary and (best is None or e.count > best[1].count):
                    best = (s, e)
        if best is None:
            break
        left, edge = best
        right = edge.other

        profiling.count("splice.merges")
        with profiling.span("splice.merge"):
            merged_frag = merge_fragments(left.fragment, right.fragment,
                                          edge.offset, frame_dims)
        _unbind(right)
        _unbind(left)
        snippets = [s for s in snippets if s is not left and s is not right]
        with profiling.span("splice.extract"):
            merged = _extract_snippet(merged_frag, cfg, device)
        snippets.insert(0, merged)
        pad.update([merged])
        _match_round([(merged, o) for o in snippets[1:]], cfg, pad)

    return [s.fragment for s in snippets]
