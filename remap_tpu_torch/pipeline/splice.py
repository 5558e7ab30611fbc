"""The fragment splicing stage (port of remap_tpu/pipeline/splice.py,
fgs.hpp).

Each fragment is blended and keypoint-extracted with a whole-canvas 1x1
grid (fgs.hpp:17/80-103: K1 on the canvas padded to 256-multiples, the
weights cut to the true canvas's interior, then K2 with a capacity sized
to the keypoint count), matched all-pairs with the cellular matcher
(``ops.splice``, cells of 15x15, fgs.hpp:119-140), then a host greedy loop
merges the highest-vote pair (ties -> first in snippet order, then edge
order, fgs.hpp:142-163), re-extracts the merged snippet (list front),
re-matches it against the rest, and repeats until no edges remain.
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

import torch
import torch.nn.functional as F

from remap_tpu_torch import models
from remap_tpu_torch.config import PipelineConfig
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.device import current
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


def _needed_multiplicity(tables: splice_ops.SortedTables) -> int:
    """The join's ``needed_multiplicity`` of a pair, read from its code
    sort on the tables' device: the most valid ``head`` rows sharing one
    code quadruple that ``other`` also holds."""
    return int(tables.need)


def _padded_tables(s: _Snippet, k: int):
    extra = k - s.codes.shape[0]
    if extra == 0:
        return s.codes, s.pos, s.valid
    return (F.pad(s.codes, (0, 0, 0, extra)), F.pad(s.pos, (0, 0, 0, extra)),
            F.pad(s.valid, (0, extra)))


def _match(head: _Snippet, other: _Snippet, cfg: PipelineConfig,
           pad: Optional[_PadState] = None
           ) -> Optional[Tuple[Tuple[int, int], int]]:
    """(offset, count) of an accepted match of ``other`` against ``head``,
    or None.  Under grid_vote the multiplicity starts at the power of two
    over the need that the join's own code sort measures, retries at the
    join's measure on overflow, and turns dense where the dense join is no
    bigger (``4 * m >= K``).  The correlation families align the pad
    state's canvases (the zero padding is masked out, so offsets are
    exact).  Recorded as a
    ``splice.match`` span with the multiplicity it ended at and the
    accepted count; a match not accepted adds to the counter
    ``splice.rejects``.  Under grid_vote the code sort and the read of the
    need are a ``splice.need`` span, and each call of the cellular matcher
    a ``splice.vote`` span, both with CUDA events on the tables' device;
    counters ``splice.jumps`` (matches whose need raised the
    multiplicity) and ``splice.retries`` (overflow retries)."""
    with profiling.span("splice.match") as sp:
        profiling.count("splice.matches")
        if pad is None:
            pad = _PadState()
            pad.update([head, other])
        canvas_match = models.family(cfg).canvas_matcher
        if canvas_match is not None:
            res = canvas_match(pad.image(head), pad.mask(head),
                               pad.image(other), pad.mask(other),
                               min_overlap=cfg.splice_min_overlap,
                               ratio=cfg.splice_xcorr_ratio)
        else:
            res, mult = _match_tables(head, other, cfg, pad)
            sp.set(multiplicity=mult)
        if not bool(res.ok):
            profiling.count("splice.rejects")
            return None
        count = int(res.count)
        sp.set(count=count)
        return tuple(int(v) for v in res.offset.tolist()), count


def _match_tables(head: _Snippet, other: _Snippet, cfg: PipelineConfig,
                  pad: _PadState):
    """The cellular matcher's result on the pad state's tables, and the
    multiplicity it ended at.  The tables are sorted once, before the
    join: the sort gives the need, and every join of the match takes its
    rows."""
    k = pad.cap
    h_tabs = _padded_tables(head, k)
    o_tabs = _padded_tables(other, k)
    mask = pad.mask(head)
    mult = cfg.join_multiplicity
    with profiling.span("splice.need", device=mask.device):
        tables = splice_ops.sort_tables(*h_tabs, *o_tabs)
        est = _needed_multiplicity(tables)
    if est > mult:
        profiling.count("splice.jumps")
        nm = 1 << (est - 1).bit_length()
        mult = 0 if 4 * nm >= k else nm
    while True:
        with profiling.span("splice.vote", device=mask.device):
            res = splice_ops.match_fragments(
                *h_tabs, *o_tabs, mask, head.dims, other.dims,
                cell_w=cfg.splice_cell[0], cell_h=cfg.splice_cell[1],
                ratio=cfg.splice_cell_ratio, multiplicity=mult,
                rows=tables.rows)
        if not bool(res.overflow) or mult == 0:
            return res, mult
        profiling.count("splice.retries")
        needed = int(res.needed_multiplicity)
        nm = max(2 * mult, 2)
        while nm < needed:
            nm *= 2
        mult = 0 if 4 * nm >= k else nm


def _match_partial(head: _Snippet, rest: List[_Snippet], cfg: PipelineConfig,
                   pad: Optional[_PadState] = None) -> None:
    for other in rest:
        vote = _match(head, other, cfg, pad)
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
    for i in range(len(snippets)):
        _match_partial(snippets[i], snippets[i + 1:], cfg, pad)

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
        _match_partial(snippets[0], snippets[1:], cfg, pad)

    return [s.fragment for s in snippets]
