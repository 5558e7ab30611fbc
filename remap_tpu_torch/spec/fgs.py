"""Spec: fragment splicing (fgs.hpp).

The port's copy of remap_tpu/spec/fgs.py (only the import paths differ);
tests/test_torch_core.py holds the two equal.

Each fragment is blended and keypoint-extracted with a whole-image 1x1 grid
(overlap 0, fgs.hpp:17/80-89); all pairs are matched with the cellular
matcher (cell 15x15, fgs.hpp:119-140); then a greedy loop merges the
highest-vote pair, re-extracts the merged snippet (inserted at the list
front, fgs.hpp:165-183) and re-matches it against the rest, until no edges
remain.

Tie-breaks: select_match keeps the first maximal edge in (snippet order,
edge insertion order) (fgs.hpp:142-163 via max_element).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.spec import kpe, kpm
from remap_tpu_torch.spec.fgm import Fragment

CELL = (15, 15)  # fgs.hpp:121


@dataclasses.dataclass(eq=False)
class Edge:
    primary: bool
    offset: Tuple[int, int]
    count: int
    other: "Snippet"


@dataclasses.dataclass(eq=False)
class Snippet:
    fragment: Fragment
    mask: np.ndarray
    region: kpe.RegionPoints
    edges: List[Edge] = dataclasses.field(default_factory=list)


def _extract_single(fragment: Fragment) -> Snippet:
    image, mask = fragment.blend()
    h, w = image.shape
    layout = make_layout(w, h, 1, 1, 0)
    res = kpe.extract(image, layout)
    return Snippet(fragment=fragment, mask=mask, region=res.regions[0])


def _match_partial(head: Snippet, rest: List[Snippet]) -> None:
    for other in rest:
        vote = kpm.match_fragments(
            head.region, head.mask, other.region, other.mask, CELL
        )
        if vote is not None:
            off, count = vote
            head.edges.append(Edge(True, off, count, other))
            other.edges.append(Edge(False, (-off[0], -off[1]), count, head))


def _select(snippets: List[Snippet]) -> Optional[Tuple[Snippet, Edge]]:
    best: Optional[Tuple[Snippet, Edge]] = None
    for s in snippets:
        for e in s.edges:
            if e.primary and (best is None or e.count > best[1].count):
                best = (s, e)
    return best


def _unbind(snippet: Snippet) -> None:
    for e in snippet.edges:
        e.other.edges = [x for x in e.other.edges if x.other is not snippet]
    snippet.edges = []


def splice(fragments: List[Fragment]) -> List[Fragment]:
    snippets = [_extract_single(f) for f in fragments]
    for i in range(len(snippets)):
        _match_partial(snippets[i], snippets[i + 1 :])

    while True:
        sel = _select(snippets)
        if sel is None:
            break
        left, edge = sel
        right = edge.other

        dst = left.fragment
        dst.blit_fragment(
            (dst.zero[0] + edge.offset[0], dst.zero[1] + edge.offset[1]),
            right.fragment,
        )
        dst.normalize()

        _unbind(right)
        _unbind(left)
        snippets.remove(right)
        snippets.remove(left)
        merged = _extract_single(dst)
        snippets.insert(0, merged)
        _match_partial(snippets[0], snippets[1:])

    return [s.fragment for s in snippets]
