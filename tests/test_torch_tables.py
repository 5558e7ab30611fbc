"""Port region tables (remap_tpu_torch.ops.tables) vs the JAX package, exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from remap_tpu.ops import tables as jtab
from remap_tpu_torch.core.regions import make_layout
from remap_tpu_torch.ops import tables as ttab
from remap_tpu_torch.ops.kernels import tables as ktab

from torch_parity import (  # noqa: F401 (fixtures)
    CFG, LAYOUT, assert_tables_equal, interpret_pallas, jax_twin, to_torch,
)

DENSITIES = [0.05, 0.35, 0.95]   # 0.95 overflows every region


def _planes(rng, b, h, w, density):
    """Random weight {0,1,2} at ``density`` and random full-range codes."""
    weight = (rng.random((b, h, w)) < density).astype(np.uint8)
    weight[weight > 0] = rng.integers(1, 3, size=int((weight > 0).sum()))
    codes = rng.integers(0, 1 << 32, size=(b, h, w, 4), dtype=np.uint32)
    return weight, codes


@pytest.mark.parametrize("density", DENSITIES)
def test_tables_plain_matches_jax_topk(density):
    """Valid rows, valid, wcounts and overflow equal JAX's topk tables
    (whose invalid rows hold other codes)."""
    rng = np.random.default_rng(11)
    weight, codes = _planes(rng, 4, 64, 96, density)
    ref = jtab.build_tables(jnp.asarray(weight), jnp.asarray(codes),
                            jax_twin(LAYOUT), CFG.region_capacity,
                            mode="topk")
    got = ttab.build_tables(to_torch(weight), to_torch(codes), LAYOUT,
                            CFG.region_capacity)
    assert_tables_equal(got, ref, full=False, msg=f"d={density}")
    if density in (0.05, 0.95):
        assert bool(np.asarray(ref.overflow).any()) == (density > 0.9)


@pytest.mark.parametrize("density", DENSITIES)
def test_tables_plain_matches_pallas_interpret(interpret_pallas, density):
    """Every row equals the TPU table kernel run in interpret mode (its
    canonical invalid rows included), on the kernel-supported layout of
    tests/test_pallas.py."""
    from remap_tpu.ops.pallas import tables as ptables

    h, w, capacity = 60, 160, 128
    layout = make_layout(w, h, 2, 2, 8)
    assert ptables.supports(jax_twin(layout), h, w, capacity)
    rng = np.random.default_rng(12)
    weight, codes = _planes(rng, 2, h, w, density)
    ref = ptables.build_tables_pallas(jnp.asarray(weight), jnp.asarray(codes),
                                      jax_twin(layout), capacity)
    got = ttab.build_tables(to_torch(weight), to_torch(codes), layout,
                            capacity)
    assert_tables_equal(got, ref, full=True, msg=f"d={density}")


def test_tables_plain_small_region_pads_to_capacity():
    """A region smaller than the table: every pixel fits, the rest of the
    table is canonical invalid rows."""
    rng = np.random.default_rng(13)
    weight, codes = _planes(rng, 2, 64, 96, 0.5)
    got = ttab.build_tables(to_torch(weight), to_torch(codes), LAYOUT, 4096)
    ref = jtab.build_tables(jnp.asarray(weight), jnp.asarray(codes),
                            jax_twin(LAYOUT), 4096, mode="topk")
    assert_tables_equal(got, ref, full=False)
    x_lo, _, y_lo, _ = LAYOUT.region_span(0, 0)
    invalid = ~got.valid[0, 0]
    assert (got.pos[0, 0][invalid] == torch.tensor([x_lo, y_lo],
                                                   dtype=torch.int32)).all()


def _edge_case(case, rng):
    """(weight, codes, layout, capacity) at an edge of the kernel's tiling:
    region 0 holding exactly ``capacity`` keypoints, a capacity of 1, a
    region one row tall."""
    if case == "count_is_capacity":
        weight, codes = _planes(rng, 2, 64, 96, 0.0)
        x_lo, x_hi, y_lo, y_hi = LAYOUT.region_span(0, 0)
        n = (x_hi - x_lo) * (y_hi - y_lo)
        picked = np.sort(rng.choice(n, 100, replace=False))
        weight[:, y_lo + picked // (x_hi - x_lo),
               x_lo + picked % (x_hi - x_lo)] = rng.integers(1, 3, (2, 100))
        return weight, codes, LAYOUT, 100
    if case == "capacity_1":
        weight, codes = _planes(rng, 2, 64, 96, 0.35)
        return weight, codes, LAYOUT, 1
    assert case == "one_row"
    layout = make_layout(300, 7, 1, 1, 0)
    weight, codes = _planes(rng, 2, 7, 300, 0.35)
    return weight, codes, layout, 64


@pytest.mark.parametrize("case", ["count_is_capacity", "capacity_1",
                                  "one_row"])
def test_tables_plain_matches_jax_topk_at_edges(case):
    """The plain version (the card tests' oracle) equals JAX's topk tables
    where a tiled kernel is most likely to slip: a count exactly the
    capacity, a capacity of 1, a one-row region."""
    rng = np.random.default_rng(16)
    weight, codes, layout, capacity = _edge_case(case, rng)
    ref = jtab.build_tables(jnp.asarray(weight), jnp.asarray(codes),
                            jax_twin(layout), capacity, mode="topk")
    got = ttab.build_tables(to_torch(weight), to_torch(codes), layout,
                            capacity)
    assert_tables_equal(got, ref, full=False, msg=case)
    counts = got.wcounts[..., 1:].sum(-1)
    if case == "count_is_capacity":
        assert (counts[:, 0] == capacity).all()
        assert bool(got.valid[:, 0].all()) and not bool(got.overflow[:, 0].any())
    elif case == "capacity_1":
        assert bool(got.overflow.all())
    else:
        x_lo, x_hi, y_lo, y_hi = ttab.region_spans(layout)[0]
        assert y_hi - y_lo == 1 and bool(got.overflow.all())


def test_tables_wrapper_rejects_cpu_tensors():
    rng = np.random.default_rng(14)
    weight, codes = _planes(rng, 1, 64, 96, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        ktab.build_tables_cuda(to_torch(weight), to_torch(codes),
                               ttab.region_spans(LAYOUT), 512)
