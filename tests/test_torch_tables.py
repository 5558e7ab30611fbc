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
    CFG, LAYOUT, assert_tables_equal, interpret_pallas, jax_twin, to_numpy,
    to_torch,
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


@pytest.mark.parametrize("density,capacity", [
    (0.05, 512), (0.35, 512), (0.35, 4096), (0.95, 64)],
    ids=["sparse", "chunk_overflow", "chunk_overflow_small_region",
         "capacity_overflow"])
def test_tables_sort2_matches_jax(density, capacity):
    """The port's "sort2" tables equal JAX's ``build_tables(mode="sort2")``
    in every row: below the chunk quota (no flag), where a 512-px chunk
    holds more than SORT2_QUOTA keypoints (the chunk-quota flag, and rows
    that differ from the topk tables), with a table larger than a region
    (the level-2 keys padded up to it) and where the count passes the
    capacity."""
    rng = np.random.default_rng(17)
    weight, codes = _planes(rng, 3, 64, 96, density)
    ref = jtab.build_tables(jnp.asarray(weight), jnp.asarray(codes),
                            jax_twin(LAYOUT), capacity, mode="sort2")
    got = ttab.build_tables(to_torch(weight), to_torch(codes), LAYOUT,
                            capacity, mode="sort2")
    assert_tables_equal(got, ref, full=True, msg=f"d={density}")
    overflow = to_numpy(got.overflow)
    assert overflow.any() == (density > 0.3)
    topk = ttab.build_tables(to_torch(weight), to_torch(codes), LAYOUT,
                             capacity)
    same = ~overflow
    for a, b in zip(got, topk):
        np.testing.assert_array_equal(to_numpy(a)[same], to_numpy(b)[same])


def test_tables_sort2_flags_the_noise_chunk():
    """The streaming step's sort2 case (iid 16-colour noise, 96x64,
    capacity 512) through extraction: region 6's flag is set in both
    packages by its chunk quota alone, since its count fits the table."""
    from remap_tpu.ops import kpe as jkpe
    from remap_tpu_torch.ops import kpe as tkpe

    rng = np.random.default_rng(32)
    frame = rng.integers(0, 16, (1, 64, 96), dtype=np.uint8)
    jd = jkpe.extract_dense(jnp.asarray(frame), jax_twin(LAYOUT))
    td = tkpe.extract_dense(to_torch(frame), LAYOUT)
    ref = jtab.build_tables(jd.weight, jd.codes, jax_twin(LAYOUT), 512,
                            mode="sort2")
    got = ttab.build_tables(td.weight, td.codes, LAYOUT, 512, mode="sort2")
    assert_tables_equal(got, ref, full=True)
    assert bool(got.overflow[0, 6])
    assert int(got.wcounts[0, 6, 1:].sum()) <= 512


def test_tables_unknown_mode_raises():
    rng = np.random.default_rng(18)
    weight, codes = _planes(rng, 1, 64, 96, 0.1)
    with pytest.raises(ValueError, match="bogus"):
        ttab.build_tables(to_torch(weight), to_torch(codes), LAYOUT, 512,
                          mode="bogus")


def test_tables_wrapper_rejects_cpu_tensors():
    rng = np.random.default_rng(14)
    weight, codes = _planes(rng, 1, 64, 96, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        ktab.build_tables_cuda(to_torch(weight), to_torch(codes),
                               ttab.region_spans(LAYOUT), 512)
