"""Binning stage tests.

Covers the reference's binning test surface (/root/reference/tests/
test_binning.py): shape/dtype/range invariants, multi-tile overlap counting,
empty inputs, boundary gaussians, multiple tile sizes — plus the checks the
reference omits or leaves broken: an actual depth-ordering assertion (the
reference computes but never asserts it, test_binning.py:103-131), a brute
force per-tile membership oracle, and the static-shape budget semantics
(span truncation, capacity overflow) unique to this static-shape design.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mojosplat_jax import RenderConfig
from mojosplat_jax.ops.binning import (
    bin_gaussians_to_tiles,
    isect_capacity,
    num_tiles,
)

CFG = RenderConfig()


def run_binning(means2d, radii, depths, H=64, W=64, config=CFG, capacity=None):
    return bin_gaussians_to_tiles(
        jnp.asarray(means2d, jnp.float32),
        jnp.asarray(radii, jnp.int32),
        jnp.asarray(depths, jnp.float32),
        H,
        W,
        config,
        capacity=capacity,
    )


def brute_force_tiles(mean, radius, H, W, ts):
    """Independent per-gaussian tile membership (floor/ceil AABB)."""
    th, tw = num_tiles(H, W, ts)
    x, y = mean
    rx, ry = radius
    if rx <= 0 or ry <= 0:
        return set()
    tx0 = int(np.clip(np.floor((x - rx) / ts), 0, tw))
    tx1 = int(np.clip(np.ceil((x + rx) / ts), 0, tw))
    ty0 = int(np.clip(np.floor((y - ry) / ts), 0, th))
    ty1 = int(np.clip(np.ceil((y + ry) / ts), 0, th))
    return {ty * tw + tx for ty in range(ty0, ty1) for tx in range(tx0, tx1)}


def extract_tile_lists(res, th, tw):
    """Dict tile_id -> list of gaussian ids in sorted order."""
    ranges = np.asarray(res.tile_ranges).reshape(-1, 2)
    gids = np.asarray(res.gaussian_ids)
    return {
        t: list(gids[ranges[t, 0] : ranges[t, 1]]) for t in range(th * tw)
    }


def test_shapes_dtypes_and_range_invariants():
    # Reference invariants: shapes, dtypes, start <= end (test_binning.py:78-100).
    means = np.array([[10.0, 10.0], [40.0, 40.0], [60.0, 20.0]])
    radii = np.array([[3, 3], [5, 5], [2, 2]])
    depths = np.array([2.0, 1.0, 3.0])
    res = run_binning(means, radii, depths)
    th, tw = num_tiles(64, 64, CFG.tile_size)
    assert res.tile_ranges.shape == (th, tw, 2)
    assert res.tile_ranges.dtype == jnp.int32
    assert res.gaussian_ids.dtype == jnp.int32
    r = np.asarray(res.tile_ranges)
    assert np.all(r[..., 0] <= r[..., 1])
    assert np.all(r >= 0)
    assert int(res.aux.num_isects) == 3  # each fits inside one tile
    assert int(res.aux.capacity_overflow) == 0
    assert int(res.aux.span_truncated) == 0


def test_membership_matches_brute_force():
    rng = np.random.default_rng(0)
    n = 50
    H = W = 96
    means = rng.uniform(-10, 106, (n, 2))
    radii = rng.integers(0, 20, (n, 2))
    radii[radii[:, 0] == 0] = 0  # some fully culled
    depths = rng.uniform(0.5, 10.0, n)
    res = run_binning(means, radii, depths, H, W)
    th, tw = num_tiles(H, W, CFG.tile_size)
    lists = extract_tile_lists(res, th, tw)
    got = {(t, g) for t, gl in lists.items() for g in gl}
    want = set()
    for i in range(n):
        for t in brute_force_tiles(means[i], radii[i], H, W, CFG.tile_size):
            want.add((t, i))
    assert got == want


def test_depth_sorted_within_tiles():
    # The check the reference's test computes but never asserts
    # (test_binning.py:103-131): within each tile, gaussians are depth-ascending.
    rng = np.random.default_rng(1)
    n = 40
    means = rng.uniform(0, 64, (n, 2))
    radii = np.full((n, 2), 10, np.int64)
    depths = rng.uniform(0.5, 10.0, n)
    res = run_binning(means, radii, depths)
    th, tw = num_tiles(64, 64, CFG.tile_size)
    for t, gl in extract_tile_lists(res, th, tw).items():
        d = depths[gl]
        assert np.all(np.diff(d) >= 0), f"tile {t} not depth-sorted"


def test_multi_tile_overlap_counted():
    # A gaussian spanning a 2x2 tile block appears in all 4 lists
    # (test_binning.py:134-147).
    means = np.array([[16.0, 16.0]])  # on the corner of 4 tiles (ts=16)
    radii = np.array([[4, 4]])
    res = run_binning(means, radii, np.array([1.0]))
    assert int(res.aux.num_isects) == 4
    lists = extract_tile_lists(res, *num_tiles(64, 64, CFG.tile_size))
    containing = [t for t, gl in lists.items() if 0 in gl]
    assert len(containing) == 4


def test_empty_and_all_culled():
    # Empty: start == end everywhere (test_binning.py:150-165).
    res = run_binning(np.zeros((3, 2)), np.zeros((3, 2)), np.ones(3))
    r = np.asarray(res.tile_ranges)
    assert np.all(r[..., 0] == r[..., 1])
    assert int(res.aux.num_isects) == 0
    assert np.all(np.asarray(res.gaussian_ids) == -1)


def test_out_of_image_gaussians_dropped():
    # Fully outside the viewport -> no intersections (test_binning.py:182-194).
    means = np.array([[-100.0, -100.0], [500.0, 500.0]])
    radii = np.array([[5, 5], [5, 5]])
    res = run_binning(means, radii, np.array([1.0, 2.0]))
    assert int(res.aux.num_isects) == 0


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_tile_sizes(ts):
    # Reference parametrizes tile sizes {8,16,32} (test_binning.py:358-373).
    cfg = RenderConfig(tile_size=ts)
    H = W = 64
    means = np.array([[32.0, 32.0]])
    radii = np.array([[ts, ts]])
    res = run_binning(means, radii, np.array([1.0]), H, W, cfg)
    th, tw = num_tiles(H, W, ts)
    assert res.tile_ranges.shape == (th, tw, 2)
    want = brute_force_tiles([32.0, 32.0], [ts, ts], H, W, ts)
    assert int(res.aux.num_isects) == len(want)


def test_span_truncation_counted_and_centered():
    # A huge gaussian is capped at max_tile_span^2 tiles, centered on its mean.
    cfg = RenderConfig(max_tile_span=2)
    means = np.array([[32.0, 32.0]])
    radii = np.array([[100, 100]])  # would cover the whole 4x4 grid
    res = run_binning(means, radii, np.array([1.0]), 64, 64, cfg)
    assert int(res.aux.num_isects) == 4  # 2x2 kept
    assert int(res.aux.span_truncated) == 16 - 4
    lists = extract_tile_lists(res, *num_tiles(64, 64, cfg.tile_size))
    kept = sorted(t for t, gl in lists.items() if gl)
    # Center tiles of the 4x4 grid: rows 1-2, cols 1-2.
    assert kept == [1 * 4 + 1, 1 * 4 + 2, 2 * 4 + 1, 2 * 4 + 2]


def test_capacity_overflow_counted():
    n = 8
    means = np.full((n, 2), 8.0)
    radii = np.full((n, 2), 2)
    depths = np.arange(n, dtype=np.float64) + 1
    res = run_binning(means, radii, depths, 64, 64, capacity=4)
    assert int(res.aux.capacity_overflow) == 4
    assert int(res.aux.num_isects) == 4


def test_overflow_drops_farthest_and_routes_agree():
    # Under capacity overflow binning must keep the NEAREST intersections
    # (depth-prioritized truncation), with every kept slot still sorted by
    # (tile, depth). The kernel route and the XLA route share this binning.
    rng = np.random.RandomState(7)
    n = 64
    means = rng.uniform(0, 64, (n, 2))
    radii = np.full((n, 2), 9)  # ~4 tiles each at ts=16
    depths = rng.uniform(1.0, 10.0, n)
    cap = 32  # far below the real intersection count
    rx = run_binning(means, radii, depths, 64, 64, config=CFG, capacity=cap)
    assert int(rx.aux.capacity_overflow) > 0
    tiles = np.asarray(rx.tile_ids)
    gids = np.asarray(rx.gaussian_ids)
    real = gids >= 0
    assert np.all(np.diff(tiles) >= 0)
    for t in np.unique(tiles[real]):
        d = depths[gids[real & (tiles == t)]]
        assert np.all(np.diff(d) >= 0)
    # Every kept gaussian is nearer than every dropped one.
    kept = set(int(g) for g in np.asarray(rx.gaussian_ids) if g >= 0)
    order = np.argsort(depths, kind="stable")
    kept_ranks = [i for i, g in enumerate(order) if int(g) in kept]
    assert max(kept_ranks) == len(kept_ranks) - 1  # a depth-prefix


def test_capacity_helper_rounds_up():
    assert isect_capacity(1, CFG) == 1024
    assert isect_capacity(1000, CFG) % 1024 == 0
    assert isect_capacity(1000, CFG) >= 4000


def test_boundary_gaussian_no_crash():
    # Gaussians exactly on image boundaries (test_binning.py:46-72).
    means = np.array([[0.0, 0.0], [63.99, 63.99], [0.0, 63.99]])
    radii = np.full((3, 2), 1)
    res = run_binning(means, radii, np.array([1.0, 2.0, 3.0]))
    assert int(res.aux.num_isects) >= 3
