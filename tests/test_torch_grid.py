"""The macro-grid march in the port against rtk_tpu: build_from_soup with
custom sort keys, the atrium soup, build_grid(march=True) bit for bit, the
bounce helpers on shared uniforms, the march's plain version against
rtk_tpu's fused march kernel (interpret mode) and against the port's flat
trace (tests/test_grid.py:286-351's cases), and Tracer(engine="march")."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtk_tpu
from rtk_tpu.models import path as jpath
from rtk_tpu.testing import grid as jgrid
from rtk_tpu.testing import scenes as jax_scenes
import rtk_tpu_torch as rt
from rtk_tpu_torch.models import path as tpath
from rtk_tpu_torch.ops.packet_trace import trace_packets
from rtk_tpu_torch.testing import grid as tgrid
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace import grid as tgrid_shim
from rtk_tpu_torch.utils import serialize as tser

from test_torch_build import assert_bits_equal
from test_torch_packed import assert_tables_equal
from test_torch_trace import CPU, _check, _rays

torch.set_num_threads(2)

LEAF = 8  # tests/test_grid.py's BuildConfig(branching=8, leaf_size=8)
DIMS = (3, 2, 3)


def _odd_even(t):
    return np.where(np.arange(t) % 2 == 1, 1, 2).astype(np.uint32)


@pytest.fixture(scope="module")
def grids():
    """blob(3) on a (3, 2, 3) grid with the march forest and a tri_mask
    (1 on odd triangles, 2 on even), built by both packages."""
    tris = scenes.blob(3)[0]
    mask = _odd_even(tris.shape[0])
    jg = jgrid.build_grid(tris, config=rtk_tpu.BuildConfig(leaf_size=LEAF),
                          dims=DIMS, march=True, tri_mask=mask)
    tg = tgrid.build_grid(tris, config=rt.BuildConfig(leaf_size=LEAF),
                          dims=DIMS, march=True, tri_mask=mask, device=CPU)
    return jg, tg


def _rand_rays(n, seed, scale=0.6, **kw):
    rng = np.random.default_rng(seed)
    return rtk_tpu.Rays.make(
        (rng.normal(size=(n, 3)) * scale).astype(np.float32),
        rng.normal(size=(n, 3)).astype(np.float32), **kw)


def _assert_parity(got, ref):
    """tests/test_grid.py::_assert_parity: equal hit masks, t within
    1e-6*(1+|t|), and a different triangle only at an exact-t tie."""
    assert torch.equal(got.hit, ref.hit)
    assert bool(((got.t - ref.t).abs() <= 1e-6 * (1 + ref.t.abs())).all())
    differ = got.slot != ref.slot
    assert torch.equal(got.t[differ], ref.t[differ])


def test_build_from_soup_codes_bit_equal():
    """Custom keys over the whole uint32 range (bit 31 set on half, with
    duplicates): the same Scene as rtk_tpu's, topology and all."""
    tris = scenes.blob(3)[0]
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 1 << 32, tris.shape[0], dtype=np.uint64)
    codes[::7] = codes[1::7][:codes[::7].shape[0]]
    codes = codes.astype(np.uint32)
    assert (codes >> 31).any()
    cfg = dict(leaf_size=4)
    want = rtk_tpu.build_from_soup(tris, config=rtk_tpu.BuildConfig(**cfg),
                                   codes=codes)
    got = rt.build_from_soup(tris, config=rt.BuildConfig(**cfg), codes=codes,
                             device=CPU)
    for f in tser._FIELDS:
        assert_bits_equal(getattr(got, f), getattr(want, f), f)
    with pytest.raises(ValueError, match="codes"):
        rt.build_from_soup(tris, codes=codes[:-1], device=CPU)


def test_atrium_and_choose_dims_equal_rtk_tpu():
    got, want = scenes.atrium(), jax_scenes.atrium()
    assert got.shape == want.shape == (409600, 3, 3)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for ext, n in (([1.0, 2.0, 0.5], 100000), ([20.0, 8.0, 20.0], 409600),
                   ([3.0, 1e-9, 3.0], 500)):
        assert tgrid.choose_dims(np.array(ext), n) == jgrid.choose_dims(
            np.array(ext), n)


def test_build_grid_bit_equal(grids):
    jg, tg = grids
    assert (tg.dims, tg.n_occ) == (tuple(jg.dims), jg.n_occ)
    for f in ("rank", "cells_to_flat", "march_to_flat", "grid_lo",
              "cell_size"):
        assert_bits_equal(getattr(tg, f), getattr(jg, f), f)
    for f in ("cells", "cells_march", "flat"):
        assert_tables_equal(getattr(tg, f), getattr(jg, f))
    # One root row per cell; empty cells are childless rows.
    cm = tg.cells_march
    assert tgrid_shim.build_grid is tgrid.build_grid
    n_cells = DIMS[0] * DIMS[1] * DIMS[2]
    assert cm.num_nodes >= n_cells and tg.n_occ <= n_cells


def test_bounce_helpers_on_shared_uniforms(monkeypatch):
    """geometric_normal and cosine_sample against rtk_tpu's, with the same
    NumPy uniforms fed to both (rtk_tpu's JAX draws are replaced)."""
    rng = np.random.default_rng(6)
    n = 500
    vp = rng.normal(size=(n, 3, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    want_n = jpath.geometric_normal(types.SimpleNamespace(
        vertex_position=jnp.asarray(vp)), jnp.asarray(d))
    got_n = tpath.geometric_normal(types.SimpleNamespace(
        vertex_position=torch.as_tensor(vp)), torch.as_tensor(d))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=1e-6)
    u = rng.random((2, n)).astype(np.float32)
    monkeypatch.setattr(jax.random, "split", lambda key: (0, 1))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda k, shape, dtype: jnp.asarray(u[k]))
    want = np.asarray(jpath.cosine_sample(None, want_n))
    got = tpath.cosine_sample(None, got_n, u1=torch.as_tensor(u[0]),
                              u2=torch.as_tensor(u[1]))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    # Unit directions in the normal's hemisphere, from a generator.
    gen = torch.Generator().manual_seed(0)
    s = tpath.cosine_sample(gen, got_n)
    assert torch.allclose(s.norm(dim=1), torch.ones(n), atol=1e-5)
    assert bool(((s * got_n).sum(dim=1) >= -1e-6).all())
    assert torch.equal(s, tpath.cosine_sample(
        torch.Generator().manual_seed(0), got_n))


CASES = {
    "random": lambda: _rand_rays(256, 7),
    "camera": lambda: jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0),
                                             (0, 1, 0), 45, 16, 16),
    "window": lambda: _rand_rays(256, 8, min_t=0.3, max_t=0.9),
    "outside_and_dead": lambda: rtk_tpu.Rays.make(
        np.repeat(np.float32([[10, 10, 10], [10, 10, 10], [0.1, 0, 0]]), 43,
                  axis=0),
        np.repeat(np.float32([[-1, -1, -1], [1, 0.5, 0.25], [1, 0, 0]]), 43,
                  axis=0),
        0.0, np.float32(np.arange(129) % 5 != 0) * np.float32(3e38)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_march_matches_rtk_tpu_and_the_flat_trace(grids, case):
    """The march's plain version against rtk_tpu's fused march kernel
    (interpret mode; test_packet.py's bar, as rtk_tpu's t can differ in
    the last bits) and against the port's flat trace on the same tables
    (test_grid.py's parity bar).  Closest-hit, then any-hit masks."""
    jg, tg = grids
    jrays = CASES[case]()
    rays = _rays(jrays)
    got = tgrid.trace_packets_march(tg, rays)
    _assert_parity(got, trace_packets(tg.flat, rays))
    # outside_and_dead repeats three rays 43 times each, and two of them
    # run through shared edges: the two kernels find different triangles
    # at the same t there (t is still held to 1e-5).
    _check(got, jgrid.trace_packets_march(jg, jrays, interpret=True,
                                          pkt=128),
           same_frac=0.0 if case == "outside_and_dead" else 0.9)
    if case == "window":
        tt = got.t[got.hit]
        assert bool(((tt > 0.3) & (tt < 0.9)).all())
    if case == "camera":
        assert got.hit.any() and not got.hit.all()
    ga = tgrid.trace_packets_march(tg, rays, mode="any")
    assert torch.equal(ga.hit, trace_packets(tg.flat, rays, mode="any").hit)


def test_march_filter_mask_culls(grids):
    jg, tg = grids
    jrays = _rand_rays(256, 3)
    rays = _rays(jrays)
    got = tgrid.trace_packets_march(tg, rays, filter_mask=1)
    assert got.hit.any()
    assert bool((got.triangle_index[got.hit] % 2 == 1).all())
    _assert_parity(got, trace_packets(tg.flat, rays, filter_mask=1))
    _check(got, jgrid.trace_packets_march(jg, jrays, interpret=True,
                                          pkt=128, filter_mask=1))


def test_march_requires_march_pack(grids):
    tris = scenes.blob(2)[0]
    g = tgrid.build_grid(tris, config=rt.BuildConfig(leaf_size=LEAF),
                         dims=DIMS, device=CPU)
    assert g.cells_march is None and g.march_to_flat is None
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 8, 8,
                              device=CPU)
    with pytest.raises(ValueError, match="march=True"):
        tgrid.trace_packets_march(g, rays)


def test_march_counts(grids):
    """Per-ray counts summed over the cells: steps = internal + leaf pops,
    every cell a ray visits costs at least its root pop, any-hit counts
    stay at or below closest-hit counts, and rays that miss the grid or
    are dead count nothing.  plain=True is the same path on the CPU."""
    _, tg = grids
    rays = _rays(CASES["outside_and_dead"]())
    hits, counts = tgrid.trace_packets_march(tg, rays, stats=True)
    assert counts.shape == (5, rays.count)
    assert torch.equal(counts[0], counts[1] + counts[2])
    _, anyc = tgrid.trace_packets_march(tg, rays, mode="any", stats=True)
    assert bool((anyc <= counts).all())
    dead = rays.max_t <= rays.min_t
    assert dead.any() and not counts[:, dead].any()
    assert bool((counts[1][hits.hit] >= 1).all())
    plain, pcounts = tgrid.trace_packets_march(tg, rays, stats=True,
                                               plain=True)
    assert torch.equal(pcounts, counts) and torch.equal(plain.t, hits.t)


def test_tracer_march_engine():
    """Tracer(engine="march") builds the grid once from the scene and its
    packed tables, meets the flat engine's parity bar, routes filter_mask
    to the grid and a filter callable to the stack engine."""
    tris = scenes.blob(3)[0]
    mask = _odd_even(tris.shape[0])
    scene = rt.build_from_soup(tris, config=rt.BuildConfig(leaf_size=LEAF),
                               device=CPU)
    march = rt.Tracer(scene, engine="march", tri_mask=mask)
    flat = rt.Tracer(scene, tri_mask=mask)
    rays = _rays(_rand_rays(256, 23))
    _assert_parity(march.closest(rays), flat.closest(rays))
    grid = march._grid
    assert grid is not None and grid.cells_march is not None
    _assert_parity(march.closest(rays, filter_mask=1),
                   flat.closest(rays, filter_mask=1))
    assert march._grid is grid
    assert torch.equal(march.any(rays).hit, flat.any(rays).hit)
    by_stack = march.closest(rays, filter_fn=lambda c: c.t > 0.5)
    assert isinstance(by_stack, rt.Hits)
    with pytest.raises(ValueError, match="filter_mask"):
        march.closest(rays, filter_fn=lambda c: c.t > 0.5, filter_mask=1)


def test_march_occupancy_words(grids):
    """GridScene.march_occ has bit c set exactly where rank[c] >= 0 (the
    occupied cells, whose root rows have a child); march_batch hands it to
    the kernel, whose wrapper refuses words of the wrong size or none."""
    from rtk_tpu_torch.ops import packet_trace as pt

    _, tg = grids
    cells = int(np.prod(tg.dims))
    words = tg.march_occ
    assert words.dtype == torch.int32 and words.shape == (-(-cells // 32),)
    bits = (words.long()[:, None] >> torch.arange(32)) & 1
    occupied = bits.reshape(-1)[:cells].bool()
    assert torch.equal(occupied, tg.rank >= 0)
    assert not bits.reshape(-1)[cells:].any()
    roots = tg.cells_march.nodes.view(-1, 8, 8)[:cells, 1, 6]
    assert torch.equal(occupied, roots != 0)
    mg, _, _ = tgrid.march_batch(tg, _rays(_rand_rays(64, 5)))
    assert mg.occ is words
    for occ in (torch.zeros(words.shape[0] + 1, dtype=torch.int32), None):
        bad = pt.MarchGrid.of(mg.dims, tg.grid_lo, tg.cell_size, occ=occ)
        with pytest.raises(ValueError, match="occupancy"):
            pt._check_grid(bad, tg.cells_march.nodes)


def test_march_batch_grouping():
    """march_batch's rows: a permutation of the caller's rays, grouped by
    (entry cell, octant) as rtk_tpu's grouping sort groups them, within a
    group by the direction inside the octant (DIR_BITS bits a component,
    stable), rays that miss the grid last; the order changes no output."""
    tris = scenes.blob(3)[0]
    g = tgrid.build_grid(tris, config=rt.BuildConfig(leaf_size=LEAF),
                         dims=(4, 4, 4), march=True, device=CPU)
    rays = _rays(_rand_rays(3000, 31, scale=1.5))
    mg, rows, idx = tgrid.march_batch(g, rays)
    n = rays.count
    assert torch.equal(torch.sort(idx).values, torch.arange(n))
    comps = torch.cat([rays.origin.T, rays.direction.T, rays.min_t[None],
                       rays.max_t[None]])
    assert torch.equal(rows, comps[:, idx])
    live, cell, *_ = tgrid.march_entry(comps, mg)
    d = rays.direction
    octant = ((d[:, 0] >= 0).long() * 4 + (d[:, 1] >= 0).long() * 2
              + (d[:, 2] >= 0).long())
    group = ((cell[0] * 4 + cell[1]) * 4 + cell[2]) * 8 + octant
    a = d.abs() / d.abs().sum(dim=1, keepdim=True)
    q = (a[:, :2] * (1 << tgrid.DIR_BITS)).long().clamp(
        0, (1 << tgrid.DIR_BITS) - 1)
    key = [tuple(x) for x in torch.stack(
        [~live, group.where(live, 0), q[:, 0].where(live, 0),
         q[:, 1].where(live, 0), torch.arange(n)], dim=1)[idx].tolist()]
    assert key == sorted(key)
    assert bool(live[idx][:int(live.sum())].all())
    hits = tgrid.trace_packets_march(g, rays)
    ref = trace_packets(g.flat, rays)
    _assert_parity(hits, ref)
