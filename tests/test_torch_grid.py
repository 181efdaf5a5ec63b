"""The macro-grid engines in the port against rtk_tpu: build_from_soup
with custom sort keys, the atrium soup, build_grid(march=True) bit for
bit, the bounce helpers on shared uniforms, the march's plain version
against rtk_tpu's fused march kernel (interpret mode) and against the
port's flat trace (tests/test_grid.py:286-351's cases),
Tracer(engine="march"), and the rounds engine (trace_packets_grid,
calibrate_caps, Tracer(engine="grid"), tests/test_grid.py:66-285's cases)
on rtk_tpu's grid carried into the port, against rtk_tpu's rounds and
the port's flat trace."""
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
from rtk_tpu_torch.testing import carry
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


# ---- the rounds engine (tests/test_grid.py:66-285) ----

@pytest.fixture(scope="module")
def rgrids():
    """tests/test_grid.py's _grid(): blob(3), leaf 8, the default dims.
    rtk_tpu's build, the port's own, and rtk_tpu's carried into the port
    (the rounds held against rtk_tpu's on the very same grid)."""
    tris = scenes.blob(3)[0]
    jg = jgrid.build_grid(tris, config=rtk_tpu.BuildConfig(leaf_size=LEAF))
    tg = tgrid.build_grid(tris, config=rt.BuildConfig(leaf_size=LEAF),
                          device=CPU)

    def packed(p):
        return carry.packed_from_arrays(
            {k: np.asarray(getattr(p, k)) for k in carry.PACKED_ARRAYS},
            num_tris=p.num_tris, leaf_size=p.leaf_size, device=CPU)

    cg = carry.grid_from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in carry.GRID_ARRAYS},
        cells=packed(jg.cells), flat=packed(jg.flat), dims=jg.dims,
        n_occ=jg.n_occ, device=CPU)
    return jg, tg, cg


def _assert_self_consistent(got):
    """tests/test_grid.py::_assert_records_self_consistent: the reported
    triangle is hit at the reported t, u, v."""
    from rtk_tpu_torch.ops.intersect import intersect_triangles, ray_shear

    hit = got.hit
    if not hit.any():
        return
    o, d = got.origin[hit], got.direction[hit]
    inf = torch.full((o.shape[0],), float("inf"))
    t, u, v, valid = intersect_triangles(o, ray_shear(d),
                                         got.vertex_position[hit][:, None],
                                         -inf, inf)
    np.testing.assert_allclose(t[:, 0].numpy(), got.t[hit].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u[:, 0].numpy(), got.u[hit].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v[:, 0].numpy(), got.v[hit].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert bool(valid.all())


# name -> (rays, trace_packets_grid keywords, held against rtk_tpu's
# rounds: records and debug counts).  Caps of at least the batch leave
# every row in every round (a thread per ray needs no packet padding), so
# "caps_tight" cuts rows where rtk_tpu's "caps_small" cuts its padding.
ROUNDS = {
    "random": (lambda: _rand_rays(512, 3, scale=0.5), {}, True),
    "any": (lambda: _rand_rays(256, 5, scale=0.4), {"mode": "any"}, True),
    "rounds_1": (lambda: _rand_rays(256, 7, scale=0.5),
                 {"rounds": 1, "skips": 1}, True),
    "caps_small": (lambda: _rand_rays(512, 9, scale=0.5),
                   {"rounds": 4, "caps": (1024,)}, False),
    "caps_tight": (lambda: _rand_rays(512, 9, scale=0.5),
                   {"rounds": 4, "caps": (10 ** 9, 160, 48)}, False),
    "caps_shrinking": (lambda: _rand_rays(512, 11, scale=0.5),
                       {"rounds": 6, "caps": (10 ** 9, 10 ** 9, 4096, 2048)},
                       True),
    "gather_sort": (lambda: _rand_rays(512, 17, scale=0.5),
                    {"sort_mode": "gather"}, False),
    "outside_and_dead": (CASES["outside_and_dead"], {}, True),
}


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_grid_rounds(rgrids, case):
    """trace_packets_grid on rtk_tpu's grid (carried) against the port's
    flat trace at test_grid.py's parity bar (hit records self-consistent),
    and, where marked, against rtk_tpu's rounds at test_packet.py's bar
    with equal per-round counts; on the port's own grid, the same records
    bit for bit."""
    jg, tg, cg = rgrids
    make, kw, vs_jax = ROUNDS[case]
    jrays = make()
    rays = _rays(jrays)
    mode = kw.get("mode", "closest")
    got, (cnts, live) = tgrid.trace_packets_grid(cg, rays,
                                                 debug_counts=True, **kw)
    flat = trace_packets(cg.flat, rays, mode=mode)
    if mode == "any":
        assert torch.equal(got.hit, flat.hit)
    else:
        _assert_parity(got, flat)
        _assert_self_consistent(got)
        assert bool((got.triangle_index[got.hit] >= 0).all())
    assert cnts.shape == (kw.get("rounds", 10), 3)
    assert cnts.dtype == torch.int32 and live.dtype == torch.int32
    if vs_jax:
        want, (jcnts, jlive) = jgrid.trace_packets_grid(
            jg, jrays, interpret=True, debug_counts=True, **kw)
        if mode == "any":
            np.testing.assert_array_equal(got.hit.numpy(),
                                          np.asarray(want.hit))
        else:
            _check(got, want,
                   same_frac=0.0 if case == "outside_and_dead" else 0.9)
        np.testing.assert_array_equal(cnts.numpy(), np.asarray(jcnts))
        assert int(live) == int(jlive)
    if case == "caps_tight":
        assert int(live) > 0 and int(cnts[1, 0]) <= 160
    if case == "gather_sort":
        ref = tgrid.trace_packets_grid(cg, rays)
        for f in ("hit", "t", "u", "v", "slot"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    if case == "random":
        own = tgrid.trace_packets_grid(tg, rays)
        for f in ("hit", "t", "u", "v", "slot"):
            assert torch.equal(getattr(own, f), getattr(got, f)), f


def test_grid_calibrated_caps(rgrids):
    """calibrate_caps gives rtk_tpu's tuple on the same grid and rays (the
    same counts, the same formula), and the engine runs it exactly."""
    jg, _, cg = rgrids
    jrays = _rand_rays(512, 13, scale=0.5)
    rays = _rays(jrays)
    caps = tgrid.calibrate_caps(cg, rays, rounds=4, skips=2)
    assert caps == jgrid.calibrate_caps(jg, jrays, rounds=4, skips=2,
                                        interpret=True)
    assert len(caps) == 4 and caps[0] == 2 ** 31 - 1
    got = tgrid.trace_packets_grid(cg, rays, rounds=4, skips=2, caps=caps)
    _assert_parity(got, trace_packets(cg.flat, rays))
    assert tgrid_shim.calibrate_caps is tgrid.calibrate_caps
    assert tgrid_shim.trace_packets_grid is tgrid.trace_packets_grid


def test_grid_explicit_dims_and_bounce_batch():
    """blob(4) on a (6, 5, 4) grid: a cosine bounce off the primaries'
    hits, against the flat trace."""
    tris = scenes.blob(4)[0]
    g = tgrid.build_grid(tris, config=rt.BuildConfig(leaf_size=LEAF),
                         dims=(6, 5, 4), device=CPU)
    cam = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 16, 16,
                             order="morton", device=CPU)
    prim = trace_packets(g.flat, cam)
    nrm = tpath.geometric_normal(prim, cam.direction)
    bounce = rt.Rays(origin=prim.position() + 1e-3 * nrm,
                     direction=tpath.cosine_sample(
                         torch.Generator().manual_seed(0), nrm),
                     min_t=torch.full((cam.count,), 1e-3),
                     max_t=torch.where(prim.hit, float(np.float32(3.4e38)),
                                       0.0))
    assert prim.hit.any()
    got = tgrid.trace_packets_grid(g, bounce)
    _assert_parity(got, trace_packets(g.flat, bounce))
    _assert_self_consistent(got)


def test_grid_multimesh_records():
    """Two meshes: mesh_index and triangle_index survive the grid's record
    unification (build_grid_from_scene with the scene's packed tables)."""
    ta = scenes.blob(2)[0]
    tb = scenes.blob(2)[0] + np.float32([1.5, 0, 0])
    meshes = [(t.reshape(-1, 3), np.arange(t.shape[0] * 3).reshape(-1, 3))
              for t in (ta, tb)]
    scene = rt.build_scene(meshes, rt.BuildConfig(leaf_size=LEAF),
                           device=CPU)
    packed = rt.Tracer(scene).packed
    g = tgrid.build_grid_from_scene(scene, packed=packed)
    rng = np.random.default_rng(31)
    rays = rt.Rays.make(rng.normal(size=(512, 3)) * 0.6 + [0.75, 0, 0],
                        rng.normal(size=(512, 3)), device=CPU)
    ref = trace_packets(packed, rays)
    got = tgrid.trace_packets_grid(g, rays)
    _assert_parity(got, ref)
    same = got.hit & (got.slot == ref.slot)
    assert torch.equal(got.mesh_index[same], ref.mesh_index[same])
    assert torch.equal(got.triangle_index[same], ref.triangle_index[same])
    assert set(got.mesh_index[same].tolist()) == {0, 1}


def test_tracer_grid_engine():
    """Tracer(engine="grid") builds its grid lazily without the march's
    forest, reuses a grid that has it, meets the flat engine's bar in both
    modes, and refresh drops the grid."""
    tris = scenes.blob(3)[0]
    scene = rt.build_from_soup(tris, config=rt.BuildConfig(leaf_size=LEAF),
                               device=CPU)
    tr = rt.Tracer(scene, engine="grid")
    rays = _rays(_rand_rays(256, 23, scale=0.5))
    _assert_parity(tr.closest(rays), trace_packets(tr.packed, rays))
    assert tr.grid.cells_march is None
    assert torch.equal(tr.any(rays).hit,
                       trace_packets(tr.packed, rays, mode="any").hit)
    assert tr.refresh(scene)._grid is None
    march = rt.Tracer(scene, engine="march")
    tr._grid = march.grid
    assert tr.grid is march.grid
    _assert_parity(tr.closest(rays), trace_packets(tr.packed, rays))


@pytest.mark.parametrize("engine", ["packet", "binned", "grid", "march"])
def test_filter_mask_culls_across_engines(engine):
    """tri_mask culling holds through every packet-kernel engine, their
    rounds and their residuals (tests/test_grid.py:232-270)."""
    tris = scenes.blob(3)[0]
    scene = rt.build_from_soup(tris, config=rt.BuildConfig(leaf_size=LEAF),
                               device=CPU)
    tr = rt.Tracer(scene, engine=engine, tri_mask=_odd_even(tris.shape[0]))
    rays = _rays(_rand_rays(256, 31, scale=0.5))
    got = tr.closest(rays, filter_mask=1)
    assert got.hit.any()
    assert bool((got.triangle_index[got.hit] % 2 == 1).all())
    _assert_parity(got, trace_packets(tr.packed, rays, filter_mask=1))
