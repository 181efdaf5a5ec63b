"""Dynamic scenes: refit, repack_bounds, refittable SAH tables,
Tracer.refresh and the refit-and-trace front-ends against rtk_tpu on the
same seeded inputs.

Refit and repack are gathers, minima and maxima only, so their outputs
are held to rtk_tpu's bit for bit (tolerance 0).  Traces of refit tables
are held to rtk_tpu's packet kernel (interpret mode on the CPU) at the
bars of tests/test_torch_trace.py: hit masks equal, t within 1e-5, u and
v within 1e-3.  The rest are this package's counterparts of rtk_tpu's own
refit tests (tests/test_packet.py, test_sah_pack.py, test_trace.py)."""
import dataclasses

import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.builder import lbvh as jlbvh
from rtk_tpu.ops.pallas_trace import trace_packets as jax_trace_packets
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace import packed as jpacked
from rtk_tpu_torch.builder import lbvh
from rtk_tpu_torch.ops import packet_trace
from rtk_tpu_torch.ops.packet_trace import (trace_packets,
                                            trace_packets_chunked,
                                            trace_packets_refit,
                                            trace_packets_refit_frames)
from rtk_tpu_torch.testing import carry, scenes
from rtk_tpu_torch.trace import packed as tpacked
from rtk_tpu_torch.trace import stack
from rtk_tpu_torch.utils.native_sah import NativeOracle

torch.set_num_threads(2)
CPU = "cpu"  # the builders default to the card; these tests run on the CPU
EYE = ((0, 3, 4), (0, 0, 0), (0, 1, 0), 50)  # BASELINE config 4's camera


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


def assert_bit_equal(got, want, names):
    """Bit patterns: NaN padding rows equal NaN, -0 differs from 0."""
    for f in names:
        g, w = _bits(getattr(got, f)), _bits(getattr(want, f))
        assert g.shape == w.shape, (f, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f)


def _soup_of(tris):
    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def _case(name):
    """(built soup, moved soup, leaf_size): the grid of config 4 at n=16;
    a shuffled soup (sorted order != soup order) with padding rows; a
    one-leaf scene; a soup one triangle past a whole leaf."""
    if name == "grid":
        return (scenes.deforming_grid(0.0, n=16),
                scenes.deforming_grid(0.9, n=16), 8)
    rng = np.random.default_rng({"shuffled": 7, "one_leaf": 8, "pad": 9}[name])
    t = {"shuffled": 300, "one_leaf": 3, "pad": 301}[name]
    base = rng.normal(size=(t, 1, 3)) * 2.0 + rng.normal(size=(t, 3, 3)) * 0.3
    base = base.astype(np.float32)[rng.permutation(t)]
    moved = (base + rng.normal(size=base.shape) * 0.2).astype(np.float32)
    return base, moved, {"shuffled": 8, "one_leaf": 4, "pad": 4}[name]


CASES = ["grid", "shuffled", "one_leaf", "pad"]


def _cam(n=16, device=CPU):
    return scenes.camera_rays(*EYE, n, n, device=device)


def _jax_cam(n=16):
    return jax_scenes.camera_rays(*EYE, n, n)


def _rays(jrays):
    return rt.Rays.make(*(np.asarray(getattr(jrays, f)) for f in
                          ("origin", "direction", "min_t", "max_t")),
                        device=CPU)


def _check(got, want):
    wh = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), wh)
    np.testing.assert_allclose(got.t.numpy()[wh], np.asarray(want.t)[wh],
                               atol=1e-5)
    same = wh & (got.triangle_index.numpy()
                 == np.asarray(want.triangle_index))
    assert same.sum() / max(wh.sum(), 1) > 0.9
    for a, b in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   atol=1e-3)


def _same(a, b, fields=("hit", "t", "slot", "u", "v")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _parity(got, ref):
    """tests/test_sah_pack.py::_parity: another topology, the same hits."""
    assert torch.equal(got.hit, ref.hit)
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-6,
                               atol=1e-6)
    diff = got.triangle_index != ref.triangle_index
    if diff.any():  # exact-t ties may resolve differently
        assert float((got.t[diff] - ref.t[diff]).abs().max()) == 0.0


def test_deforming_grid_bit_equal():
    for t, n in ((0.0, 16), (0.35, 16), (1.7, 5)):
        got, want = scenes.deforming_grid(t, n=n), jax_scenes.deforming_grid(
            t, n=n)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_refit_and_repack_bit_equal(name, wide):
    """refit fields and repack_bounds tables against rtk_tpu's (tolerance
    0), a tri_mask riding the repack, and the identity: refit to the built
    soup and repack give back the built tables."""
    base, moved, leaf = _case(name)
    jscene = rtk_tpu.build_from_soup(base, config=rtk_tpu.BuildConfig(
        leaf_size=leaf, wide_nodes=wide))
    scene = rt.build_from_soup(base, config=rt.BuildConfig(
        leaf_size=leaf, wide_nodes=wide), device=CPU)
    mask = (np.arange(base.shape[0]) % 3 + 1).astype(np.uint32)
    jpk = jpacked.pack_scene(jscene, tri_mask=mask)
    pk = tpacked.pack_scene(scene, tri_mask=mask)

    jscene2, scene2 = rtk_tpu.refit(jscene, moved), rt.refit(scene, moved)
    assert_bit_equal(scene2, jscene2, carry.SCENE_ARRAYS)
    assert (scene2.has_wide, scene2.num_leaves) == (jscene2.has_wide,
                                                    jscene2.num_leaves)
    pk2 = tpacked.repack_bounds(pk, scene2)
    assert_bit_equal(pk2, jpacked.repack_bounds(jpk, jscene2),
                     carry.PACKED_ARRAYS)
    assert (pk2.depth, pk2.stack_size, pk2.branching) == (
        pk.depth, pk.stack_size, pk.branching)
    assert torch.equal(pk2.tris[:, tpacked.MASK_COL],
                       pk.tris[:, tpacked.MASK_COL])
    # A tensor is taken as well as an array.
    assert_bit_equal(rt.refit(scene, torch.from_numpy(moved)), scene2,
                     carry.SCENE_ARRAYS)
    # Identity.
    same = rt.refit(scene, base)
    assert_bit_equal(same, scene, carry.SCENE_ARRAYS)
    assert_bit_equal(tpacked.repack_bounds(pk, same), pk,
                     carry.PACKED_ARRAYS)
    with pytest.raises(ValueError, match="triangles for a topology"):
        rt.refit(scene, moved[:-1])


def _binary(base, leaf, step_quant, w):
    """The same host-SAH tree packed by both packages, with refit aux."""
    tree = NativeOracle(base.reshape(-1, 9), leaf_max=leaf,
                        step_quant=step_quant).export_tree()
    mask = (np.arange(base.shape[0]) % 3 + 1).astype(np.uint32)
    jp, jaux = jpacked.pack_binary_tree(base, *tree, leaf_size=leaf,
                                        tri_mask=mask, return_refit_aux=True,
                                        branching=w)
    tp, aux = tpacked.pack_binary_tree(base, *tree, leaf_size=leaf,
                                       tri_mask=mask, return_refit_aux=True,
                                       branching=w, device=CPU)
    return jp, jaux, tp, aux


@pytest.mark.parametrize("name,leaf,step_quant,w", [
    ("grid", 8, True, 8), ("shuffled", 8, False, 8), ("shuffled", 4, True, 16),
    ("pad", 16, True, 16), ("one_leaf", 4, False, 8)])
def test_refit_packed_binary_bit_equal(name, leaf, step_quant, w):
    """BinaryRefitAux arrays and refit_packed_binary tables against
    rtk_tpu's (tolerance 0) at both widths, the identity refit, and the
    carry: a table and aux that rtk_tpu packed refit here to the same
    bits."""
    base, moved, _ = _case(name)
    jp, jaux, tp, aux = _binary(base, leaf, step_quant, w)
    assert_bit_equal(aux, jaux, carry.REFIT_AUX_ARRAYS)
    assert all(getattr(aux, f).dtype == torch.int32
               for f in carry.REFIT_AUX_ARRAYS)
    want = jpacked.refit_packed_binary(jp, jaux, moved)
    got = tpacked.refit_packed_binary(tp, aux, moved)
    assert_bit_equal(got, want, carry.PACKED_ARRAYS)
    assert (got.depth, got.branching) == (tp.depth, w)
    assert_bit_equal(tpacked.refit_packed_binary(tp, aux, base), tp,
                     carry.PACKED_ARRAYS)
    carried = carry.packed_from_arrays(
        {k: np.asarray(getattr(jp, k)) for k in carry.PACKED_ARRAYS},
        num_tris=jp.num_tris, leaf_size=jp.leaf_size, branching=w,
        device=CPU)
    caux = carry.refit_aux_from_arrays(
        {k: np.asarray(getattr(jaux, k)) for k in carry.REFIT_AUX_ARRAYS},
        device=CPU)
    assert_bit_equal(tpacked.refit_packed_binary(carried, caux, moved), want,
                     carry.PACKED_ARRAYS)


def test_build_sah_packed_refittable():
    base, _, _ = _case("grid")
    cfg = dict(leaf_size=16)
    want, jaux = rtk_tpu.build_sah_packed(
        _soup_of(base), rtk_tpu.BuildConfig(**cfg), step_quant=True,
        refittable=True)
    got, aux = rt.build_sah_packed(_soup_of(base), rt.BuildConfig(**cfg),
                                   step_quant=True, refittable=True,
                                   device=CPU)
    assert isinstance(aux, tpacked.BinaryRefitAux) and aux.device.type == CPU
    assert_bit_equal(got, want, carry.PACKED_ARRAYS)
    assert_bit_equal(aux, jaux, carry.REFIT_AUX_ARRAYS)
    plain = rt.build_sah_packed(_soup_of(base), rt.BuildConfig(**cfg),
                                step_quant=True, device=CPU)
    assert_bit_equal(plain, got, carry.PACKED_ARRAYS)


@pytest.mark.parametrize("kind", ["lbvh", "sah", "sah16"])
def test_refit_trace_against_rtk_tpu_kernel(kind):
    """The slice as a whole: build, refit, repack and trace in both
    packages; rtk_tpu's packet kernel in interpret mode is the bar."""
    base, moved, leaf = _case("shuffled")
    jrays = _jax_cam()
    jrays = rtk_tpu.Rays.make(np.asarray(jrays.origin) * 1.5,
                              np.asarray(jrays.direction))
    if kind == "lbvh":
        jscene = rtk_tpu.build_from_soup(
            base, config=rtk_tpu.BuildConfig(leaf_size=leaf))
        jp = jpacked.repack_bounds(jpacked.pack_scene(jscene),
                                   rtk_tpu.refit(jscene, moved))
        scene = rt.build_from_soup(base, config=rt.BuildConfig(
            leaf_size=leaf), device=CPU)
        got, _, _ = trace_packets_refit(tpacked.pack_scene(scene), scene,
                                        moved, _rays(jrays))
    else:
        w = 16 if kind == "sah16" else 8
        jp0, jaux, tp, aux = _binary(base, leaf, True, w)
        jp = jpacked.refit_packed_binary(jp0, jaux, moved)
        got, same_aux, _ = trace_packets_refit(tp, aux, moved, _rays(jrays))
        assert same_aux is aux
    want = jax_trace_packets(jp, jrays, interpret=True, sort_rays=False)
    assert np.asarray(want.hit).sum() > 20
    _check(got, want)
    np.testing.assert_allclose(
        got.vertex_position.numpy(), np.asarray(want.vertex_position))


def test_packet_refit_repack():
    """tests/test_packet.py::test_packet_refit_repack: the repacked tables
    against the stack engine on the refit scene."""
    t0, t1, _ = _case("grid")
    scene = rt.build_scene(_soup_of(t0), device=CPU)
    scene2 = rt.refit(scene, t1)
    got = trace_packets(tpacked.repack_bounds(tpacked.pack_scene(scene),
                                              scene2), _cam())
    want = stack.trace_closest(scene2, _cam())
    assert torch.equal(got.hit, want.hit) and got.hit.any()
    np.testing.assert_allclose(got.t.numpy()[want.hit.numpy()],
                               want.t.numpy()[want.hit.numpy()], atol=1e-5)


def test_refit_matches_rebuild_results():
    """tests/test_trace.py::test_refit_matches_rebuild_results: the stack
    engine on a refit scene (wide bounds regathered) against the oracle."""
    t0, t1 = scenes.deforming_grid(0.0, n=24), scenes.deforming_grid(0.7,
                                                                     n=24)
    rays = _cam(32)
    got = stack.trace_closest(rt.refit(rt.build_scene(_soup_of(t0),
                                                      device=CPU), t1), rays)
    ot = NativeOracle(t1.reshape(-1, 9)).trace(
        *(getattr(rays, f).numpy()
          for f in ("origin", "direction", "min_t", "max_t")))
    want_hit = ot[3] >= 0
    np.testing.assert_array_equal(got.hit.numpy(), want_hit)
    np.testing.assert_allclose(got.t.numpy()[want_hit], ot[0][want_hit],
                               atol=1e-4)


def _tables(kind, n=24, leaf=8):
    g0 = scenes.deforming_grid(0.0, n=n)
    if kind == "lbvh":
        scene = rt.build_scene(_soup_of(g0), rt.BuildConfig(leaf_size=leaf),
                               device=CPU)
        return tpacked.pack_scene(scene), scene
    return rt.build_sah_packed(_soup_of(g0), rt.BuildConfig(leaf_size=leaf),
                               step_quant=True, refittable=True, device=CPU)


def _separate(packed, scene, frame, rays, **kw):
    if isinstance(scene, tpacked.BinaryRefitAux):
        return trace_packets(tpacked.refit_packed_binary(packed, scene,
                                                         frame), rays, **kw)
    return trace_packets(tpacked.repack_bounds(packed,
                                               rt.refit(scene, frame)),
                         rays, **kw)


@pytest.mark.parametrize("kind", ["lbvh", "sah"])
def test_packet_refit_fused_matches_separate(kind):
    """test_packet_refit_fused_matches_separate and the first half of
    test_sah_refit_fused_and_frames_paths: the front-end equals refit ->
    repack -> trace_packets bit for bit, whatever the flags."""
    packed, scene = _tables(kind)
    rays = _cam(24)
    for t, kw in ((0.1, {}), (0.25, dict(defer_uv=True, sort_rays=True)),
                  (0.4, dict(mode="any", watertight=False))):
        frame = scenes.deforming_grid(t, n=24)
        got, scene2, packed2 = trace_packets_refit(packed, scene, frame,
                                                   rays, **kw)
        _same(got, _separate(packed, scene, frame, rays, **kw))
        assert got.uv_deferred == bool(kw.get("defer_uv"))
        _same(trace_packets(packed2, rays, **kw), got)
        if kind == "lbvh":
            assert_bit_equal(scene2, rt.refit(scene, frame),
                             carry.SCENE_ARRAYS)
    # The reference's positional order: mode, watertight, interpret, ...
    got, _, _ = trace_packets_refit(packed, scene, frame, rays, "any", False,
                                    None, 8)
    _same(got, _separate(packed, scene, frame, rays, mode="any",
                         watertight=False))


@pytest.mark.parametrize("sort_rays", [False, True])
@pytest.mark.parametrize("kind", ["lbvh", "sah"])
def test_packet_refit_frames_matches_per_frame(kind, sort_rays):
    """test_packet_refit_frames_scan_matches_per_frame and the second half
    of test_sah_refit_fused_and_frames_paths: the hoisted sort and the
    frame loop against per-frame calls, bit for bit; each frame's lazy
    fields read its own vertices."""
    packed, scene = _tables(kind)
    rays = _cam(24)
    ts = (0.1, 0.25, 0.4)
    frames = np.stack([scenes.deforming_grid(t, n=24) for t in ts])
    before = packet_trace.KERNEL_LAUNCHES
    got = trace_packets_refit_frames(packed, scene, frames, rays,
                                     sort_rays=sort_rays, defer_uv=True)
    assert len(got) == len(ts) and packet_trace.KERNEL_LAUNCHES == before
    for f, t in enumerate(ts):
        ref, _, _ = trace_packets_refit(packed, scene, frames[f], rays,
                                        sort_rays=sort_rays, defer_uv=True)
        assert got[f].uv_deferred and got[f].hit.any()
        _same(got[f], ref)
        full, _, _ = trace_packets_refit(packed, scene, frames[f], rays,
                                         sort_rays=sort_rays)
        _same(got[f], full)  # lazy u, v equal the carried ones
        assert torch.equal(got[f].tri_v, ref.tri_v)
        h = got[f].hit
        np.testing.assert_allclose(
            got[f].position().numpy()[h], full.position().numpy()[h])
        tri = torch.from_numpy(frames[f])[got[f].triangle_index[h].long()]
        assert torch.equal(got[f].vertex_position[h], tri)
    # A tensor and a list of frames are taken as the array is.
    for alt in (torch.from_numpy(frames), list(frames)):
        again = trace_packets_refit_frames(packed, scene, alt, rays,
                                           sort_rays=sort_rays)
        _same(again[-1], got[-1])


@pytest.mark.parametrize("step_quant", [False, True])
def test_sah_refit_matches_lbvh_of_frame(step_quant):
    """tests/test_sah_pack.py::test_sah_refit_matches_lbvh_of_frame."""
    g0 = scenes.deforming_grid(0.0, n=24)
    frame = scenes.deforming_grid(0.3, n=24)
    rays = _cam(32)
    ref = trace_packets(tpacked.pack_scene(rt.build_from_soup(
        frame, config=rt.BuildConfig(leaf_size=8), device=CPU)), rays)
    sah, aux = rt.build_sah_packed(_soup_of(g0), rt.BuildConfig(leaf_size=8),
                                   step_quant=step_quant, refittable=True,
                                   device=CPU)
    got = trace_packets(tpacked.refit_packed_binary(sah, aux, frame), rays)
    _parity(got, ref)
    h = got.hit
    np.testing.assert_allclose(got.position().numpy()[h],
                               ref.position().numpy()[h], rtol=1e-6,
                               atol=1e-6)


def test_refit_w16_equals_w8():
    """One SAH tree packed 8 and 16 wide, both refit to one frame: the
    same hits (tests/test_torch_w16.py's width bar)."""
    base, moved, _ = _case("shuffled")
    rays = _cam(24)
    rays = dataclasses.replace(rays, origin=rays.origin * 1.5)
    out = []
    for w in (8, 16):
        _, _, tp, aux = _binary(base, 8, True, w)
        hits, _, p2 = trace_packets_refit(tp, aux, moved, rays)
        assert p2.branching == w and p2.nodes.shape[0] == p2.num_nodes * w
        out.append(hits)
    assert out[0].hit.sum() > 20
    _parity(out[1], out[0])
    fresh = trace_packets(tpacked.pack_scene(rt.build_from_soup(
        moved, config=rt.BuildConfig(leaf_size=8), device=CPU)), rays)
    _parity(out[0], fresh)


def test_packet_chunked_matches():
    """tests/test_packet.py::test_packet_chunked_matches: 700 rays over
    chunk=256 (two whole slices and a partial one, which is not padded)."""
    rng = np.random.default_rng(31)
    tris = rng.normal(size=(300, 3, 3)).astype(np.float32)
    packed = tpacked.pack_scene(rt.build_scene(
        _soup_of(tris), rt.BuildConfig(leaf_size=8), device=CPU))
    rays = rt.Rays.make(rng.normal(size=(700, 3)).astype(np.float32) * 3.0,
                        rng.normal(size=(700, 3)).astype(np.float32),
                        device=CPU)
    for kw in ({}, dict(mode="any"), dict(defer_uv=True, sort_rays=True)):
        a = trace_packets(packed, rays, **kw)
        b = trace_packets_chunked(packed, rays, chunk=256, **kw)
        assert b.count == rays.count and b.origin is rays.origin
        _same(a, b)
        for f in ("triangle_index", "mesh_index"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    # n <= chunk is the plain call; per-batch arrays are refused.
    _same(trace_packets_chunked(packed, rays, chunk=700), a)
    with pytest.raises(ValueError, match="stats"):
        trace_packets_chunked(packed, rays, chunk=256, stats=True)


@pytest.mark.parametrize("engine,wide", [
    pytest.param("packet", True, id="packet"),
    pytest.param("march", True, id="march"),
    pytest.param("stack", True, id="stack"),
    # BASELINE config 4's build: no wide arrays, the packed tables only.
    pytest.param("packet", False, id="packet-no_wide_nodes")])
def test_tracer_refresh(engine, wide):
    """Tracer.refresh keeps config, mask and engine, repacks built tables
    and never rebuilds them, drops the march grid; filter_mask results
    equal a fresh masked Tracer of the frame."""
    t0, t1 = scenes.deforming_grid(0.0, n=16), scenes.deforming_grid(0.6,
                                                                     n=16)
    mask = (np.arange(t0.shape[0]) % 2 + 1).astype(np.uint32)
    cfg = rt.BuildConfig(leaf_size=8, wide_nodes=wide)
    tcfg = rt.TraceConfig(defer_uv=True)
    scene = rt.build_scene(_soup_of(t0), cfg, device=CPU)
    tracer = rt.Tracer(scene, engine=engine, config=tcfg, tri_mask=mask)
    rays = _cam(24)
    if engine == "stack":
        cold = tracer.refresh(rt.refit(scene, t1))
        assert cold._packed is None and cold.engine == "stack"
        want = rt.Tracer(rt.build_scene(_soup_of(t1), cfg, device=CPU),
                         engine="stack").closest(rays)
        got = cold.closest(rays)
        assert torch.equal(got.hit, want.hit)
        np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=1e-5)
        return
    tracer.closest(rays, filter_mask=1)  # builds the tables (and the grid)
    assert (tracer._grid is not None) == (engine == "march")
    moved = tracer.refresh(rt.refit(scene, t1))
    assert (moved.engine, moved.config, moved._grid) == (engine, tcfg, None)
    assert moved.tri_mask is mask and moved._packed is not None
    assert moved._packed.meta is tracer._packed.meta  # repacked, not rebuilt
    fresh = rt.Tracer(rt.build_scene(_soup_of(t1), cfg, device=CPU),
                      engine=engine, config=tcfg, tri_mask=mask)
    for m in (1, 2, None):
        got, want = (t.closest(rays, filter_mask=m) for t in (moved, fresh))
        assert want.hit.any()
        _parity(got, want)
        assert torch.equal(got.triangle_index, want.triangle_index) or m
    assert torch.equal(moved.any(rays).hit, fresh.any(rays).hit)
    if engine == "march":  # the march against the flat trace of the frame
        flat = trace_packets(moved.packed, rays)
        got = moved.closest(rays)
        assert torch.equal(got.hit, flat.hit)
        np.testing.assert_allclose(got.t.numpy(), flat.t.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("wide", [True, False])
def test_refit_refresh_closest_chain(wide):
    """The benchmark's frame loop: refit -> refresh -> closest chained over
    frames of config 4's grid (each refit from the last frame's scene),
    equal each frame to a fresh build of that frame."""
    cfg = rt.BuildConfig(leaf_size=8, wide_nodes=wide)
    scene = rt.build_scene(_soup_of(scenes.deforming_grid(0.0, n=16)), cfg,
                           device=CPU)
    tracer = rt.Tracer(scene)
    tracer.packed
    rays = _cam(32)
    for t in (0.05, 0.1, 0.15, 0.9):
        frame = scenes.deforming_grid(t, n=16)
        scene = rt.refit(scene, frame)
        tracer = tracer.refresh(scene)
        got = tracer.closest(rays)
        want = rt.Tracer(rt.build_scene(_soup_of(frame), cfg,
                                        device=CPU)).closest(rays)
        assert want.hit.any()
        _parity(got, want)
        same = got.triangle_index == want.triangle_index
        for f in ("t", "u", "v", "mesh_index"):
            assert torch.equal(getattr(got, f)[same], getattr(want, f)[same])


def test_refit_counters():
    """REFITS and REPACKS count calls; REFIT_LEVELS is the range table's
    levels of the last refit, ceil(log2 leaves) + 1."""
    from rtk_tpu_torch import scene as tscene

    t0, t1 = scenes.deforming_grid(0.0, n=16), scenes.deforming_grid(0.3,
                                                                     n=16)
    scene = rt.build_scene(_soup_of(t0), rt.BuildConfig(
        leaf_size=8, wide_nodes=False), device=CPU)
    tracer = rt.Tracer(scene)
    tracer.packed
    lbvh.REFIT_LEVELS = 0
    before = tscene.REFITS, tpacked.REPACKS
    tracer.refresh(rt.refit(scene, t1))
    assert (tscene.REFITS - before[0], tpacked.REPACKS - before[1]) == (1, 1)
    assert scene.num_leaves == 64 and lbvh.REFIT_LEVELS == 7
    # The host-SAH tables refit and regather in one call: a refit.
    packed, aux = _tables("sah", n=16)
    before = tscene.REFITS, tpacked.REPACKS
    tpacked.refit_packed_binary(packed, aux, t1)
    assert (tscene.REFITS - before[0], tpacked.REPACKS - before[1]) == (1, 0)


def _leaf(first, count):
    return dict(left=-1, right=-1, first=first, count=count)


@pytest.mark.parametrize("nodes,match", [
    # Children that leave a gap in their parent's triangle range.
    ([dict(left=1, right=4, first=0, count=0),
      dict(left=2, right=3, first=0, count=0), _leaf(0, 2), _leaf(4, 2),
      _leaf(2, 2)], "not an in-place partition"),
    # An empty leaf: its rank range is inverted.
    ([dict(left=1, right=2, first=0, count=0), _leaf(0, 2), _leaf(2, 0)],
     "leaf-rank ranges are inconsistent")])
def test_binary_refit_aux_rejects(nodes, match):
    cols = {k: np.array([n[k] for n in nodes], np.int64) for k in nodes[0]}
    is_leaf = cols["left"] < 0
    leaf_nodes = np.nonzero(is_leaf)[0]
    args = (cols["left"], cols["right"], cols["first"], cols["count"],
            is_leaf, leaf_nodes, np.array([0]), np.arange(leaf_nodes.size))
    with pytest.raises(ValueError, match=match):
        tpacked._binary_refit_aux(*args, device=CPU)
    with pytest.raises(ValueError, match=match):
        jpacked._binary_refit_aux(*args)


def test_lbvh_refit_leftovers():
    """refit_binary (the fixpoint form) gives the range-query bounds, and
    node_parents / node_depths equal rtk_tpu's."""
    base, moved, leaf = _case("shuffled")
    scene = rt.refit(rt.build_from_soup(base, config=rt.BuildConfig(
        leaf_size=leaf), device=CPU), moved)
    bmin, bmax = lbvh.refit_binary(scene.bin_left, scene.bin_right,
                                   scene.leaf_min, scene.leaf_max)
    assert torch.equal(bmin, scene.bin_min) and torch.equal(bmax,
                                                            scene.bin_max)
    left, right = scene.bin_left.numpy(), scene.bin_right.numpy()
    jmin, jmax = jlbvh.refit_binary(left, right, scene.leaf_min.numpy(),
                                    scene.leaf_max.numpy())
    np.testing.assert_array_equal(bmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(bmax.numpy(), np.asarray(jmax))
    parent = lbvh.node_parents(scene.bin_left, scene.bin_right)
    jparent = jlbvh.node_parents(left, right)
    np.testing.assert_array_equal(parent.numpy(), np.asarray(jparent))
    depth = lbvh.node_depths(parent)
    np.testing.assert_array_equal(depth.numpy(),
                                  np.asarray(jlbvh.node_depths(jparent)))
    assert int(depth[0]) == 0 and int(depth.max()) < left.shape[0]
