"""The traversal's plain PyTorch version against rtk_tpu's packet kernel
(interpret mode on the CPU) on the same carried tables, and the slice as a
whole: build_scene -> Tracer against rtk_tpu, build_sah_packed against
the native oracle."""
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch
from rtk_tpu.ops.pallas_trace import trace_packets as jax_trace_packets
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace.packed import pack_scene as jax_pack_scene
from rtk_tpu_torch.ops import packet_trace
from rtk_tpu_torch.ops.packet_trace import trace_packets, trace_packets_reference
from rtk_tpu_torch.testing import carry, scenes
from rtk_tpu_torch.trace.packed import pack_scene
from rtk_tpu_torch.utils.native_sah import NativeOracle

torch.set_num_threads(2)
CPU = "cpu"  # the builders default to the card; these tests run on the CPU


def _soup_of(tris):
    t = tris.shape[0]
    return (tris.reshape(-1, 3), np.arange(t * 3).reshape(-1, 3))


def _carry(jpacked):
    arrays = {k: np.asarray(getattr(jpacked, k)) for k in carry.PACKED_ARRAYS}
    return carry.packed_from_arrays(arrays, num_tris=jpacked.num_tris,
                                    leaf_size=jpacked.leaf_size, device=CPU)


def _rays(jrays):
    return rtk_tpu_torch.Rays.make(
        *(np.asarray(getattr(jrays, f))
          for f in ("origin", "direction", "min_t", "max_t")), device="cpu")


def _jax_rays(o, d, min_t=None, max_t=None):
    return rtk_tpu.Rays.make(np.asarray(o, np.float32),
                             np.asarray(d, np.float32),
                             None if min_t is None else np.float32(min_t),
                             None if max_t is None else
                             np.asarray(max_t, np.float32))


def _check(got, want, atol=1e-5, same_frac=0.9):
    """The bar of tests/test_packet.py::_check: hit equal, t within atol,
    more than same_frac of hits on the same triangle, u/v within 1e-3."""
    wh = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), wh)
    np.testing.assert_allclose(got.t.numpy()[wh], np.asarray(want.t)[wh],
                               atol=atol)
    same = wh & (got.triangle_index.numpy()
                 == np.asarray(want.triangle_index))
    assert same.sum() / max(wh.sum(), 1) > same_frac
    for a, b in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   atol=1e-3)


def _against_jax(tris, jrays, leaf=4, tri_mask=None, **kw):
    jscene = rtk_tpu.build_scene(_soup_of(tris),
                                 rtk_tpu.BuildConfig(leaf_size=leaf))
    jp = jax_pack_scene(jscene, tri_mask=tri_mask)
    want = jax_trace_packets(jp, jrays, interpret=True, **kw)
    got = trace_packets_reference(_carry(jp), _rays(jrays), **kw)
    return got, want


@pytest.mark.parametrize("leaf", [1, 4, 8])
def test_closest_cornell_leaf_sizes(leaf):
    got, want = _against_jax(scenes.cornell_box(),
                             jax_scenes.cornell_camera(16, 16),
                             leaf=leaf)
    _check(got, want)
    assert got.hit.all()


def test_closest_random_soup():
    rng = np.random.default_rng(5)
    tris = rng.normal(size=(300, 3, 3)).astype(np.float32)
    jrays = _jax_rays(rng.normal(size=(256, 3)) * 3.0,
                      rng.normal(size=(256, 3)))
    got, want = _against_jax(tris, jrays)
    _check(got, want)


def test_anyhit():
    tris = scenes.cornell_box()
    jrays = jax_scenes.cornell_camera(16, 16)
    got, want = _against_jax(tris, jrays, mode="any")
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    closest, _ = _against_jax(tris, jrays)
    h = got.hit.numpy()
    ct = closest.t.numpy()[h]
    assert (got.t.numpy()[h] >= ct - 1e-5 * (1.0 + np.abs(ct))).all()


def test_t_window():
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    packed = pack_scene(rtk_tpu_torch.build_scene(_soup_of(tri), device=CPU))
    o, d = [0.2, 0.2, 1.0], [0.0, 0.0, -1.0]
    for kw in (dict(min_t=1.5), dict(max_t=0.5)):
        rays = rtk_tpu_torch.Rays.make(o, d, **kw, device="cpu")
        assert not bool(trace_packets(packed, rays).hit[0])
    h = trace_packets(packed, rtk_tpu_torch.Rays.make(o, d, device="cpu"))
    assert bool(h.hit[0]) and abs(float(h.t[0]) - 1.0) < 1e-6


def test_anyhit_mixed_dead_lanes():
    """Dead rays (max_t <= min_t) interleaved with live ones: dead rays
    never hit and keep t = max_t; live rays agree with the reference."""
    rng = np.random.default_rng(29)
    tris = rng.normal(size=(300, 3, 3)).astype(np.float32)
    n = 256
    o = rng.normal(size=(n, 3)) * 3.0
    d = rng.normal(size=(n, 3))
    dead = rng.random(n) < 0.6
    max_t = np.where(dead, 0.0, 3.0e38)
    got, want = _against_jax(tris, _jax_rays(o, d, 0.0, max_t), leaf=8,
                             mode="any")
    gh = got.hit.numpy()
    assert not gh[dead].any()
    np.testing.assert_array_equal(gh, np.asarray(want.hit))
    assert (got.t.numpy()[dead] == 0.0).all()
    assert (got.slot.numpy()[dead] == -1).all()


def test_filter_mask():
    tris = scenes.blob(3)[0]
    t = tris.shape[0]
    tri_mask = np.where(np.arange(t) % 2 == 1, 1, 2).astype(np.uint32)
    jrays = jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0),
                                   45, 16, 16)
    got, want = _against_jax(tris, jrays, tri_mask=tri_mask, filter_mask=1)
    _check(got, want)
    ti = got.triangle_index.numpy()[got.hit.numpy()]
    assert ti.size and (ti % 2 == 1).all()
    got_any, _ = _against_jax(tris, jrays, tri_mask=tri_mask,
                              filter_mask=1, mode="any")
    ti = got_any.triangle_index.numpy()[got_any.hit.numpy()]
    assert (ti % 2 == 1).all()


def test_defer_uv():
    """defer_uv: t and slot bit-equal to the carried run; u/v recomputed by
    PacketHits with the same arithmetic, so bit-equal too; and the
    reference bar against rtk_tpu's defer_uv trace."""
    tris = scenes.blob(3)[0]
    jrays = jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0),
                                   45, 24, 24)
    got, want = _against_jax(tris, jrays, defer_uv=True)
    assert got.uv_deferred and not got.u_k.any()
    _check(got, want)
    full, _ = _against_jax(tris, jrays)
    for f in ("hit", "t", "slot", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(full, f)), f
    sub = got[:100]
    assert sub.uv_deferred and sub.count == 100
    assert torch.equal(got.full().u, full.u)


def test_watertight_closed_mesh():
    """Rays from inside a closed icosphere at every edge midpoint, random
    edge points and vertices all hit, closest and any."""
    verts, faces = scenes.icosphere(2)
    tris = verts[faces].astype(np.float32)
    packed = pack_scene(rtk_tpu_torch.build_scene(_soup_of(tris), device=CPU))
    rng = np.random.default_rng(7)
    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    lam = rng.uniform(0.0, 1.0, size=(edges.shape[0], 1)).astype(np.float32)
    edge_pts = verts[edges[:, 0]] * (1 - lam) + verts[edges[:, 1]] * lam
    mids = (verts[edges[:, 0]] + verts[edges[:, 1]]) * 0.5
    targets = np.concatenate([mids, edge_pts, verts], axis=0)
    rays = rtk_tpu_torch.Rays.make(np.zeros_like(targets), targets,
                                   device="cpu")
    for mode in ("closest", "any"):
        leaks = int((~trace_packets(packed, rays, mode=mode).hit).sum())
        assert leaks == 0, f"{mode}: {leaks}/{rays.count} rays leaked"


def test_sorted_and_unsorted_batches_agree():
    """The coherence sort only reorders work: results come back in the
    caller's order, bit-equal to the unsorted trace."""
    rng = np.random.default_rng(11)
    tris = rng.normal(size=(300, 3, 3)).astype(np.float32)
    packed = pack_scene(rtk_tpu_torch.build_scene(_soup_of(tris), device=CPU))
    rays = rtk_tpu_torch.Rays.make(rng.normal(size=(512, 3)) * 3.0,
                                   rng.normal(size=(512, 3)), device="cpu")
    a = trace_packets(packed, rays, sort_rays=False)
    b = trace_packets(packed, rays, sort_rays=True)
    for f in ("hit", "t", "u", "v", "slot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_cpu_tensors_take_the_plain_version():
    tris = scenes.cornell_box()
    packed = pack_scene(rtk_tpu_torch.build_scene(_soup_of(tris), device=CPU))
    rays = scenes.cornell_camera(8, 8, device="cpu")
    before = packet_trace.KERNEL_LAUNCHES
    a = trace_packets(packed, rays)
    b = trace_packets_reference(packed, rays)
    assert packet_trace.KERNEL_LAUNCHES == before
    for f in ("hit", "t", "u", "v", "slot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_slice_build_scene_tracer():
    """The slice end to end: the port's build_scene -> Tracer against
    rtk_tpu's build_scene -> trace_closest / trace_any."""
    v, f = scenes.blob(3)[1:]
    jrays = jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0),
                                   45, 24, 24, order="morton")
    jscene = rtk_tpu.build_scene((v, f))
    tracer = rtk_tpu_torch.Tracer(
        rtk_tpu_torch.build_scene((v, f), device=CPU))
    got = tracer.closest(_rays(jrays))
    want = rtk_tpu.trace_closest(jscene, jrays)
    _check(got, want)
    full = got.full()
    np.testing.assert_array_equal(full.mesh_index.numpy(),
                                  np.asarray(want.mesh_index))
    same = got.hit.numpy() & (full.triangle_index.numpy()
                              == np.asarray(want.triangle_index))
    np.testing.assert_array_equal(full.vertex_index.numpy()[same],
                                  np.asarray(want.vertex_index)[same])
    occ = tracer.any(_rays(jrays))
    np.testing.assert_array_equal(occ.hit.numpy(),
                                  np.asarray(rtk_tpu.trace_any(jscene,
                                                               jrays).hit))


def test_sah_packed_against_native_oracle():
    """build_sah_packed(step_quant=True, leaf 16) traced by the port
    against the C++ oracle's own trace, at the bench gate's thresholds
    (bench.py:515-516)."""
    tris = scenes.blob(3)[0]
    packed = rtk_tpu_torch.build_sah_packed(
        _soup_of(tris), rtk_tpu_torch.BuildConfig(leaf_size=16),
        step_quant=True, device=CPU)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 32, 32,
                              order="morton", device="cpu")
    got = trace_packets(packed, rays)
    ot, ou, ov, oidx = NativeOracle(tris.reshape(-1, 9)).trace(
        *(getattr(rays, f).numpy()
          for f in ("origin", "direction", "min_t", "max_t")))
    gh, oh = got.hit.numpy(), oidx >= 0
    n = gh.size
    both = gh & oh
    assert both.sum() > 500
    t_bad = (np.abs(got.t.numpy()[both] - ot[both]) > 1e-4).sum()
    same = both & (got.triangle_index.numpy() == oidx)
    uv_bad = ((np.abs(got.u.numpy()[same] - ou[same]) > 1e-3)
              | (np.abs(got.v.numpy()[same] - ov[same]) > 1e-3)).sum()
    assert (gh != oh).sum() <= n * 1e-4
    assert t_bad <= both.sum() * 1e-4
    assert same.sum() / both.sum() > 0.95
    assert uv_bad <= same.sum() * 1e-4


@pytest.mark.parametrize("engine", ["stackless", "binned", "grid", "march"])
def test_unported_engines_raise(engine):
    """The four engines this test once found unported (it kept its name):
    each traces the closed box with every ray a hit, and meets
    tests/test_packet.py's bar against rtk_tpu's same engine on the same
    scene and rays (the engines' own tests hold each one further)."""
    scene = rtk_tpu_torch.build_scene(_soup_of(scenes.cornell_box()),
                                      device=CPU)
    jscene = rtk_tpu.build_scene(_soup_of(scenes.cornell_box()))
    jrays = jax_scenes.cornell_camera(8, 8)
    tracer = rtk_tpu_torch.Tracer(scene, engine=engine)
    hits = tracer.closest(_rays(jrays))
    assert tracer.engine == engine and bool(hits.hit.all())
    _check(hits, rtk_tpu.Tracer(jscene, engine=engine).closest(jrays))


def test_stack_engine_and_filter_callables():
    """Tracer(engine="stack") and a filter callable on the default engine,
    once the cases of the test above, against rtk_tpu's stack engine."""
    scene = rtk_tpu_torch.build_scene(_soup_of(scenes.cornell_box()),
                                      device=CPU)
    jscene = rtk_tpu.build_scene(_soup_of(scenes.cornell_box()))
    jrays = jax_scenes.cornell_camera(8, 8)
    fn = lambda c: c.t > 1.0  # noqa: E731
    stack = rtk_tpu_torch.Tracer(scene, engine="stack")
    _check(stack.closest(_rays(jrays)), rtk_tpu.trace_closest(jscene, jrays))
    _check(rtk_tpu_torch.Tracer(scene).closest(_rays(jrays), filter_fn=fn),
           rtk_tpu.trace_closest(jscene, jrays, filter_fn=fn))
