"""The instanced (TLAS/BLAS) path of the port against rtk_tpu's on the same
scenes: the merge, the plain traversal with per-ray roots against the
Pallas kernel's packet roots (interpret mode), the candidate rounds, the
exactness residual, round caps, and the stack engine it runs on."""
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch
from rtk_tpu import instancing as jinst
from rtk_tpu.config import TraceConfig as JaxTraceConfig
from rtk_tpu.ops.pallas_trace import trace_packets as jax_trace_packets
from rtk_tpu.oracle import trace_brute
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace import packed as jpacked
from rtk_tpu.trace import stack as jstack
from rtk_tpu_torch import instancing as tinst
from rtk_tpu_torch.builder.sah import build_sah_forest
from rtk_tpu_torch.config import TraceConfig
from rtk_tpu_torch.ops.packet_trace import (packet_trace, trace_packets,
                                            trace_packets_reference)
from rtk_tpu_torch.testing import carry, scenes
from rtk_tpu_torch.trace import packed as tpacked
from rtk_tpu_torch.trace import stack as tstack

torch.set_num_threads(2)
CPU = "cpu"  # the builders default to the card; these tests run on the CPU

T_REL = 1e-5  # |t - t_ref| <= T_REL * (1 + |t_ref|) against rtk_tpu
BRUTE_TOL = 2e-4  # tests/test_instancing.py's bar against brute force


def _soup_of(tris):
    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def _transform(scale, rot_y, tx, ty, tz):
    c, s = np.cos(rot_y), np.sin(rot_y)
    lin = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) * scale
    return np.concatenate([lin, [[tx], [ty], [tz]]], axis=1).astype(np.float32)


class Case:
    """tests/test_instancing.py::_setup in both packages, plus the world-
    space soup of every instance for the brute-force oracle."""

    def __init__(self, n_inst, seed, rays):
        rng = np.random.default_rng(seed)
        self.srcs = [scenes.blob(2)[0],
                     scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5])]
        inst_blas = rng.integers(0, 2, n_inst).astype(np.int32)
        tf = np.stack([
            _transform(0.5 + rng.random(), rng.random() * 6.28,
                       *(rng.random(3) * 8 - 4)) for _ in range(n_inst)])
        self.jis = jinst.build_instanced(
            [rtk_tpu.build_scene(_soup_of(t)) for t in self.srcs],
            inst_blas, tf)
        self.tis = tinst.build_instanced(
            [rtk_tpu_torch.build_scene(_soup_of(t), device=CPU)
             for t in self.srcs],
            inst_blas, tf)
        self.tps = tinst.pack_instanced(self.tis)
        self.world = np.concatenate(
            [np.einsum("ab,tvb->tva", m[:, :3], self.srcs[b]) + m[:, 3]
             for b, m in zip(inst_blas, tf)])
        self.jrays = rays
        self.rays = rtk_tpu_torch.Rays.make(
            *(np.asarray(getattr(rays, f))
              for f in ("origin", "direction", "min_t", "max_t")),
            device="cpu")
        self._brute = None

    @property
    def brute(self):
        if self._brute is None:
            self._brute = trace_brute(self.world, self.jrays)
        return self._brute


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    return rtk_tpu.Rays.make((rng.normal(size=(n, 3)) * 6).astype(np.float32),
                             rng.normal(size=(n, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def case6():
    """6 instances, 300 random rays; one rtk_tpu run of each path."""
    case = Case(6, 2, _random_rays(300, 7))
    case.ref_packets = jinst.trace_closest_instanced_packets(
        jinst.pack_instanced(case.jis), case.jrays, interpret=True,
        return_live_counts=True)
    case.ref_stack = jinst.trace_closest_instanced(case.jis, case.jrays)
    return case


@pytest.fixture(scope="module")
def cam12():
    """12 overlapping instances seen by a 16x16 camera; the uncapped port
    trace at 12 candidates is the reference for the capped ones."""
    case = Case(12, 9, jax_scenes.camera_rays(
        (0, 2, 12), (0, 0, 0), (0, 1, 0), 45, 16, 16))
    case.full = tinst.trace_closest_instanced_packets(
        case.tps, case.rays, max_candidates=12)
    return case


def _assert_same_hits(got, want):
    for f in ("hit", "t", "u", "v", "slot"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _against_ref(hits, inst, ref_hits, ref_inst):
    """Hits equal, t within T_REL, instance equal except at exact-t ties."""
    wh = np.asarray(ref_hits.hit)
    np.testing.assert_array_equal(hits.hit.numpy(), wh)
    t, rt = hits.t.numpy()[wh], np.asarray(ref_hits.t)[wh]
    assert (np.abs(t - rt) <= T_REL * (1 + np.abs(rt))).all()
    differ = inst.numpy() != np.asarray(ref_inst)
    assert not (differ & ~wh).any()
    assert (t == rt)[differ[wh]].all()


def _against_brute(hits, inst, brute):
    wh = np.asarray(brute.hit)
    np.testing.assert_array_equal(hits.hit.numpy(), wh)
    np.testing.assert_allclose(hits.t.numpy()[wh], np.asarray(brute.t)[wh],
                               rtol=BRUTE_TOL, atol=BRUTE_TOL)
    np.testing.assert_array_equal(inst.numpy() >= 0, wh)


def test_merge_and_build_bit_equal(case6):
    """merge_blas and build_instanced give rtk_tpu's arrays bit for bit."""
    for f in carry.SCENE_ARRAYS:
        np.testing.assert_array_equal(
            getattr(case6.tis.merged, f).numpy(),
            np.asarray(getattr(case6.jis.merged, f)), err_msg=f)
    for f in ("roots", "instance_blas", "world_from_object",
              "object_from_world", "inst_lo", "inst_hi"):
        np.testing.assert_array_equal(getattr(case6.tis, f).numpy(),
                                      np.asarray(getattr(case6.jis, f)),
                                      err_msg=f)
    assert case6.tis.total_triangles == case6.jis.total_triangles
    with pytest.raises(ValueError, match="wide_nodes"):
        tinst.merge_blas([rtk_tpu_torch.build_scene(
            _soup_of(case6.srcs[0]),
            rtk_tpu_torch.BuildConfig(wide_nodes=False), device=CPU)])


def test_per_ray_roots_against_pallas_packet_roots(case6):
    """The plain traversal on the carried forest tables, each 128-ray
    packet starting at one BLAS root, against the Pallas kernel's
    packet_roots; ray_roots spells the same trace."""
    jp, jroots = jpacked.pack_forest(case6.jis.merged,
                                     np.asarray(case6.jis.roots))
    arrays = {k: np.asarray(getattr(jp, k)) for k in carry.PACKED_ARRAYS}
    packed = carry.packed_from_arrays(arrays, num_tris=jp.num_tris,
                                      leaf_size=jp.leaf_size, roots=jroots,
                                      device=CPU)
    jrays = _random_rays(256, 3)
    jrays = rtk_tpu.Rays.make(np.asarray(jrays.origin) / 6,
                              np.asarray(jrays.direction))
    proots = jroots[[1, 0]]  # packet 0 in the box, packet 1 in the blob
    want = jax_trace_packets(jp, jrays, interpret=True, packet_roots=proots)
    rays = rtk_tpu_torch.Rays.make(np.asarray(jrays.origin),
                                   np.asarray(jrays.direction), device="cpu")
    got = trace_packets_reference(packed, rays, packet_roots=proots)
    wh = np.asarray(want.hit)
    assert wh[:128].any() and wh[128:].any()
    np.testing.assert_array_equal(got.hit.numpy(), wh)
    np.testing.assert_allclose(got.t.numpy()[wh], np.asarray(want.t)[wh],
                               atol=1e-5)
    per_ray = torch.as_tensor(np.repeat(proots, 128))
    _assert_same_hits(trace_packets(packed, rays, ray_roots=per_ray), got)


def test_packet_roots_contract(case6):
    packed = case6.tps.packed
    rays = case6.rays[:200]  # one block of 8 packets of 128 rays
    short = trace_packets(packed, rays, packet_roots=[1])
    padded = trace_packets(packed, rays, packet_roots=[1] + [0] * 7)
    _assert_same_hits(short, padded)
    with pytest.raises(ValueError, match="entries"):
        trace_packets(packed, rays, packet_roots=[0] * 9)
    with pytest.raises(ValueError, match="sort_rays"):
        trace_packets(packed, rays, packet_roots=[0], sort_rays=True)
    with pytest.raises(ValueError, match="not both"):
        trace_packets(packed, rays, packet_roots=[0],
                      ray_roots=torch.zeros(200, dtype=torch.int32))
    with pytest.raises(ValueError, match="root rows"):
        trace_packets(packed, rays, ray_roots=torch.full(
            (200,), packed.num_nodes, dtype=torch.int32))


def test_instanced_packets_against_rtk_tpu(case6):
    hits, inst, live = tinst.trace_closest_instanced_packets(
        case6.tps, case6.rays, return_live_counts=True)
    ref_hits, ref_inst, ref_live = case6.ref_packets
    assert hits.hit.any()
    _against_ref(hits, inst, ref_hits, ref_inst)
    np.testing.assert_array_equal(live.numpy(), np.asarray(ref_live))
    # A CPU trace takes the plain version: plain=True is the same trace.
    _assert_same_hits(tinst.trace_closest_instanced_packets(
        case6.tps, case6.rays, plain=True)[0], hits)


@pytest.mark.parametrize("path", ["packets", "stack"])
def test_instanced_against_brute_force(case6, cam12, path):
    for case in (case6, cam12):
        if path == "packets":
            hits, inst = tinst.trace_closest_instanced_packets(case.tps,
                                                               case.rays)
        else:
            hits, inst = tinst.trace_closest_instanced(case.tis, case.rays)
        _against_brute(hits, inst, case.brute)


def test_stack_instanced_against_rtk_tpu(case6):
    hits, inst = tinst.trace_closest_instanced(case6.tis, case6.rays)
    _against_ref(hits, inst, *case6.ref_stack)


def test_exact_residual_with_one_candidate(cam12):
    """max_candidates=1 leaves most rays to the exactness residual (the
    stack engine), whose merged slots map back to packed slots: the same
    hits, records and instances as 12 candidates."""
    stats = {}
    hits, inst = tinst.trace_closest_instanced_packets(
        cam12.tps, cam12.rays, max_candidates=1, stats=stats)
    full, full_inst = cam12.full
    assert stats["residual"] > 0
    np.testing.assert_array_equal(hits.hit.numpy(), full.hit.numpy())
    np.testing.assert_allclose(hits.t.numpy(), full.t.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(inst.numpy(), full_inst.numpy())
    np.testing.assert_array_equal(hits.triangle_index.numpy(),
                                  full.triangle_index.numpy())


@pytest.mark.parametrize("caps", ["auto", "starved", "calibrated"])
def test_round_caps_keep_the_result(cam12, caps):
    full, full_inst = cam12.full
    if caps == "starved":
        caps = (1024,) + (128,) * 11
    elif caps == "calibrated":
        caps = tinst.calibrate_round_caps(cam12.tps, cam12.rays,
                                          max_candidates=12)
    stats = {}
    hits, inst = tinst.trace_closest_instanced_packets(
        cam12.tps, cam12.rays, max_candidates=12, round_caps=caps,
        stats=stats)
    _assert_same_hits(hits, full)
    assert torch.equal(inst, full_inst)
    if caps == (1024,) + (128,) * 11:
        assert stats["residual"] > 0  # cut rows went to the residual


def test_caps_from_counts_matches_rtk_tpu():
    for counts, n, n_inst, kw in (([5000, 700, 3, 0], 65536, 125, {}),
                                  ([300, 20], 1000, 2, dict(p_pk=16)),
                                  ([1, 0, 0], 256, 12, dict(unit=256))):
        assert tinst.caps_from_counts(counts, n, n_inst, **kw) == \
            jinst.caps_from_counts(np.asarray(counts), n, n_inst, **kw)


def test_sah_forest_tables(cam12):
    """build_sah_forest tables through pack_instanced: the LBVH forest's
    hits and t, and the residual's records mapped into the SAH tables."""
    tris = cam12.srcs
    pk, roots = build_sah_forest(tris, rtk_tpu_torch.BuildConfig(leaf_size=4),
                                device=CPU)
    sah = tinst.pack_instanced(cam12.tis, packed=pk, packed_roots=roots)
    full, _ = cam12.full
    for c in (12, 1):
        hits, _ = tinst.trace_closest_instanced_packets(sah, cam12.rays,
                                                        max_candidates=c)
        np.testing.assert_array_equal(hits.hit.numpy(), full.hit.numpy())
        t, ft = hits.t.numpy(), full.t.numpy()
        assert (np.abs(t - ft) <= T_REL * (1 + np.abs(ft))).all()
        same = hits.triangle_index.numpy() == full.triangle_index.numpy()
        assert same.mean() > 0.9
        np.testing.assert_array_equal(
            hits.vertex_position.numpy()[same],
            full.vertex_position.numpy()[same])
    wrong, wrong_roots = build_sah_forest(
        tris[::-1], rtk_tpu_torch.BuildConfig(leaf_size=4), device=CPU)
    with pytest.raises(ValueError, match="BLAS list"):
        tinst.pack_instanced(cam12.tis, packed=wrong,
                             packed_roots=wrong_roots)


@pytest.fixture(scope="module")
def two_blas():
    """cornell_box then blob(3) merged in both packages, per-ray start
    nodes alternating between the two roots, 16x16 camera rays."""
    tris = [scenes.cornell_box(), scenes.blob(3)[0]]
    jmerged, roots = jinst.merge_blas(
        [rtk_tpu.build_scene(_soup_of(t)) for t in tris])
    tmerged, _ = tinst.merge_blas(
        [rtk_tpu_torch.build_scene(_soup_of(t), device=CPU) for t in tris])
    jrays = jax_scenes.camera_rays((0.2, 0.1, 3.0), (0, 0, 0),
                                               (0, 1, 0), 60, 16, 16)
    rays = rtk_tpu_torch.Rays.make(
        *(np.asarray(getattr(jrays, f))
          for f in ("origin", "direction", "min_t", "max_t")), device="cpu")
    start = roots[np.arange(rays.count) % 2]
    return jmerged, tmerged, jrays, rays, start


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_trace_loop_start_node_against_rtk_tpu(two_blas, mode):
    jmerged, tmerged, jrays, rays, start = two_blas
    got, slot = tstack._trace_loop(tmerged, rays, mode=mode,
                                   config=TraceConfig(max_stack=64),
                                   start_node=torch.as_tensor(start),
                                   return_slot=True)
    want, want_slot = jstack._trace_loop(
        jmerged, jrays, mode=mode, filter_fn=None,
        config=JaxTraceConfig(max_stack=64), start_node=start,
        return_slot=True)
    wh = np.asarray(want.hit)
    assert wh[0::2].any() and wh[1::2].any()
    np.testing.assert_array_equal(got.hit.numpy(), wh)
    if mode == "closest":
        np.testing.assert_allclose(got.t.numpy()[wh], np.asarray(want.t)[wh],
                                   atol=1e-5)
        same = slot.numpy() == np.asarray(want_slot)
        assert same[wh].mean() > 0.9
        np.testing.assert_array_equal(got.triangle_index.numpy()[same],
                                      np.asarray(want.triangle_index)[same])


def test_trace_loop_refuses_stack_overflow(two_blas):
    """Where rtk_tpu's engine drops pushes past max_stack, the port raises;
    a stack sized from the wide depth never overflows."""
    _, tmerged, _, rays, start = two_blas
    with pytest.raises(RuntimeError, match="max_stack"):
        tstack._trace_loop(tmerged, rays, mode="closest",
                           config=TraceConfig(max_stack=3),
                           start_node=torch.as_tensor(start))
    depth = tstack.wide_depth(tmerged, np.unique(start))
    tstack._trace_loop(tmerged, rays, mode="closest",
                       config=TraceConfig(max_stack=depth * 7),
                       start_node=torch.as_tensor(start))


def test_front_doors():
    for name in ("build_instanced", "pack_instanced",
                 "trace_closest_instanced",
                 "trace_closest_instanced_packets"):
        assert getattr(rtk_tpu_torch, name) is getattr(tinst, name)
        assert getattr(rtk_tpu_torch.api, name) is getattr(tinst, name)


@pytest.mark.parametrize("bad", ["past_the_table", "negative", "one_short"])
def test_pack_instanced_refuses_bad_packed_roots(cam12, bad):
    """pack_instanced checks the root rows once, on the host (the rounds
    launch from them without a check); a caller's roots stay checked by
    trace_packets and the kernel's wrapper."""
    pk, roots = build_sah_forest(cam12.srcs,
                                 rtk_tpu_torch.BuildConfig(leaf_size=4),
                                 device=CPU)
    rows = pk.nodes.shape[0] // pk.branching
    wrong = {"past_the_table": np.asarray(roots) * 0 + rows,
             "negative": np.asarray(roots) - rows - 1,
             "one_short": np.asarray(roots)[:-1]}[bad]
    with pytest.raises(ValueError, match="packed_roots"):
        tinst.pack_instanced(cam12.tis, packed=pk, packed_roots=wrong)
    ok = tinst.pack_instanced(cam12.tis, packed=pk, packed_roots=roots)
    assert ok.packed_roots.dtype == torch.int32
    np.testing.assert_array_equal(ok.packed_roots.numpy(), roots)
    rays8 = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="root rows"):
        packet_trace(pk.nodes, pk.tris, rays8, leaf_size=pk.leaf_size,
                     stack_size=pk.stack_size,
                     roots=torch.full((4,), rows, dtype=torch.int32))
