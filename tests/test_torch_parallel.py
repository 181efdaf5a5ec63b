"""parallel/shard.py against rtk_tpu.parallel.shard: the conftest's 8
virtual JAX devices are the reference mesh and Mesh([cpu] * 8) the port's.
Every sharded front end is held against rtk_tpu's at trace tolerance (the
Pallas kernel in interpret mode) and against the port's own unsharded call
bit for bit: each ray's trace does not depend on its batch."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.instancing import build_instanced as jbuild_instanced
from rtk_tpu.instancing import pack_instanced as jpack_instanced
from rtk_tpu.parallel import shard as jshard
from rtk_tpu.testing import grid as jgrid
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace.packed import pack_scene as jpack_scene
from rtk_tpu_torch.ops.packet_trace import trace_packets
from rtk_tpu_torch.parallel import shard
from rtk_tpu_torch.testing import carry, scenes
from rtk_tpu_torch.testing.grid import trace_packets_grid
from rtk_tpu_torch.trace.packed import pack_scene

from test_torch_build import assert_bits_equal
from test_torch_trace import CPU, _check, _rays

torch.set_num_threads(2)
MESH8 = shard.Mesh([torch.device("cpu")] * 8)
T_TIE = 1e-6  # |t - t_unsharded| <= T_TIE * (1 + |t|) (tests/test_grid.py)


def _soup_of(tris):
    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def _same(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


HITS = [f.name for f in dataclasses.fields(rt.Hits)]
PACKET = ("hit", "slot", "t", "u", "v")


def _parity(got, want):
    """Scene sharding against one scene: equal hit masks, t within
    T_TIE, another triangle only at an exact-t tie (the parts' trees meet
    the tie in another order)."""
    assert torch.equal(got.hit, want.hit)
    assert bool(((got.t - want.t).abs() <= T_TIE * (1 + want.t.abs())).all())
    differ = got.triangle_index != want.triangle_index
    assert torch.equal(got.t[differ], want.t[differ])


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8  # the reference's mesh
    assert MESH8.shape == {"rays": 8} and MESH8.size == 8
    assert MESH8.devices[3] == torch.device("cpu")
    assert shard.default_mesh(["cpu"] * 3).shape == {"rays": 3}
    with pytest.raises(ValueError, match="one name per axis"):
        shard.Mesh([torch.device("cpu")] * 4, ("scene", "rays"))
    with pytest.raises(ValueError, match="do not fold"):
        shard.hybrid_mesh(3, [torch.device("cpu")] * 8)


def test_default_mesh_raises_without_a_card(monkeypatch):
    """No CUDA device: the default mesh raises; it never falls back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.default_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.hybrid_mesh(2)


@pytest.fixture(scope="module")
def cornell():
    tris = scenes.cornell_box()
    scene = rt.build_scene(_soup_of(tris), device=CPU)
    jscene = rtk_tpu.build_scene(_soup_of(tris))
    jrays = jax_scenes.cornell_camera(32, 32)  # 1024 rays, divisible by 8
    ref = jshard.trace_closest_sharded(jscene, jrays, jshard.default_mesh())
    return scene, jscene, _rays(jrays), jrays, ref


@pytest.mark.smoke
def test_sharded_matches_single_device(cornell):
    scene, _, rays, _, ref = cornell
    got = shard.trace_closest_sharded(scene, rays, MESH8)
    _same(got, rt.trace_closest(scene, rays), HITS)
    _check(got, ref)


def test_sharded_ragged_ray_count(cornell):
    scene, _, rays, _, ref = cornell
    rays = rays[:217]  # not divisible by 8
    got = shard.trace_closest_sharded(scene, rays, MESH8)
    assert got.t.shape[0] == 217
    _same(got, rt.trace_closest(scene, rays), HITS)
    _check(got, ref[:217])


def test_sharded_any_hit(cornell):
    scene, _, rays, _, _ = cornell
    rays = rays[::4]
    got = shard.trace_any_sharded(scene, rays, MESH8)
    assert got.hit.all()
    _same(got, rt.trace_any(scene, rays), HITS)


def test_ray_index_filter_sees_the_callers_index(cornell):
    """A filter keyed on ray_index gives the unsharded hits: each shard's
    filter sees the caller's ray index.  rtk_tpu's shards see their local
    row, so its sharded call hits every ray of the closed box where the
    unsharded call hits the first 512 (the reference fault, not copied)."""
    scene, jscene, rays, jrays, _ = cornell

    def first_half(c):
        return c.ray_index < 512

    got = shard.trace_closest_sharded(scene, rays, MESH8,
                                      filter_fn=first_half)
    _same(got, rt.trace_closest(scene, rays, filter_fn=first_half), HITS)
    assert int(got.hit.sum()) == 512 and bool(got.hit[:512].all())
    occ = shard.trace_any_sharded(scene, rays, MESH8, filter_fn=first_half)
    assert torch.equal(occ.hit, got.hit)
    ref = jshard.trace_closest_sharded(jscene, jrays, filter_fn=first_half)
    assert int(np.asarray(ref.hit).sum()) == 1024


@pytest.mark.smoke
def test_packet_engine_sharded_matches_single(cornell):
    """trace_packets on each shard: rtk_tpu's at trace tolerance, the
    port's unsharded call bit for bit (also with each shard sorted, on a
    4-entry mesh), and trace_packets' flag checks."""
    _, _, rays, jrays, _ = cornell
    tris = scenes.cornell_box()
    packed = pack_scene(rt.build_scene(_soup_of(tris),
                                       rt.BuildConfig(leaf_size=8),
                                       device=CPU))
    jpacked = jpack_scene(rtk_tpu.build_scene(
        _soup_of(tris), rtk_tpu.BuildConfig(leaf_size=8)))
    got = shard.trace_packets_sharded(packed, rays, MESH8, interpret=True)
    _same(got, trace_packets(packed, rays), PACKET)
    _check(got, jshard.trace_packets_sharded(jpacked, jrays,
                                             jshard.default_mesh(),
                                             interpret=True))
    mesh4 = shard.Mesh([torch.device("cpu")] * 4)
    for kw in ({"sort_rays": True}, {"mode": "any"}):
        _same(shard.trace_packets_sharded(packed, rays, mesh4, **kw),
              trace_packets(packed, rays, **kw), PACKET)
    with pytest.raises(ValueError, match="multiple of 128"):
        shard.trace_packets_sharded(packed, rays, MESH8, pkt=100)


@pytest.fixture(scope="module")
def blob3():
    """1220 of blob(3)'s triangles in 8 parts of 152 and 153 (so four
    parts pad to the others' 160 rows), built by both packages, and
    rtk_tpu's scene-sharded closest on a 16x16 camera."""
    tris = scenes.blob(subdivisions=3)[0][:1220]
    desc = _soup_of(tris)
    cfg = dict(branching=8, leaf_size=8)
    jmesh = jshard.default_mesh()
    jss = jshard.build_scene_sharded(desc, jmesh, rtk_tpu.BuildConfig(**cfg))
    ss = shard.build_scene_sharded(desc, MESH8, rt.BuildConfig(**cfg))
    jrays = jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                                   16, 16)
    ref = jshard.trace_closest_scene_sharded(jss, jrays, jmesh,
                                             interpret=True)
    whole = pack_scene(rt.build_from_soup(tris, config=rt.BuildConfig(**cfg),
                                          device=CPU))
    return desc, ss, jss, _rays(jrays), ref, whole


def test_partition_soup_matches_reference():
    tris = scenes.blob(subdivisions=3)[0]
    for n in (2, 3, 5, 8):
        for a, b in zip(shard.partition_soup(tris, n),
                        jshard.partition_soup(tris, n), strict=True):
            np.testing.assert_array_equal(a, b)


def test_partition_soup_rejects_tiny_scenes():
    tri_pos = np.zeros((5, 3, 3), np.float32)
    with pytest.raises(ValueError, match="non-empty parts"):
        shard.partition_soup(tri_pos, 8)


def test_build_scene_sharded_tables_match_reference(blob3):
    """The stacked padded tables equal rtk_tpu's ShardedScene bit for bit,
    NaN rows padding `tris` included; each part lives on its row's
    device."""
    _, ss, jss, _, _, _ = blob3
    assert ss.num_parts == jss.num_parts == 8
    assert (ss.part_tris, ss.num_tris, ss.leaf_size) == (
        jss.part_tris, jss.num_tris, jss.leaf_size)
    for f in ("nodes", "tris", "tri_v", "tri_vidx", "tri_mesh", "tri_prim"):
        assert_bits_equal(getattr(ss, f), getattr(jss, f), f)
    padded = [p.num_tris < ss.part_tris - 7 for p in ss.parts]
    assert any(padded) and bool(torch.isnan(ss.tris[:, -1]).any())
    assert all(p.device == torch.device("cpu") for p in ss.parts)


def test_scene_sharded_matches_single_device(blob3):
    """Closest and any over 8 parts: rtk_tpu's scene-sharded records at
    trace tolerance, one unsharded scene's at the tie bar, and any-hit's
    mask equal to closest's."""
    _, ss, _, rays, ref, whole = blob3
    got = shard.trace_closest_scene_sharded(ss, rays, MESH8, interpret=True)
    _check(got, ref)
    _parity(got, trace_packets(whole, rays))
    # globalised slots resolve through the parts' tables laid end to end
    np.testing.assert_array_equal(got.triangle_index.numpy(),
                                  np.asarray(ref.triangle_index))
    occ = shard.trace_any_scene_sharded(ss, rays, MESH8)
    assert torch.equal(occ.hit, got.hit)


def test_scene_sharded_any_hit_record_consistent(blob3):
    """Scene-sharded any-hit returns one part's whole record: the lowest
    part that hits, bit for bit; (t, u, v) reproduce the slot's triangle
    hit point; a miss keeps t = max_t and slot = -1."""
    _, ss, _, rays, _, _ = blob3
    occ = shard.trace_any_scene_sharded(ss, rays, MESH8)
    h = occ.hit
    assert h.any()
    rank = torch.where(h, occ.slot // ss.part_tris, ss.num_parts)
    for r, part in enumerate(ss.parts):
        mine = rank == r
        want = trace_packets(part, rays, mode="any")
        assert not bool((want.hit & (rank > r)).any())  # lowest rank wins
        got = dataclasses.replace(occ, slot=occ.slot - r * ss.part_tris)
        for f in ("t", "u", "v", "slot"):
            assert torch.equal(getattr(got, f)[mine], getattr(want, f)[mine])
    # o + t*d == barycentric(slot triangle, u, v) for every hit ray.
    tv = ss.tri_v.reshape(-1, 3, 3)[occ.slot[h]]
    u, v = occ.u[h, None], occ.v[h, None]
    p_bary = u * tv[:, 0] + v * tv[:, 1] + (1.0 - u - v) * tv[:, 2]
    np.testing.assert_allclose(occ.position()[h].numpy(), p_bary.numpy(),
                               atol=5e-3)
    assert bool((occ.slot[~h] == -1).all())
    assert torch.equal(occ.t[~h], rays.max_t[~h])


def test_hybrid_2d_scene_x_rays_matches_single(blob3):
    """(2 scene parts) x (4 ray shards) over 8 entries, with a ragged
    batch: rtk_tpu's 8-part records at trace tolerance, one scene at the
    tie bar, and the same two parts on a 1-D mesh bit for bit."""
    desc, _, _, rays, ref, whole = blob3
    mesh = shard.hybrid_mesh(n_scene=2, devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"scene": 2, "rays": 4}
    ss = shard.build_scene_sharded(desc, mesh, rt.BuildConfig(leaf_size=8))
    assert ss.num_parts == 2
    rays, ref = rays[:255], ref[:255]  # ragged on the ray axis
    got = shard.trace_closest_scene_sharded(ss, rays, mesh)
    assert got.t.shape[0] == rays.count
    _check(got, ref)
    _parity(got, trace_packets(whole, rays))
    mesh2 = shard.Mesh([torch.device("cpu")] * 2, ("scene",))
    for mode in ("closest", "any"):
        h = shard.trace_scene_sharded(ss, rays, mesh, mode)
        _same(h, shard.trace_scene_sharded(ss, rays, mesh2, mode), PACKET)
    occ = shard.trace_any_scene_sharded(ss, rays, mesh)
    assert torch.equal(occ.hit, got.hit)
    with pytest.raises(ValueError, match="scene rows"):
        shard.trace_closest_scene_sharded(ss, rays, MESH8)


def test_grid_engine_sharded_matches_single():
    """The rounds engine on each shard of 300 random rays, on rtk_tpu's
    grid carried into the port: rtk_tpu's sharded call at the tie bar, the
    port's unsharded call bit for bit."""
    tris = scenes.blob(subdivisions=3)[0]
    jg = jgrid.build_grid(tris, config=rtk_tpu.BuildConfig(leaf_size=8))

    def packed(p):
        return carry.packed_from_arrays(
            {k: np.asarray(getattr(p, k)) for k in carry.PACKED_ARRAYS},
            num_tris=p.num_tris, leaf_size=p.leaf_size, device=CPU)

    g = carry.grid_from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in carry.GRID_ARRAYS},
        cells=packed(jg.cells), flat=packed(jg.flat), dims=jg.dims,
        n_occ=jg.n_occ, device=CPU)
    rng = np.random.default_rng(31)
    jrays = rtk_tpu.Rays.make(
        rng.normal(size=(300, 3)).astype(np.float32) * 0.5,
        rng.normal(size=(300, 3)).astype(np.float32))
    rays = _rays(jrays)
    got = shard.trace_grid_sharded(g, rays, MESH8, interpret=True, rounds=2)
    _same(got, trace_packets_grid(g, rays, rounds=2), PACKET)
    ref = jshard.trace_grid_sharded(jg, jrays, jshard.default_mesh(),
                                    interpret=True, rounds=2)
    _check(got, ref)


def test_instanced_sharded_matches_single():
    """Instanced tracing on each shard, the exactness residual once over
    the gathered unproven rays: rtk_tpu's sharded call at trace tolerance,
    the port's unsharded call bit for bit (instance index included), also
    with one candidate, where the residual re-traces most rays."""
    rng = np.random.default_rng(41)
    blob_tris = scenes.blob(subdivisions=2)[0]
    n_inst = 5
    tf = np.zeros((n_inst, 3, 4), np.float32)
    for i in range(n_inst):
        tf[i, :, :3] = np.eye(3, dtype=np.float32) * 0.6
        tf[i, :, 3] = rng.random(3).astype(np.float32) * 4 - 2
    blas = rt.build_scene(_soup_of(blob_tris), device=CPU)
    ps = rt.pack_instanced(rt.build_instanced([blas], np.zeros(n_inst, int),
                                              tf))
    jps = jpack_instanced(jbuild_instanced(
        [rtk_tpu.build_scene(_soup_of(blob_tris))], np.zeros(n_inst, int),
        tf))
    jrays = rtk_tpu.Rays.make(
        rng.normal(size=(300, 3)).astype(np.float32) * 3.0,
        rng.normal(size=(300, 3)).astype(np.float32))
    rays = _rays(jrays)
    for c in (3, 1):
        got, gi = shard.trace_instanced_sharded(ps, rays, MESH8,
                                                max_candidates=c)
        want, wi = rt.trace_closest_instanced_packets(ps, rays,
                                                      max_candidates=c)
        _same(got, want, PACKET)
        assert torch.equal(gi, wi)
    got, gi = shard.trace_instanced_sharded(ps, rays, MESH8,
                                            max_candidates=3)
    ref, ri = jshard.trace_instanced_sharded(jps, jrays,
                                             jshard.default_mesh(),
                                             interpret=True,
                                             max_candidates=3)
    _check(got, ref)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(gi.numpy()[hit], np.asarray(ri)[hit])


def test_example_shard_multichip(capsys):
    """examples/torch_shard_multichip.py on 8 CPU entries at 16x16; it
    runs on the card unless told otherwise."""
    import importlib.util
    import inspect
    import os

    spec = importlib.util.spec_from_file_location(
        "torch_shard_multichip", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "examples", "torch_shard_multichip.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    assert inspect.signature(ex.main).parameters["device"].default == "cuda"
    assert ex.main(size=16, device="cpu") > 0
    out = capsys.readouterr().out
    assert out.count(": match") == 3 and "8 entries on the CPU" in out
