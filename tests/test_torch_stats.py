"""utils/stats.py and the packet trace's per-ray counts against rtk_tpu:
the stats variant's plain version (fields, the steps = internal + leaf
identity, the box and triangle tests, any-hit <= closest-hit),
measure_trace, and log_build / scene_stats on the carried scene (the same
lines and numbers)."""
import json

import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.utils import stats as jstats
from rtk_tpu_torch.ops.packet_trace import (trace_packets,
                                            trace_packets_reference)
from rtk_tpu_torch.testing import carry, scenes
from rtk_tpu_torch.trace.packed import pack_scene
from rtk_tpu_torch.utils import stats

from test_torch_trace import CPU, _soup_of

torch.set_num_threads(2)


def _blob_rays(side=24):
    return scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, side,
                              side, device="cpu")


@pytest.mark.parametrize("leaf", [1, 4, 8])
def test_counts_fields_and_any_le_closest(leaf):
    tris = scenes.blob(3)[0]
    packed = pack_scene(rt.build_scene(_soup_of(tris),
                                       rt.BuildConfig(leaf_size=leaf),
                                       device=CPU))
    rays = _blob_rays()
    hc, closest = trace_packets(packed, rays, stats=True)
    ha, anyhit = trace_packets(packed, rays, mode="any", stats=True)
    for c in (closest, anyhit):
        assert c.shape == (5, rays.count) and c.dtype == torch.int32
        assert (c >= 0).all()
        assert torch.equal(c[0], c[1] + c[2])
        # Each popped node tests its 2..8 live children; each popped leaf
        # at most leaf_size rows, at least one.
        assert (2 * c[1] <= c[3]).all() and (c[3] <= 8 * c[1]).all()
        assert (c[2] <= c[4]).all() and (c[4] <= leaf * c[2]).all()
    assert (anyhit <= closest).all()
    # Every live ray pops its root; rays that hit popped a leaf.
    assert (closest[1] >= 1).all() and (closest[2][hc.hit] >= 1).all()
    # The counts ride beside unchanged hit records.
    plain = trace_packets(packed, rays)
    for f in ("hit", "t", "u", "v", "slot"):
        assert torch.equal(getattr(hc, f), getattr(plain, f)), f
    assert torch.equal(ha.hit, hc.hit)


def test_counts_come_back_in_the_callers_order():
    rng = np.random.default_rng(8)
    tris = rng.normal(size=(300, 3, 3)).astype(np.float32)
    packed = pack_scene(rt.build_scene(_soup_of(tris), device=CPU))
    rays = rt.Rays.make(rng.normal(size=(512, 3)) * 3.0,
                        rng.normal(size=(512, 3)), device="cpu")
    _, a = trace_packets(packed, rays, sort_rays=False, stats=True)
    _, b = trace_packets(packed, rays, sort_rays=True, stats=True)
    assert torch.equal(a, b)
    _, c = trace_packets_reference(packed, rays[:100], stats=True)
    assert torch.equal(c, a[:, :100])


def test_triangle_tests_skip_padding_and_masked_rows():
    """Triangle tests count only the rows the function needs: a popped
    leaf's real triangles that pass the mask, never its NaN padding.  A
    predicate that rejects every candidate leaves best_t at max_t, so the
    pops do not depend on the mask and the rows can be summed across
    masks."""
    tris = scenes.blob(3)[0]
    n = tris.shape[0]
    mask = np.where(np.arange(n) % 2 == 1, 1, 2).astype(np.uint32)
    packed = rt.build_sah_packed(_soup_of(tris), rt.BuildConfig(leaf_size=16),
                                 tri_mask=mask, device=CPU)
    assert torch.isnan(packed.tris[:, 0]).any()  # leaves hold padding
    rays = _blob_rays()
    reject = rt.jit_filter(lambda c: c.t < -1.0)
    runs = [trace_packets(packed, rays, filter_fn=reject, stats=True, **kw)
            for kw in ({}, {"filter_mask": 1}, {"filter_mask": 2},
                       {"filter_mask": 4})]
    (h, full), (_, odd), (_, even), (_, none) = runs
    assert not h.hit.any() and (full[2] > 0).any()
    for c in (odd, even, none):
        assert torch.equal(c[:4], full[:4])
    assert torch.equal(odd[4] + even[4], full[4])
    assert (none[4] == 0).all()
    assert (full[4] < 16 * full[2]).any()  # padding is not counted


def test_triangle_tests_equal_leaf_pops_without_padding():
    tris = scenes.blob(3)[0]
    packed = pack_scene(rt.build_scene(_soup_of(tris),
                                       rt.BuildConfig(leaf_size=1),
                                       device=CPU))
    assert not torch.isnan(packed.tris[:, 0]).any()
    _, c = trace_packets(packed, _blob_rays(), stats=True)
    assert torch.equal(c[4], c[2])


def test_dead_rays_count_nothing():
    packed = pack_scene(rt.build_scene(_soup_of(scenes.cornell_box()),
                                       device=CPU))
    rays = rt.Rays.make(np.zeros((4, 3)) + 0.5, [[0, 0, -1.0]] * 4, 1.0,
                        [0.0, 1.0, 0.5, 3.0e38], device="cpu")
    _, c = trace_packets(packed, rays, stats=True)
    assert (c[:, :3] == 0).all() and (c[:2, 3] > 0).all()


def test_measure_trace_with_steps():
    """tests/test_checks.py:69-82's check on the port."""
    tris = scenes.blob(3)[0]
    tracer = rt.Tracer(rt.build_scene(_soup_of(tris), device=CPU),
                       engine="packet")
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 32, 32,
                              device="cpu")
    st = stats.measure_trace(tracer, rays, iters=1, with_steps=True)
    assert st.rays == rays.count
    assert st.steps_per_block and st.steps_per_block > 0
    assert st.device == "cpu" and "Mrays/s on cpu" in str(st)
    assert stats.measure_trace(rt.Tracer(tracer.scene, engine="stack"),
                               rays, iters=1,
                               with_steps=True).steps_per_block is None


def test_steps_per_block_is_the_blocks_critical_path():
    steps = torch.arange(300, dtype=torch.int32)
    # blocks [0, 128), [128, 256), [256, 300): maxima 127, 255, 299
    assert stats.steps_per_block(steps) == pytest.approx((127 + 255 + 299)
                                                         / 3)


def _axis_by_hand(d):
    """The kernel's kz of one direction: largest |d|, ties x, y, z."""
    a = [abs(float(c)) for c in d]
    top = max(a)
    return 0 if a[0] == top else (1 if a[1] == top else 2)


def _mixed_by_hand(direction, warp=32):
    groups = [direction[i:i + warp] for i in range(0, len(direction), warp)]
    return sum(len({_axis_by_hand(d) for d in g}) > 1
               for g in groups) / len(groups)


def _sorted_bounce(n=1000, seed=31):
    """Seeded bounce-like rays in the coherence key's order, as the front
    end sorts a bounce batch: half leave a floor close to its normal (+y),
    half leave a wall (normal -x) spread about theirs."""
    from rtk_tpu_torch.ops.morton import ray_coherence_key_reference

    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    floor = np.arange(n) < n // 2
    o[floor, 1] = -4.0
    o[~floor, 0] = 4.0
    nrm = np.where(floor[:, None], [0.0, 4.0, 0.0], [-1.0, 0.0, 0.0])
    d = nrm + rng.normal(size=(n, 3))
    d = torch.as_tensor((d / np.linalg.norm(d, axis=1,
                                            keepdims=True)).astype(np.float32))
    order = torch.sort(ray_coherence_key_reference(torch.as_tensor(o), d),
                       stable=True).indices
    return d[order]


def _mixed_axis_case(name):
    """(directions, the share counted by hand) of each case."""
    if name == "one_axis":
        d = torch.tensor([[0.1, -0.2, 1.0], [0.3, 0.3, -0.9]]).repeat(50, 1)
        return d, 0.0
    if name == "lanes_cycle":
        one = torch.tensor([[1.0, 0.2, -0.3], [0.1, -1.0, 0.5],
                            [0.2, 0.4, 1.0]])
        return one.repeat(32, 1), 1.0
    if name == "short_last_group":
        # Groups of 32, 32 and 6: only the short last one is mixed.
        d = torch.tensor([[1.0, 0.5, 0.5]]).repeat(70, 1)
        d[66] = torch.tensor([0.1, 0.2, -2.0])
        return d, 1 / 3
    if name == "ties":
        # Ties of |d| go x, then y, then z: the first group all x, the
        # second all y, the third x and y.
        to_x = torch.tensor([[1.0, 1.0, 1.0], [-1.0, 1.0, 0.5],
                             [1.0, 0.2, -1.0], [-2.0, -2.0, 0.0]])
        to_y = torch.tensor([[0.5, 1.0, 1.0], [0.0, -1.0, 1.0],
                             [0.25, 3.0, -3.0], [-0.5, 1.0, -0.5]])
        d = torch.cat([to_x.repeat(8, 1), to_y.repeat(8, 1),
                       torch.cat([to_x, to_y]).repeat(4, 1)])
        return d, 1 / 3
    d = _sorted_bounce()
    return d, _mixed_by_hand(d.tolist())


@pytest.mark.parametrize("name", ["one_axis", "lanes_cycle",
                                  "short_last_group", "ties",
                                  "sorted_bounce"])
def test_mixed_axis_share(name):
    """The share of consecutive 32-ray groups whose shear axes differ,
    against a count by hand (ties x, then y, then z, as the kernel's kz)."""
    d, want = _mixed_axis_case(name)
    assert _mixed_by_hand(d.tolist()) == pytest.approx(want)
    assert stats.mixed_axis_share(d) == pytest.approx(want)
    if name == "sorted_bounce":
        assert 0.0 < want < 1.0
        assert stats.mixed_axis_share(d[:0]) == 0.0


def _scenes(leaf=4):
    tris = scenes.blob(3)[0]
    jscene = rtk_tpu.build_scene(_soup_of(tris),
                                 rtk_tpu.BuildConfig(leaf_size=leaf))
    arrays = {k: np.asarray(getattr(jscene, k)) for k in carry.SCENE_ARRAYS}
    tscene = carry.scene_from_arrays(
        arrays, num_tris=jscene.num_tris, leaf_size=jscene.leaf_size,
        branching=jscene.branching, num_leaves=jscene.num_leaves,
        device=CPU)
    return jscene, tscene


@pytest.mark.parametrize("per_node", [False, True])
def test_log_build_matches_rtk_tpu(per_node):
    jscene, tscene = _scenes()
    want, got = [], []
    users = []
    jst = jstats.log_build(jscene, jstats.BuildLogger(
        lambda u, b, m: want.append(m)), per_node=per_node)
    st = stats.log_build(tscene, stats.BuildLogger(
        lambda u, b, m: (got.append(m), users.append((u, b))),
        user="me", build="b"), per_node=per_node)
    assert got == want
    assert set(users) == {("me", "b")}
    assert str(st) == str(jst)
    assert sum("level" in ln for ln in got) == st.max_depth


@pytest.mark.parametrize("leaf", [1, 8])
def test_scene_stats_matches_rtk_tpu(leaf):
    jscene, tscene = _scenes(leaf)
    want = jstats.scene_stats(jscene)
    got = stats.scene_stats(tscene)
    for f in ("num_tris", "num_leaves", "num_wide_nodes", "max_depth",
              "avg_leaf_occupancy", "avg_child_occupancy", "sah_cost"):
        assert getattr(got, f) == getattr(want, f), f


def test_profiler_trace_and_annotate(tmp_path):
    @stats.annotate("rtk.trace")
    def run(tracer, rays):
        """traces"""
        return tracer.closest(rays)

    assert run.__name__ == "run" and run.__doc__ == "traces"
    tracer = rt.Tracer(rt.build_scene(_soup_of(scenes.cornell_box()),
                                      device=CPU))
    with stats.profiler_trace(str(tmp_path), annotation="block") as prof:
        run(tracer, scenes.cornell_camera(8, 8, device="cpu"))
    names = {e.key for e in prof.key_averages()}
    assert {"rtk.trace", "block"} <= names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "rtk.trace"
               for ev in trace["traceEvents"])
