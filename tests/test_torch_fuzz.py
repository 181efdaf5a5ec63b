"""The port's counterpart of tests/test_fuzz.py: rtk_tpu's adversarial
soups (degenerate triangles, duplicates, an axis-aligned fan of shared
edges, a tiny far cluster) traced through the port's engines, the stack
engine and the plain packet traversal first, against rtk_tpu's float64
brute-force oracle (trace_brute), at test_fuzz.py's bar; and edge rays
against rtk_tpu's packet kernel."""
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.oracle import trace_brute
from rtk_tpu.ops.pallas_trace import trace_packets as jax_trace_packets
from rtk_tpu.trace.packed import pack_scene as jax_pack_scene
from rtk_tpu_torch.ops.packet_trace import trace_packets
from rtk_tpu_torch.trace.packed import pack_scene

from test_fuzz import _adversarial_soup

torch.set_num_threads(2)
CPU = "cpu"
ENGINES = ("stack", "packet", "stackless", "binned", "grid")


@pytest.mark.parametrize("seed", [11, 29, 3, 5, 7])
def test_fuzz_engines_agree_with_oracle(seed):
    """Every engine at LBVH leaf 4, 8 and 16: the hit set within 2% of the
    oracle's (which sits within float noise of the window's edge), t
    within rtol 1e-4 / atol 1e-5 on common hits."""
    tris = _adversarial_soup(seed)
    rng = np.random.default_rng(seed + 1)
    n = 256
    o = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    ref = trace_brute(tris, rtk_tpu.Rays.make(o, d, min_t=1e-4))
    rh, rtt = np.asarray(ref.hit), np.asarray(ref.t)
    rays = rt.Rays.make(o, d, min_t=1e-4, device=CPU)
    for leaf in (4, 8, 16):
        scene = rt.build_from_soup(tris, config=rt.BuildConfig(leaf_size=leaf),
                                   device=CPU)
        for engine in ENGINES:
            got = rt.Tracer(scene, engine=engine).closest(rays)
            gh, gt = got.hit.numpy(), got.t.numpy()
            mism = gh != rh
            assert mism.mean() < 0.02, (engine, leaf, mism.sum())
            both = gh & rh
            np.testing.assert_allclose(gt[both], rtt[both], rtol=1e-4,
                                       atol=1e-5,
                                       err_msg=f"{engine} k={leaf}")


def test_fuzz_degenerate_only_scene_never_hits():
    """A scene of only zero-area triangles builds, traces and hits nothing
    on any engine."""
    rng = np.random.default_rng(3)
    t = rng.normal(size=(16, 3, 3)).astype(np.float32)
    t[:, 1] = t[:, 0]
    scene = rt.build_from_soup(t, config=rt.BuildConfig(leaf_size=4),
                               device=CPU)
    rays = rt.Rays.make(rng.normal(size=(64, 3)), rng.normal(size=(64, 3)),
                        device=CPU)
    for engine in ENGINES:
        assert not rt.Tracer(scene, engine=engine).closest(rays).hit.any()


def test_fuzz_edge_rays_match_rtk_tpu():
    """Zero and -0 direction components, NaN origins and directions, a
    window with min_t > max_t, and an empty batch: the plain packet
    traversal and the stack engine give rtk_tpu's packet-kernel hit
    masks."""
    tris = _adversarial_soup(11)
    z = np.float32(-0.0)
    nan = np.float32(np.nan)
    o = np.float32([[0, 0, -3], [0, 0, -3], [0.3, 0.2, -3], [nan, 0, -3],
                    [0, 0, -3], [0, 0, -3], [0.1, 0.1, 3], [0.2, 0, -3]])
    d = np.float32([[0, 0, 1], [z, z, 1], [0, z, 1], [0, 0, 1],
                    [nan, 0, 1], [0, 0, 1], [z, 0, -1], [0, 0, 1]])
    min_t = np.float32([0, 0, 0, 0, 0, 5, 0, 0])
    max_t = np.float32([1e30, 1e30, 1e30, 1e30, 1e30, 1, 1e30, 1e30])
    jscene = rtk_tpu.build_from_soup(
        tris, config=rtk_tpu.BuildConfig(leaf_size=4))
    want = jax_trace_packets(jax_pack_scene(jscene),
                             rtk_tpu.Rays.make(o, d, min_t, max_t),
                             interpret=True)
    scene = rt.build_from_soup(tris, config=rt.BuildConfig(leaf_size=4),
                               device=CPU)
    rays = rt.Rays.make(o, d, min_t, max_t, device=CPU)
    for got in (trace_packets(pack_scene(scene), rays),
                rt.Tracer(scene, engine="stack").closest(rays)):
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    assert not got.hit[3:6].any()
    empty = trace_packets(pack_scene(scene), rays[:0])
    assert empty.hit.shape == (0,)
