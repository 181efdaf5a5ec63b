"""testing/binned.py in the port against rtk_tpu's (tests/test_binned.py's
three cases, on both packages' tables of the same blob(3) scene): the
subtree cut bit for bit, the binned engine against the flat trace at
test_binned.py's bar and against rtk_tpu's binned engine (interpret mode)
at test_packet.py's, and a tree whose cut surfaces leaves as bin roots."""
import dataclasses

import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.testing import binned as jbinned
from rtk_tpu.trace.packed import pack_scene as jax_pack_scene
from rtk_tpu_torch.ops.packet_trace import trace_packets
from rtk_tpu_torch.testing import binned as tbinned
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene

from test_torch_trace import CPU, _check

torch.set_num_threads(2)


def _tables(subdivisions, leaf):
    tris = scenes.blob(subdivisions)[0]
    soup = (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))
    jp = jax_pack_scene(rtk_tpu.build_scene(
        soup, rtk_tpu.BuildConfig(leaf_size=leaf)))
    tp = pack_scene(rt.build_scene(soup, rt.BuildConfig(leaf_size=leaf),
                                   device=CPU))
    return jp, tp


@pytest.fixture(scope="module")
def blob3():
    """tests/test_binned.py's tables: blob(3), LBVH leaf 8."""
    return _tables(3, 8)


@pytest.fixture(scope="module")
def shallow():
    """blob(1), LBVH leaf 8: 80 triangles, whose cut at depth 1 is two
    nodes and six leaves, and at depth 2 all leaves."""
    return _tables(1, 8)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return rtk_tpu.Rays.make(o, d), rt.Rays.make(o, d, device=CPU)


def _assert_flat_parity(got, ref):
    """test_binned.py's bar: equal hit masks, t within 1e-6 (rtol and
    atol), another triangle only at an exact-t tie."""
    assert torch.equal(got.hit, ref.hit)
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-6,
                               atol=1e-6)
    differ = got.slot != ref.slot
    assert torch.equal(got.t[differ], ref.t[differ])


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_subtree_bins_bit_equal(blob3, shallow, depth):
    """The cut equals rtk_tpu's bit for bit (entries, box corners) on both
    trees; depth 1 is the root's children; a shallow tree surfaces leaf
    entries (-2 - leaf), which the bins cache accepts as roots."""
    for jp, tp in (blob3, shallow):
        want = jbinned.subtree_bins(jp, depth)
        got = tbinned.subtree_bins(tp, depth)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(
                g.view(np.int32), np.asarray(w).view(np.int32))
        roots, lo, hi = got
        assert (lo <= hi).all()
    assert tbinned.subtree_bins(blob3[1], 1)[0].shape[0] <= 8
    assert tbinned.subtree_bins(blob3[1], 2)[0].shape[0] > 8
    assert (tbinned.subtree_bins(shallow[1], 2)[0] <= -2).sum() >= 8


@pytest.mark.parametrize("kw", [dict(depth=2, max_candidates=4),
                                dict(depth=2, max_candidates=1),
                                dict(depth=3, max_candidates=8)],
                         ids=["c4", "c1_residual", "depth3"])
def test_binned_matches_flat_and_rtk_tpu(blob3, kw):
    """Closest-hit against the port's flat trace and (at depth 2)
    rtk_tpu's binned engine, then any-hit masks (test_binned.py:34-76)."""
    jp, tp = blob3
    jrays, rays = _rays(512, 3)
    got = tbinned.trace_packets_binned(tp, rays, **kw)
    _assert_flat_parity(got, trace_packets(tp, rays))
    if kw["depth"] == 2:  # test_binned.py's cut (rtk_tpu's rounds are slow)
        _check(got, jbinned.trace_packets_binned(jp, jrays, interpret=True,
                                                 **kw))
    ga = tbinned.trace_packets_binned(tp, rays, mode="any", **kw)
    assert torch.equal(ga.hit, trace_packets(tp, rays, mode="any").hit)


def test_binned_leaf_roots(shallow):
    """Bins whose roots are leaves start their rounds at the leaf: the
    records meet the flat trace's bar and rtk_tpu's binned engine's, in
    both modes and under a candidate cap of 1 (the residual)."""
    jp, tp = shallow
    roots = tbinned.subtree_bins(tp, 1)[0]
    assert (roots <= -2).any() and (roots >= 0).any()
    jrays, rays = _rays(256, 5)
    for c in (8, 1):
        got = tbinned.trace_packets_binned(tp, rays, depth=1,
                                           max_candidates=c)
        assert got.hit.any()
        _assert_flat_parity(got, trace_packets(tp, rays))
        _check(got, jbinned.trace_packets_binned(jp, jrays, interpret=True,
                                                 depth=1, max_candidates=c))
    for depth in (1, 2):
        ga = tbinned.trace_packets_binned(tp, rays, mode="any", depth=depth)
        assert torch.equal(ga.hit, trace_packets(tp, rays, mode="any").hit)


def test_bins_cache_holds_its_table(blob3):
    """The cache is keyed by the node table and holds it, so a new table
    never receives another's bins; a 16-wide table is refused."""
    _, tp = blob3
    a = tbinned._BINS.get(tp, 2)
    assert tbinned._BINS.get(tp, 2) is a
    copy = pack_scene(rt.build_scene(
        (scenes.blob(2)[0].reshape(-1, 3),
         np.arange(scenes.blob(2)[0].shape[0] * 3).reshape(-1, 3)),
        rt.BuildConfig(leaf_size=8), device=CPU))
    b = tbinned._BINS.get(copy, 2)
    assert b[3] != a[3] or not torch.equal(b[0], a[0])
    wide = dataclasses.replace(tp, branching=16)
    with pytest.raises(ValueError, match="8-wide"):
        tbinned.subtree_bins(wide, 2)
