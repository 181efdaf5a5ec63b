"""trace/stackless.py in the port against rtk_tpu's: the entity table bit
for bit on the same Scene (blob(3), the Cornell box, a single-leaf scene;
each through the parameter carry as well), and the trace (closest,
sort_rays, any) against rtk_tpu's stackless engine and the port's flat
trace, on rtk_tpu's entity table fed to the port too
(tests/test_trace.py:184-203's cases)."""
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace import stackless as jstackless
from rtk_tpu_torch.ops.packet_trace import trace_packets
from rtk_tpu_torch.testing import carry, scenes
from rtk_tpu_torch.trace import stackless as tstackless

from test_torch_trace import CPU, _check, _rays, _soup_of

torch.set_num_threads(2)

SCENES = {"cornell": (lambda: scenes.cornell_box(), 4),
          "blob3": (lambda: scenes.blob(3)[0], 8),
          "single_leaf": (lambda: scenes.cornell_box()[:3], 4)}


@pytest.fixture(scope="module")
def built():
    """Each scene built by both packages, and both entity tables."""
    out = {}
    for name, (make, leaf) in SCENES.items():
        tris = make()
        js = rtk_tpu.build_scene(_soup_of(tris),
                                 rtk_tpu.BuildConfig(leaf_size=leaf))
        ts = rt.build_scene(_soup_of(tris), rt.BuildConfig(leaf_size=leaf),
                            device=CPU)
        out[name] = (js, jstackless.build_stackless(js), ts,
                     tstackless.build_stackless(ts))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_entities_bit_equal(built, name):
    _, jsl, ts, tsl = built[name]
    assert tsl.num_entities == jsl.num_entities
    assert np.array_equal(tsl.entities.numpy(), np.asarray(jsl.entities))
    assert (ts.num_leaves == 1) == (name == "single_leaf")
    carried = carry.stackless_from_arrays(
        {k: np.asarray(getattr(jsl, k)) for k in carry.STACKLESS_ARRAYS},
        num_tris=jsl.num_tris, device=CPU)
    for k in carry.STACKLESS_ARRAYS:
        got, want = getattr(carried, k), getattr(tsl, k)
        assert got.dtype == want.dtype and torch.equal(got, want), k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_matches_rtk_tpu(built, name):
    """Closest-hit at test_packet.py's bar against rtk_tpu's stackless
    engine and the port's flat trace; sort_rays gives the same records in
    the caller's order; any-hit masks equal the closest-hit mask."""
    js, jsl, ts, tsl = built[name]
    jrays = (jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                                    16, 16) if name == "blob3"
             else jax_scenes.cornell_camera(16, 16))
    rays = _rays(jrays)
    got = tstackless.trace_stackless(tsl, rays)
    want = jstackless.trace_stackless(jsl, jrays)
    _check(got, want)
    flat = trace_packets(rt.Tracer(ts).packed, rays)
    assert torch.equal(got.hit, flat.hit)
    np.testing.assert_allclose(got.t[got.hit].numpy(),
                               flat.t[flat.hit].numpy(), atol=1e-6)
    if name == "cornell":  # the closed box
        assert got.hit.all()
    assert torch.equal(tstackless.trace_stackless(tsl, rays,
                                                  sort_rays=True).t, got.t)
    ga = tstackless.trace_stackless(tsl, rays, mode="any")
    assert torch.equal(ga.hit, got.hit)
    # rtk_tpu's own table, carried, traces the same records.
    carried = carry.stackless_from_arrays(
        {k: np.asarray(getattr(jsl, k)) for k in carry.STACKLESS_ARRAYS},
        num_tris=jsl.num_tris, device=CPU)
    again = tstackless.trace_stackless(carried, rays)
    for f in ("hit", "t", "u", "v", "triangle_index"):
        assert torch.equal(getattr(again, f), getattr(got, f)), f


def test_tracer_stackless_engine(built):
    """Tracer(engine="stackless") builds the table once, refuses
    filter_mask as rtk_tpu does, routes a filter callable to the stack
    engine, and refresh drops the table."""
    _, _, ts, _ = built["cornell"]
    tracer = rt.Tracer(ts, engine="stackless")
    rays = scenes.cornell_camera(8, 8, device=CPU)
    hits = tracer.closest(rays)
    assert isinstance(hits, rt.Hits) and bool(hits.hit.all())
    table = tracer.stackless
    tracer.any(rays)
    assert tracer.stackless is table
    with pytest.raises(ValueError, match="filter_mask"):
        tracer.closest(rays, filter_mask=1)
    by_stack = tracer.closest(rays, filter_fn=lambda c: c.t > 0.5)
    assert torch.equal(by_stack.hit, hits.hit)
    assert tracer.refresh(ts)._stackless is None
