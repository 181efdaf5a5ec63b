"""trace_packets_kz_binned in the port: its records equal trace_packets'
on the same rays bit for bit (the kernel picks the shear axis per ray),
and meet tests/test_kz_binned.py's bar against rtk_tpu's dispatcher
(interpret mode) on the same tables."""
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.ops.pallas_trace import (
    trace_packets_kz_binned as jax_kz_binned)
from rtk_tpu.trace.packed import pack_scene as jax_pack_scene
from rtk_tpu_torch.ops.packet_trace import (trace_packets,
                                            trace_packets_kz_binned)
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene

from test_torch_trace import CPU, _soup_of

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tables():
    tris = scenes.blob(3)[0]
    cfg = dict(leaf_size=8)
    jp = jax_pack_scene(rtk_tpu.build_scene(_soup_of(tris),
                                            rtk_tpu.BuildConfig(**cfg)))
    tp = pack_scene(rt.build_scene(_soup_of(tris), rt.BuildConfig(**cfg),
                                   device=CPU))
    return jp, tp


def _batch(kind):
    rng = np.random.default_rng(4)
    n = 512
    if kind == "one_axis":  # every ray's dominant axis is z
        d = rng.normal(size=(n, 3)) * [0.3, 0.3, 1.0]
        d[:, 2] = np.where(d[:, 2] >= 0, 1.0, -1.0)
    else:
        d = rng.normal(size=(n, 3))
    o = rng.normal(size=(n, 3)) * 2
    if kind == "ties":  # |dx| == |dy| == |dz| on some rays
        d[::3] = np.sign(d[::3])
    o, d = o.astype(np.float32), d.astype(np.float32)
    return rtk_tpu.Rays.make(o, d), rt.Rays.make(o, d, device=CPU)


@pytest.mark.parametrize("kw", [{}, {"mode": "any"}, {"filter_mask": 1},
                                {"defer_uv": True}],
                         ids=["closest", "any", "mask", "defer_uv"])
@pytest.mark.parametrize("kind", ["mixed", "one_axis", "ties"])
def test_kz_binned_equals_trace_packets(tables, kind, kw):
    jp, tp = tables
    jrays, rays = _batch(kind)
    got = trace_packets_kz_binned(tp, rays, **kw)
    want = trace_packets(tp, rays, **kw)
    for f in ("hit", "t", "u", "v", "slot"):
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b), f
    if not kw:
        # tests/test_kz_binned.py's bar against rtk_tpu's dispatcher.
        ref = jax_kz_binned(jp, jrays, pkt=128, p_pk=8, interpret=True)
        rh = np.asarray(ref.hit)
        np.testing.assert_array_equal(got.hit.numpy(), rh)
        np.testing.assert_allclose(got.t.numpy()[rh], np.asarray(ref.t)[rh],
                                   rtol=1e-6, atol=1e-6)
        same = rh & (got.triangle_index.numpy()
                     == np.asarray(ref.triangle_index))
        assert same.sum() / max(rh.sum(), 1) > 0.95
        miss = ~got.hit
        assert torch.equal(got.t[miss], rays.max_t[miss])
        assert bool((got.slot[miss] == -1).all())


def test_kz_binned_passes_flags_on(tables):
    """pkt and the other keywords reach trace_packets, whose checks apply
    (rtk_tpu raises the same ValueErrors)."""
    _, tp = tables
    _, rays = _batch("mixed")
    with pytest.raises(ValueError, match="pkt"):
        trace_packets_kz_binned(tp, rays, pkt=100)
    with pytest.raises(ValueError, match="narrow"):
        trace_packets_kz_binned(tp, rays, narrow=False)
