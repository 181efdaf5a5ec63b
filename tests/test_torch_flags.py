"""The TPU schedule flags that rtk_tpu refuses in combination: the
port's trace_packets, trace_packets_refit and trace_packets_refit_frames
raise ValueError wherever rtk_tpu's raise, on the same flags, and accept
what rtk_tpu accepts (pallas_trace.py:1579-1585, :1651-1693, :1983,
:2091)."""
import numpy as np
import pytest

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.ops import pallas_trace as jpt
from rtk_tpu.trace.packed import pack_scene as jax_pack_scene
from rtk_tpu_torch.ops import packet_trace as pt
from rtk_tpu_torch.trace.packed import pack_scene

CPU = "cpu"

# name -> (flags, leaf size).  Leaves of 4 are not lane-aligned (% 8).
CASES = {
    "kz_static_3": ({"kz_static": 3}, 8),
    "kz_static_wide": ({"kz_static": 0, "narrow": False}, 8),
    "pkt_100": ({"pkt": 100}, 8),
    "pkt_100_roots": ({"pkt": 100, "packet_roots": np.zeros(2, np.int32),
                       "sort_rays": False}, 8),
    "tris128_leaf4": ({"tris128": True}, 4),
    "tris128_wide": ({"tris128": True, "narrow": False}, 8),
    "leaf_loop_leaf4": ({"leaf_loop": True}, 4),
    "leaf_loop_wide": ({"leaf_loop": True, "narrow": False}, 8),
    "hbm_tris_leaf4": ({"hbm_tris": True}, 4),
}
FRONTS = ("trace_packets", "trace_packets_refit",
          "trace_packets_refit_frames")


@pytest.fixture(scope="module")
def soups():
    """64 random triangles and 64 rays, both packages' scenes and tables
    at leaf 4 and 8."""
    rng = np.random.default_rng(0)
    tris = rng.normal(size=(64, 3, 3)).astype(np.float32)
    o = (rng.normal(size=(64, 3)) * 0.1).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    out = {"tris": tris, "jrays": rtk_tpu.Rays.make(o, d),
           "rays": rt.Rays.make(o, d, device=CPU)}
    for leaf in (4, 8):
        js = rtk_tpu.build_from_soup(
            tris, config=rtk_tpu.BuildConfig(leaf_size=leaf))
        ts = rt.build_from_soup(tris, config=rt.BuildConfig(leaf_size=leaf),
                                device=CPU)
        out[leaf] = (js, jax_pack_scene(js), ts, pack_scene(ts))
    return out


def _call(mod, front, scene, packed, tris, rays, kw):
    if front == "trace_packets":
        extra = {"interpret": True} if mod is jpt else {}
        return mod.trace_packets(packed, rays, **extra, **kw)
    if mod is jpt:
        kw = dict(kw, interpret=True)
    if front == "trace_packets_refit":
        return mod.trace_packets_refit(packed, scene, tris, rays, **kw)
    return mod.trace_packets_refit_frames(packed, scene, tris[None], rays,
                                          **kw)


def _outcome(fn):
    try:
        fn()
    except TypeError as e:
        # A flag the front end does not take, or a failure further in.
        return TypeError if "unexpected keyword" in str(e) else Exception
    except ValueError:
        return ValueError
    except Exception:  # noqa: BLE001  any other failure
        return Exception
    return None


@pytest.mark.parametrize("front", FRONTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_flags_refused_where_rtk_tpu_refuses_them(soups, case, front):
    """Both packages raise ValueError on the same flags; a flag a front end
    does not take is a TypeError in both; what rtk_tpu accepts the port
    accepts.  rtk_tpu's refit front ends fail on hbm_tris with leaves of 4
    deep in the TPU program (not with a ValueError); the port refuses the
    flag up front, as its trace_packets does."""
    kw, leaf = CASES[case]
    js, jp, ts, tp = soups[leaf]
    want = _outcome(lambda: _call(jpt, front, js, jp, soups["tris"],
                                  soups["jrays"], kw))
    got = _outcome(lambda: _call(pt, front, ts, tp, soups["tris"],
                                 soups["rays"], kw))
    assert got == (ValueError if want is Exception else want), (want, got)
    if front == "trace_packets":
        assert got is ValueError  # every case is one rtk_tpu refuses


def test_unset_flags_still_trace(soups):
    """narrow=None is the reference's True and pkt=None a valid width: the
    flags rtk_tpu accepts on aligned leaves trace, with the records of a
    call without them."""
    _, _, ts, tp = soups[8]
    rays = soups["rays"]
    want = pt.trace_packets(tp, rays)
    for kw in ({"narrow": None, "pkt": None},
               {"narrow": None, "pkt": None, "kz_static": 1,
                "leaf_loop": True, "tris128": True, "hbm_tris": True},
               {"pkt": 256, "narrow": True, "kz_static": 2},
               {"pkt": None, "packet_roots": np.zeros(1, np.int32),
                "sort_rays": False}):
        got = pt.trace_packets(tp, rays, **kw)
        for f in ("hit", "t", "u", "v", "slot"):
            assert np.array_equal(getattr(got, f).numpy(),
                                  getattr(want, f).numpy()), (kw, f)
    hits, _, _ = pt.trace_packets_refit(tp, ts, soups["tris"], rays,
                                        narrow=None, pkt=100,
                                        leaf_loop=True)
    assert np.array_equal(hits.t.numpy(), want.t.numpy())
