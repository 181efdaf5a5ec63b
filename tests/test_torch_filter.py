"""Filter callables in the port against rtk_tpu: the packet trace's plain
version with a jit_filter predicate against rtk_tpu's Pallas kernel
(interpret mode) and against rtk_tpu's stack engine; the port's stack
engine; the Tracer's routing; and the captured predicate's C++ compiled
with g++ against the same callable on torch tensors (the only check of the
generated code on a machine without nvcc)."""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.ops.pallas_trace import trace_packets as jax_trace_packets
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace import stack as jstack
from rtk_tpu.trace.packed import pack_scene as jax_pack_scene
from rtk_tpu_torch.ops import filter_capture
from rtk_tpu_torch.ops.packet_trace import trace_packets
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene
from rtk_tpu_torch.types import HitCandidate

from test_torch_trace import CPU, _carry, _rays, _soup_of

torch.set_num_threads(2)

T_RTOL = 1e-6  # tests/test_packet.py:337's bar (packet vs stack engine)

# Predicates of tests/test_packet.py:330-368 and tests/test_trace.py:
# 126-150, written with operators only so that rtk_tpu (jax), the port's
# plain version (torch) and jit_filter (symbolic) all run them.
PREDICATES = {
    "reject_all": lambda c: c.mesh_index < 0,
    "by_mesh": lambda c: c.mesh_index == 0,
    "by_tri_and_t": lambda c: (c.triangle_index % 3 == 1) & (c.t > 2.0),
    "by_ray": lambda c: c.ray_index % 2 == 0,
}


def _two_meshes():
    """cornell_box's walls and boxes as two meshes (test_trace.py:137)."""
    walls, boxes = scenes.cornell_box()[:10], scenes.cornell_box()[10:]
    return [_soup_of(walls), _soup_of(boxes)]


def _case(name):
    """(meshes, rtk_tpu rays) of a predicate's test scene."""
    if name == "by_mesh":
        return _two_meshes(), jax_scenes.cornell_camera(16, 16)
    return (_soup_of(scenes.blob(3)[0]),
            jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                                   16, 16))


def _check(got, want, what, name):
    """Hit equal, t within T_RTOL, triangle equal (test_packet.py:
    330-339).  cornell_box's quads split into two triangles whose shared
    diagonal the 16^2 camera hits exactly, where either may win a tie
    (ROADMAP §3): there, more than 90% on the same triangle, as
    tests/test_packet.py::_check allows."""
    wh = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), wh, err_msg=what)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=T_RTOL, err_msg=what)
    gt, wt = got.triangle_index.numpy(), np.asarray(want.triangle_index)
    if name == "by_mesh":
        assert (gt == wt)[wh].mean() > 0.9, what
    else:
        np.testing.assert_array_equal(gt, wt, err_msg=what)


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_plain_filter_matches_pallas_kernel(name):
    """trace_packets(filter_fn=jit_filter(f)) on the carried tables against
    rtk_tpu's packet kernel with the same callable, closest-hit."""
    meshes, jrays = _case(name)
    jscene = rtk_tpu.build_scene(meshes)
    jp = jax_pack_scene(jscene)
    fn = PREDICATES[name]
    want = jax_trace_packets(jp, jrays, interpret=True, filter_fn=fn)
    got = trace_packets(_carry(jp), _rays(jrays),
                        filter_fn=rt.jit_filter(fn))
    _check(got, want, "packet", name)
    if name != "reject_all":
        assert got.hit.any()
    else:
        assert not got.hit.any()


@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_filter_matches_jax_stack_engine(name, mode):
    """The port's two filter paths -- the packet trace's plain version with
    the captured predicate, and the stack engine with the plain callable
    -- against rtk_tpu's stack engine.  Any-hit: the hit mask, and every
    hit passes the predicate."""
    meshes, jrays = _case(name)
    fn = PREDICATES[name]
    jscene = rtk_tpu.build_scene(meshes)
    jfn = jstack.trace_closest if mode == "closest" else jstack.trace_any
    want = jfn(jscene, jrays, filter_fn=fn)
    scene = rt.build_scene(meshes, device=CPU)
    rays = _rays(jrays)
    tfn = rt.trace_closest if mode == "closest" else rt.trace_any
    for what, got in (
            ("stack", tfn(scene, rays, filter_fn=fn)),
            ("packet", getattr(rt.Tracer(scene), mode)(
                rays, filter_fn=rt.jit_filter(fn)))):
        if mode == "closest":
            _check(got, want, what, name)
        else:
            np.testing.assert_array_equal(got.hit.numpy(),
                                          np.asarray(want.hit))
            h = got.hit
            cand = HitCandidate(
                t=got.t[h], u=got.u[h], v=got.v[h],
                mesh_index=got.mesh_index[h],
                triangle_index=got.triangle_index[h],
                ray_index=torch.nonzero(h).squeeze(1).to(torch.int32))
            assert bool(fn(cand).all()) if h.any() else True


def test_ray_filter_survives_the_coherence_sort():
    tris = scenes.blob(3)[0]
    packed = pack_scene(rt.build_scene(_soup_of(tris), device=CPU))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 24,
                              24, device="cpu")
    even = torch.arange(rays.count) % 2 == 0
    base = trace_packets(packed, rays)
    flt = rt.jit_filter(PREDICATES["by_ray"])
    for sort_rays in (False, True):
        got = trace_packets(packed, rays, sort_rays=sort_rays, filter_fn=flt)
        assert torch.equal(got.hit, base.hit & even)


def test_filter_under_defer_uv_sees_u_and_v():
    """The predicate reads u and v under defer_uv too: the same records
    as without defer_uv."""
    tris = scenes.blob(3)[0]
    packed = pack_scene(rt.build_scene(_soup_of(tris), device=CPU))
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 24,
                              24, device="cpu")
    flt = rt.jit_filter(lambda c: (c.u > 0.25) & (c.v < 0.5))
    a = trace_packets(packed, rays, filter_fn=flt)
    b = trace_packets(packed, rays, filter_fn=flt, defer_uv=True)
    assert b.uv_deferred and a.hit.any()
    for f in ("hit", "t", "slot", "u", "v"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert bool(((a.u > 0.25) & (a.v < 0.5))[a.hit].all())


def test_tracer_routes_filters():
    """A jit_filter predicate stays on the packet engine, an unmarked
    callable goes to the stack engine (rtk_tpu/tracer.py:111-199), and
    filter_mask on the stack engine raises."""
    scene = rt.build_scene(_soup_of(scenes.cornell_box()), device=CPU)
    rays = scenes.cornell_camera(8, 8, device="cpu")
    fn = PREDICATES["by_tri_and_t"]
    tracer = rt.Tracer(scene)
    assert isinstance(tracer.closest(rays, filter_fn=rt.jit_filter(fn)),
                      rt.PacketHits)
    assert isinstance(tracer.closest(rays, filter_fn=fn), rt.Hits)
    stack = rt.Tracer(scene, engine="stack")
    assert stack.engine == "stack"
    with pytest.raises(ValueError, match="filter_mask"):
        stack.closest(rays, filter_mask=1)
    with pytest.raises(TypeError, match="jit_filter"):
        trace_packets(tracer.packed, rays, filter_fn=fn)


def test_filter_needs_exact_triangle_ids():
    """Triangle ids ride f32 columns: 2^24 triangles and more raise
    (pallas_trace.py:1719-1722)."""
    import dataclasses

    packed = pack_scene(rt.build_scene(_soup_of(scenes.cornell_box()),
                                       device=CPU))
    big = dataclasses.replace(packed, num_tris=1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        trace_packets(big, scenes.cornell_camera(4, 4, device="cpu"),
                      filter_fn=rt.jit_filter(PREDICATES["by_mesh"]))


@pytest.mark.parametrize("fn", [
    lambda c: (c.t > 0) and (c.u > 0),
    lambda c: c.t + 1.0,
    lambda c: np.abs(c.t) > 0,
    lambda c: torch.sin(c.t) > 0,
    lambda c: c.t.sum() > 0,
    lambda c: (c.t > 0) + 1,
    lambda c: (c.t & 1) == 0,
    lambda c: c.triangle_index < 2 ** 40,
    lambda c: jnp.zeros_like(c.t, dtype=bool),
], ids=["and", "float_result", "numpy", "torch_sin", "method",
        "bool_arith", "float_bitwise", "int_overflow", "jax_call"])
def test_jit_filter_refuses_what_it_cannot_capture(fn):
    with pytest.raises(TypeError, match="stack engine"):
        rt.jit_filter(fn)


# ---- the generated C++ against torch, through g++ ----

CAPTURED = {
    "tri_and_t": PREDICATES["by_tri_and_t"],
    "floor_ops": lambda c: (c.triangle_index // -3 + c.ray_index % -5
                            - c.mesh_index // 4 % 3) >= -2,
    "float_floor": lambda c: (c.t // 0.37 + c.u % -0.25 * 3.0
                              - c.v % 0.5) < c.t * 0.5,
    "promote": lambda c: (c.triangle_index / c.ray_index
                          + c.mesh_index * 0.1 > c.u - 7)
                         | (c.ray_index == 2.0),
    "bits_where": lambda c: torch.where(
        c.t != c.t, c.u > 0.5,
        ((c.triangle_index ^ ~c.ray_index) & 0xF0) != (abs(c.mesh_index) | 3)),
    "wrap_neg": lambda c: -(c.triangle_index * 1000003 - c.ray_index)
                          + abs(-c.t) * -2.0 <= 0.0,
    "constant": lambda c: False,
}


def _host_library(flt, tmp_path):
    """g++ build of the captured predicate with an array evaluator."""
    src = tmp_path / "pred.cpp"
    src.write_text(
        f'#include "{tmp_path / "pred.h"}"\n'
        'extern "C" void eval(int n, const float* t, const float* u,\n'
        '                     const float* v, const int* m, const int* p,\n'
        '                     const int* r, unsigned char* out) {\n'
        '  for (int i = 0; i < n; ++i)\n'
        '    out[i] = rtk_filter_pred(t[i], u[i], v[i], m[i], p[i], r[i]);\n'
        '}\n')
    (tmp_path / "pred.h").write_text(flt.source)
    so = tmp_path / "pred.so"
    subprocess.run(
        [shutil.which("g++"), "-std=c++17", "-O2", "-ffp-contract=off",
         "-shared", "-fPIC",
         f"-I{filter_capture.__file__.rsplit('/', 2)[0]}/csrc", str(src),
         "-o", str(so)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def _random_candidates(n, seed):
    """Candidates with negative and zero ints, zeros, signed zeros, NaN
    and infinite t, and int32 extremes."""
    rng = np.random.default_rng(seed)
    t = rng.normal(scale=3.0, size=n).astype(np.float32)
    t[rng.random(n) < 0.05] = np.nan
    t[rng.random(n) < 0.02] = np.inf
    t[rng.random(n) < 0.05] = 0.0
    t[rng.random(n) < 0.02] = -0.0
    u = rng.uniform(-1, 2, n).astype(np.float32)
    v = rng.uniform(-1, 2, n).astype(np.float32)
    v[rng.random(n) < 0.05] = 0.5

    def ints(lo, hi):
        a = rng.integers(lo, hi, n, dtype=np.int64)
        a[rng.random(n) < 0.1] = 0
        a[rng.random(n) < 0.01] = -2 ** 31
        a[rng.random(n) < 0.01] = 2 ** 31 - 1
        return a.astype(np.int32)

    m, p, r = ints(-9, 9), ints(-5000, 5000), ints(-300, 300)
    r[r == 0] = 1  # the int32 true-division operand of "promote"
    return t, u, v, m, p, r


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("name", sorted(CAPTURED))
def test_captured_cxx_matches_torch(name, tmp_path):
    fn = CAPTURED[name]
    flt = rt.jit_filter(fn)
    lib = _host_library(flt, tmp_path)
    arrays = _random_candidates(4096, seed=len(name))
    n = arrays[0].shape[0]
    out = np.zeros(n, np.uint8)
    lib.eval(ctypes.c_int(n), *(a.ctypes.data_as(ctypes.c_void_p)
                                for a in arrays),
             out.ctypes.data_as(ctypes.c_void_p))
    cand = HitCandidate(*(torch.as_tensor(a) for a in arrays))
    want = fn(cand)
    want = (torch.full((n,), bool(want)) if isinstance(want, bool)
            else want)
    assert want.dtype == torch.bool
    np.testing.assert_array_equal(out.astype(bool), want.numpy())
