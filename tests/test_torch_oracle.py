"""The port's small host-side pieces against rtk_tpu's: the f64 brute-force
oracle, the SSE BVH4 oracle, the threaded native mesh decode, scene_bounds,
sort_by_morton and uniform_kz."""
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu import oracle as joracle
from rtk_tpu.ops import morton as jmorton
from rtk_tpu.ops.pallas_trace import uniform_kz as jax_uniform_kz
from rtk_tpu_torch import mesh as tmesh
from rtk_tpu_torch import oracle as toracle
from rtk_tpu_torch.ops import morton as tmorton
from rtk_tpu_torch.ops.packet_trace import uniform_kz
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.utils import native_host
from rtk_tpu_torch.utils.native_sah import NativeOracle, NativeOracleSSE

from test_torch_trace import CPU, _soup_of

torch.set_num_threads(2)

HIT_FIELDS = ("hit", "t", "u", "v", "mesh_index", "triangle_index",
              "vertex_position", "vertex_index")


def _soup(seed, n):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 1, 3))
    return (c + 0.3 * rng.normal(size=(n, 3, 3))).astype(np.float32)


def _seeded_rays(seed, n):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    min_t = np.where(rng.random(n) < 0.2, 0.5, 0.0).astype(np.float32)
    max_t = np.where(rng.random(n) < 0.2, 2.0, 1e30).astype(np.float32)
    return o, d, min_t, max_t


@pytest.mark.parametrize("seed,n_tris,chunk", [(0, 300, 4096), (1, 700, 256),
                                               (2, 64, 64)])
def test_trace_brute_equals_reference(seed, n_tris, chunk):
    """Every field of the record equal, t, u and v bit for bit, on seeded
    soups (chunk boundaries inside and at the end of the soup)."""
    tris = _soup(seed, n_tris)
    o, d, mn, mx = _seeded_rays(seed + 10, 600)
    want = joracle.trace_brute(tris, rtk_tpu.Rays.make(o, d, mn, mx),
                               chunk=chunk)
    got = toracle.trace_brute(tris, rt.Rays.make(o, d, mn, mx, device=CPU),
                              chunk=chunk)
    assert 0.05 < got.hit.float().mean() < 1.0
    for f in HIT_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_trace_brute_metadata_and_ties():
    """Per-triangle metadata is carried, and of two coincident triangles
    the earlier wins, as in the reference."""
    tris = np.concatenate([_soup(3, 40)] * 2)
    o, d, mn, mx = _seeded_rays(4, 300)
    meta = dict(tri_mesh=np.arange(80, dtype=np.int32) // 40,
                tri_prim=np.arange(80, dtype=np.int32)[::-1].copy(),
                tri_vidx=np.arange(240, dtype=np.int32).reshape(80, 3) * 2)
    want = joracle.trace_brute(tris, rtk_tpu.Rays.make(o, d, mn, mx), **meta)
    got = toracle.trace_brute(tris, rt.Rays.make(o, d, mn, mx, device=CPU),
                              **meta)
    for f in HIT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.hit.any() and int(got.mesh_index.max()) == 0


def test_trace_brute_anchors_the_packet_trace():
    """The port's packet trace against its own oracle, at
    tests/test_trace.py's bar: hits equal, t within 1e-4."""
    tris = scenes.blob(2)[0]
    rays = scenes.camera_rays((0, 0, 3), (0, 0, 0), (0, 1, 0), 45, 24, 24,
                              device=CPU)
    want = toracle.trace_brute(tris, rays)
    got = rt.Tracer(rt.build_scene(_soup_of(tris), device=CPU)).closest(rays)
    assert torch.equal(got.hit, want.hit)
    h = want.hit
    np.testing.assert_allclose(got.t[h].numpy(), want.t[h].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_sse_bvh4_matches_scalar():
    """tests/test_native_oracle.py:105-134 on the port's binding: the same
    hit mask, t within rtol 1e-5 / atol 1e-6, over 95% of hits on the same
    triangle with u, v within 1e-4, and the any-hit mask."""
    tris = scenes.blob(subdivisions=3)[0]
    cam = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 48, 48,
                             device=CPU)
    o, d, mn, mx = (getattr(cam, f).numpy()
                    for f in ("origin", "direction", "min_t", "max_t"))
    a = NativeOracle(tris.reshape(-1, 9))
    b = NativeOracleSSE(tris.reshape(-1, 9))
    ta, ua, va, ia = a.trace(o, d, mn, mx)
    tb, ub, vb, ib = b.trace(o, d, mn, mx)
    hm = ia >= 0
    assert 0 < hm.sum() < hm.size
    np.testing.assert_array_equal(hm, ib >= 0)
    np.testing.assert_allclose(tb[hm], ta[hm], rtol=1e-5, atol=1e-6)
    same = hm & (ia == ib)
    assert same.sum() / max(hm.sum(), 1) > 0.95
    np.testing.assert_allclose(ub[same], ua[same], atol=1e-4)
    np.testing.assert_allclose(vb[same], va[same], atol=1e-4)
    _, _, _, i2 = b.trace(o, d, mn, mx, mode="any")
    np.testing.assert_array_equal(i2 >= 0, hm)


def test_sse_oracle_equals_reference_binding():
    """The same C++ source through both packages' bindings."""
    from rtk_tpu.utils.native_sah import NativeOracleSSE as JaxSSE

    tris = scenes.blob(2)[0].reshape(-1, 9)
    o, d, mn, mx = _seeded_rays(5, 500)
    for got, want in zip(NativeOracleSSE(tris, leaf_max=2).trace(o, d, mn, mx),
                         JaxSSE(tris, leaf_max=2).trace(o, d, mn, mx)):
        np.testing.assert_array_equal(got, want)


needs_toolchain = pytest.mark.skipif(not native_host.available(),
                                     reason="no C++ toolchain")


@needs_toolchain
def test_native_host_decode_matches_numpy():
    """tests/test_native_oracle.py:69-100 on the port's binding."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=(5000, 3)).astype(np.float32)
    rec = np.zeros((5000, 4), np.float32)
    rec[:, :3] = v
    got = native_host.decode_positions(rec.tobytes(), 5000, 16, "f32")
    np.testing.assert_array_equal(got, v)
    v64 = rng.normal(size=(3000, 3))
    got = native_host.decode_positions(v64.tobytes(), 3000, 24, "f64")
    np.testing.assert_array_equal(got, v64.astype(np.float32))
    idx = rng.integers(0, 60000, size=4096).astype(np.uint16)
    buf = np.zeros((4096, 4), np.uint16)
    buf[:, 0] = idx
    got = native_host.decode_indices(buf.tobytes(), 4096, 8, "u16")
    np.testing.assert_array_equal(got, idx.astype(np.uint32))
    gi = rng.integers(0, 5000, size=9999).astype(np.uint32)
    np.testing.assert_array_equal(native_host.gather_soup(v, gi), v[gi])


def _raw_mesh(n_verts, n_tris, pos_type, idx_type, rng):
    """A MeshDesc of raw strided buffers: vertex records with one
    component of padding, index records with one of padding."""
    pdt = {"f32": np.float32, "f64": np.float64}[pos_type]
    idt = {"u16": np.uint16, "u32": np.uint32}[idx_type]
    rec = np.zeros((n_verts, 4), pdt)
    rec[:, :3] = rng.normal(size=(n_verts, 3))
    ibuf = np.zeros((n_tris * 3, 2), idt)
    ibuf[:, 0] = rng.integers(0, min(n_verts, np.iinfo(idt).max),
                              size=n_tris * 3)
    return tmesh.MeshDesc(
        num_triangles=n_tris, positions=rec.tobytes(),
        position_stride=rec.itemsize * 4, position_type=pos_type,
        indices=ibuf.tobytes(), index_stride=ibuf.itemsize * 2,
        index_type=idx_type)


@needs_toolchain
@pytest.mark.parametrize("pos_type,idx_type", [("f32", "u32"),
                                               ("f64", "u16")])
@pytest.mark.parametrize("n_verts,n_tris", [
    ((1 << 18) + 5, (1 << 18) // 3 + 7),  # every decode takes the C++ path
    (3000, 1000)])  # every decode stays in NumPy
def test_native_decode_hook_equals_numpy(monkeypatch, pos_type, idx_type,
                                         n_verts, n_tris):
    """build_soup through the threaded C++ decode equals the NumPy decode
    byte for byte, above and below NATIVE_DECODE_MIN; the hook is taken
    exactly when a count reaches it."""
    m = _raw_mesh(n_verts, n_tris, pos_type, idx_type,
                  np.random.default_rng(n_verts))
    calls = []
    real = tmesh._native

    def spy():
        calls.append(1)
        return real()

    monkeypatch.setattr(tmesh, "_native", spy)
    native = tmesh.build_soup(m)
    big = n_tris * 3 >= tmesh.NATIVE_DECODE_MIN
    assert len(calls) == (3 if big else 0)
    monkeypatch.setattr(tmesh, "_native", lambda: None)
    plain = tmesh.build_soup(m)
    for f in ("tri_pos", "tri_vidx", "tri_mesh", "tri_prim"):
        a, b = getattr(native, f), getattr(plain, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # And rtk_tpu's decode of the same buffers.
    want = rtk_tpu.mesh.build_soup(rtk_tpu.MeshDesc(**{
        k: getattr(m, k) for k in (
            "num_triangles", "positions", "position_stride", "position_type",
            "indices", "index_stride", "index_type")}))
    assert want.tri_pos.tobytes() == native.tri_pos.tobytes()
    assert want.tri_vidx.tobytes() == native.tri_vidx.tobytes()


def test_scene_bounds_and_sort_by_morton_equal_reference():
    import jax.numpy as jnp

    tris = _soup(6, 500)
    lo, hi = tmorton.scene_bounds(torch.tensor(tris))
    jlo, jhi = jmorton.scene_bounds(jnp.asarray(tris))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    cent = tris.mean(axis=1)
    codes = tmorton.morton3d(torch.tensor(cent), lo, hi, bits=4)  # many ties
    jcodes = jmorton.morton3d(jnp.asarray(cent), jlo, jhi, bits=4)
    assert len(np.unique(codes.numpy())) < 400
    s, perm = tmorton.sort_by_morton(codes)
    js, jperm = jmorton.sort_by_morton(jcodes)
    np.testing.assert_array_equal(s.numpy().astype(np.uint32), np.asarray(js))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("case", ["x", "y", "z", "tie_xy", "tie_yz", "mixed",
                                  "one"])
def test_uniform_kz_equals_reference(case):
    rng = np.random.default_rng(7)
    d = rng.uniform(-0.4, 0.4, (256, 3)).astype(np.float32)
    if case in "xyz":
        d[:, "xyz".index(case)] = rng.choice([-1.0, 1.0], 256)
    elif case == "tie_xy":  # x beats y at equal magnitude
        d[:, 0], d[:, 1] = 0.9, -0.9
    elif case == "tie_yz":
        d[:, 1], d[:, 2] = -0.7, 0.7
    elif case == "mixed":
        d[:128, 0], d[128:, 2] = 1.0, -1.0
    else:
        d = d[:1]
    want = jax_uniform_kz(rtk_tpu.Rays.make(np.zeros_like(d), d))
    got = uniform_kz(rt.Rays.make(np.zeros_like(d), d, device=CPU))
    assert got == want
    assert got == {"x": 0, "y": 1, "z": 2, "tie_xy": 0, "tie_yz": 1,
                   "mixed": None}.get(case, got)
