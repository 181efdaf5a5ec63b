"""utils/aot.py: the serving artifact reloads and gives the direct call's
records bit for bit (rtk_tpu's LoadedTrace at trace tolerance), serves
every scene of its pinned shapes, refuses other shapes and foreign blobs,
and loads in a process that cannot import jax.  A "cuda" artifact embeds
the kernel library, which needs nvcc: that test is in
tests/test_torch_kernel.py, which runs on the card.  Here a host build of
that library (tests/test_torch_kernel_host.py) stands in for nvcc's, to
show that the artifact binds the sorted front end's entry points (the
coherence key, the unsort) from the library it embeds."""
import dataclasses
import io
import os
import shutil
import struct
import subprocess
import sys
import textwrap
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu.scene import build_from_soup as jbuild_from_soup
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace.packed import pack_scene as jpack_scene
from rtk_tpu.utils import aot as jaot
from rtk_tpu_torch.ops.packet_trace import trace_packets, trace_packets_refit
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene
from rtk_tpu_torch.utils import aot, serialize

from test_torch_kernel_host import (KEY_CASES, host_key, host_library,
                                    host_rows, rows_batch, same_bits)
from test_torch_trace import CPU, _check, _rays

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKET = ("hit", "slot", "t", "u", "v")


def _same(got, want, fields=PACKET):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def _packed(tris=None, device=CPU):
    tris = scenes.cornell_box() if tris is None else tris
    return pack_scene(rt.build_from_soup(
        tris, config=rt.BuildConfig(branching=8, leaf_size=8),
        device=device))


@pytest.mark.smoke
def test_aot_roundtrip_matches_direct():
    packed = _packed()
    jrays = jax_scenes.cornell_camera(32, 32)
    rays = _rays(jrays)
    lt = aot.load_packet_trace(
        aot.export_packet_trace(packed, rays.count, interpret=True))
    assert lt.n_rays == rays.count and lt.platforms == ("cpu",)
    got = lt(packed, rays)
    _same(got, trace_packets(packed, rays, interpret=True))
    # Lazy hit assembly works off the caller's packed tables.
    assert torch.equal(got.triangle_index,
                       trace_packets(packed, rays).triangle_index)
    jpacked = jpack_scene(jbuild_from_soup(
        jnp.asarray(scenes.cornell_box()),
        config=rtk_tpu.BuildConfig(branching=8, leaf_size=8)))
    jlt = jaot.load_packet_trace(
        jaot.export_packet_trace(jpacked, jrays.count, interpret=True))
    _check(got, jlt(jpacked, jrays))


def test_aot_artifact_serves_refit_tables():
    """One artifact serves any scene with the same table shapes: trace a
    DEFORMED rebuild of the same topology through an artifact exported
    for the original (the refit-sequence serving pattern)."""
    rng = np.random.default_rng(3)
    base = scenes.cornell_box()
    packed0 = _packed(base)
    jig = base + rng.normal(scale=1e-3, size=base.shape).astype(np.float32)
    packed1 = _packed(jig)
    assert packed1.nodes.shape == packed0.nodes.shape
    rays = scenes.cornell_camera(16, 16, device=CPU)
    lt = aot.load_packet_trace(aot.export_packet_trace(packed0, rays.count))
    got = lt(packed1, rays)
    _same(got, trace_packets(packed1, rays))
    assert not torch.equal(got.t, trace_packets(packed0, rays).t)


def test_aot_refit_trace_roundtrip():
    """export_refit_trace: one artifact animates a deforming mesh, one
    call a frame (refit + repack + trace); hit records interpolate the
    deformed geometry through the returned vertex table."""
    grid0 = scenes.deforming_grid(0.0, n=8)  # 128 tris
    scene = rt.build_from_soup(grid0, config=rt.BuildConfig(branching=8,
                                                            leaf_size=8),
                               device=CPU)
    packed = pack_scene(scene)
    rays = scenes.camera_rays((0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 16, 16,
                              device=CPU)
    lt = aot.load_refit_trace(aot.export_refit_trace(
        packed, scene, rays.count, interpret=True, sort_rays=True))
    assert lt.n_rays == rays.count
    for tphase in (0.2, 0.5):
        frame = torch.as_tensor(scenes.deforming_grid(tphase, n=8))
        got = lt(packed, frame, rays)
        ref, _, rp = trace_packets_refit(packed, scene, frame, rays,
                                         sort_rays=True)
        _same(got, ref, PACKET + ("tri_v", "tri_prim"))
        assert torch.equal(got.tri_v, rp.tri_v)
        assert not torch.equal(got.tri_v, packed.tri_v)


def test_aot_filter_and_flags_are_pinned():
    """A jit_filter predicate rides in the artifact as its captured
    expression (the plain version evaluates it; a CUDA artifact embeds its
    kernel build), with defer_uv and a filter mask; the artifact's records
    equal the direct call's."""
    tris = scenes.blob(3)[0]
    mask = np.where(np.arange(tris.shape[0]) % 3 == 0, 1, 2).astype(
        np.uint32)
    packed = pack_scene(rt.build_from_soup(
        tris, config=rt.BuildConfig(leaf_size=8), device=CPU), tri_mask=mask)
    rays = scenes.camera_rays((0, 0, 3), (0, 0, 0), (0, 1, 0), 45, 24, 24,
                              device=CPU)
    odd = rt.jit_filter(lambda c: (c.triangle_index % 2 == 1)
                        | (c.ray_index < 40))
    kw = dict(filter_fn=odd, defer_uv=True, filter_mask=2, mode="any")
    lt = aot.load_packet_trace(aot.export_packet_trace(packed, rays.count,
                                                       **kw))
    assert lt._filter.key == odd.key
    got = lt(packed, rays)
    assert got.uv_deferred and got.hit.any()
    _same(got, trace_packets(packed, rays, **kw))


def test_aot_refuses_other_shapes_and_keywords():
    packed = _packed()
    rays = scenes.cornell_camera(16, 16, device=CPU)
    lt = aot.load_packet_trace(aot.export_packet_trace(packed, rays.count))
    with pytest.raises(ValueError, match="argument 2"):
        lt(packed, rays[:100])
    with pytest.raises(ValueError, match="argument 0"):
        lt(_packed(scenes.blob(2)[0]), rays)
    with pytest.raises(ValueError, match="argument 4"):
        lt(packed, rt.Rays(rays.origin, rays.direction,
                           rays.min_t.double(), rays.max_t))
    with pytest.raises(ValueError, match="leaf size"):
        lt(dataclasses.replace(packed, leaf_size=4), rays)
    grid = scenes.deforming_grid(0.0, n=8)
    scene = rt.build_from_soup(grid, config=rt.BuildConfig(leaf_size=8),
                               device=CPU)
    lr = aot.load_refit_trace(aot.export_refit_trace(pack_scene(scene), scene,
                                                     rays.count))
    with pytest.raises(ValueError, match="argument 0"):
        lr(pack_scene(scene), grid[:100], rays)
    for kw, what in (({"stats": True}, "cannot pin"),
                     ({"ray_roots": None}, "cannot pin"),
                     ({"mode": "nearest"}, "unknown mode"),
                     ({"pkt": 100}, "multiple of 128"),
                     ({"platforms": ["tpu"]}, "platforms")):
        with pytest.raises(ValueError, match=what):
            aot.export_packet_trace(packed, 64, **kw)
    with pytest.raises(TypeError, match="jit_filter"):
        aot.export_packet_trace(packed, 64,
                                filter_fn=lambda c: c.t > 1.0)


def test_aot_refuses_foreign_blobs():
    """A wrong magic, container version, kind or artifact version
    raises."""
    packed = _packed()
    blob = aot.export_packet_trace(packed, 64)
    with pytest.raises(ValueError, match="bad magic"):
        aot.load_packet_trace(b"\0NOT_RTK" + blob[8:])
    old = bytearray(blob)
    struct.pack_into("<I", old, 12, 1)
    with pytest.raises(ValueError, match="unsupported version"):
        aot.load_packet_trace(bytes(old))
    scene_blob = io.BytesIO()
    serialize.save_packed_scene(packed, scene_blob)
    with pytest.raises(ValueError, match="kind 1"):
        aot.load_packet_trace(scene_blob.getvalue())
    with pytest.raises(ValueError, match="not a refit-trace"):
        aot.load_refit_trace(blob)
    future = bytearray(blob)
    # meta ints start at byte 32: (AOT_VERSION, n_rays)
    struct.pack_into("<q", future, 32, aot.AOT_VERSION + 1)
    with pytest.raises(ValueError, match="artifact version"):
        aot.load_packet_trace(bytes(future))


@pytest.mark.parametrize(
    "load,old_version", [("trace", 1), ("refit", 1), ("trace", 2),
                         ("refit", 2), ("trace", 3), ("refit", 3),
                         ("trace", 4), ("refit", 4), ("trace", 5),
                         ("refit", 5)],
    ids=["trace", "refit", "trace-v2", "refit-v2", "trace-v3", "refit-v3",
         "trace-v4", "refit-v4", "trace-v5", "refit-v5"])
def test_aot_refuses_a_version_1_artifact(load, old_version):
    """An artifact stamped with version 1 (exported before the library
    held the rows pass, rtk_ray_rows), version 2 (before it held the
    shade pass, rtk_shade), version 3 (before it held the refit and
    repack, csrc/refit.cu), version 4 (before it held the instance
    candidate slab, csrc/candidates.cu) or version 5 (before it held an
    instanced round's object rays and scatter, csrc/rounds.cu) is refused
    by the version check before its library is bound, with the loader's
    own error."""
    scene = rt.build_from_soup(scenes.cornell_box(),
                               config=rt.BuildConfig(leaf_size=8), device=CPU)
    packed = pack_scene(scene)
    blob, loader = ((aot.export_packet_trace(packed, 64),
                     aot.load_packet_trace) if load == "trace" else
                    (aot.export_refit_trace(packed, scene, 64),
                     aot.load_refit_trace))
    assert aot.AOT_VERSION == 6
    old = bytearray(blob)
    # meta ints start at byte 32: (AOT_VERSION, n_rays)
    struct.pack_into("<q", old, 32, old_version)
    with pytest.raises(ValueError,
                       match=f"unsupported artifact version {old_version}"):
        loader(bytes(old))


_SERVER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    import torch
    from rtk_tpu_torch.ops import packet_trace
    from rtk_tpu_torch.testing import scenes
    from rtk_tpu_torch.utils.aot import load_packet_trace
    from rtk_tpu_torch.utils.serialize import load_packed_scene
    packed = load_packed_scene(sys.argv[1], device="cpu")
    with open(sys.argv[2], "rb") as f:
        trace = load_packet_trace(f.read())
    hits = trace(packed, scenes.cornell_camera(16, 16, device="cpu"))
    torch.save({f: getattr(hits, f) for f in ("hit", "slot", "t", "u", "v")},
               sys.argv[3])
    assert not packet_trace.BUILD_SECONDS
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "rtk_tpu")
           and sys.modules[m] is not None]
    assert not bad, bad
""")


def test_aot_serves_in_a_process_without_jax(tmp_path):
    """A server process that cannot import jax loads the scene blob and
    the artifact, traces, and gives the direct call's records."""
    packed = _packed()
    rays = scenes.cornell_camera(16, 16, device=CPU)
    serialize.save_packed_scene(packed, tmp_path / "scene.rtk")
    (tmp_path / "trace.aot").write_bytes(
        aot.export_packet_trace(packed, rays.count))
    proc = subprocess.run(
        [sys.executable, "-c", _SERVER, str(tmp_path / "scene.rtk"),
         str(tmp_path / "trace.aot"), str(tmp_path / "out.pt")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = torch.load(tmp_path / "out.pt")
    _same(types.SimpleNamespace(**out), trace_packets(packed, rays))


def test_example_serve_aot(capfd):
    """examples/torch_serve_aot.py on the CPU at 16x16: the server process
    loads both files, builds nothing and sees the closed box hit."""
    import importlib.util
    import inspect

    spec = importlib.util.spec_from_file_location(
        "torch_serve_aot", os.path.join(REPO, "examples",
                                        "torch_serve_aot.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    assert inspect.signature(ex.main).parameters["device"].default == "cuda"
    ex.main(size=16, device="cpu")
    out = capfd.readouterr().out
    assert "kernel builds in this process: 0" in out, out
    assert "[serve] steady state" in out


def test_aot_cuda_artifact_binds_the_key_from_its_library(tmp_path,
                                                          monkeypatch):
    """An artifact exported for "cuda" embeds the one library that holds
    the traversal, the coherence key, the rows pass and the unsort, and
    the loader binds them from it: here the library is the host build (g++
    behind the CUDA stand-in header) put where nvcc's would be, and the
    loaded artifact's key and rows entry points give ops/morton.py's plain
    keys and the plain rows on CPU arrays.  The
    loader writes the library under tmp_path, not the package."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    from rtk_tpu_torch.ops import library, morton
    from rtk_tpu_torch.ops import packet_trace as pt

    so = host_library(tmp_path, "aot_host")
    monkeypatch.setattr(library, "kernel_library", lambda flt=None: (so, ""))
    monkeypatch.setattr(aot, "BUILD_DIR", tmp_path / "served")
    packed = _packed()
    rays = scenes.cornell_camera(32, 32, device=CPU)
    blob = aot.export_packet_trace(packed, rays.count,
                                   platforms=["cpu", "cuda"])
    lt = aot.load_packet_trace(blob)
    assert lt.platforms == ("cpu", "cuda") and lt._lib is not None
    served = list((tmp_path / "served").iterdir())
    assert [f.read_bytes() for f in served] == [so.read_bytes()]
    assert lt._lib.rtk_coherence_key.argtypes is not None
    assert lt._lib.rtk_unsort.argtypes is not None
    assert lt._lib.rtk_ray_rows.argtypes is not None
    parts, perm = rows_batch(257, 7)
    assert same_bits(host_rows(lt._lib, parts, perm),
                     pt.ray_rows_reference(*parts, perm))
    for name in ("scattered", "same_origin"):
        o, d = KEY_CASES[name]
        assert torch.equal(host_key(lt._lib, o, d),
                           morton.ray_coherence_key_reference(o, d)), name
    # On CPU arrays the artifact runs the plain versions.
    _same(lt(packed, rays), trace_packets(packed, rays))
