"""Serialization of the port against rtk_tpu, byte for byte both ways: a
blob saved by rtk_tpu loads in the port with equal arrays, and the port's
blob of the same scene, packed scene and instanced scene equals rtk_tpu's
bytes.  Also the header checks, the branching / has_wide metadata, W=16
tables, and the card as the default device of the loaders and of ray
batches."""
import inspect
import io

import numpy as np
import pytest
import torch

import rtk_tpu
import rtk_tpu_torch as rt
from rtk_tpu import instancing as jinst
from rtk_tpu.builder import sah as jsah
from rtk_tpu.trace import packed as jpacked
from rtk_tpu.utils import serialize as jser
from rtk_tpu_torch import instancing as tinst
from rtk_tpu_torch import tasks
from rtk_tpu_torch.builder import sah as tsah
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.testing.grid import build_grid
from rtk_tpu_torch.trace import packed as tpacked
from rtk_tpu_torch.types import miss_hits
from rtk_tpu_torch.utils import serialize as tser
from rtk_tpu_torch.utils.native_sah import NativeOracle

from test_torch_trace import CPU, _soup_of

torch.set_num_threads(2)


def _tf(n=4):
    tf = np.zeros((n, 3, 4), np.float32)
    tf[:, :, :3] = np.eye(3) * 0.5
    tf[:, :, 3] = np.arange(n * 3, dtype=np.float32).reshape(n, 3) * 0.7
    return tf


def _pairs(kind, wide=True):
    """(rtk_tpu object, port object, rtk_tpu saver, port saver) of one
    container kind, built from the same inputs."""
    tris = scenes.blob(3)[0]
    cfg = dict(leaf_size=4, wide_nodes=wide)
    j = rtk_tpu.build_scene(_soup_of(tris), rtk_tpu.BuildConfig(**cfg))
    t = rt.build_scene(_soup_of(tris), rt.BuildConfig(**cfg), device=CPU)
    if kind == "scene":
        return j, t, jser.save_scene, tser.save_scene
    if kind == "packed":
        return (jpacked.pack_scene(j), tpacked.pack_scene(t),
                jser.save_packed_scene, tser.save_packed_scene)
    if kind == "sah_packed":
        return (jsah.build_sah_packed(_soup_of(tris),
                                      rtk_tpu.BuildConfig(leaf_size=16),
                                      step_quant=True),
                rt.build_sah_packed(_soup_of(tris), rt.BuildConfig(
                    leaf_size=16), step_quant=True, device=CPU),
                jser.save_packed_scene, tser.save_packed_scene)
    box = scenes.cornell_box()
    jb = [j, rtk_tpu.build_scene(_soup_of(box))]
    tb = [t, rt.build_scene(_soup_of(box), device=CPU)]
    inst = np.array([0, 1, 0, 1])
    return (jinst.build_instanced(jb, inst, _tf()),
            tinst.build_instanced(tb, inst, _tf()),
            jser.save_instanced_scene, tser.save_instanced_scene)


def _blob(save, obj):
    buf = io.BytesIO()
    n = save(obj, buf)
    assert n == len(buf.getvalue()) and n % 128 == 0
    return buf.getvalue()


def _host(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same_arrays(got, want, fields):
    for f in fields:
        g, w = _host(getattr(got, f)), _host(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


KINDS = ["scene", "packed", "sah_packed", "instanced"]


@pytest.mark.parametrize("kind", KINDS)
def test_port_blob_equals_rtk_tpu_bytes(kind):
    j, t, jsave, tsave = _pairs(kind)
    assert _blob(tsave, t) == _blob(jsave, j)


@pytest.mark.parametrize("kind", KINDS)
def test_rtk_tpu_blob_loads_in_the_port(kind):
    j, t, jsave, tsave = _pairs(kind)
    loaded = tser.load_any(_blob(jsave, j), device=CPU)
    if kind == "scene":
        _assert_same_arrays(loaded, t, tser._FIELDS)
        assert (loaded.num_tris, loaded.leaf_size, loaded.branching,
                loaded.num_leaves, loaded.has_wide) == (
            t.num_tris, t.leaf_size, t.branching, t.num_leaves, t.has_wide)
    elif kind == "instanced":
        _assert_same_arrays(loaded, t, tser._INSTANCED_FIELDS)
        _assert_same_arrays(loaded.merged, t.merged, tser._FIELDS)
        assert (loaded.blas_tris, loaded.blas_slots, loaded.max_stack) == (
            t.blas_tris, t.blas_slots, t.max_stack)
    else:
        _assert_same_arrays(loaded, t, tser._PACKED_FIELDS)
        assert (loaded.num_tris, loaded.leaf_size, loaded.branching,
                loaded.depth) == (t.num_tris, t.leaf_size, t.branching,
                                  t.depth)
    # ... and back: the port's blob loads in rtk_tpu with equal arrays.
    back = jser.load_any(_blob(tsave, loaded))
    for f in ({"scene": jser._FIELDS, "instanced": jser._INSTANCED_FIELDS}
              .get(kind, jser._PACKED_FIELDS)):
        np.testing.assert_array_equal(_host(getattr(back, f)),
                                      _host(getattr(j, f)), err_msg=f)


def test_loaded_scenes_trace_the_same():
    _, t, _, tsave = _pairs("scene")
    loaded = tser.load_scene(_blob(tsave, t), device=CPU)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 16, 16,
                              device="cpu")
    a, b = rt.Tracer(t).closest(rays), rt.Tracer(loaded).closest(rays)
    for f in ("hit", "t", "u", "v", "slot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    _, tp, _, psave = _pairs("sah_packed")
    lp = tser.load_packed_scene(_blob(psave, tp), device=CPU)
    from rtk_tpu_torch.ops.packet_trace import trace_packets
    a, b = trace_packets(tp, rays), trace_packets(lp, rays)
    for f in ("hit", "t", "slot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_has_wide_and_branching_survive(tmp_path):
    """wide_nodes=False keeps has_wide=False through save and load, both
    packages; packed blobs carry branching in meta slot 3."""
    j, t, jsave, tsave = _pairs("scene", wide=False)
    assert not t.has_wide
    path = tmp_path / "s.rtk8"
    tser.save_scene(t, path)
    assert not tser.load_scene(path, device=CPU).has_wide
    assert not jser.load_scene(str(path)).has_wide
    assert not tser.load_scene(_blob(jsave, j), device=CPU).has_wide
    _, tp, _, psave = _pairs("packed")
    kind, _, meta = tser._load_container(_blob(psave, tp))
    assert kind == tser.KIND_PACKED and meta[3] == 8


def test_w16_blob_is_refused_naming_k3():
    """A blob of rtk_tpu's 16-wide tables was refused until ROADMAP K3 was
    ported; it now loads in the port as 16-wide tables with rtk_tpu's
    arrays, and the port's blob of them is rtk_tpu's bytes
    (tests/test_torch_w16.py traces them)."""
    tris = scenes.blob(2)[0]
    tree = NativeOracle(tris.reshape(-1, 9), leaf_max=4).export_tree()
    p16 = jpacked.pack_binary_tree(tris, *tree, leaf_size=4, branching=16)
    blob = _blob(jser.save_packed_scene, p16)
    assert jser.load_packed_scene(blob).branching == 16
    for load in (tser.load_packed_scene, tser.load_any):
        got = load(blob, device=CPU)
        assert got.branching == 16 and got.stack_size == 1 + 15 * got.depth
        _assert_same_arrays(got, p16, tser._PACKED_FIELDS)
        assert _blob(tser.save_packed_scene, got) == blob


def test_header_validation():
    _, t, _, tsave = _pairs("scene")
    data = _blob(tsave, t)
    with pytest.raises(ValueError, match="magic"):
        tser.load_scene(b"JUNKJUNK" + data[8:], device=CPU)
    for pos, val, what in ((8, 0xFF, "endian"), (10, 8, "sizeof_real"),
                           (12, 99, "version")):
        bad = bytearray(data)
        bad[pos] = val
        with pytest.raises(ValueError, match=what):
            tser.load_scene(bytes(bad), device=CPU)
    with pytest.raises(ValueError, match="truncated"):
        tser.load_scene(data[:len(data) // 2], device=CPU)
    with pytest.raises(ValueError, match="kind 0"):
        tser.load_packed_scene(data, device=CPU)


ENTRY_POINTS = [
    rt.build_scene, rt.build_from_soup, rt.build_sah_packed,
    tsah.build_sah_forest, tpacked.pack_binary_tree, rt.load_scene,
    rt.load_packed_scene, rt.load_instanced_scene, rt.load_any,
    tasks.start_build, tasks.build_scene_tasks,
]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


RAY_ENTRY_POINTS = [rt.Rays.make, scenes.camera_rays, scenes.cornell_camera,
                    miss_hits, build_grid]


@pytest.mark.parametrize("fn", RAY_ENTRY_POINTS, ids=lambda f: f.__name__)
def test_ray_batches_default_to_the_card(fn):
    """Ray batches and what else a caller makes from host arrays land on
    the card unless the caller names a device; Rays.make keeps a tensor's
    own device."""
    default = inspect.signature(fn).parameters["device"].default
    if fn is rt.Rays.make:
        assert default is None
        if torch.cuda.is_available():
            assert rt.Rays.make(np.zeros((1, 3)),
                                np.ones((1, 3))).device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError),
                               match="CUDA"):
                rt.Rays.make(np.zeros((1, 3)), np.ones((1, 3)))
        o = torch.zeros((2, 3))
        assert rt.Rays.make(o, o + 1).device == o.device
    else:
        assert default == "cuda"
