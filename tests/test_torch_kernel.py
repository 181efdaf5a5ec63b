"""The CUDA packet-traversal kernel against its plain PyTorch version on the
card.  Needs a CUDA device and nvcc: each test skips without a card.  On
the H100: `python -m pytest tests/test_torch_kernel.py -m cuda -q`."""
import numpy as np
import pytest
import torch

import rtk_tpu_torch
from rtk_tpu_torch.ops import packet_trace
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.trace.packed import pack_scene

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _soup_of(tris):
    return (tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))


def _both(packed, rays, **kw):
    before = packet_trace.KERNEL_LAUNCHES
    got = packet_trace.trace_packets(packed, rays, **kw)
    torch.cuda.synchronize()
    assert packet_trace.KERNEL_LAUNCHES == before + 1
    return got, packet_trace.trace_packets_reference(packed, rays, **kw)


def _assert_same(got, want):
    for f in ("hit", "slot", "t", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("leaf", [1, 4, 16])
def test_kernel_matches_reference(cuda, leaf):
    v, f = scenes.blob(4)[1:]
    mask = (np.arange(f.shape[0]) % 3 + 1).astype(np.uint32)
    scene = rtk_tpu_torch.build_scene(
        (v, f), rtk_tpu_torch.BuildConfig(leaf_size=leaf), device=cuda)
    packed = pack_scene(scene, tri_mask=mask)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 96, 96,
                              order="morton", device=cuda)
    for kw in (dict(), dict(mode="any"), dict(filter_mask=2),
               dict(defer_uv=True), dict(sort_rays=True)):
        _assert_same(*_both(packed, rays, **kw))


def test_kernel_random_soup_and_dead_rays(cuda):
    rng = np.random.default_rng(3)
    tris = rng.normal(size=(1280, 3, 3)).astype(np.float32)
    packed = pack_scene(rtk_tpu_torch.build_scene(_soup_of(tris),
                                                  device=cuda))
    n = 4096
    dead = rng.random(n) < 0.3
    rays = rtk_tpu_torch.Rays.make(
        rng.normal(size=(n, 3)) * 3.0, rng.normal(size=(n, 3)), 0.0,
        np.where(dead, 0.0, 3.0e38), device=cuda)
    for mode in ("closest", "any"):
        got, want = _both(packed, rays, mode=mode)
        _assert_same(got, want)
        assert not got.hit[torch.as_tensor(dead, device=cuda)].any()


def test_kernel_sah_tables(cuda):
    tris = scenes.blob(4)[0]
    packed = rtk_tpu_torch.build_sah_packed(
        _soup_of(tris), rtk_tpu_torch.BuildConfig(leaf_size=16),
        step_quant=True, device=cuda)
    rays = scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, 64, 64,
                              device=cuda)
    _assert_same(*_both(packed, rays))


def test_kernel_refuses_too_deep_tree(cuda):
    packed = pack_scene(rtk_tpu_torch.build_scene(
        _soup_of(scenes.cornell_box()), device=cuda))
    cap = packet_trace.load_kernel().rtk_packet_trace_max_stack()
    rays = torch.zeros((8, 4), device=cuda)
    with pytest.raises(ValueError, match="stack"):
        packet_trace.packet_trace_kernel(
            packed.nodes, packed.tris, rays, leaf_size=packed.leaf_size,
            stack_size=cap + 1)
