"""The rows of the packet front end (ops/packet_trace.py::_ray_rows): the
plain version is the stacking and the gather, CPU tensors and the plain
front end take the plain steps and never touch the library, and every
Steps runs in one order (key, sort, then one rows pass through the
permutation) and gives the same rows.  csrc/ray_rows.cu itself is held
against the plain version in tests/test_torch_kernel_host.py (a host
build) and tests/test_torch_kernel.py (the card)."""
import dataclasses

import pytest
import torch

from rtk_tpu_torch.ops import morton
from rtk_tpu_torch.ops import packet_trace as pt
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.types import Rays

from test_torch_kernel_host import rows_batch, same_bits

torch.set_num_threads(2)

STEPS = "rtk.packet_trace."


def _cat_rows(o, d, mn, mx):
    """The rows as the front end stacked them before the rows pass."""
    return torch.cat([o.T, d.T, mn[None], mx[None]]).to(torch.float32)


def _rays(n, seed):
    return Rays(*rows_batch(n, seed)[0])


def _camera(side=16):
    return scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45, side,
                              side, device="cpu")


def _spans(prof):
    return [e.name[len(STEPS):] for e in prof.events()
            if e.name.startswith(STEPS)]


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ray_rows_reference_is_the_cat_and_gather(seed, sort):
    """ray_rows_reference is the stacking, then the gather through idx
    when it is given; f64 rays give the bits of their f32 casts."""
    n = 300 + 97 * seed
    parts, perm = rows_batch(n, seed)
    idx = perm if sort else None
    want = _cat_rows(*parts)
    if sort:
        want = want[:, idx]
    got = pt.ray_rows_reference(*parts, idx)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert same_bits(got, want)
    wide = rows_batch(n, seed, torch.float64)[0]
    assert same_bits(pt.ray_rows_reference(*wide, idx), got)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_cpu_ray_rows_keep_the_plain_path(sort, plain):
    """On CPU tensors, and in the plain front end, _ray_rows runs the
    plain steps: the rows stacked and gathered through the plain key's
    sort, the spans key, sort, rows (rows alone unsorted), and no launch
    of the library."""
    rays = _rays(777, 3)
    before = (pt.ROWS_LAUNCHES, pt.KEY_LAUNCHES)
    steps = pt.front_steps(rays.device, plain)
    assert steps is pt.PLAIN
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rows, idx = pt._ray_rows(steps, rays, sort)
    assert (pt.ROWS_LAUNCHES, pt.KEY_LAUNCHES) == before
    want = _cat_rows(rays.origin, rays.direction, rays.min_t, rays.max_t)
    if sort:
        want_idx = torch.sort(morton.ray_coherence_key_reference(
            rays.origin, rays.direction), stable=True).indices
        assert torch.equal(idx, want_idx)
        want = want[:, want_idx].contiguous()
    else:
        assert idx is None
    assert same_bits(rows, want)
    assert _spans(prof) == (["key", "sort", "rows"] if sort else ["rows"])


@pytest.mark.parametrize("stand_in", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_card_order_of_the_front_steps(sort, stand_in):
    """Whichever Steps it is given (the plain steps, or a stand-in whose
    key and rows are the plain ones behind other callables, as the card's
    kernels are), _ray_rows keys and sorts first and writes the rows once
    through the permutation: each step called once, the spans key, sort,
    rows (rows alone unsorted), and the rows of the cat and the gather."""
    rays = _camera()
    calls = []

    def key_of(*args):
        calls.append(("key", len(args)))
        return morton.ray_coherence_key_reference(*args)

    def rows_of(*args):
        calls.append(("rows", len(args)))
        return pt.ray_rows_reference(*args)

    steps = (dataclasses.replace(pt.PLAIN, key=key_of, rows=rows_of)
             if stand_in else pt.PLAIN)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rows, idx = pt._ray_rows(steps, rays, sort)
    if stand_in:
        assert calls == ([("key", 2)] if sort else []) + [("rows", 5)]
    assert _spans(prof) == (["key", "sort", "rows"] if sort else ["rows"])
    want = _cat_rows(rays.origin, rays.direction, rays.min_t, rays.max_t)
    assert (idx is None) == (not sort)
    if sort:
        want_idx = torch.sort(morton.ray_coherence_key_reference(
            rays.origin, rays.direction), stable=True).indices
        assert torch.equal(idx, want_idx)
        want = want[:, want_idx]
    assert same_bits(rows, want)
