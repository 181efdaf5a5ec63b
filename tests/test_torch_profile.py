"""The profiling entry points, tools/torch_profile_trace.py and
tools/torch_profile_refit.py, against rtk_tpu on the CPU.

The dispatch probe's plain version is held bit for bit against the JAX
round's trivial Pallas kernel (tools/profile_trace.py:60-65, rebuilt here
from the same two-line body, since that tool defines it inside main()),
run in interpret mode.  The trace stages run on blob(2) at 32^2 on tables
carried from rtk_tpu, against rtk_tpu's _run_kernel (interpret mode) and
trace_packets at tests/test_torch_trace.py's bars: hit masks equal, t
within 1e-5, more than 90% of hits on the same triangle, u and v within
1e-3 there.  The refit stages run on deforming_grid(n=8) at 16^2 against
rtk_tpu's refit and repack_bounds bit for bit and its
trace_packets_refit at the same bars.  Between the port's own stages the
records are equal bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rtk_tpu
from rtk_tpu.ops import pallas_trace as PT
from rtk_tpu.testing import scenes as jax_scenes
from rtk_tpu.trace import packed as jpacked
from rtk_tpu_torch.testing import carry

# test_torch_kernel imports the probe's tool from tools/, which it puts on
# sys.path; the refit tool is imported from there beside it.
from test_torch_kernel import ptrace  # isort: skip
import torch_profile_refit as prefit  # noqa: E402  isort: skip

torch.set_num_threads(2)
CPU = "cpu"
FIELDS = ("hit", "slot", "t", "u", "v")


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(_bits(getattr(a, f)),
                                      _bits(getattr(b, f)), err_msg=f)


def _check(got_hit, got_t, got_tri, got_u, got_v, want_hit, want_t, want_tri,
           want_u, want_v):
    """tests/test_torch_trace.py::_check on plain arrays."""
    wh = np.asarray(want_hit)
    np.testing.assert_array_equal(np.asarray(got_hit), wh)
    assert wh.sum() > 20
    np.testing.assert_allclose(np.asarray(got_t)[wh], np.asarray(want_t)[wh],
                               atol=1e-5)
    same = wh & (np.asarray(got_tri) == np.asarray(want_tri))
    assert same.sum() / wh.sum() > 0.9
    for a, b in ((got_u, want_u), (got_v, want_v)):
        np.testing.assert_allclose(np.asarray(a)[same], np.asarray(b)[same],
                                   atol=1e-3)


def _check_hits(got, want):
    _check(got.hit.numpy(), got.t.numpy(), got.triangle_index.numpy(),
           got.u.numpy(), got.v.numpy(), want.hit, want.t,
           want.triangle_index, want.u, want.v)


@pytest.mark.parametrize("seed", [0, 14])
def test_probe_plain_matches_pallas_triv(seed):
    """The probe's plain version, and dispatch_probe on a CPU tensor,
    against the JAX tool's triv kernel (interpret mode) bit for bit on the
    seeded special values."""
    def triv(x_ref, o_ref):
        o_ref[:] = x_ref[:] + 1.0

    x = ptrace.probe_input(seed)
    assert x.shape == ptrace.PROBE_SHAPE and x.dtype == np.float32
    for probe in (np.isnan, np.isposinf, np.isneginf):
        assert probe(x).sum() >= 1
    assert (np.signbit(x) & (x == 0)).any() and (~np.signbit(x)
                                                 & (x == 0)).any()
    assert ((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)).sum() > 100
    assert (np.abs(np.abs(x) - 2.0 ** 24) <= 512).sum() > 100
    want = np.asarray(jax.jit(lambda a: pl.pallas_call(
        triv, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(a))(jnp.asarray(x)))
    for got in (ptrace.dispatch_probe_reference(torch.from_numpy(x)),
                ptrace.dispatch_probe(torch.from_numpy(x))):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got), want.view(np.int32))


def test_dispatch_probe_cpu_takes_the_plain_version():
    """A CPU tensor takes the plain version: no build, no launch counted;
    other types and devices are refused."""
    before, lib = ptrace.PROBE_LAUNCHES, ptrace._lib
    x = torch.from_numpy(ptrace.probe_input())
    got = ptrace.dispatch_probe(x)
    assert torch.equal(got.view(torch.int32), (x + 1.0).view(torch.int32))
    assert ptrace.PROBE_LAUNCHES == before and ptrace._lib is lib
    with pytest.raises(ValueError, match="float32"):
        ptrace.dispatch_probe(x.double())
    with pytest.raises(ValueError, match="no dispatch probe"):
        ptrace.dispatch_probe(x.to("meta"))
    # Non-contiguous and empty inputs.
    np.testing.assert_array_equal(
        ptrace.dispatch_probe(x.T).numpy(), (x.T + 1.0).numpy())
    assert ptrace.dispatch_probe(torch.empty(0)).shape == (0,)


@pytest.fixture(scope="module")
def trace_case():
    """blob(2) built and packed by rtk_tpu (BuildConfig(8, 8)), carried
    into the port, and 32^2 Morton primaries of the tool's camera in both
    packages."""
    cfg = rtk_tpu.BuildConfig(branching=8, leaf_size=8)
    jscene = rtk_tpu.build_from_soup(jax_scenes.blob(subdivisions=2)[0],
                                     config=cfg)
    jp = jpacked.pack_scene(jscene)
    packed = carry.packed_from_arrays(
        {k: np.asarray(getattr(jp, k)) for k in carry.PACKED_ARRAYS},
        num_tris=jp.num_tris, leaf_size=jp.leaf_size, device=CPU)
    jrays = jax_scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0), 45,
                                   32, 32, order="morton")
    rays = ptrace.camera(CPU, side=32)
    return jp, jrays, packed, rays


def test_profile_trace_scene_and_camera(trace_case):
    """The tool's own scene and camera equal rtk_tpu's bit for bit."""
    jp, jrays, _, rays = trace_case
    packed = ptrace.build_packed(CPU, subdivisions=2)
    for k in carry.PACKED_ARRAYS:
        np.testing.assert_array_equal(_bits(getattr(packed, k)),
                                      _bits(getattr(jp, k)), err_msg=k)
    for f in ("origin", "direction", "min_t", "max_t"):
        np.testing.assert_array_equal(_bits(getattr(rays, f)),
                                      _bits(getattr(jrays, f)), err_msg=f)


def test_profile_trace_raw_kernel_against_rtk_tpu(trace_case):
    """Stage (b) against rtk_tpu's _run_kernel in interpret mode, as the
    JAX tool's raw() calls it (pkt 128, p_pk 8: 1024 rays are one block
    of eight packets)."""
    jp, jrays, packed, rays = trace_case
    n, pkt = rays.count, 128
    o, d = np.asarray(jrays.origin), np.asarray(jrays.direction)
    comps = tuple(jnp.asarray(c.reshape(n // pkt, pkt)) for c in (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        np.asarray(jrays.min_t), np.asarray(jrays.max_t)))
    wt, wu, wv, wslot = (np.asarray(a).reshape(-1) for a in PT._run_kernel(
        jp.nodes, jp.tris, comps, jnp.zeros((n // pkt,), jnp.int32),
        jnp.full((1,), 0xFFFFFF, jnp.int32), mode="closest",
        watertight=True, interpret=True, num_tris=jp.num_tris,
        leaf_size=jp.leaf_size, p_pk=8, pkt=pkt))
    t, u, v, slot = (a.numpy() for a in
                     ptrace.trace_stages(packed, rays)["raw_kernel"]())
    _check(slot >= 0, t, slot, u, v, wslot >= 0, wt, wslot, wu, wv)


@pytest.mark.parametrize("stage,sort_rays", [("trace_unsorted", False),
                                             ("trace_sorted", True)])
def test_profile_trace_stages_against_rtk_tpu(trace_case, stage, sort_rays):
    """Stages (c) and (d) against rtk_tpu's trace_packets (interpret mode)
    with the same sort_rays."""
    jp, jrays, packed, rays = trace_case
    want = PT.trace_packets(jp, jrays, sort_rays=sort_rays, interpret=True)
    _check_hits(ptrace.trace_stages(packed, rays)[stage](), want)


def test_profile_trace_stage_records_agree(trace_case):
    """The port's stages give one record: sorted == unsorted, and the raw
    kernel's outputs == the unsorted trace's, bit for bit."""
    _, _, packed, rays = trace_case
    stages = ptrace.trace_stages(packed, rays)
    t, u, v, slot = stages["raw_kernel"]()
    unsorted = stages["trace_unsorted"]()
    _same(stages["trace_sorted"](), unsorted)
    hit = slot >= 0
    np.testing.assert_array_equal(_bits(t), _bits(unsorted.t))
    np.testing.assert_array_equal(slot.numpy(), unsorted.slot.numpy())
    for a, b in ((u, unsorted.u), (v, unsorted.v)):
        np.testing.assert_array_equal(_bits(torch.where(hit, a, 0.0)),
                                      _bits(b))


def test_profile_trace_probe_stage():
    """Stage (a)'s two callables compute x + 1 on an (8, 128) zero
    tensor."""
    for fn in ptrace.probe_stages(CPU).values():
        out = fn()
        assert out.shape == ptrace.PROBE_SHAPE and bool((out == 1.0).all())


@pytest.fixture(scope="module")
def refit_case():
    """The refit tool's stages at n=8, 16^2 (and 32^2 for the large
    trace), and rtk_tpu's build of the same grid."""
    fns, rays = prefit.stages(CPU, n=8, side=16, big_side=32)
    cfg = rtk_tpu.BuildConfig(branching=8, leaf_size=8)
    jscene = rtk_tpu.build_from_soup(jax_scenes.deforming_grid(0.0, n=8),
                                     config=cfg)
    frame = jax_scenes.deforming_grid(prefit.FRAME_TIMES[1], n=8)
    return fns, rays, jscene, frame


def test_profile_refit_stages_against_rtk_tpu(refit_case):
    """refit and repack_bounds bit for bit against rtk_tpu's; the fused
    frame against rtk_tpu's trace_packets_refit (interpret mode)."""
    fns, _, jscene, frame = refit_case
    jscene2 = rtk_tpu.refit(jscene, frame)
    _same(fns["refit"](), jscene2, carry.SCENE_ARRAYS)
    jp = jpacked.pack_scene(jscene)
    _same(fns["repack"](), jpacked.repack_bounds(jp, jscene2),
          carry.PACKED_ARRAYS)
    want = PT.trace_packets_refit(
        jp, jscene, frame, jax_scenes.camera_rays(
            (0, 3, 4), (0, 0, 0), (0, 1, 0), 50, 16, 16, order="morton"),
        sort_rays=False, interpret=True)[0]
    _check_hits(fns["fused"]()[0], want)


def test_profile_refit_fused_equals_stages(refit_case):
    """The fused frame's tables and records equal the stages run one
    after another, bit for bit; the rest of the stages run and count the
    rays they trace."""
    fns, rays, _, _ = refit_case
    hits, scene2, packed2 = fns["fused"]()
    _same(scene2, fns["refit"](), carry.SCENE_ARRAYS)
    _same(packed2, fns["repack"](), carry.PACKED_ARRAYS)
    _same(hits, fns["trace"]())
    assert rays == {"trace": 256, "fused": 256, "trace_big": 1024}
    big = fns["trace_big"]()
    assert big.t.shape == (1024,) and int(big.hit.sum()) > 0
    assert bool((fns["tiny_op"]() == 1.0).all())
    # On the CPU the refit and the repack are their plain versions.
    _same(fns["refit_plain"](), scene2, carry.SCENE_ARRAYS)
    _same(fns["repack_plain"](), packed2, carry.PACKED_ARRAYS)


def test_profile_refit_frame_bytes(refit_case):
    """frame_bytes at n=8 (128 triangles in 16 leaves of 8, 15 wide nodes
    of 8 slots, 72 packed node rows of 8): the refit reads the soup
    (4,608 B) and writes the sorted rows (4,608), 32 boxes (768) and the
    wide slots' boxes (2,880); the repack reads the rows (4,608) and
    writes the packed vertices and triangle table (12,800) and the node
    rows (2,304)."""
    fns, _, _, _ = refit_case
    scene2, packed2 = fns["refit"](), fns["repack"]()
    assert (scene2.num_tris, scene2.num_leaves) == (128, 16)
    assert tuple(scene2.node_min.shape) == (15, 8, 3)
    assert tuple(packed2.nodes.shape) == (72, 8)
    assert prefit.frame_bytes(scene2, packed2) == {
        "refit": 4608 + 4608 + 768 + 2880, "repack": 4608 + 12800 + 2304}
