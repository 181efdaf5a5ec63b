"""csrc/packet_trace.cu built for the host and held against its plain
versions.  g++ compiles the CUDA source against a small header that
stands in for CUDA's (the vector types, __ldg, __popc, and the launch run
as a loop over the threads in turn), so the kernel's own code runs here on
the CPU (its single-instruction NaN min/max take their plain C++ form
off the card): every instantiation (8- and 16-wide tables, the grid march
and a filter build) in every mode equals the plain PyTorch version bit for
bit, counts included.  Built with -ffp-contract=off, as nvcc's -fmad=false.
csrc/dispatch_probe.cu, csrc/coherence_key.cu, csrc/ray_rows.cu,
csrc/unsort.cu, csrc/shade.cu, csrc/refit.cu, csrc/candidates.cu and
csrc/rounds.cu are built the same way and held bit for bit against their
plain versions.
This checks the kernels' logic and arithmetic; that nvcc builds them for
sm_90a, and the card's results, are tests/test_torch_kernel.py's."""
import ctypes
import dataclasses
import pathlib
import re
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rtk_tpu_torch as rt
from rtk_tpu_torch.ops import library, morton
from rtk_tpu_torch.ops import packet_trace as pt
from rtk_tpu_torch.testing import scenes
from rtk_tpu_torch.testing.grid import build_grid, march_batch
from rtk_tpu_torch.trace.packed import pack_binary_tree, pack_scene
from rtk_tpu_torch.utils.native_sah import NativeOracle

from test_torch_kernel import (CANDIDATE_CASES, FILTERS, MASK_QMASKS,
                               ROUND_CASES, SCATTER_CASES, TIE_CASES,
                               _root_slot_boxes, assert_same_best,
                               assert_same_candidates,
                               assert_same_round_rays, candidate_case,
                               round_case, scatter_case,
                               chain_forest, chain_grid, chain_rays,
                               leaf_root_case, long_tail_rays,
                               long_tail_scene, mask_tree, ptrace, tie_rays,
                               tie_tree, wide_tie_tree)

torch.set_num_threads(2)
CPU = "cpu"

# What the kernel sources take from CUDA, for a host build.  A thread runs
# as a warp of its own; __match_any_sync has every third thread play a
# lane whose warp holds rays of other sign octants and other shear axes,
# so both the octant and per-axis copies of the node and leaf tests and
# the loop that reads the signs and the axis from the ray are held
# against the plain versions.  The coherence key's warp
# reductions see a warp of one lane at the thread's own lane
# (__ballot_sync), so every thread folds its own value, and its atomics
# run one thread at a time, as the launch does.
CUDA_SHIM = r"""
#pragma once
#include <math.h>
#include <string.h>
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
static inline int2 make_int2(int x, int y) { return int2{x, y}; }
struct dim3 { unsigned x, y, z; };
static dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline unsigned __activemask() { return 1u; }
static inline unsigned __match_any_sync(unsigned mask, int) {
  return threadIdx.x % 3 ? mask : 0u;
}
static inline unsigned __ballot_sync(unsigned, bool p) {
  return p ? 1u << (threadIdx.x & 31) : 0u;
}
static inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }
static inline unsigned atomicMin(unsigned* p, unsigned v) {
  const unsigned old = *p;
  if (v < old) *p = v;
  return old;
}
static inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
static inline void __threadfence() {}
template <class T> static inline T __ldcg(const T* p) { return *p; }
static inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, 4);
  return i;
}
static inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, 4);
  return f;
}
static inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
static inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
static inline float __fsqrt_rn(float x) { return sqrtf(x); }
static inline int cudaGetLastError() { return 0; }
static inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
"""
LAUNCH = """    packet_trace_kernel<W, MARCH>
        <<<blocks, RTK_BLOCK, 0, (cudaStream_t)stream>>>("""
HOST_LAUNCH = """    for (unsigned b_ = 0; b_ < (unsigned)blocks * RTK_BLOCK; ++b_)
      if ((blockIdx.x = b_ / RTK_BLOCK, threadIdx.x = b_ % RTK_BLOCK,
           blockDim.x = RTK_BLOCK, true))
        packet_trace_kernel<W, MARCH>("""


def _host_build(tmp, name, flags=()):
    src = library.KERNEL_SRC.read_text()
    assert LAUNCH in src and "#include <cuda_runtime.h>" in src
    (tmp / "cuda_shim.h").write_text(CUDA_SHIM)
    cpp = tmp / f"{name}.cpp"
    cpp.write_text(src.replace("#include <cuda_runtime.h>",
                               '#include "cuda_shim.h"')
                   .replace(LAUNCH, HOST_LAUNCH))
    so = tmp / f"lib{name}.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{tmp}", f"-I{library.CSRC}",
                    *flags, str(cpp), "-o", str(so)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtk_packet_trace.argtypes = [ptr] * 5 + [i32] * 8 + [ptr] * 6
    if not flags:
        lib.rtk_packet_march.argtypes = ([ptr] * 3 + [i32] * 9 + [f32] * 9
                                         + [ptr] * 7)
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The kernel library and an odd-triangle filter build, for the
    host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    tmp = tmp_path_factory.mktemp("kernel_host")
    flt = rt.jit_filter(FILTERS["odd_tri"])
    (tmp / "pred.h").write_text(flt.source)
    return {None: _host_build(tmp, "plain"),
            "odd_tri": _host_build(tmp, "odd_tri",
                                   ("-DRTK_FILTER", "-include",
                                    str(tmp / "pred.h"))),
            "filter_fn": flt}


def _ptr(a):
    return None if a is None else a.data_ptr()


SENTINEL = 0x7FBADBAD  # a NaN pattern no traversal writes


def _run(call, n):
    """Outputs (t, u, v, slot, counts) of one host launch over n rays,
    each output filled with SENTINEL first."""
    out = tuple(torch.full(shape, SENTINEL, dtype=torch.int32)
                for shape in ((n,),) * 4 + ((5, n),))
    out = tuple(o.view(torch.float32) for o in out[:3]) + out[3:]
    assert call(*map(_ptr, out), None) == 0
    return out


def _trace(lib, packed, rays8, mode="closest", qmask=None, defer_uv=False,
           roots=None, ray_index=None):
    return _run(lambda *o: lib.rtk_packet_trace(
        _ptr(packed.nodes), _ptr(packed.tris), _ptr(rays8), _ptr(roots),
        _ptr(ray_index), rays8.shape[1], packed.leaf_size, packed.branching,
        int(mode == "any"), 1, int(qmask is not None), int(qmask or 0),
        int(defer_uv), *o), rays8.shape[1])


def _assert_bits(got, want, what):
    for g, w, name in zip(got, want, ("t", "u", "v", "slot", "counts")):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{what}: {name}"


def _rows(rays):
    return torch.cat([rays.origin.T, rays.direction.T, rays.min_t[None],
                      rays.max_t[None]]).contiguous()


def _batches(n=2000):
    """Morton camera rays, and n incoherent rays with dead ones and t
    windows."""
    rng = np.random.default_rng(11)
    u = rng.random(n)
    return {"camera": scenes.camera_rays((0, 0, 3.0), (0, 0, 0), (0, 1, 0),
                                         45, 40, 40, order="morton",
                                         device=CPU),
            "incoherent": rt.Rays.make(
                rng.normal(size=(n, 3)) * 1.5, rng.normal(size=(n, 3)),
                np.where(u < 0.3, 0.2, 0.0),
                np.where(u < 0.1, 0.0, np.where(u < 0.3, 0.9, 3.0e38)),
                device=CPU)}


@pytest.mark.parametrize("width", [8, 16])
def test_host_kernel_equals_plain_version(libs, width):
    """SAH leaf-16 tables of blob(4) at one width: closest, any, the mask
    filter, defer_uv and the odd-triangle filter build."""
    tris = scenes.blob(4)[0]
    tree = NativeOracle(tris.reshape(-1, 9), leaf_max=16,
                        step_quant=True).export_tree()
    mask = (np.arange(tris.shape[0]) % 3 + 1).astype(np.uint32)
    packed = pack_binary_tree(tris, *tree, leaf_size=16, branching=width,
                              tri_mask=mask, device=CPU)
    kw0 = dict(leaf_size=16, stack_size=packed.stack_size, stats=True,
               branching=width)
    for name, rays in _batches().items():
        rows = _rows(rays)
        for kw in (dict(), dict(mode="any"), dict(qmask=2),
                   dict(defer_uv=True)):
            _assert_bits(_trace(libs[None], packed, rows, **kw),
                         pt.packet_trace_reference(packed.nodes, packed.tris,
                                                   rows, **kw0, **kw),
                         f"{name} {kw}")
        ridx = torch.arange(rows.shape[1], dtype=torch.int32).flip(0)
        _assert_bits(_trace(libs["odd_tri"], packed, rows, ray_index=ridx),
                     pt.packet_trace_reference(
                         packed.nodes, packed.tris, rows, **kw0,
                         filter_fn=libs["filter_fn"], ray_index=ridx),
                     f"{name} filter")


def test_host_kernel_roots_on_a_16_wide_forest(libs):
    tri_v, *tree, roots = chain_forest(60)
    packed = pack_binary_tree(tri_v, *tree, roots, leaf_size=1,
                              branching=16, device=CPU)
    rows = _rows(_batches()["incoherent"])
    per_ray = torch.as_tensor(np.random.default_rng(2).integers(
        0, 2, rows.shape[1]), dtype=torch.int32)
    _assert_bits(_trace(libs[None], packed, rows, roots=per_ray),
                 pt.packet_trace_reference(
                     packed.nodes, packed.tris, rows, leaf_size=1,
                     stack_size=packed.stack_size, roots=per_ray,
                     stats=True, branching=16), "forest roots")


@pytest.mark.parametrize("kw", [{}, {"mode": "any"}, {"qmask": 1}],
                         ids=["closest", "any", "mask"])
def test_host_kernel_leaf_roots(libs, kw):
    """Roots that are leaf entries (-2 - leaf) beside node rows: the kernel
    starts those rays at the leaf, as its plain version does, bit for bit
    with counts (one leaf pop and nothing else for a leaf root)."""
    packed, rays, roots = leaf_root_case(CPU)
    rows = _rows(rays)
    got = _trace(libs[None], packed, rows, roots=roots, **kw)
    want = pt.packet_trace_reference(
        packed.nodes, packed.tris, rows, leaf_size=packed.leaf_size,
        stack_size=packed.stack_size, roots=roots, stats=True, **kw)
    _assert_bits(got, want, f"leaf roots {kw}")
    leafy = roots <= -2
    assert bool((want[4][:2, leafy] <= 1).all()) and want[3][leafy].ge(
        0).any()


def _march(lib, grid, rays, what):
    """The march kernel against its plain version on march_batch's rows of
    `rays`: closest, any and the mask filter, counts summed over the
    cells, empty cells stepped over unread by the grid's occupancy
    words."""
    cm = grid.cells_march
    mg, rows, _ = march_batch(grid, rays)
    for kw in (dict(), dict(mode="any"), dict(qmask=1)):
        want = pt.packet_march_reference(
            cm.nodes, cm.tris, rows, leaf_size=cm.leaf_size,
            stack_size=cm.stack_size, grid=mg, stats=True, **kw)
        got = _run(lambda *o: lib.rtk_packet_march(
            _ptr(cm.nodes), _ptr(cm.tris), _ptr(rows), rows.shape[1],
            cm.leaf_size, int(kw.get("mode") == "any"), 1,
            int("qmask" in kw), kw.get("qmask", 0), *mg.dims, *mg.lo,
            *mg.cs, *mg.hi, _ptr(mg.occ), *o), rows.shape[1])
        _assert_bits(got, want, f"{what} {kw}")


def test_host_march_equals_plain_version(libs):
    """The march instantiation on blob(4)'s grid (choose_dims' cells,
    LBVH leaf 8, a tri_mask)."""
    tris = scenes.blob(4)[0]
    mask = (np.arange(tris.shape[0]) % 2 + 1).astype(np.uint32)
    grid = build_grid(tris, config=rt.BuildConfig(leaf_size=8), march=True,
                      tri_mask=mask, device=CPU)
    for name, rays in _batches().items():
        _march(libs[None], grid, rays, f"march {name}")


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_host_march_cell_chains(libs, n):
    """Chains that cross many cells, empty ones among them, start inside
    the grid or leave it through each face, retire mid-chain at an
    any-hit, or never start (dead rays), at ragged batch sizes."""
    _march(libs[None], chain_grid(CPU), chain_rays(n, CPU), f"chains n={n}")


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_host_any_hit_long_tail(libs, n):
    """Any-hit where most rays end at their first leaves and every 32nd
    walks much of the tree, unsorted, at ragged batch sizes."""
    packed = long_tail_scene(CPU)
    rows = _rows(long_tail_rays(n, CPU))
    _assert_bits(_trace(libs[None], packed, rows, mode="any"),
                 pt.packet_trace_reference(
                     packed.nodes, packed.tris, rows, mode="any",
                     leaf_size=packed.leaf_size,
                     stack_size=packed.stack_size, stats=True),
                 f"long tail n={n}")


@pytest.mark.parametrize("leaf_size,count,width", TIE_CASES)
def test_host_kernel_ties_and_leaf_sizes(libs, leaf_size, count, width):
    """Children at equal entry distance (ties by slot), coincident
    triangles in two leaves (the first found wins) and every leaf-loop
    shape, closest and any (which leaves at the nearest child with entries
    still stacked), the mask filter and the filter build."""
    tri_v, *tree = tie_tree(64, count)
    mask = (np.arange(tri_v.shape[0]) % 3 + 1).astype(np.uint32)
    packed = pack_binary_tree(tri_v, *tree, leaf_size=leaf_size,
                              branching=width, tri_mask=mask, device=CPU)
    rows = _rows(tie_rays(600, CPU))
    kw0 = dict(leaf_size=leaf_size, stack_size=packed.stack_size, stats=True,
               branching=width)
    hits = 0
    for kw in (dict(), dict(mode="any"), dict(qmask=2)):
        got = _trace(libs[None], packed, rows, **kw)
        _assert_bits(got, pt.packet_trace_reference(
            packed.nodes, packed.tris, rows, **kw0, **kw), f"ties {kw}")
        hits += int((got[3] >= 0).sum())
    assert hits > 0
    for kw in (dict(), dict(mode="any")):
        _assert_bits(_trace(libs["odd_tri"], packed, rows, **kw),
                     pt.packet_trace_reference(
                         packed.nodes, packed.tris, rows, **kw0, **kw,
                         filter_fn=libs["filter_fn"]), f"ties filter {kw}")


def test_host_kernel_deep_tree_within_the_stack(libs):
    """A chain whose traversal stack comes close to the compiled one."""
    tri_v, *tree, roots = chain_forest(240)
    packed = pack_binary_tree(tri_v, *tree, roots, leaf_size=1, device=CPU)
    cap = libs[None].rtk_packet_trace_max_stack()
    assert cap // 2 < packed.stack_size <= cap
    rows = _rows(tie_rays(400, CPU))
    per_ray = torch.ones(rows.shape[1], dtype=torch.int32)
    _assert_bits(_trace(libs[None], packed, rows, roots=per_ray),
                 pt.packet_trace_reference(
                     packed.nodes, packed.tris, rows, leaf_size=1,
                     stack_size=packed.stack_size, roots=per_ray,
                     stats=True), "deep chain")


def _blob_lbvh():
    """blob(3) on LBVH leaf-4 tables, with a tri_mask."""
    v, f = scenes.blob(3)[1:]
    mask = (np.arange(f.shape[0]) % 3 + 1).astype(np.uint32)
    return pack_scene(rt.build_scene((v, f), device=CPU), tri_mask=mask)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 128 * 3 + 7, 128 * 20 + 7])
def test_host_kernel_ragged_batches(libs, n):
    """Batch sizes that leave a ragged last warp and block: every output
    of every ray is written (none keeps the sentinel it was filled with)
    and equals the plain version bit for bit, counts included, in every
    mode."""
    packed = _blob_lbvh()
    rows = _rows(_batches(n)["incoherent"])
    kw0 = dict(leaf_size=packed.leaf_size, stack_size=packed.stack_size,
               stats=True)
    for kw in (dict(), dict(mode="any"), dict(qmask=2), dict(defer_uv=True)):
        _assert_bits(_trace(libs[None], packed, rows, **kw),
                     pt.packet_trace_reference(packed.nodes, packed.tris,
                                               rows, **kw0, **kw),
                     f"n={n} {kw}")


def test_host_roots_in_the_rounds_order(libs):
    """Round 0 of an instanced trace as the rounds launch it: every ray
    with a candidate, grouped by instance (stable), in its first
    candidate's object space, from that instance's BLAS root."""
    from rtk_tpu_torch import instancing

    rng = np.random.default_rng(9)
    blas = [rt.build_scene((t.reshape(-1, 3),
                            np.arange(t.shape[0] * 3).reshape(-1, 3)),
                           device=CPU)
            for t in (scenes.blob(2)[0],
                      scenes.box([-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]))]
    tf = np.zeros((12, 3, 4), np.float32)
    tf[:, :, :3] = np.eye(3) * (0.5 + rng.random((12, 1, 1)))
    tf[:, :, 3] = rng.random((12, 3)) * 8 - 4
    ps = rt.pack_instanced(rt.build_instanced(blas, rng.integers(0, 2, 12),
                                              tf))
    iscene = ps.iscene
    rays = scenes.camera_rays((0, 2, 12), (0, 0, 0), (0, 1, 0), 45, 48, 48,
                              order="morton", device=CPU)
    cand, _, _ = instancing._instance_candidates(iscene, rays, 1)
    rows = torch.nonzero(cand[:, 0] >= 0).squeeze(1)
    inst = cand[rows, 0].long()
    order = torch.sort(inst, stable=True).indices
    rows, inst = rows[order], inst[order]
    o, d = instancing._object_rays(iscene.object_from_world[inst],
                                   rays.origin[rows], rays.direction[rows])
    rows8 = torch.cat([o.T, d.T, rays.min_t[rows][None],
                       rays.max_t[rows][None]]).contiguous()
    roots = ps.packed_roots[iscene.instance_blas[inst]].contiguous()
    got = _trace(libs[None], ps.packed, rows8, roots=roots)
    _assert_bits(got, pt.packet_trace_reference(
        ps.packed.nodes, ps.packed.tris, rows8, leaf_size=ps.packed.leaf_size,
        stack_size=ps.packed.stack_size, roots=roots, stats=True),
        "round 0 roots")
    assert bool((got[3] >= 0).any())


def _padding_between(packed, qmask):
    """Rows of NaN padding that pass qmask, after a real row of their leaf
    that fails it and before a next leaf whose first row passes it."""
    tris, k = packed.tris, packed.leaf_size
    pad = torch.isnan(tris[:, 0])
    ok = (tris[:, pt.MASK_COL].to(torch.int32) & qmask) != 0
    found = 0
    for leaf in range(tris.shape[0] // k - 1):
        rows = range(leaf * k, (leaf + 1) * k)
        real = [r for r in rows if not pad[r]]
        nxt = (leaf + 1) * k
        if (real and len(real) < k and not ok[real[-1]]
                and ok[real[-1] + 1] and not pad[nxt] and ok[nxt]):
            found += 1
    return found


@pytest.mark.parametrize("leaf_size", [1, 4, 8, 16, 40])
def test_host_kernel_mask_leaves(libs, leaf_size):
    """The mask filter, kernel == plain bit for bit, counts included, on
    mask_tree's leaves: a leaf whose every row the mask rejects, NaN
    padding rows that pass the mask between a leaf's masked rows and the
    next leaf's unmasked ones, leaves of 1 to 40 rows (past 32: a leaf
    loop in two parts), under single- and multi-bit masks (1, 2, 3,
    0x800000, 0xFFFFFF), 8 and 16 wide, closest and any."""
    tree, mask = mask_tree(leaf_size)
    rows = _rows(tie_rays(600, CPU))
    hits = 0
    for width in (8, 16):
        packed = pack_binary_tree(*tree, leaf_size=leaf_size,
                                  branching=width, tri_mask=mask, device=CPU)
        tris = packed.tris
        bits = tris[:, pt.MASK_COL].to(torch.int32)
        leaves = bits[:tris.shape[0] // leaf_size * leaf_size].view(
            -1, leaf_size)
        assert bool(((leaves & 0xFFFFFF) == 0).all(dim=1).any())
        if leaf_size >= 4:
            assert _padding_between(packed, 1) > 0
        kw0 = dict(leaf_size=leaf_size, stack_size=packed.stack_size,
                   stats=True, branching=width)
        for qmask in MASK_QMASKS:
            for mode in ("closest", "any"):
                got = _trace(libs[None], packed, rows, mode=mode, qmask=qmask)
                _assert_bits(got, pt.packet_trace_reference(
                    packed.nodes, packed.tris, rows, **kw0, mode=mode,
                    qmask=qmask), f"w{width} qmask {qmask:#x} {mode}")
                hits += int((got[3] >= 0).sum())
    assert hits > 0


@pytest.mark.parametrize("n", [9, 10, 11, 12, 13, 14, 15, 16])
def test_host_w16_wide_nodes_with_ties(libs, n):
    """16-wide roots of n live children (9 to 16) whose slots 7 and 8 lie
    at one entry distance from every ray, so the near-to-far order keeps
    slot order across the halves of the node: closest, any, the mask
    filter and defer_uv equal the plain version bit for bit, counts
    included."""
    tri_v, *tree = wide_tie_tree(n)
    mask = (np.arange(tri_v.shape[0]) % 3 + 1).astype(np.uint32)
    packed = pack_binary_tree(tri_v, *tree, leaf_size=4, branching=16,
                              tri_mask=mask, device=CPU)
    masks = int(packed.nodes[1, 6]) & 0xFFFFFFFF
    assert bin(masks).count("1") == n
    lo, hi = _root_slot_boxes(packed.nodes)
    assert np.array_equal(lo[7], lo[8]) and np.array_equal(hi[7], hi[8])
    rows = _rows(tie_rays(600, CPU))
    kw0 = dict(leaf_size=4, stack_size=packed.stack_size, stats=True,
               branching=16)
    for kw in (dict(), dict(mode="any"), dict(qmask=2),
               dict(defer_uv=True)):
        got = _trace(libs[None], packed, rows, **kw)
        _assert_bits(got, pt.packet_trace_reference(
            packed.nodes, packed.tris, rows, **kw0, **kw), f"n={n} {kw}")
    assert bool((got[3] >= 0).any())


PROBE_LAUNCH = """    dispatch_probe_kernel<<<blocks, PROBE_BLOCK, 0, (cudaStream_t)stream>>>(
"""
PROBE_HOST_LAUNCH = """    for (unsigned b_ = 0; b_ < (unsigned)blocks * PROBE_BLOCK; ++b_)
      if ((blockIdx.x = b_ / PROBE_BLOCK, threadIdx.x = b_ % PROBE_BLOCK,
           blockDim.x = PROBE_BLOCK, true))
        dispatch_probe_kernel(
"""


@pytest.mark.parametrize("n", [0, 1, 127, 129, 1024, 128 * 20 + 7])
def test_host_dispatch_probe(tmp_path, n):
    """csrc/dispatch_probe.cu built for the host behind CUDA_SHIM (its
    launch run as a loop over the threads) equals the probe's plain
    version, x + 1.0, bit for bit on tools/torch_profile_trace.py's
    seeded special values (ragged sizes cut from them), and leaves the
    output past n untouched."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = pathlib.Path(ptrace.PROBE_SRC).read_text()
    assert PROBE_LAUNCH in src and "#include <cuda_runtime.h>" in src
    (tmp_path / "cuda_shim.h").write_text(CUDA_SHIM)
    cpp = tmp_path / "probe.cpp"
    cpp.write_text(src.replace("#include <cuda_runtime.h>",
                               '#include "cuda_shim.h"')
                   .replace(PROBE_LAUNCH, PROBE_HOST_LAUNCH))
    so = tmp_path / "libprobe.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{tmp_path}", str(cpp), "-o", str(so)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.rtk_dispatch_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p]
    x = torch.from_numpy(np.concatenate(
        [ptrace.probe_input(s).reshape(-1) for s in range(3)]))[:n]
    out = torch.full((n + 5,), SENTINEL, dtype=torch.int32)
    assert lib.rtk_dispatch_probe(x.data_ptr(), out.data_ptr(), n, None) == 0
    assert torch.equal(out[:n], ptrace.dispatch_probe_reference(x)
                       .view(torch.int32))
    assert bool((out[n:] == SENTINEL).all())


# The front end's kernels launch as NAME<<<GRID, BLOCK, 0, STREAM>>>(.
FRONT_LAUNCH = re.compile(r"(\w+)<<<(\w+), (\w+), 0, ([^>]+)>>>\(")
FRONT_HOST_LAUNCH = (r"for (unsigned b_ = 0; b_ < (unsigned)(\2) * \3; ++b_)"
                     r"\n    if ((blockIdx.x = b_ / \3, threadIdx.x = b_ % "
                     r"\3, blockDim.x = \3, gridDim.x = (\2), true))\n"
                     r"      \1(")
KEY_REDUCE = "constexpr int KEY_REDUCE_BLOCKS = 1024;"


# The same loop from the last thread to the first.
REVERSED_HOST_LAUNCH = (r"for (long long b_ = (long long)(\2) * \3 - 1; "
                        r"b_ >= 0; --b_)\n    if ((blockIdx.x = b_ / \3, "
                        r"threadIdx.x = b_ % \3, blockDim.x = \3, "
                        r"gridDim.x = (\2), true))\n      \1(")


def front_host_source(src, launches, reduce_blocks=None, reverse=False):
    """csrc/coherence_key.cu, csrc/ray_rows.cu, csrc/unsort.cu,
    csrc/shade.cu, csrc/refit.cu or csrc/candidates.cu for a host build
    behind CUDA_SHIM: each
    of its `launches` launches runs as a loop over the threads in turn
    (reverse: from the last thread to the first); reduce_blocks: the key's
    bounds kernels' grid cap, to make a small batch take several turns of
    their grid-stride loops."""
    text = src.read_text()
    assert "#include <cuda_runtime.h>" in text
    host, n = FRONT_LAUNCH.subn(
        REVERSED_HOST_LAUNCH if reverse else FRONT_HOST_LAUNCH, text)
    assert n == launches
    if reduce_blocks is not None:
        assert KEY_REDUCE in host
        host = host.replace(KEY_REDUCE, "constexpr int KEY_REDUCE_BLOCKS = "
                            f"{reduce_blocks};")
    return host.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')


def host_library(tmp, name, reduce_blocks=None):
    """The library kernel_library builds (the traversal without a filter,
    the coherence key, the rows pass, the unsort, render_path's shade
    pass, the refit and repack, the instance candidate slab and an
    instanced round's object rays and scatter in one .so), built for the
    host -> its path."""
    (tmp / "cuda_shim.h").write_text(CUDA_SHIM)
    sources = {
        "trace": library.KERNEL_SRC.read_text()
        .replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
        .replace(LAUNCH, HOST_LAUNCH),
        "key": front_host_source(library.KEY_SRC, 3, reduce_blocks),
        "rows": front_host_source(library.ROWS_SRC, 1),
        "unsort": front_host_source(library.UNSORT_SRC, 1),
        "shade": front_host_source(library.SHADE_SRC, 1),
        "refit": front_host_source(library.REFIT_SRC, 4),
        "candidates": front_host_source(library.CANDIDATES_SRC, 1),
        "rounds": front_host_source(library.ROUNDS_SRC, 2)}
    for part, text in sources.items():
        (tmp / f"{name}_{part}.cpp").write_text(text)
    so = tmp / f"lib{name}.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{tmp}", f"-I{library.CSRC}",
                    *(str(tmp / f"{name}_{part}.cpp") for part in sources),
                    "-o", str(so)], check=True, capture_output=True,
                   text=True)
    return so


@pytest.fixture(scope="module")
def key_libs(tmp_path_factory):
    """The host build of the library as nvcc builds it, and one whose key
    bounds kernels run 3 blocks (so every thread folds many rays)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    tmp = tmp_path_factory.mktemp("key_host")
    return {cap: library.bind_library(host_library(tmp, f"key{cap}", cap),
                                      True)
            for cap in (None, 3)}


def host_key(lib, o, d):
    """The library's keys of CPU views o, d, through the wrapper's own
    call (_key_call), the output past n left as SENTINEL."""
    n = o.shape[0]
    key = torch.full((n + 3,), SENTINEL, dtype=torch.int32)
    bounds = torch.empty((12,), dtype=torch.int32)
    assert pt._key_call(lib, o, d, bounds, key, None) == 0
    assert bool((key[n:] == SENTINEL).all())
    return key[:n]


def key_cases():
    """The batches of tests/test_torch_morton.py, the edge cases of the
    key's floors and ragged sizes -> {name: (origin, direction)}."""
    from test_torch_morton import _batch

    cases = {name: tuple(map(torch.from_numpy, _batch(name)))
             for name in ("morton", "raster", "scattered")}
    rng = np.random.default_rng(16)
    d = torch.from_numpy(rng.normal(size=(777, 3)).astype(np.float32))
    one = torch.tensor([[0.5, -2.0, 3.0]])
    cases.update({
        # Every origin equal: the scale's 1e-2 floor.
        "same_origin": (one.expand(777, 3), d),
        # Every probe equal: the extent's 1e-30 floor on every axis.
        "same_ray": (one.expand(50, 3), d[:1].expand(50, 3)),
        # Origins at +-0 and directions in one plane (one axis's probes
        # all equal).
        "zero_origins": (torch.tensor([[0.0, -0.0, 0.0]]).repeat(200, 1)
                         * torch.tensor([1.0, 1.0, -1.0]),
                         d[:200] * torch.tensor([1.0, 1.0, 0.0])),
        "single": (one, d[:1]),
        "zero_direction": (one, torch.zeros((1, 3))),
    })
    zd = d.clone()
    zd[::5] = 0.0  # zero directions among others: the norm's 1e-30 floor
    o = torch.from_numpy((rng.normal(size=(777, 3)) * 4).astype(np.float32))
    cases["zero_directions"] = (o, zd)
    for n in (2, 31, 257, 4099):
        cases[f"ragged{n}"] = (
            torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)))
    return cases


KEY_CASES = key_cases()


@pytest.mark.parametrize("cap", [None, 3])
@pytest.mark.parametrize("name", list(KEY_CASES))
def test_host_coherence_key(key_libs, name, cap):
    """csrc/coherence_key.cu built for the host (its launches run as loops
    over the threads, its warp reductions over one lane) equals
    ops/morton.py's plain version bit for bit, with its bounds kernels at
    the card's grid cap and at 3 blocks."""
    o, d = KEY_CASES[name]
    want = morton.ray_coherence_key_reference(o, d)
    got = host_key(key_libs[cap], o, d)
    assert torch.equal(got, want), f"{int((got != want).sum())} keys differ"


def test_host_coherence_key_strides(key_libs):
    """The key reads origins and directions through their strides: an
    expanded origin (row stride 0) and a direction that is a transposed
    view give the keys of contiguous copies."""
    o, d = KEY_CASES["scattered"]
    d_t = d.T.contiguous().T  # (N, 3) with strides (1, N)
    assert d_t.stride() == (1, d.shape[0])
    lib = key_libs[None]
    assert torch.equal(host_key(lib, o, d_t), host_key(lib, o, d))
    cam = KEY_CASES["same_origin"]
    assert cam[0].stride()[0] == 0
    assert torch.equal(host_key(lib, *cam),
                       host_key(lib, cam[0].contiguous(), cam[1]))


def test_coherence_key_kernel_takes_cuda_tensors():
    """The wrapper never runs on the CPU: ray_coherence_key sends CPU
    tensors to the plain version, and the kernel's wrapper refuses them."""
    o, d = KEY_CASES["ragged31"]
    assert torch.equal(morton.ray_coherence_key(o, d),
                       morton.ray_coherence_key_reference(o, d))
    with pytest.raises(ValueError, match="CUDA"):
        pt.coherence_key_kernel(o, d)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("n", [1, 255, 257, 4099])
def test_host_unsort(key_libs, n, stats):
    """csrc/unsort.cu built for the host equals unsort_reference (the
    index-puts it replaces) bit for bit on a seeded permutation, counts
    included, through the wrapper's own call (_unsort_call); the inputs
    are left as they were."""
    rng = np.random.default_rng(n)
    idx = torch.from_numpy(rng.permutation(n))
    out = (torch.from_numpy(rng.normal(size=n).astype(np.float32)),
           torch.from_numpy(rng.random(n).astype(np.float32)),
           torch.from_numpy(rng.random(n).astype(np.float32)),
           torch.from_numpy(rng.integers(-1, 9, n).astype(np.int32)))
    if stats:
        out += (torch.from_numpy(rng.integers(0, 99, (5, n))
                                 .astype(np.int32)),)
    kept = tuple(a.clone() for a in out)
    res = tuple(torch.full_like(a, 7) for a in out)
    assert pt._unsort_call(key_libs[None], idx, out, res, None) == 0
    want = pt.unsort_reference(out, idx)
    for got, w, a, k in zip(res, want, out, kept):
        assert torch.equal(got.view(torch.int32), w.view(torch.int32))
        assert torch.equal(a, k)


def test_unsort_kernel_takes_cuda_tensors():
    """The unsort's wrapper never runs on the CPU: the front end sends CPU
    tensors to unsort_reference, and the wrapper refuses them."""
    out = (torch.zeros(3), torch.zeros(3), torch.zeros(3),
           torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        pt.unsort_kernel(out, torch.arange(3))
    steps = pt.front_steps(torch.device("cpu"))
    assert (steps.key, steps.rows, steps.unsort) == (
        morton.ray_coherence_key_reference, pt.ray_rows_reference,
        pt.unsort_reference)


def rows_batch(n, seed, dtype=torch.float32):
    """A seeded batch of n rays (origin, direction, min_t, max_t), with
    NaN, signed zeros, infinities and a denormal among the values, and a
    seeded permutation of [0, n)."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, 8)).astype(np.float32)
    special = rng.random((n, 8)) < 0.05
    vals[special] = rng.choice(np.array(
        [np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-45], np.float32),
        int(special.sum()))
    t = torch.from_numpy(vals).to(dtype)
    parts = (t[:, :3].contiguous(), t[:, 3:6].contiguous(),
             t[:, 6].contiguous(), t[:, 7].contiguous())
    return parts, torch.from_numpy(rng.permutation(n))


def host_rows(lib, parts, idx):
    """The library's rows of CPU f32 views through idx (None: the
    caller's order), through the wrapper's own call (_rows_call), into
    rows filled with NaN first."""
    rows = torch.full((8, parts[0].shape[0]), float("nan"))
    assert pt._rows_call(lib, None if idx is None else idx.contiguous(),
                         *parts, rows, None) == 0
    return rows


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("n", [0, 1, 255, 257, 1025, 16384])
def test_host_ray_rows(key_libs, n, sort):
    """csrc/ray_rows.cu built for the host (its launch a loop over the
    threads) equals ray_rows_reference bit for bit, NaN payloads and signed
    zeros included, unsorted and through a seeded permutation; the inputs
    are left as they were."""
    parts, perm = rows_batch(n, n + 1)
    kept = tuple(a.clone() for a in parts)
    idx = perm if sort else None
    got = host_rows(key_libs[None], parts, idx)
    assert same_bits(got, pt.ray_rows_reference(*parts, idx))
    assert all(same_bits(a, k) for a, k in zip(parts, kept))


@pytest.mark.parametrize("sort", [False, True])
def test_host_ray_rows_strides(key_libs, sort):
    """The rows pass reads the rays through their element strides: an
    expanded origin and min_t (stride 0), a direction sliced from a wider
    tensor, a direction that is a transposed view and a max_t that is a
    column give the rows of contiguous copies, and the plain version's."""
    n = 1031
    (o, d, _, mx), perm = rows_batch(n, 5)
    wide = torch.from_numpy(np.random.default_rng(6).normal(
        size=(n, 7)).astype(np.float32))
    wide[:, 2:5] = d
    wide[:, 6] = mx
    layouts = {
        "camera": (o[:1].expand(n, 3), d, torch.zeros(()).expand(n), mx),
        "sliced": (o, wide[:, 2:5], torch.zeros(n), wide[:, 6]),
        "transposed": (o, d.T.contiguous().T, torch.zeros(n), mx)}
    assert layouts["camera"][0].stride() == (0, 1)
    assert layouts["sliced"][1].stride() == (7, 1)
    assert layouts["transposed"][1].stride() == (1, n)
    idx = perm if sort else None
    lib = key_libs[None]
    for name, parts in layouts.items():
        got = host_rows(lib, parts, idx)
        assert same_bits(got, host_rows(
            lib, tuple(a.contiguous() for a in parts), idx)), name
        assert same_bits(got, pt.ray_rows_reference(*parts, idx)), name


def test_ray_rows_kernel_takes_cuda_tensors():
    """The rows pass's wrapper never runs on the CPU: it refuses CPU
    tensors, and a batch of wrong shape or index, before it launches."""
    (o, d, mn, mx), perm = rows_batch(9, 1)
    before = pt.ROWS_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        pt.ray_rows_kernel(o, d, mn, mx)
    with pytest.raises(ValueError, match="CUDA"):
        pt.ray_rows_kernel(o, d, mn, mx, perm)
    with pytest.raises(ValueError, match="int64"):
        pt.ray_rows_kernel(o, d, mn, mx, perm.to(torch.int32))
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        pt.ray_rows_kernel(o, d[:, :2], mn, mx)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        pt.ray_rows_kernel(o, d, mn[:4], mx)
    assert pt.ROWS_LAUNCHES == before


# ---- csrc/candidates.cu: the instance candidate slab ----

@pytest.mark.parametrize("name,c", CANDIDATE_CASES)
def test_host_instance_candidates(key_libs, name, c):
    """csrc/candidates.cu built for the host (its launch a loop over the
    threads) equals _instance_candidates_impl bit for bit, through the
    wrapper's own call (_candidates_call), every output filled with
    SENTINEL first: ties on entry distance (the first instance wins),
    +-0.0 components and distances, origins inside boxes, dead rows and
    rows that miss every box, c from 1 to past B, a c + 1 above 32 (the
    passes), a batch that is not a whole block, one ray and none."""
    from rtk_tpu_torch import instancing

    lo, hi, rays = candidate_case(name)
    n, k = rays.count, min(c, lo.shape[0])
    out = (torch.full((n, k), SENTINEL, dtype=torch.int32),
           torch.full((n, k), SENTINEL, dtype=torch.int32).view(
               torch.float32),
           torch.full((n,), SENTINEL, dtype=torch.int32).view(torch.float32))
    if n:
        assert instancing._candidates_call(key_libs[None], lo, hi, rays, k,
                                           *out, None) == 0
    want = instancing._instance_candidates_impl(lo, hi, rays, c)
    assert_same_candidates(out, want, f"{name} c={c}")


def test_candidates_kernel_checks_before_launch(monkeypatch):
    """The slab's wrapper refuses a tensor of the wrong device, dtype or
    shape, a view that is not contiguous, no box or c < 1, and CPU tensors,
    before it launches; the dispatcher sends CPU rays to the plain slab."""
    from rtk_tpu_torch import instancing

    monkeypatch.setattr(library, "launch", lambda *a: pytest.fail(
        "the wrapper launched"))
    lo, hi, rays = candidate_case("mixed")
    before = instancing.CANDIDATE_LAUNCHES

    def refused(match, lo=lo, hi=hi, c=12, **over):
        bad = dataclasses.replace(rays, **over)
        with pytest.raises(ValueError, match=match):
            instancing.candidates_kernel(lo, hi, bad, c)

    refused("CUDA")
    refused("origin", origin=rays.origin.to("meta"))
    refused("direction", direction=rays.direction.double())
    refused("min_t", min_t=rays.min_t[:-1])
    refused("max_t", max_t=rays.max_t[:, None])
    refused("hi", hi=hi[:-1])
    refused("lo", lo=lo.to(torch.float16))
    refused("contiguous",
            direction=rays.direction.T.contiguous().T)
    refused("c >= 1", c=0)
    refused("a box", lo=lo[:0], hi=hi[:0])
    assert instancing.CANDIDATE_LAUNCHES == before
    iscene = SimpleNamespace(inst_lo=lo, inst_hi=hi)
    assert_same_candidates(
        instancing._instance_candidates(iscene, rays, 12),
        instancing._instance_candidates_impl(lo, hi, rays, 12), "dispatch")


# ---- csrc/rounds.cu: an instanced round's object rays and scatter ----

@pytest.mark.parametrize("affines,m", ROUND_CASES)
def test_host_round_rays(key_libs, affines, m):
    """csrc/rounds.cu's round rays built for the host (its launch a loop
    over the threads) equal round_rays_reference (_object_rays and the
    eager gathers) bit for bit, through the wrapper's own call
    (_round_rays_call), every output filled with SENTINEL first: uniform
    scales, rotations, negative scales, one instance; 0 to 391 rows."""
    from rtk_tpu_torch import instancing
    from rtk_tpu_torch.types import Rays

    args = round_case(affines, m)
    ids = torch.full((2, m), SENTINEL, dtype=torch.int32)
    out = (_filled(m, 3), _filled(m, 3), _filled(m), _filled(m), *ids)
    assert instancing._round_rays_call(key_libs[None], *args, *out,
                                       None) == 0
    assert_same_round_rays((Rays(*out[:4]), out[4], out[5]),
                           instancing.round_rays_reference(*args),
                           f"{affines} m={m}")


@pytest.mark.parametrize("name,m", SCATTER_CASES)
def test_host_round_scatter(key_libs, name, m):
    """csrc/rounds.cu's scatter built for the host leaves the frame's best
    records bit-equal to round_scatter_reference's (the masked
    index-puts), through the wrapper's own call (_round_scatter_call):
    misses, ties with best t, NaN t, a round where no row improves; 0 to
    391 rows."""
    from rtk_tpu_torch import instancing

    args, best = scatter_case(name, m)
    want = {k: v.clone() for k, v in best.items()}
    out = [best[k] for k in ("t", "u", "v", "slot", "inst")]
    assert instancing._round_scatter_call(key_libs[None], *args, *out,
                                          None) == 0
    instancing.round_scatter_reference(*args, want)
    assert_same_best(best, want, f"{name} m={m}")


def test_round_kernels_check_before_launch(monkeypatch):
    """The rounds' wrappers refuse a tensor of the wrong dtype, shape or
    device, a view that is not contiguous, and CPU tensors, before they
    launch; ROUND_LAUNCHES does not move."""
    from rtk_tpu_torch import instancing

    monkeypatch.setattr(library, "launch", lambda *a: pytest.fail(
        "the wrapper launched"))
    args = round_case("rotation", 33)
    names = {instancing.round_rays_kernel: (
        "rows", "inst", "origin", "direction", "min_t", "best_t",
        "object_from_world", "instance_blas", "packed_roots"),
        instancing.round_scatter_kernel: (
            "rows", "hit", "t", "u", "v", "slot", "bt", "inst")}
    before = instancing.ROUND_LAUNCHES

    def refused(fn, base, match, best=None, **over):
        got = dict(zip(names[fn], base))
        got.update(over)
        with pytest.raises(ValueError, match=match):
            fn(*got.values(), *(() if best is None else (best,)))

    rays = instancing.round_rays_kernel
    refused(rays, args, "CUDA")
    refused(rays, args, "rows", rows=args[0].int())
    refused(rays, args, "inst", inst=args[1][:-1])
    refused(rays, args, "origin", origin=args[2].to("meta"))
    refused(rays, args, "direction", direction=args[3].double())
    refused(rays, args, "min_t", min_t=args[4][:-1])
    refused(rays, args, "best_t", best_t=args[5][:, None])
    refused(rays, args, "object_from_world",
            object_from_world=args[6].reshape(-1, 4, 3))
    refused(rays, args, "instance_blas", instance_blas=args[7].long())
    refused(rays, args, "packed_roots", packed_roots=args[8].float())
    refused(rays, args, "contiguous",
            direction=args[3].T.contiguous().T)
    refused(rays, args, "contiguous",
            rows=torch.stack([args[0], args[0]], 1)[:, 0])
    sargs, best = scatter_case("mixed", 33)
    scatter = instancing.round_scatter_kernel
    refused(scatter, sargs, "CUDA", best=best)
    refused(scatter, sargs, "hit", best=best, hit=sargs[1].int())
    refused(scatter, sargs, "^t must", best=best, t=sargs[2][:-1])
    refused(scatter, sargs, "slot", best=best, slot=sargs[5].long())
    refused(scatter, sargs, "bt", best=best, bt=sargs[6].double())
    refused(scatter, sargs, "inst", best=best, inst=sargs[7][:, None])
    refused(scatter, sargs, r"best\['v'\]",
            best={**best, "v": best["v"][:-1]})
    refused(scatter, sargs, r"best\['slot'\]",
            best={**best, "slot": best["slot"].float()})
    refused(scatter, sargs, "contiguous", best=best,
            u=torch.stack([sargs[3], sargs[3]], 1)[:, 0])
    refused(scatter, sargs, "contiguous",
            best={**best, "t": torch.stack([best["t"]] * 2, 1)[:, 0]})
    assert instancing.ROUND_LAUNCHES == before


def test_round_launches_stay_zero_on_the_plain_route(monkeypatch):
    """An instanced trace of CPU tensors runs its rounds' glue eagerly:
    ROUND_LAUNCHES stays 0, six syncs a launched round are counted, and no
    kernel wrapper is called."""
    from rtk_tpu_torch import instancing
    from test_torch_instanced_path import instanced_case

    for name in ("round_rays_kernel", "round_scatter_kernel"):
        monkeypatch.setattr(instancing, name, lambda *a: pytest.fail(
            "the plain route called a round kernel"))
    for name in ("ROUND_LAUNCHES", "INSTANCED_SYNCS", "INSTANCED_ROUNDS"):
        monkeypatch.setattr(instancing, name, 0)
    case = instanced_case()
    st = {}
    hits, _ = instancing.trace_closest_instanced_packets(
        case["pscene"], case["rays"], 4, exact=False, stats=st)
    assert instancing.ROUND_LAUNCHES == 0 and bool(hits.hit.any())
    assert instancing.INSTANCED_ROUNDS == sum(k > 0 for k in
                                              st["live_counts"]) > 0
    assert instancing.INSTANCED_SYNCS == (len(st["live_counts"])
                                          + 6 * instancing.INSTANCED_ROUNDS)


# ---- csrc/shade.cu: render_path's shade pass ----

# The host build's sqrtf, cosf and sinf are torch's own on the CPU (its
# vectorised functions, which differ from libm's in the last bit for a
# few values), handed in as ctypes callbacks: on the card the kernel and
# torch call the same CUDA functions, and here the same torch ones, so the
# rest of the kernel's arithmetic is held bit for bit.  The norm's root is
# __fsqrt_rn, correctly rounded, as torch's norm takes it on both devices.
TORCH_MATH = r"""
typedef float (*rtk_unary_f)(float);
extern "C" { rtk_unary_f rtk_host_sqrtf, rtk_host_cosf, rtk_host_sinf; }
#define sqrtf(x) rtk_host_sqrtf(x)
#define cosf(x) rtk_host_cosf(x)
#define sinf(x) rtk_host_sinf(x)
"""
UNARY = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)


@pytest.fixture(scope="module")
def shade_lib(tmp_path_factory):
    """csrc/shade.cu built for the host (its launch a loop over the
    threads) with torch's CPU sqrt, cos and sin."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    tmp = tmp_path_factory.mktemp("shade_host")
    (tmp / "cuda_shim.h").write_text(CUDA_SHIM)
    cpp = tmp / "shade.cpp"
    cpp.write_text(front_host_source(library.SHADE_SRC, 1).replace(
        '#include "cuda_shim.h"', '#include "cuda_shim.h"\n' + TORCH_MATH))
    so = tmp / "libshade.so"
    subprocess.run([shutil.which("g++"), "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{tmp}", str(cpp), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.rtk_shade.restype = ctypes.c_int
    lib.rtk_shade.argtypes = [ctypes.c_void_p] * 2
    hooks = {name: UNARY(lambda x, f=f: float(f(torch.tensor(
        [x], dtype=torch.float32))[0]))
        for name, f in (("sqrtf", torch.sqrt), ("cosf", torch.cos),
                        ("sinf", torch.sin))}
    for name, hook in hooks.items():
        ctypes.c_void_p.in_dll(lib, f"rtk_host_{name}").value = ctypes.cast(
            hook, ctypes.c_void_p).value
    lib.hooks = hooks  # the callbacks live as long as the library
    return lib


SHADE_SIDE = 32
# Three materials for the hall's four meshes (the walls' index is past
# them and clamps to the last); the second's albedo ends every path that
# hits the ceiling by the throughput floor.
SHADE_ALBEDO = [[0.7, 0.7, 0.7], [1e-6, 1e-6, 1e-6], [0.6, 0.3, 0.3]]
SHADE_EMISSION = [[0, 0, 0], [4.0, 4.0, 4.0], [0.1, 0.2, 0.3]]


@pytest.fixture(scope="module")
def shade_scene():
    """The lit hall of tests/test_torch_path.py (open on two sides, so
    rays miss), its materials, and 32^2 camera rays."""
    from test_torch_path import _hall

    parts = [p.astype(np.float32) for p in _hall()]
    scene = rt.build_scene([(p.reshape(-1, 3),
                             np.arange(3 * len(p)).reshape(-1, 3))
                            for p in parts], device=CPU)
    from rtk_tpu_torch.models import path

    return dict(scene=scene, tracer=rt.Tracer(scene),
                stackless=rt.Tracer(scene, engine="stackless"),
                mats=path.Materials.make(SHADE_ALBEDO, SHADE_EMISSION,
                                         device=CPU),
                bg=torch.tensor([0.2, 0.3, 0.4]),
                rays=scenes.camera_rays((0.3, 1.4, 1.8), (0, 1.0, 0),
                                        (0, 1, 0), 75, SHADE_SIDE,
                                        SHADE_SIDE, order="morton",
                                        device=CPU))


def shade_batch(sc, bounce, seed):
    """A bounce batch of the hall -> (rays, throughput, index, radiance,
    uniforms by path): bounce 0 the camera's rays; bounce 1 the next rays
    of bounce 0 through the plain pass (dead rays among them).  Seeded
    throughputs (every seventh under the floor once the albedo is taken),
    a permutation of the paths (more paths than rays) and radiance."""
    from rtk_tpu_torch.models import path

    g = torch.Generator().manual_seed(seed)
    n = sc["rays"].count
    paths = n + 77
    cur = sc["rays"]
    if bounce:
        prev = shade_batch(sc, 0, seed + 1)
        hits = sc["tracer"].closest(prev[0])
        u = prev[4][prev[2]]
        cur = path._shade_sample(
            hits, prev[0], prev[1], prev[2], prev[3].clone(), sc["mats"],
            None, sc["bg"], sc["scene"].bounds_min, sc["scene"].bounds_max,
            epsilon=1e-4, sort_rays=True, last=False, u1=u[:, 0],
            u2=u[:, 1])[1]
    throughput = torch.rand((n, 3), generator=g)
    throughput[::7] *= 1e-4
    return (cur, throughput, torch.randperm(paths, generator=g)[:n],
            torch.rand((paths, 3), generator=g),
            torch.rand((paths, 2), generator=g))


def host_shade(lib, hits, cur, throughput, index, radiance, sc, *,
               sort_rays, last, draws=None, draw_index=None):
    """The host build's pass through the wrapper's own checks and call
    (_shade_args, _shade_call) -> radiance if last, else (radiance, next
    rays, throughput, key, number alive); the outputs are filled with NaN
    (keys with -1) first."""
    from rtk_tpu_torch.models import path

    args, out, keep = path._shade_args(
        hits, cur, throughput, index, radiance, sc["mats"], sc["bg"],
        sc["scene"].bounds_min, sc["scene"].bounds_max, epsilon=1e-4,
        sort_rays=sort_rays, last=last, draws=draws, draw_index=draw_index)
    if out is not None:
        nxt, tp, key, alive = out
        for a in (nxt.origin, nxt.direction, nxt.min_t, nxt.max_t, tp):
            a.fill_(float("nan"))
        key.fill_(-1)
        alive.fill_(-5)  # the entry point zeroes it
    assert path._shade_call(lib, args, None) == 0
    del keep
    return radiance if last else (radiance, *out)


def assert_shade_equal(got, want, sc, sort_rays):
    """Every output of the kernel equals the plain pass's bit for bit: the
    radiance, the next rays, the throughput and the live count, the sort
    permutation of its key, and the key itself, made again from the plain
    pass's next rays with models/path.py's own _ray_sort_key."""
    from rtk_tpu_torch.models import path

    radiance, nxt, tp, key, alive = got
    w_rad, w_nxt, w_tp, w_perm, w_alive = want
    assert same_bits(radiance, w_rad), "radiance"
    for f in ("origin", "direction", "min_t", "max_t"):
        assert same_bits(getattr(nxt, f), getattr(w_nxt, f)), f
    assert same_bits(tp, w_tp), "throughput"
    assert int(alive) == int(w_alive)
    assert torch.equal(torch.sort(key, stable=True).indices, w_perm)
    dead = (w_nxt.max_t == 0).to(torch.int32)
    if sort_rays:
        dead = (dead << 28) | (path._ray_sort_key(
            w_nxt, sc["scene"].bounds_min, sc["scene"].bounds_max) >> 4)
    assert torch.equal(key, dead)


@pytest.mark.parametrize("handed", [False, True])
@pytest.mark.parametrize("sort_rays", [True, False])
@pytest.mark.parametrize("record", ["packet", "plain"])
@pytest.mark.parametrize("bounce", [0, 1])
def test_host_shade_equals_plain(shade_lib, shade_scene, bounce, record,
                                 sort_rays, handed):
    """csrc/shade.cu built for the host equals models/path.py's plain
    _shade_sample bit for bit on a 32^2 bounce batch of the hall (misses
    through the open sides, rays dead by the throughput floor, a mesh
    past the material count), on a PacketHits record and on the stackless
    engine's plain Hits, with the sort on and off, and with a generator's
    (2, N) draw read by slot or the uniforms handed in read by path."""
    from rtk_tpu_torch.models import path

    sc = shade_scene
    cur, tp, index, radiance, uniforms = shade_batch(sc, bounce, 40 + bounce)
    hits = sc["tracer" if record == "packet" else "stackless"].closest(cur)
    assert isinstance(hits, rt.PacketHits) == (record == "packet")
    hit = hits.hit
    assert 0 < int(hit.sum()) < cur.count
    if handed:
        draws, draw_index = uniforms, index
        u = uniforms[index]
    else:
        u = torch.rand((2, cur.count),
                       generator=torch.Generator().manual_seed(9)).T
        draws, draw_index = u, None
        assert draws.stride() == (1, cur.count)
    kept = (tp.clone(), index.clone(), draws.clone())
    want = path._shade_sample(
        hits, cur, tp, index, radiance.clone(), sc["mats"], None, sc["bg"],
        sc["scene"].bounds_min, sc["scene"].bounds_max, epsilon=1e-4,
        sort_rays=sort_rays, last=False, u1=u[:, 0], u2=u[:, 1])
    got = host_shade(shade_lib, hits, cur, tp, index, radiance, sc,
                     sort_rays=sort_rays, last=False, draws=draws,
                     draw_index=draw_index)
    assert_shade_equal(got, want, sc, sort_rays)
    assert got[0] is radiance  # updated in place
    dead = got[1].max_t == 0
    assert bool(dead[~hit].all()) and bool(dead[hit].any())
    assert all(torch.equal(a, b) for a, b in zip((tp, index, draws), kept))


@pytest.mark.parametrize("record", ["packet", "plain"])
def test_host_shade_last_bounce(shade_lib, shade_scene, record):
    """The last bounce adds the emission or the sky to the radiance and
    writes nothing else: no draws are read."""
    from rtk_tpu_torch.models import path

    sc = shade_scene
    cur, tp, index, radiance, _ = shade_batch(sc, 1, 3)
    hits = sc["tracer" if record == "packet" else "stackless"].closest(cur)
    want = path._shade_sample(
        hits, cur, tp, index, radiance.clone(), sc["mats"], None, sc["bg"],
        sc["scene"].bounds_min, sc["scene"].bounds_max, epsilon=1e-4,
        sort_rays=True, last=True)
    got = host_shade(shade_lib, hits, cur, tp, index, radiance, sc,
                     sort_rays=True, last=True)
    assert got is radiance and same_bits(got, want)


def test_host_shade_strides(shade_lib, shade_scene):
    """The pass reads the rays and the record's rays through their
    element strides: a camera's expanded origin (row stride 0) and a
    direction that is a transposed view give the results of contiguous
    copies, and the plain pass's."""
    from rtk_tpu_torch.models import path

    sc = shade_scene
    _, tp, index, radiance, uniforms = shade_batch(sc, 0, 8)
    r = sc["rays"]
    cur = rt.Rays(r.origin[:1].expand(r.count, 3),
                  r.direction.T.contiguous().T, r.min_t, r.max_t)
    assert cur.origin.stride() == (0, 1)
    assert cur.direction.stride() == (1, r.count)
    flat = rt.Rays(*(a.contiguous() for a in (cur.origin, cur.direction,
                                              cur.min_t, cur.max_t)))
    u = uniforms[index]
    want = path._shade_sample(
        sc["tracer"].closest(flat), flat, tp, index, radiance.clone(),
        sc["mats"], None, sc["bg"], sc["scene"].bounds_min,
        sc["scene"].bounds_max, epsilon=1e-4, sort_rays=True, last=False,
        u1=u[:, 0], u2=u[:, 1])
    hits = sc["tracer"].closest(cur)
    assert hits.origin.stride() == (0, 1)
    got = host_shade(shade_lib, hits, cur, tp, index, radiance, sc,
                     sort_rays=True, last=False, draws=uniforms,
                     draw_index=index)
    assert_shade_equal(got, want, sc, True)


def test_shade_kernel_takes_cuda_tensors(shade_scene):
    """The shade pass's wrapper never runs on the CPU (render_path sends
    CPU tensors to the plain pass), and it refuses a wrong device, dtype
    or shape before it launches."""
    from rtk_tpu_torch.models import path

    sc = shade_scene
    cur, tp, index, radiance, uniforms = shade_batch(sc, 0, 5)
    hits = sc["tracer"].closest(cur)
    lo, hi = sc["scene"].bounds_min, sc["scene"].bounds_max
    kw = dict(epsilon=1e-4, sort_rays=True, last=False, draws=uniforms,
              draw_index=index)
    before = path.SHADE_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        path.shade_kernel(hits, cur, tp, index, radiance, sc["mats"],
                          sc["bg"], lo, hi, **kw)

    def refused(match, **over):
        a = dict(hits=hits, cur=cur, throughput=tp, index=index,
                 radiance=radiance, materials=sc["mats"], bg=sc["bg"],
                 lo=lo, hi=hi, **kw)
        a.update(over)
        with pytest.raises(ValueError, match=match):
            path._shade_args(**a)

    refused("meta", throughput=tp.to("meta"))
    refused("int64", index=index.to(torch.int32))
    refused(r"throughput must be a torch.float32 \(1024, 3\)",
            throughput=tp[:, :2])
    refused("float32", throughput=tp.double())
    refused("draw_index", draw_index=index[:9])
    refused(r"\(\*, 2\)", draws=uniforms[:, :1])
    refused(r"\(1101, 2\)", draws=uniforms[:50])
    refused("contiguous", radiance=radiance.T.contiguous().T)
    refused("hits.slot", hits=rt.PacketHits(
        **{**{f: getattr(hits, f) for f in (
            "hit", "t", "u_k", "v_k", "origin", "direction", "tri_v",
            "tri_vidx", "tri_mesh", "tri_prim")},
           "slot": hits.slot.to(torch.int64)}))
    assert path.SHADE_LAUNCHES == before


@pytest.fixture(scope="module")
def instanced_shade():
    """tests/test_torch_instanced_path.py's four rotated, unevenly scaled
    instances seen by 32^2 camera rays (misses around them), its
    InstancedTracer as the tracer and the union of its boxes as the
    scene's bounds."""
    from test_torch_instanced_path import instanced_case

    c = instanced_case(side=SHADE_SIDE)
    return dict(c, scene=c["tracer"].scene, bg=torch.tensor([0.2, 0.3, 0.4]))


@pytest.mark.parametrize("sort_rays", [True, False])
@pytest.mark.parametrize("bounce", [0, 1])
def test_host_shade_equals_plain_on_instanced_records(
        shade_lib, instanced_shade, bounce, sort_rays):
    """csrc/shade.cu built for the host equals the plain _shade_sample bit
    for bit on instanced records (the normal mapped to world space by the
    hit instance's object_from_world, a miss's -1 clamped to instance 0),
    on the camera's batch and a bounce batch, with the uniforms handed in
    by path; and the mapping moves the next rays."""
    from rtk_tpu_torch.models import path

    sc = instanced_shade
    cur, tp, index, radiance, uniforms = shade_batch(sc, bounce, 60 + bounce)
    hits = sc["tracer"].closest(cur)
    assert hits.instance is not None
    assert 0 < int(hits.hit.sum()) < cur.count
    u = uniforms[index]
    lo, hi = sc["scene"].bounds_min, sc["scene"].bounds_max
    want = path._shade_sample(
        hits, cur, tp, index, radiance.clone(), sc["mats"], None, sc["bg"],
        lo, hi, epsilon=1e-4, sort_rays=sort_rays, last=False, u1=u[:, 0],
        u2=u[:, 1])
    got = host_shade(shade_lib, hits, cur, tp, index, radiance.clone(), sc,
                     sort_rays=sort_rays, last=False, draws=uniforms,
                     draw_index=index)
    assert_shade_equal(got, want, sc, sort_rays)
    flat = host_shade(shade_lib, dataclasses.replace(
        hits, instance=None, object_from_world=None), cur, tp, index,
        radiance.clone(), sc, sort_rays=sort_rays, last=False,
        draws=uniforms, draw_index=index)
    moved = (flat[1].direction != got[1].direction).any(dim=1)
    assert bool(moved[hits.hit].all()) and not bool(moved[~hits.hit].any())


# ---- a deforming frame's refit and repack: csrc/refit.cu ----

@pytest.fixture(scope="module")
def refit_libs(tmp_path_factory):
    """csrc/refit.cu built for the host behind CUDA_SHIM, its launches run
    over the threads first to last ("forward") and last to first
    ("reversed"): in the climb, whichever child of a node comes second
    folds it, so the two builds fold every node from the other side."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    tmp = tmp_path_factory.mktemp("refit_host")
    (tmp / "cuda_shim.h").write_text(CUDA_SHIM)
    libs = {}
    for order in ("forward", "reversed"):
        cpp = tmp / f"refit_{order}.cpp"
        cpp.write_text(front_host_source(library.REFIT_SRC, 4,
                                         reverse=order == "reversed"))
        so = tmp / f"librefit_{order}.so"
        subprocess.run([shutil.which("g++"), "-std=c++17", "-O2",
                        "-ffp-contract=off", "-shared", "-fPIC",
                        f"-I{tmp}", str(cpp), "-o", str(so)], check=True,
                       capture_output=True, text=True)
        libs[order] = library.declare_refit(ctypes.CDLL(str(so)))
    return libs


def _filled(*shape):
    """An f32 output filled with SENTINEL, a NaN no pass writes."""
    return torch.full(shape, SENTINEL, dtype=torch.int32).view(torch.float32)


def host_refit(lib, scene, tri_pos):
    """scene.refit_kernel's launches on the host build over CPU tensors
    (outputs filled with SENTINEL first) -> the refit Scene."""
    import dataclasses

    n_leaf, k = scene.num_leaves, scene.leaf_size
    n_int = n_leaf - 1
    tri_pos = tri_pos.contiguous()
    tri_v = _filled(n_leaf * k, 3, 3)
    leaf_min, leaf_max = _filled(n_leaf, 3), _filled(n_leaf, 3)
    bounds_min, bounds_max = _filled(3), _filled(3)
    bmin, bmax = ((_filled(n_int, 3), _filled(n_int, 3)) if n_int
                  else (leaf_min, leaf_max))
    scratch = torch.full((2 * n_int + n_leaf,), -7, dtype=torch.int32)
    if n_int:
        assert lib.rtk_refit_parents(
            _ptr(scene.bin_left), _ptr(scene.bin_right), n_int, n_leaf,
            _ptr(scratch), None) == 0
    assert lib.rtk_refit_leaves(
        _ptr(tri_pos), scene.num_tris, _ptr(scene.perm), n_leaf, k,
        _ptr(scene.bin_left), _ptr(scene.bin_right), _ptr(scratch),
        *map(_ptr, (tri_v, leaf_min, leaf_max, bmin, bmax, bounds_min,
                    bounds_max)), None) == 0
    node_min, node_max = scene.node_min, scene.node_max
    if not n_int:
        node_min, node_max = node_min.clone(), node_max.clone()
        node_min[0, 0], node_max[0, 0] = leaf_min[0], leaf_max[0]
    elif scene.has_wide:
        node_min, node_max = (_filled(*scene.node_min.shape)
                              for _ in range(2))
        assert lib.rtk_refit_slots(
            _ptr(scene.node_child), scene.node_child.numel(), n_int, n_leaf,
            *map(_ptr, (bmin, bmax, leaf_min, leaf_max, node_min,
                        node_max)), None) == 0
    return dataclasses.replace(
        scene, node_min=node_min, node_max=node_max, tri_v=tri_v,
        leaf_min=leaf_min, leaf_max=leaf_max, bin_min=bmin, bin_max=bmax,
        bounds_min=bounds_min, bounds_max=bounds_max)


def host_repack(lib, packed, scene):
    """trace/packed.repack_kernel's launch on the host build over CPU
    tensors (outputs filled with SENTINEL first) -> the repacked tables."""
    import dataclasses

    nd, w = packed.slot_src.shape
    tp = packed.tri_perm.shape[0]
    nodes = torch.full((nd * w, 8), SENTINEL, dtype=torch.int32)
    tris, tri_v = _filled(tp, 16), _filled(tp, 3, 3)
    assert lib.rtk_repack(
        _ptr(packed.slot_src), _ptr(packed.meta), nd, w, _ptr(scene.bin_min),
        _ptr(scene.bin_max), scene.bin_min.shape[0], _ptr(scene.leaf_min),
        _ptr(scene.leaf_max), scene.leaf_min.shape[0], _ptr(packed.tri_perm),
        _ptr(scene.tri_v), scene.tri_v.shape[0], _ptr(packed.tri_mesh),
        _ptr(packed.tri_prim), _ptr(packed.tris), tp, _ptr(nodes),
        _ptr(tris), _ptr(tri_v), None) == 0
    return dataclasses.replace(packed, nodes=nodes, tris=tris, tri_v=tri_v)


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("name", ["grid", "shuffled", "one_leaf", "pad"])
def test_host_refit_and_repack(refit_libs, name, wide, order):
    """The refit's launches (the parents, the leaves' gather, fold and
    climb, the wide slots) and the repack's equal the plain refit and
    repack_bounds bit for bit on test_torch_refit.py's cases, a tri_mask
    riding the repack, with the climb's threads in either order; refit to
    the built soup gives back the built tables."""
    from test_torch_refit import CASES, _case, assert_bit_equal

    from rtk_tpu_torch.testing import carry
    from rtk_tpu_torch.trace import packed as tpacked

    assert name in CASES
    lib = refit_libs[order]
    base, moved, leaf = _case(name)
    scene = rt.build_from_soup(base, config=rt.BuildConfig(
        leaf_size=leaf, wide_nodes=wide), device=CPU)
    mask = (np.arange(base.shape[0]) % 3 + 1).astype(np.uint32)
    packed = pack_scene(scene, tri_mask=mask)
    for frame in (moved, base):
        want = rt.refit(scene, frame)
        got = host_refit(lib, scene, torch.from_numpy(frame))
        assert_bit_equal(got, want, carry.SCENE_ARRAYS)
        assert_bit_equal(host_repack(lib, packed, got),
                         tpacked.repack_bounds(packed, want),
                         carry.PACKED_ARRAYS)
    assert_bit_equal(got, scene, carry.SCENE_ARRAYS)


def _signed_zero_frame(seed=5, t=96):
    """A soup of t triangles and a frame of it in which every y is +0.0,
    -0.0 or above and every z is +0.0, -0.0 or below, drawn at random:
    the y minima and the z maxima of most leaves and nodes are zeros of
    both signs."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(t, 3, 3)).astype(np.float32)
    frame = base.copy()
    pick = rng.integers(0, 4, size=(t, 3))
    zeros = np.array([0.0, -0.0], np.float32)
    frame[..., 1] = np.where(pick < 2, zeros[pick % 2],
                             np.abs(frame[..., 1]) + 0.5)
    frame[..., 2] = np.where(pick % 3 == 0, zeros[(pick // 3) % 2],
                             -np.abs(frame[..., 2]) - 0.5)
    return base, frame


def _left_folds(rows, n_leaf, lo, hi):
    """Boxes of the leaves and of the leaf ranges [lo, hi] folded left to
    right, the left value kept on a tie: the rule of csrc/refit.cu."""
    def fold(vals, keep_left_min):
        acc = vals[0]
        for v in vals[1:]:
            acc = np.where((v < acc) if keep_left_min else (v > acc), v, acc)
        return acc

    per_leaf = rows.reshape(n_leaf, -1, 3)
    lmin = np.stack([fold(list(x), True) for x in per_leaf])
    lmax = np.stack([fold(list(x), False) for x in per_leaf])
    bmin = np.stack([fold(list(lmin[a:b + 1]), True) for a, b in zip(lo, hi)])
    bmax = np.stack([fold(list(lmax[a:b + 1]), False)
                     for a, b in zip(lo, hi)])
    return lmin, lmax, bmin, bmax


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("t,leaf", [(24, 4), (96, 2)])
def test_host_refit_signed_zeros(refit_libs, order, t, leaf):
    """-0.0 and +0.0 in one leaf and across one node's leaf range: every
    box is the leftmost extreme of its range (csrc/refit.cu's rule), with
    the climb's threads in either order.  The plain refit's leaf boxes and
    bounds (amin and amax) agree bit for bit.  Its node boxes come from a
    range table of vectorised torch.minimum and torch.maximum, whose tie
    keeps the right operand: they agree in value, and where their bits
    differ, the box's range holds zeros of both signs at its extreme."""
    from test_torch_refit import assert_bit_equal

    from rtk_tpu_torch.testing import carry
    from rtk_tpu_torch.trace import packed as tpacked

    lib = refit_libs[order]
    base, frame = _signed_zero_frame(t=t)
    scene = rt.build_from_soup(base, config=rt.BuildConfig(
        leaf_size=leaf, wide_nodes=True), device=CPU)
    got = host_refit(lib, scene, torch.from_numpy(frame))
    want = rt.refit(scene, frame)
    rows = got.tri_v.numpy().reshape(-1, 3)
    lo, hi = scene.bin_lo.numpy(), scene.bin_hi.numpy()
    lmin, lmax, bmin, bmax = _left_folds(rows, scene.num_leaves, lo, hi)

    def bits(a):
        return np.asarray(a).view(np.int32)

    def mixed(vals):  # zeros of both signs among the values
        z = vals == 0
        return (z & np.signbit(vals)).any(0) & (z & ~np.signbit(vals)).any(0)

    # The case is exercised: a leaf whose y minimum is a zero reached with
    # both signs, and a node whose leaves' y minima are zeros of both.
    per_leaf = rows.reshape(scene.num_leaves, -1, 3)
    assert any(mixed(x)[1] and x[:, 1].min() == 0 for x in per_leaf)
    assert any(mixed(lmin[a:b + 1])[1] and lmin[a:b + 1, 1].min() == 0
               for a, b in zip(lo, hi))
    assert np.array_equal(bits(got.leaf_min), bits(lmin))
    assert np.array_equal(bits(got.leaf_max), bits(lmax))
    assert np.array_equal(bits(got.bin_min), bits(bmin))
    assert np.array_equal(bits(got.bin_max), bits(bmax))
    # The root (node 0) covers every leaf: its box is the scene's bounds.
    assert np.array_equal(bits(got.bounds_min), bits(bmin[0]))
    assert np.array_equal(bits(got.bounds_max), bits(bmax[0]))
    for f in ("tri_v", "leaf_min", "leaf_max", "bounds_min", "bounds_max"):
        assert np.array_equal(bits(getattr(got, f)),
                              bits(getattr(want, f))), f
    for f, boxes, own in (("bin_min", lmin, bmin), ("bin_max", lmax, bmax)):
        plain = getattr(want, f).numpy()
        assert np.array_equal(plain, own), f  # equal values
        differ = bits(plain) != bits(own)
        tied = np.stack([mixed(boxes[a:b + 1]) for a, b in zip(lo, hi)])
        assert not (differ & ~(tied & (own == 0))).any(), f
    # The wide slots take their boxes from these, and so does the repack.
    for f in ("node_min", "node_max"):
        g, w = getattr(got, f), getattr(want, f)
        assert torch.equal(g, w), f
    packed = pack_scene(scene)
    assert_bit_equal(host_repack(lib, packed, got),
                     tpacked.repack_bounds(packed, got), carry.PACKED_ARRAYS)


def test_refit_and_repack_kernels_take_cuda_tensors():
    """refit_kernel and repack_kernel refuse CPU tensors (the plain
    versions take them) and launch nothing."""
    from rtk_tpu_torch import scene as tscene
    from rtk_tpu_torch.trace import packed as tpacked

    scene = rt.build_from_soup(scenes.deforming_grid(0.0, n=4), device=CPU)
    packed = pack_scene(scene)
    frame = torch.from_numpy(scenes.deforming_grid(0.3, n=4))
    before = tscene.REFIT_LAUNCHES, tpacked.REPACK_LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        tscene.refit_kernel(scene, frame)
    with pytest.raises(ValueError, match="CUDA device"):
        tpacked.repack_kernel(packed, scene)
    assert (tscene.REFIT_LAUNCHES, tpacked.REPACK_LAUNCHES) == before
    assert pt.front_steps(torch.device("cpu")).refit is tscene.refit_reference
    assert pt.CARD.repack is tpacked.repack_kernel
