"""Packet-table traversal: the trace front-end, the CUDA kernel's wrapper
and its plain PyTorch version.

`trace_packets` is the counterpart of rtk_tpu.ops.pallas_trace
.trace_packets: it orders the rays by a coherence key (for batches of
16384 rays and more), runs the traversal, restores the caller's order and
returns a lazy PacketHits.  The traversal runs in
  * `packet_trace_kernel`: the hand-written CUDA kernel
    (csrc/packet_trace.cu, one thread per ray), for CUDA tensors;
  * `packet_trace_reference`: a vectorised PyTorch traversal over the same
    tables with the same child order and arithmetic, for CPU tensors.
The two agree bit for bit.  A CUDA tensor always goes to the kernel: a
build or launch failure raises, it never falls back.  Tables are 8 or 16
wide (PackedScene.branching); each width is its own instantiation of the
kernel.

The sorted front end's own steps run as the port's kernels too, built
into the same library (ops/library.py): the coherence key
(`coherence_key_kernel`, csrc/coherence_key.cu), the rows stacked and
gathered through the sort's permutation in one pass (`ray_rows_kernel`,
csrc/ray_rows.cu) and the unsort of the outputs (`unsort_kernel`,
csrc/unsort.cu).  Which code runs the steps is one `Steps` value, which
`front_steps` picks by device: CARD, the kernels, for CUDA tensors; PLAIN,
the plain versions, for CPU tensors and in `trace_packets_reference`.

`packet_march` is the grid march over a table with one root row per
macro-grid cell (testing/grid.py): the kernel's march instantiation walks
each ray's cell chain in one launch; its plain version runs rounds of the
roots traversal over the live rays, one cell a round, with the kernel's
DDA arithmetic.

Multi-root tables (forests of BLAS trees, the instanced path, the grid's
cells) take a root per ray: `ray_roots`, or the reference's
`packet_roots`, one per 128-ray packet.  The kernel reads each ray's root
where the single-root trace starts at row 0.  A root is an entry in the
kernel's stack encoding: a node row, or -2 - l to start at leaf l (the
binned engine's subtree cut can surface a leaf).

`filter_fn` takes a predicate captured by ops/filter_capture.jit_filter:
the kernel's filter variant is a separate nvcc build per predicate, and
the plain version calls the predicate on torch tensors.  `stats=True`
returns per-ray counts of popped entries, internal pops, leaf pops, child
box tests and triangle tests beside the hits (the kernel's nullable
`counts` output).

`trace_packets_refit` and `trace_packets_refit_frames` are the dynamic
scene's front-ends: refit the tables to moved vertices on the device
(scene.refit + repack_bounds, each a `Steps` step: on the card
csrc/refit.cu's launches; or refit_packed_binary for a host-SAH
topology), then trace; `trace_packets_chunked` bounds the working memory
of a huge batch.  They run the same kernel.

The TPU kernel's scheduling flags (dual, ordered, islab, narrow,
leaf_loop, kz_static, tris128, hbm_tris, lesion, p_pk, pkt) pick how the
TPU steps its packets through the same function.  trace_packets accepts
them and they have no effect here, except that pkt and p_pk set the
packet geometry that packet_roots is laid out in; the combinations the
reference refuses raise ValueError here too (_check_flags).
`trace_packets_kz_binned` is the reference's dispatcher by dominant
direction axis; the kernel picks the shear axis per ray, so it is one
trace_packets call.

While a profiler records, a front end's call is the span
`rtk.packet_trace` (utils/stats.py::span) over its steps' spans:
`rtk.packet_trace.key` and `.sort` (sorted batches), `.rows`, `.launch`
(the traversal: the kernel's checks, library, outputs and launch, or the
plain version), `.unsort` and `.wrap` (the PacketHits).
The refit front ends run the steps' spans without the outer one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from rtk_tpu_torch.ops import library
from rtk_tpu_torch.ops.filter_capture import JitFilter
from rtk_tpu_torch.ops.intersect import intersect_triangles, ray_shear
from rtk_tpu_torch.ops.library import BUILD_SECONDS  # noqa: F401 (read here)
from rtk_tpu_torch.ops.morton import ray_coherence_key_reference
from rtk_tpu_torch.scene import refit_by, refit_kernel, refit_reference
from rtk_tpu_torch.trace.packed import (MASK_COL, MESH_COL, PRIM_COL,
                                        BinaryRefitAux, PackedScene,
                                        refit_packed_binary, repack_by,
                                        repack_kernel, repack_reference)
from rtk_tpu_torch.types import HitCandidate, PacketHits, Rays
from rtk_tpu_torch.utils.stats import span

_BIG = 3.0e38
SORT_RAYS_MIN = 16384  # coherence-sort batches at least this large
REF_CHUNK = 1 << 22  # rays per plain-version pass (bounds its stack tensor)
PKT = 128  # rays per packet of the reference's packet_roots layout
DEFAULT_P = 8  # packets per block of that layout
FILTER_MAX_TRIS = 1 << 24  # triangle ids ride f32 columns, exact below 2^24

# Launches of the CUDA kernel in this process, and of its variants
# (launches with per-ray roots, a filter predicate, per-ray counts, a
# 16-wide table, the grid march, any-hit mode, a filter mask or deferred
# u/v, each also counted in KERNEL_LAUNCHES).
# A run resets them and reads them back to show that its main path went
# through the kernel.  KEY_LAUNCHES counts calls of the coherence key's
# kernels (coherence_key_kernel: a memset and three launches each),
# ROWS_LAUNCHES launches of the rows pass (ray_rows_kernel),
# UNSORT_LAUNCHES launches of the unsort (unsort_kernel).
KERNEL_LAUNCHES = 0
KEY_LAUNCHES = 0
ROWS_LAUNCHES = 0
UNSORT_LAUNCHES = 0
ROOTS_LAUNCHES = 0
FILTER_LAUNCHES = 0
STATS_LAUNCHES = 0
W16_LAUNCHES = 0
MARCH_LAUNCHES = 0
ANY_LAUNCHES = 0
MASK_LAUNCHES = 0
DEFER_UV_LAUNCHES = 0
WIDTHS = (8, 16)  # node-table widths the kernel is instantiated for


def _check_tables(nodes, tris, rays8, w):
    if w not in WIDTHS:
        raise ValueError(f"node tables are 8 or 16 wide, not {w}")
    if (nodes.dtype != torch.int32 or nodes.ndim != 2 or nodes.shape[1] != 8
            or nodes.shape[0] % w):
        raise ValueError(f"nodes must be an (Nd*{w}, 8) int32 table")
    if tris.dtype != torch.float32 or tris.ndim != 2 or tris.shape[1] != 16:
        raise ValueError("tris must be a (Tp, 16) float32 table")
    if rays8.dtype != torch.float32 or rays8.ndim != 2 or rays8.shape[0] != 8:
        raise ValueError("rays must be an (8, N) float32 tensor")
    if not (nodes.device == tris.device == rays8.device):
        raise ValueError("tables and rays must be on one device")


def check_root_entries(roots, rows: int, leaves: int):
    """Refuse root entries outside a table of `rows` node rows and `leaves`
    leaves (one host sync on a device tensor).  An entry is in the
    kernel's stack encoding: a node row in [0, rows), or -2 - l for leaf l
    in [0, leaves), which starts the traversal at that leaf (a shallow cut
    surfaces leaves as roots: testing/binned.py)."""
    roots = torch.as_tensor(roots)
    if not roots.numel():
        return
    bad = (roots >= rows) | ((roots < 0) & ((roots > -2)
                                             | (roots < -1 - leaves)))
    if bool(bad.any()):
        lo, hi = (int(x) for x in torch.aminmax(roots))
        raise ValueError(f"root rows span [{lo}, {hi}]; the table has "
                         f"{rows} rows and {leaves} leaves (entries -2 - "
                         "leaf)")


def _check_roots(roots, nodes, rays8, w, leaves, in_range=False):
    """Per-ray root entries: (N,) int32 on the rays' device, each a row of
    the w-wide node table or a leaf (-2 - leaf; a bad root would read
    outside the tables).  One host sync, unless the caller knows the
    entries are in range (in_range)."""
    if roots is None:
        return None
    n = rays8.shape[1]
    if roots.dtype != torch.int32 or tuple(roots.shape) != (n,):
        raise ValueError(f"roots must be an ({n},) int32 tensor")
    if roots.device != rays8.device:
        raise ValueError("roots and rays must be on one device")
    if not in_range:
        check_root_entries(roots, nodes.shape[0] // w, leaves)
    return roots.contiguous()


def _require_captured(filter_fn):
    if filter_fn is not None and not isinstance(filter_fn, JitFilter):
        raise TypeError(
            "the kernel takes a filter captured by jit_filter; run other "
            "callables on the stack engine (trace_closest/trace_any, or "
            "Tracer.closest/any with the callable unmarked)")


def _check_filter(filter_fn, ray_index, rays8):
    _require_captured(filter_fn)
    if ray_index is None:
        return None
    if filter_fn is None:
        raise ValueError("ray_index is read by filter traces only")
    n = rays8.shape[1]
    if (ray_index.dtype != torch.int32 or tuple(ray_index.shape) != (n,)
            or ray_index.device != rays8.device):
        raise ValueError(f"ray_index must be an ({n},) int32 tensor on the "
                         "rays' device")
    return ray_index.contiguous()


def _kernel_prelude(nodes, tris, rays8, stack_size, w, filter_fn=None,
                    lib=None):
    """Checks shared by the kernel's launches -> (lib, nodes, tris,
    rays8), contiguous, and the library built for filter_fn (or `lib`, a
    library loaded already: utils/aot.py's embedded build)."""
    _check_tables(nodes, tris, rays8, w)
    if not rays8.is_cuda:
        raise ValueError("packet_trace_kernel takes CUDA tensors")
    nodes, tris, rays8 = (a.contiguous() for a in (nodes, tris, rays8))
    if any(a.data_ptr() % 16 for a in (nodes, tris)):
        raise ValueError("kernel tables must be 16-byte aligned")
    if lib is None:
        lib = library.load_kernel(filter_fn)
    cap = lib.rtk_packet_trace_max_stack()
    if stack_size > cap:
        raise ValueError(f"tree needs a {stack_size}-entry traversal stack; "
                         f"the kernel is compiled for {cap}")
    if rays8.shape[1] > 2 ** 31 - 1024:
        raise ValueError(f"{rays8.shape[1]} rays exceed the kernel's 32-bit "
                         "ray index")
    return lib, nodes, tris, rays8


def _ptr(a):
    return None if a is None else a.data_ptr()


def _launch(entry, call, rays8, stats, *args):
    """Allocate the outputs and launch call(*args, out pointers...,
    stream) on the rays' device (library.launch) -> (t, u, v, slot[,
    counts])."""
    n = rays8.shape[1]
    dev = rays8.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    counts = (torch.empty((5, n), dtype=torch.int32, device=dev) if stats
              else None)
    library.launch(dev, entry, call, *args, t.data_ptr(), u.data_ptr(),
                   v.data_ptr(), slot.data_ptr(), _ptr(counts))
    return (t, u, v, slot, counts) if stats else (t, u, v, slot)


def packet_trace_kernel(nodes, tris, rays8, *, leaf_size: int,
                        stack_size: int, mode: str = "closest",
                        watertight: bool = True, qmask: int | None = None,
                        defer_uv: bool = False, roots=None, filter_fn=None,
                        ray_index=None, stats: bool = False,
                        branching: int = 8):
    """Launch the CUDA kernel on the current stream -> (t, u, v, slot),
    and the (5, N) int32 counts as a fifth output with stats=True.

    rays8: (8, N) f32 rows [ox oy oz dx dy dz min_t max_t] on a CUDA
    device.  branching: the node table's width (8 or 16; each its own
    instantiation).  stack_size: entries the deepest tree can need
    (PackedScene.stack_size); raises before launch if the compiled stack
    is smaller.  roots: None (every ray starts at row 0) or (N,) int32
    root entries: node rows, or -2 - l to start at leaf l (the kernel's
    stack encoding).  filter_fn: None or a jit_filter predicate (its own kernel
    build); ray_index: None (the caller's index is the column) or (N,)
    int32 caller indices the predicate sees.  stats: per-ray counts of
    popped entries, internal pops, leaf pops, child box tests (live child
    slots of the popped nodes) and triangle tests (rows of the popped
    leaves that are not NaN padding and pass the mask).
    """
    return _kernel(nodes, tris, rays8, leaf_size=leaf_size,
                   stack_size=stack_size, mode=mode, watertight=watertight,
                   qmask=qmask, defer_uv=defer_uv, roots=roots,
                   filter_fn=filter_fn, ray_index=ray_index, stats=stats,
                   branching=branching)


def _kernel(nodes, tris, rays8, *, leaf_size, stack_size, mode="closest",
            watertight=True, qmask=None, defer_uv=False, roots=None,
            filter_fn=None, ray_index=None, stats=False, branching=8,
            roots_in_range=False, lib=None):
    """packet_trace_kernel, as CARD's trace; roots_in_range: the roots are
    entries of the tables already (checked on the host when their source
    was made, or clamped into range on the device), so the launch makes no
    host sync to check them.  lib: launch from this loaded library (an AOT
    artifact's, utils/aot.py) instead of the one built from the sources."""
    global KERNEL_LAUNCHES, ROOTS_LAUNCHES, FILTER_LAUNCHES, STATS_LAUNCHES
    global W16_LAUNCHES, ANY_LAUNCHES, MASK_LAUNCHES, DEFER_UV_LAUNCHES
    lib, nodes, tris, rays8 = _kernel_prelude(nodes, tris, rays8,
                                              stack_size, branching,
                                              filter_fn, lib)
    ray_index = _check_filter(filter_fn, ray_index, rays8)
    roots = _check_roots(roots, nodes, rays8, branching,
                         tris.shape[0] // leaf_size, roots_in_range)
    out = _launch(
        "rtk_packet_trace", lib.rtk_packet_trace, rays8, stats,
        nodes.data_ptr(), tris.data_ptr(), rays8.data_ptr(), _ptr(roots),
        _ptr(ray_index), rays8.shape[1], leaf_size, branching,
        int(mode == "any"), int(watertight), int(qmask is not None),
        int(qmask or 0), int(defer_uv))
    KERNEL_LAUNCHES += 1
    ROOTS_LAUNCHES += roots is not None
    FILTER_LAUNCHES += filter_fn is not None
    STATS_LAUNCHES += stats
    W16_LAUNCHES += branching == 16
    ANY_LAUNCHES += mode == "any"
    MASK_LAUNCHES += qmask is not None
    DEFER_UV_LAUNCHES += bool(defer_uv)
    return out


def coherence_key_kernel(origin: torch.Tensor, direction: torch.Tensor,
                         lib=None) -> torch.Tensor:
    """ray_coherence_key on the card: the (N,) int32 keys of (N, 3)
    origins and directions on one CUDA device, from the library's
    rtk_coherence_key (csrc/coherence_key.cu: a memset and three launches
    on the current stream, no host sync), equal bit for bit to
    ops/morton.py's plain version on a CPU copy.  Any strides (a camera's
    expanded origin is read in place).  lib: a loaded library to launch
    from (an AOT artifact's, utils/aot.py) instead of the one built from
    the sources.  Raises if the tensors are not on the card or the build
    or the launch fails."""
    global KEY_LAUNCHES
    o, d = origin.to(torch.float32), direction.to(torch.float32)
    if o.ndim != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError("origin and direction must be (N, 3) tensors")
    if not (o.is_cuda and d.device == o.device):
        raise ValueError("coherence_key_kernel takes CUDA tensors on one "
                         "device")
    key = torch.empty((o.shape[0],), dtype=torch.int32, device=o.device)
    if not key.numel():
        return key
    if lib is None:
        lib = library.load_kernel()
    bounds = torch.empty((12,), dtype=torch.int32, device=o.device)
    library.launch(o.device, "rtk_coherence_key", _key_call, lib, o, d,
                   bounds, key)
    KEY_LAUNCHES += 1
    return key


def _key_call(lib, o, d, bounds, key, stream):
    """rtk_coherence_key on f32 (N, 3) views o and d (element strides),
    12 int32 of scratch and the (N,) int32 output -> its error code."""
    return lib.rtk_coherence_key(o.data_ptr(), *o.stride(), d.data_ptr(),
                                 *d.stride(), o.shape[0], bounds.data_ptr(),
                                 key.data_ptr(), stream)


def ray_rows_kernel(origin, direction, min_t, max_t, idx=None, lib=None):
    """The (8, N) f32 rows [ox oy oz dx dy dz min_t max_t] the traversal
    reads, on the card: one launch of the library's rtk_ray_rows
    (csrc/ray_rows.cu), equal bit for bit to ray_rows_reference.
    origin, direction: (N, 3); min_t, max_t: (N,); any strides (a camera's
    expanded origin is read in place) and any float type (cast to f32).
    idx: None (the caller's order) or (N,) int64, the caller's index of
    each sorted ray (a permutation), whose order the rows take.  lib: as
    coherence_key_kernel's.  Raises if the tensors are not on one card or
    the launch fails."""
    global ROWS_LAUNCHES
    # The dtype test skips .to's dispatch on f32 inputs: a rooted round
    # calls this once per round on a few rays, where host time is the cost.
    o, d, mn, mx = (a if a.dtype == torch.float32 else a.to(torch.float32)
                    for a in (origin, direction, min_t, max_t))
    n = o.shape[0]
    if (o.ndim != 2 or o.shape[1] != 3 or d.shape != o.shape
            or mn.shape != (n,) or mx.shape != (n,)):
        raise ValueError("origin and direction must be (N, 3) tensors and "
                         "min_t and max_t (N,) tensors")
    if idx is not None and (idx.dtype != torch.int64
                            or tuple(idx.shape) != (n,)):
        raise ValueError(f"idx must be an ({n},) int64 tensor")
    ins = (o, d, mn, mx) if idx is None else (o, d, mn, mx, idx)
    if not (o.is_cuda and all(a.device == o.device for a in ins)):
        raise ValueError("ray_rows_kernel takes CUDA tensors on one device")
    rows = torch.empty((8, n), dtype=torch.float32, device=o.device)
    if n:
        if lib is None:
            lib = library.load_kernel()
        if idx is not None:
            idx = idx.contiguous()
        library.launch(o.device, "rtk_ray_rows", _rows_call, lib, idx, o, d,
                       mn, mx, rows)
        ROWS_LAUNCHES += 1
    return rows


def _rows_call(lib, idx, o, d, mn, mx, rows, stream):
    """rtk_ray_rows of f32 views o, d (N, 3) and mn, mx (N,) (element
    strides) through idx (None or contiguous (N,) int64) into the
    contiguous (8, N) rows -> its error code."""
    return lib.rtk_ray_rows(_ptr(idx), o.shape[0], o.data_ptr(), *o.stride(),
                            d.data_ptr(), *d.stride(), mn.data_ptr(),
                            *mn.stride(), mx.data_ptr(), *mx.stride(),
                            rows.data_ptr(), stream)


def ray_rows_reference(origin, direction, min_t, max_t, idx=None):
    """ray_rows_kernel's plain version, on any device: the rows stacked in
    the caller's order (a cat), then gathered through idx when it is
    given."""
    rows = torch.cat([origin.T, direction.T, min_t[None],
                      max_t[None]]).to(torch.float32)
    return rows if idx is None else rows[:, idx].contiguous()


def unsort_kernel(out, idx, lib=None):
    """The traversal's outputs (t, u, v, slot[, counts]) in the sorted
    order back in the caller's order, on the card: one launch of the
    library's rtk_unsort (csrc/unsort.cu), equal to unsort_reference.
    idx: (N,) int64, the caller's index of each sorted ray (a
    permutation).  lib: as coherence_key_kernel's.  Raises if the tensors
    are not on the card or the launch fails."""
    global UNSORT_LAUNCHES
    t = out[0]
    n = t.shape[0]
    if not (idx.is_cuda and all(a.device == idx.device for a in out)):
        raise ValueError("unsort_kernel takes CUDA tensors on one device")
    if idx.dtype != torch.int64 or tuple(idx.shape) != (n,):
        raise ValueError(f"idx must be an ({n},) int64 tensor")
    idx = idx.contiguous()
    out = tuple(a.contiguous() for a in out)
    res = tuple(torch.empty_like(a) for a in out)
    if n:
        if lib is None:
            lib = library.load_kernel()
        library.launch(t.device, "rtk_unsort", _unsort_call, lib, idx, out,
                       res)
        UNSORT_LAUNCHES += 1
    return res


def _unsort_call(lib, idx, out, res, stream):
    """rtk_unsort of contiguous outputs `out` into `res` -> its error
    code."""
    counts = out[4] if len(out) > 4 else None
    return lib.rtk_unsort(idx.data_ptr(), idx.shape[0],
                          *(a.data_ptr() for a in out[:4]), _ptr(counts),
                          *(a.data_ptr() for a in res[:4]),
                          _ptr(res[4] if len(res) > 4 else None), stream)


def unsort_reference(out, idx):
    """unsort_kernel's plain version: an empty_like and an index-put an
    output, on any device."""
    def unsort(a):
        res = torch.empty_like(a)
        res[..., idx] = a
        return res

    return tuple(map(unsort, out))


def _crcp(d):
    """Clamped reciprocal: +-3e38 for d == 0 (sign from d >= 0)."""
    big = torch.where(d >= 0, _BIG, -_BIG).to(d.dtype)
    return torch.where(d == 0.0, big, 1.0 / d)


def _popc16(v):
    """Set bits of each value in [0, 2^16) (int32 tensors)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def _trace_chunk(nodes3, tris, rays8, roots, ray_index, *, leaf_size,
                 stack_size, mode, watertight, qmask, defer_uv, filter_fn,
                 stats):
    """Per-ray depth-first traversal, every ray popping one entry a step.
    nodes3: (Nd, W, 8) node rows.  ray_index: the caller's index of each
    column (for filter_fn)."""
    dev = rays8.device
    w = nodes3.shape[1]
    wmask = (1 << w) - 1
    ox, oy, oz, dx, dy, dz, mint, maxt = rays8
    m = rays8.shape[1]
    # Pops and tests per ray, counted where the kernel counts them.
    n_int, n_leaf, n_box, n_tri = torch.zeros((4, m), dtype=torch.int32,
                                              device=dev)
    origin = torch.stack([ox, oy, oz], dim=1)
    direction = torch.stack([dx, dy, dz], dim=1)
    rcp = _crcp(direction)
    best_t = maxt.clone()
    best_u = torch.zeros_like(maxt)
    best_v = torch.zeros_like(maxt)
    best_s = torch.full((m,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((m, max(stack_size, 1)), dtype=torch.int32,
                        device=dev)
    if roots is not None:
        stack[:, 0] = roots  # each ray's root row (default: row 0)
    sp = torch.where(maxt <= mint, 0, 1).to(torch.int64)
    wbits = 1 << torch.arange(w, device=dev, dtype=torch.int32)
    k_iota = torch.arange(leaf_size, device=dev)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        sp[act] -= 1
        e = stack[act, sp[act]]
        inner = e >= 0
        if stats:
            n_int[act] += inner.to(torch.int32)
            n_leaf[act] += (~inner).to(torch.int32)

        ia, ie = act[inner], e[inner].long()
        if ia.numel():
            rows = nodes3[ie]  # (k, W, 8) i32
            b = rows[..., :6].contiguous().view(torch.float32)
            o, r = origin[ia, None, :], rcp[ia, None, :]
            pos = r >= 0
            near = (torch.where(pos, b[..., :3], b[..., 3:]) - o) * r
            far = (torch.where(pos, b[..., 3:], b[..., :3]) - o) * r
            enter = torch.maximum(torch.maximum(near[..., 0], near[..., 1]),
                                  torch.maximum(near[..., 2],
                                                mint[ia, None]))
            exit_ = torch.minimum(torch.minimum(far[..., 0], far[..., 1]),
                                  torch.minimum(far[..., 2],
                                                best_t[ia, None]))
            fc, fl = rows[:, 0, 6:7], rows[:, 0, 7:8]
            # Internal mask in bits 0..W-1, leaf mask above it (at W=16
            # through the sign bit: the shift's sign fill is masked off).
            im = rows[:, 1, 6:7] & wmask
            lm = (rows[:, 1, 6:7] >> w) & wmask
            if stats:
                n_box[ia] += _popc16(im | lm)[:, 0]
            is_i = (im & wbits) != 0
            is_l = (lm & wbits) != 0
            below = wbits - 1
            entry = torch.where(is_i, fc + _popc16(im & below),
                                -(fl + _popc16(lm & below)) - 2)
            hit = (enter <= exit_) & (is_i | is_l)
            # Near-to-far by entry distance, ties by slot, misses last:
            # two stable sorts give the (miss, enter, slot) order.
            o1 = torch.sort(torch.where(hit, enter, float("inf")), dim=1,
                            stable=True).indices
            o2 = torch.sort((~hit.gather(1, o1)).to(torch.int8), dim=1,
                            stable=True).indices
            ent = entry.gather(1, o1.gather(1, o2))
            cnt = hit.sum(dim=1)
            base = sp[ia]
            for j in range(w):  # push far first: top = nearest
                sel = j < cnt
                rj = ia[sel]
                stack[rj, base[sel] + j] = ent[sel, cnt[sel] - 1 - j]
            sp[ia] = base + cnt

        la, le = act[~inner], e[~inner].long()
        if la.numel():
            slots = (-le - 2)[:, None] * leaf_size + k_iota  # (k, K)
            trow = tris[slots]  # (k, K, 16)
            t, u, v, ok = intersect_triangles(
                origin[la], ray_shear(direction[la]),
                trow[..., :9].reshape(-1, leaf_size, 3, 3),
                mint[la], best_t[la], watertight=watertight)
            # The rows tested: not NaN padding (never a hit) and, under a
            # mask, passing it; the kernel skips the rest before any
            # arithmetic.
            tested = trow[..., 0] == trow[..., 0]
            if qmask is not None:
                tested &= (trow[..., MASK_COL].to(torch.int32) & qmask) != 0
                ok &= tested
            if stats:
                n_tri[la] += tested.sum(dim=1, dtype=torch.int32)
            if filter_fn is not None:
                # The caller's predicate on (rays, K) candidates, with u
                # and v even under defer_uv (pallas_trace.py:1003-1018).
                ok &= filter_fn(HitCandidate(
                    t=t, u=u, v=v,
                    mesh_index=trow[..., MESH_COL].to(torch.int32),
                    triangle_index=trow[..., PRIM_COL].to(torch.int32),
                    ray_index=ray_index[la, None].expand(-1, leaf_size)))
            # The nearest accepted triangle, first on ties: the kernel's
            # sequential t < best update over the leaf's rows.
            tk, kk = torch.where(ok, t, float("inf")).min(dim=1)
            upd = ok.any(dim=1)
            lu, ku = la[upd], kk[upd]
            best_t[lu] = tk[upd]
            best_s[lu] = slots[upd, ku].to(torch.int32)
            if not defer_uv:
                best_u[lu] = u[upd, ku]
                best_v[lu] = v[upd, ku]
            if mode == "any":
                sp[la[best_s[la] >= 0]] = 0
    out = (best_t, best_u, best_v, best_s)
    if stats:
        out += (torch.stack([n_int + n_leaf, n_int, n_leaf, n_box, n_tri]),)
    return out


def packet_trace_reference(nodes, tris, rays8, *, leaf_size: int,
                           stack_size: int, mode: str = "closest",
                           watertight: bool = True,
                           qmask: int | None = None, defer_uv: bool = False,
                           roots=None, filter_fn=None, ray_index=None,
                           stats: bool = False, branching: int = 8):
    """The kernel's plain PyTorch version on any device -> (t, u, v, slot)
    and, with stats=True, the (5, N) counts.

    Same tables, child order and arithmetic as csrc/packet_trace.cu; a
    filter_fn is called on torch tensors.  Rays run REF_CHUNK at a time to
    bound the (rays, stack_size) stack tensor.
    """
    _check_tables(nodes, tris, rays8, branching)
    roots = _check_roots(roots, nodes, rays8, branching,
                         tris.shape[0] // leaf_size)
    ray_index = _check_filter(filter_fn, ray_index, rays8)
    if filter_fn is not None and ray_index is None:
        ray_index = torch.arange(rays8.shape[1], dtype=torch.int32,
                                 device=rays8.device)
    nodes3 = nodes.reshape(-1, branching, 8)

    def part(a, s):
        return None if a is None else a[s:s + REF_CHUNK]

    outs = [_trace_chunk(nodes3, tris, rays8[:, s:s + REF_CHUNK],
                         part(roots, s), part(ray_index, s),
                         leaf_size=leaf_size, stack_size=stack_size,
                         mode=mode, watertight=watertight, qmask=qmask,
                         defer_uv=defer_uv, filter_fn=filter_fn,
                         stats=stats)
            for s in range(0, max(rays8.shape[1], 1), REF_CHUNK)]
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))


def _trace_plain(nodes, tris, rays8, *, roots_in_range=False, **kw):
    """packet_trace_reference as PLAIN's trace: it checks the roots
    whatever the caller knows of them (roots_in_range)."""
    return packet_trace_reference(nodes, tris, rays8, **kw)


def packet_trace(nodes, tris, rays8, **kw):
    """The kernel wrapper: CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    return front_steps(rays8.device).trace(nodes, tris, rays8, **kw)


@dataclasses.dataclass(frozen=True)
class MarchGrid:
    """The macro-grid of a march trace as the kernel takes it: cells per
    axis, the low corner and the cell size (f32 values, as GridScene
    stores them) and the high corner lo + cs * dims, formed in f64 and
    rounded to f32 once, as the reference's Python-float constant is
    (testing/grid.py:937-941).  occ: the grid's occupancy words
    (GridScene.march_occ: (ceil(cells / 32),) int32, bit c set where cell
    c has a tree), with which the kernel steps over empty cells without
    reading their root rows; the plain version has no use for them."""

    dims: tuple
    lo: tuple
    cs: tuple
    hi: tuple
    occ: torch.Tensor = dataclasses.field(compare=False)

    @staticmethod
    def of(dims, grid_lo, cell_size, occ) -> "MarchGrid":
        dims = tuple(int(d) for d in dims)
        lo = np.asarray(torch.as_tensor(grid_lo).cpu(), np.float32)
        cs = np.asarray(torch.as_tensor(cell_size).cpu(), np.float32)
        hi = [np.float32(float(lo[a]) + float(cs[a]) * dims[a])
              for a in range(3)]
        return MarchGrid(dims, tuple(float(x) for x in lo),
                         tuple(float(x) for x in cs),
                         tuple(float(x) for x in hi), occ)


def _check_grid(grid: MarchGrid, nodes):
    if any(d < 1 for d in grid.dims):
        raise ValueError(f"grid dims {grid.dims} must be positive")
    cells = grid.dims[0] * grid.dims[1] * grid.dims[2]
    if cells > nodes.shape[0] // 8:
        raise ValueError(f"{cells} grid cells but the table has "
                         f"{nodes.shape[0] // 8} root rows")
    occ = grid.occ
    if (occ is None or occ.dtype != torch.int32
            or tuple(occ.shape) != (-(-cells // 32),)
            or occ.device != nodes.device):
        raise ValueError(f"grid occupancy must be ({-(-cells // 32)},) "
                         f"int32 words on the tables' device")


def packet_march_kernel(nodes, tris, rays8, *, leaf_size: int,
                        stack_size: int, grid: MarchGrid,
                        mode: str = "closest", watertight: bool = True,
                        qmask: int | None = None, stats: bool = False):
    """Launch the kernel's march instantiation on the current stream ->
    (t, u, v, slot[, counts]) over the 8-wide table `nodes` whose row c is
    grid cell c's root (build_grid(march=True)).  Each ray walks its own
    cell chain; counts sum over its cells.  Arguments as
    packet_trace_kernel's."""
    global KERNEL_LAUNCHES, STATS_LAUNCHES, MARCH_LAUNCHES
    global ANY_LAUNCHES, MASK_LAUNCHES
    lib, nodes, tris, rays8 = _kernel_prelude(nodes, tris, rays8,
                                              stack_size, 8)
    _check_grid(grid, nodes)
    out = _launch(
        "rtk_packet_march", lib.rtk_packet_march, rays8, stats,
        nodes.data_ptr(), tris.data_ptr(), rays8.data_ptr(), rays8.shape[1],
        leaf_size, int(mode == "any"), int(watertight),
        int(qmask is not None), int(qmask or 0), *grid.dims, *grid.lo,
        *grid.cs, *grid.hi, grid.occ.data_ptr())
    KERNEL_LAUNCHES += 1
    STATS_LAUNCHES += stats
    MARCH_LAUNCHES += 1
    ANY_LAUNCHES += mode == "any"
    MASK_LAUNCHES += qmask is not None
    return out


def march_entry(rays8, grid: MarchGrid):
    """Each ray's grid entry, in the kernel's f32 arithmetic -> (live,
    cell, tm, step, tdel): live rays enter the grid; cell (3, N) int64
    indices of the first cell, tm (3, N) the t of the next boundary per
    axis, step (3, N) +-1, tdel (3, N) the t across one cell."""
    ox, oy, oz, dx, dy, dz, mint, maxt = rays8
    o, d = (ox, oy, oz), (dx, dy, dz)
    rcp = [_crcp(c) for c in d]
    near = torch.full_like(ox, -_BIG)
    far = torch.full_like(ox, _BIG)
    for a in range(3):
        t0 = (grid.lo[a] - o[a]) * rcp[a]
        t1 = (grid.hi[a] - o[a]) * rcp[a]
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    live = (near <= far) & ~(far < 0.0) & ~(maxt <= mint)
    s0 = torch.maximum(near, torch.zeros_like(near))
    cell, tm, step, tdel = [], [], [], []
    for a in range(3):
        f = torch.floor((o[a] + d[a] * s0 - grid.lo[a]) / grid.cs[a])
        c = torch.where(live, f.clamp(0.0, grid.dims[a] - 1), 0.0).long()
        pos = d[a] >= 0.0
        nb = grid.lo[a] + (c + pos.long()).to(torch.float32) * grid.cs[a]
        cell.append(c)
        tm.append((nb - o[a]) * rcp[a])
        step.append(torch.where(pos, 1, -1))
        tdel.append(grid.cs[a] * rcp[a].abs())
    return (live, torch.stack(cell), torch.stack(tm), torch.stack(step),
            torch.stack(tdel))


def packet_march_reference(nodes, tris, rays8, *, leaf_size: int,
                           stack_size: int, grid: MarchGrid,
                           mode: str = "closest", watertight: bool = True,
                           qmask: int | None = None, stats: bool = False):
    """The march's plain PyTorch version on any device: rounds over the
    live rays, each tracing its current cell's tree through the plain
    roots traversal with max_t := best_t (the kernel's accept rule, strict
    <, so a miss keeps the old record), then retiring or taking one DDA
    step with the kernel's f32 arithmetic.  Equals packet_march_kernel
    bit for bit."""
    _check_tables(nodes, tris, rays8, 8)
    _check_grid(grid, nodes)
    n = rays8.shape[1]
    dev = rays8.device
    live, cell, tm, step, tdel = march_entry(rays8, grid)
    best_t = rays8[7].clone()
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_s = torch.full((n,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((5, n), dtype=torch.int32, device=dev)
    dims = torch.tensor(grid.dims, device=dev)[:, None]
    act = torch.nonzero(live).squeeze(1)
    while act.numel():
        c = cell[:, act]
        sub = rays8[:, act].clone()
        sub[7] = best_t[act]
        out = packet_trace_reference(
            nodes, tris, sub, leaf_size=leaf_size, stack_size=stack_size,
            mode=mode, watertight=watertight, qmask=qmask, stats=stats,
            roots=((c[0] * grid.dims[1] + c[1]) * grid.dims[2]
                   + c[2]).to(torch.int32))
        upd = out[3] >= 0
        for best, new in zip((best_t, best_u, best_v, best_s), out):
            best[act] = torch.where(upd, new, best[act])
        if stats:
            counts[:, act] += out[4]
        # Retire at a hit before the cell's exit (any-hit: at any hit),
        # else step across the nearest boundary, ties x, y, z.
        t3 = tm[:, act]
        exit_t = torch.minimum(t3[0], torch.minimum(t3[1], t3[2]))
        fin = best_t[act] <= exit_t
        if mode == "any":
            fin |= best_s[act] >= 0
        act, t3 = act[~fin], t3[:, ~fin]
        mx = (t3[0] <= t3[1]) & (t3[0] <= t3[2])
        my = ~mx & (t3[1] <= t3[2])
        ax = torch.stack([mx, my, ~mx & ~my])
        cell[:, act] += torch.where(ax, step[:, act], 0)
        tm[:, act] = torch.where(ax, t3 + tdel[:, act], t3)
        c = cell[:, act]
        act = act[((c >= 0) & (c < dims)).all(dim=0)]
    out = (best_t, best_u, best_v, best_s)
    return out + (counts,) if stats else out


def packet_march(nodes, tris, rays8, **kw):
    """The march wrapper: CUDA tensors launch the kernel's march
    instantiation, CPU tensors take its plain version."""
    return front_steps(rays8.device).march(nodes, tris, rays8, **kw)


@dataclasses.dataclass(frozen=True)
class Steps:
    """The code that runs each step of a front end, with the signatures of
    the plain versions; the traversal also takes roots_in_range.  refit
    and repack are a deforming frame's (scene.refit, repack_bounds)."""

    key: Callable
    rows: Callable
    unsort: Callable
    trace: Callable
    march: Callable
    refit: Callable
    repack: Callable

    @staticmethod
    def of(lib) -> "Steps":
        """The kernels of a loaded library (an AOT artifact's); the march,
        which no artifact runs, is CARD's."""
        def own(f):
            return functools.partial(f, lib=lib)

        return Steps(own(coherence_key_kernel), own(ray_rows_kernel),
                     own(unsort_kernel), own(_kernel), packet_march_kernel,
                     own(refit_kernel), own(repack_kernel))


PLAIN = Steps(ray_coherence_key_reference, ray_rows_reference,
              unsort_reference, _trace_plain, packet_march_reference,
              refit_reference, repack_reference)
# The kernels of the library built from the sources (ops/library.py).
CARD = Steps(coherence_key_kernel, ray_rows_kernel, unsort_kernel, _kernel,
             packet_march_kernel, refit_kernel, repack_kernel)


def front_steps(device: torch.device, plain: bool = False,
                card: Steps | None = None) -> Steps:
    """The steps for tensors on `device`: PLAIN on the CPU, and on any
    device when plain; on a CUDA device `card` (Steps.of an artifact's
    library), or CARD when it is None."""
    if plain or device.type == "cpu":
        return PLAIN
    if device.type != "cuda":
        raise ValueError(f"no packet traversal for device {device}")
    return CARD if card is None else card


def _ray_roots(packed: PackedScene, n: int, packet_roots, ray_roots, pkt,
               p_pk):
    """(N,) int32 root row per ray from either spelling, or None.

    packet_roots keeps the reference's contract (pallas_trace.py:1639-
    1706): one root per pkt-ray packet (128 by default) of a batch padded
    to whole blocks of p_pk packets; a short list pads with root 0 and a
    longer one raises."""
    if packet_roots is not None and ray_roots is not None:
        raise ValueError("pass packet_roots or ray_roots, not both")
    dev = packed.device
    if ray_roots is not None:
        roots = torch.as_tensor(ray_roots, device=dev).to(torch.int32)
        if tuple(roots.shape) != (n,):
            raise ValueError(f"ray_roots must have shape ({n},)")
        return roots
    if packet_roots is None:
        return None
    unit = PKT if pkt is None else int(pkt)
    block = (DEFAULT_P if p_pk is None else int(p_pk)) * unit
    n_packets = -(-n // block) * block // unit
    roots = torch.as_tensor(packet_roots, device=dev).to(torch.int32)
    roots = roots.reshape(-1)
    if roots.shape[0] > n_packets:
        raise ValueError(f"packet_roots has {roots.shape[0]} entries for "
                         f"{n_packets} {unit}-ray packets")
    # A short list pads with root 0, as the block-padding packets do.
    roots = torch.cat([roots, roots.new_zeros(n_packets - roots.shape[0])])
    return torch.repeat_interleave(roots, unit)[:n].contiguous()


def _check_flags(packed: PackedScene, pkt=None, narrow=None, kz_static=None,
                 tris128=None, leaf_loop=None, hbm_tris=None):
    """The reference's checks on the TPU schedule flags
    (pallas_trace.py:1579-1585, :1651-1693), with its ValueErrors: the
    flags have no effect here, but a combination the reference refuses is
    refused too.  narrow=None is the reference's default, True; pkt=None
    lets the reference pick a valid width."""
    narrow = True if narrow is None else narrow
    aligned = packed.leaf_size % 8 == 0
    if pkt is not None and int(pkt) % 128 != 0:
        raise ValueError("pkt must be a multiple of 128 (VPU lane width)")
    if kz_static is not None:
        if kz_static not in (0, 1, 2):
            raise ValueError("kz_static must be 0, 1 or 2 (axis index)")
        if not narrow:
            raise ValueError("kz_static needs the narrow leaf path")
    if leaf_loop and not (aligned and narrow):
        raise ValueError("leaf_loop needs lane-aligned leaves "
                         "(leaf_size % 8 == 0) and the narrow leaf path")
    if tris128 and not (aligned and narrow):
        raise ValueError("tris128 needs lane-aligned leaves "
                         "(leaf_size % 8 == 0) and the narrow leaf path")
    if hbm_tris and not aligned:
        raise ValueError("HBM-resident triangles require leaf_size % 8 == 0 "
                         "(lane-aligned leaf rows)")


def _check_front(packed: PackedScene, rays: Rays, mode, filter_fn=None):
    if mode not in ("closest", "any"):
        raise ValueError(f"unknown mode {mode!r}")
    if rays.device != packed.device:
        raise ValueError(f"rays on {rays.device}, scene on {packed.device}")
    if filter_fn is not None:
        # The predicate reads triangle identity from exact f32 columns
        # (pallas_trace.py:1719-1722).
        _require_captured(filter_fn)
        if packed.num_tris >= FILTER_MAX_TRIS:
            raise ValueError(
                "packet-kernel filter callables need triangle ids exact "
                "in f32 (< 2^24 triangles); use the stack engine")


def _ray_rows(steps: Steps, rays: Rays, sort_rays, roots=None):
    """The batch as the traversal takes it -> (rows, idx): the (8, N) f32
    rows, coherence-sorted when sort_rays (None: for >= 16384 rays without
    roots), and the caller's index of each column, or None unsorted.  The
    key and the sort come first, then one pass of steps.rows writes the
    rows in the sorted order."""
    if sort_rays is None:
        sort_rays = rays.count >= SORT_RAYS_MIN and roots is None
    if sort_rays and roots is not None:
        raise ValueError("sort_rays cannot reorder rays that carry per-"
                         "packet or per-ray roots; pass sort_rays=False")
    idx = None
    if sort_rays:
        with span("rtk.packet_trace.key"):
            key = steps.key(rays.origin, rays.direction)
        with span("rtk.packet_trace.sort"):
            idx = torch.sort(key, stable=True).indices
    with span("rtk.packet_trace.rows"):
        comps = steps.rows(rays.origin, rays.direction, rays.min_t,
                           rays.max_t, idx)
    return comps, idx


def _traverse(steps: Steps, packed: PackedScene, rays: Rays, comps, idx,
              mode, watertight, filter_mask, defer_uv, roots=None,
              filter_fn=None, stats=False, roots_in_range=False):
    """Run the traversal over rows from _ray_rows, restore the caller's
    order and wrap the outputs with packed's hit-assembly tables."""
    # The caller's ray index survives the sort (pallas_trace.py:1475-1481).
    ray_index = (idx.to(torch.int32)
                 if idx is not None and filter_fn is not None else None)
    qmask = None if filter_mask is None else int(filter_mask) & 0xFFFFFF
    with span("rtk.packet_trace.launch"):
        out = steps.trace(packed.nodes, packed.tris, comps,
                          leaf_size=packed.leaf_size,
                          stack_size=packed.stack_size, mode=mode,
                          watertight=watertight, qmask=qmask,
                          defer_uv=defer_uv, roots=roots,
                          filter_fn=filter_fn, ray_index=ray_index,
                          stats=stats, branching=packed.branching,
                          roots_in_range=roots_in_range)
    if idx is not None:
        # Back to the caller's order.
        with span("rtk.packet_trace.unsort"):
            out = steps.unsort(out, idx)
    with span("rtk.packet_trace.wrap"):
        t, u, v, slot = out[:4]
        hit = slot >= 0
        zero = torch.zeros((), device=t.device)
        hits = PacketHits(
            hit=hit, t=t, u_k=torch.where(hit, u, zero),
            v_k=torch.where(hit, v, zero), slot=slot, origin=rays.origin,
            direction=rays.direction, tri_v=packed.tri_v,
            tri_vidx=packed.tri_vidx, tri_mesh=packed.tri_mesh,
            tri_prim=packed.tri_prim, uv_deferred=defer_uv)
    return (hits, out[4]) if stats else hits


def _front(steps: Steps, packed: PackedScene, rays: Rays, mode, watertight,
           sort_rays, filter_mask, defer_uv, roots, filter_fn=None,
           stats=False, roots_in_range=False):
    """The checks, the rows, the traversal and the unsort of every
    trace_packets-shaped front end, each by `steps`, in the span
    `rtk.packet_trace`."""
    with span("rtk.packet_trace"):
        _check_front(packed, rays, mode, filter_fn)
        comps, idx = _ray_rows(steps, rays, sort_rays, roots)
        return _traverse(steps, packed, rays, comps, idx, mode, watertight,
                         filter_mask, defer_uv, roots, filter_fn, stats,
                         roots_in_range)


def trace_packets(packed: PackedScene, rays: Rays, mode: str = "closest",
                  watertight: bool = True, interpret: bool | None = None,
                  p_pk: int | None = None, hbm_tris: bool | None = None,
                  packet_roots=None, dual: bool | None = None,
                  pkt: int | None = None, narrow: bool | None = None,
                  sort_rays: bool | None = None, ordered: bool | None = None,
                  islab: bool | None = None, lesion: str | None = None,
                  filter_mask: int | None = None, stats: bool = False,
                  filter_fn=None, *, kz_static: int | None = None,
                  tris128: bool | None = None, leaf_loop: bool | None = None,
                  defer_uv: bool = False, ray_roots=None):
    """Trace rays through the packed tables (rtk_trace_ray contract,
    rtk.c:543-577): t, u, v and the packed triangle slot per ray, the rest
    of the record lazily through PacketHits.  A miss keeps t = max_t.

    The parameters the reference has come in the reference's order
    (pallas_trace.py:1588-1604) as far as filter_fn; the reference's
    `march` tuple that follows has no counterpart here (the march is
    packet_march), so everything after it is keyword-only, and so is
    ray_roots, which only this package has.

    mode: "closest" (nearest hit in the open window (min_t, max_t)) or
      "any" (each ray stops at its first hit leaf).
    filter_mask: test only triangles whose packed mask bits (pack_scene
      tri_mask) share a bit with it.
    filter_fn: a predicate captured by jit_filter (HitCandidate -> bool),
      ANDed into the leaf phase's accept test; ray_index is the caller's
      row even when the batch is sorted.  Other callables raise (run them
      on the stack engine).  Needs fewer than 2^24 triangles.
    stats: also return the (5, N) int32 per-ray counts, in the caller's
      order: entries popped, internal pops, leaf pops, child box tests,
      triangle tests -> (hits, counts).
    defer_uv: the kernel writes t and slot only; .u/.v are recomputed.
    sort_rays: coherence-sort the batch first (None: for >= 16384 rays
      without roots); results come back in the caller's order either way.
      Rays that carry roots cannot be sorted.
    ray_roots: (N,) int32 packed root row per ray (multi-root tables such
      as pack_forest / build_sah_forest; default: every ray at row 0).
    packet_roots: the same, one root per pkt-ray packet (128 unless pkt
      is given) of the batch padded to blocks of p_pk packets (8).

    interpret, dual, ordered, islab, narrow, leaf_loop, kz_static, tris128,
    hbm_tris, lesion, p_pk and pkt select the TPU kernel's schedule; they
    are accepted and have no effect beyond the packet_roots layout, but
    the combinations the reference refuses raise ValueError (pkt not a
    multiple of 128, kz_static outside 0-2 or without the narrow path,
    leaf_loop or tris128 on leaves not a multiple of 8 or without it,
    hbm_tris on such leaves).
    """
    _check_flags(packed, pkt=pkt, narrow=narrow, kz_static=kz_static,
                 tris128=tris128, leaf_loop=leaf_loop, hbm_tris=hbm_tris)
    roots = _ray_roots(packed, rays.count, packet_roots, ray_roots, pkt,
                       p_pk)
    return _front(front_steps(rays.device), packed, rays, mode, watertight,
                  sort_rays, filter_mask, defer_uv, roots, filter_fn, stats)


def trace_packets_reference(packed: PackedScene, rays: Rays,
                            mode: str = "closest", watertight: bool = True,
                            sort_rays: bool | None = None,
                            filter_mask: int | None = None,
                            defer_uv: bool = False, packet_roots=None,
                            ray_roots=None, pkt: int | None = None,
                            p_pk: int | None = None, stats: bool = False,
                            filter_fn=None):
    """trace_packets through the plain PyTorch traversal, coherence key
    and unsort, on any device."""
    roots = _ray_roots(packed, rays.count, packet_roots, ray_roots, pkt,
                       p_pk)
    return _front(PLAIN, packed, rays, mode, watertight, sort_rays,
                  filter_mask, defer_uv, roots, filter_fn, stats)


def _trace_rooted(steps: Steps, packed: PackedScene, rays: Rays, roots,
                  mode: str = "closest", watertight: bool = True,
                  filter_mask: int | None = None, pkt: int | None = None):
    """trace_packets(packed, rays, mode, watertight, ray_roots=roots,
    sort_rays=False, filter_mask=..., pkt=...) by `steps` for (N,) int32
    roots on the rays' device that are entries of packed's tables already:
    instancing's rounds gather them from pack_instanced's packed_roots and
    the binned rounds from the bins' roots, both checked on the host when
    made; the grid rounds clamp cell ranks into the cells' root rows.  On
    the card the launch then makes no host sync to check them (the plain
    trace checks them)."""
    _check_flags(packed, pkt=pkt)
    return _front(steps, packed, rays, mode, watertight, False, filter_mask,
                  False, roots, roots_in_range=True)


def trace_packets_kz_binned(packed: PackedScene, rays: Rays, pkt: int = 256,
                            p_pk: int = 16, **kw) -> PacketHits:
    """The reference's dispatcher for incoherent batches
    (pallas_trace.py:1780-1827), which sorts the rays by dominant
    |direction| axis and traces each axis-pure sub-batch with its axis as
    kz_static, because on the TPU kz_static fixes the leaf phase's shear
    axis at compile time.  The kernel here picks the axis per ray in every
    launch, so one trace_packets call gives the same records with no sort,
    no host sync and no scatter.  kz_static is passed all the same, so
    that the reference's checks on it apply (narrow=False raises); pkt,
    p_pk and the other keywords are passed on and checked there.
    """
    return trace_packets(packed, rays, kz_static=0, pkt=pkt, p_pk=p_pk,
                         **kw)


def trace_packets_chunked(packed: PackedScene, rays: Rays,
                          chunk: int = 1 << 24, **kw) -> PacketHits:
    """trace_packets with bounded working memory for huge ray batches.

    trace_packets holds several N-sized intermediates beside its outputs
    (the coherence keys, the sort order, the sorted (8, N) rows).  This
    host loop traces `chunk`-ray slices, so the working memory stays
    O(chunk), and concatenates the per-ray results in the caller's order;
    each slice is sorted on its own.  The tables are the scene's, not
    copies, and the result carries the caller's ray tensors.

    The reference pads the last slice with dead rays so that every slice
    reuses one compiled program; nothing is compiled per shape here, so
    the last slice runs at its own length and no padding is made.

    kw: trace_packets' keywords, other than stats and the root arrays
    (they are laid out per batch, not per slice).  A filter_fn sees
    ray_index within its slice, as the reference's does.
    """
    for name in ("stats", "ray_roots", "packet_roots"):
        if kw.get(name) is not None and kw.get(name) is not False:
            raise ValueError(f"trace_packets_chunked does not slice {name}")
    n = rays.count
    if n <= chunk:
        return trace_packets(packed, rays, **kw)
    outs = [trace_packets(packed, rays[i:i + chunk], **kw)
            for i in range(0, n, chunk)]
    return dataclasses.replace(
        outs[0], origin=rays.origin, direction=rays.direction,
        **{f: torch.cat([getattr(o, f) for o in outs])
           for f in ("hit", "t", "u_k", "v_k", "slot")})


def uniform_kz(rays: Rays) -> int | None:
    """The batch's shared dominant |direction| axis, or None if mixed (one
    readback).

    The check for the reference's trace_packets(kz_static=...) contract,
    with the kernel's tie rule: x beats y beats z at equal magnitude.  The
    kernel here picks the axis per ray and ignores kz_static.
    """
    ad = rays.direction.to(torch.float32).abs()
    maxc = ad.amax(dim=1)
    kzr = torch.where(ad[:, 0] == maxc, 0,
                      torch.where(ad[:, 1] == maxc, 1, 2)).cpu()
    k0 = int(kzr[0])
    return k0 if bool((kzr == k0).all()) else None


def _refit_repack(steps: Steps, scene, packed: PackedScene, tri_pos):
    """One frame's refit and repack -> (scene', packed').  scene: the LBVH
    Scene the tables were packed from (refit + repack_bounds, each by
    `steps`) or a BinaryRefitAux (a host-SAH topology,
    refit_packed_binary)."""
    if isinstance(scene, BinaryRefitAux):
        return scene, refit_packed_binary(packed, scene, tri_pos)
    scene2 = refit_by(steps.refit, scene, tri_pos)
    return scene2, repack_by(steps.repack, packed, scene2)


def trace_packets_refit(packed: PackedScene, scene, new_tri_pos, rays: Rays,
                        mode: str = "closest", watertight: bool = True,
                        interpret: bool | None = None,
                        p_pk: int | None = None,
                        hbm_tris: bool | None = None,
                        dual: bool | None = None, pkt: int | None = None,
                        narrow: bool | None = None,
                        sort_rays: bool | None = None,
                        ordered: bool | None = None,
                        islab: bool | None = None,
                        leaf_loop: bool | None = None,
                        defer_uv: bool = False):
    """A dynamic scene's frame: refit the BVH to deformed vertices (same
    topology), regather the packed tables, trace.  Everything is enqueued
    on the scene's device; nothing is read back.

    scene: the LBVH Scene that `packed` was packed from, or a
    BinaryRefitAux (build_sah_packed(refittable=True)): the host-SAH
    topology refits on the device with the same range queries.
    new_tri_pos: (T, 3, 3) vertices in soup order, an array or a tensor.

    Returns (hits, refit_scene, repacked_scene); refit_scene is the aux
    itself for a BinaryRefitAux.  Equal, bit for bit, to refit ->
    repack_bounds -> trace_packets.  The schedule flags are accepted
    without effect, as trace_packets documents; leaf_loop and hbm_tris
    are checked as there (the reference checks leaf_loop,
    pallas_trace.py:1983, and fails on hbm_tris with unaligned leaves),
    pkt is not (the reference takes any width here).
    """
    _check_flags(packed, narrow=narrow, leaf_loop=leaf_loop,
                 hbm_tris=hbm_tris)
    return _refit_trace(front_steps(rays.device), packed, scene, new_tri_pos,
                        rays, mode, watertight, sort_rays, defer_uv)


def _refit_trace(steps: Steps, packed: PackedScene, scene, new_tri_pos,
                 rays: Rays, mode, watertight, sort_rays, defer_uv):
    """trace_packets_refit after its flag checks, each step by `steps`
    (utils/aot.py's artifacts pass their own library's)."""
    _check_front(packed, rays, mode)
    scene2, packed2 = _refit_repack(steps, scene, packed, new_tri_pos)
    comps, idx = _ray_rows(steps, rays, sort_rays)
    hits = _traverse(steps, packed2, rays, comps, idx, mode, watertight,
                     None, defer_uv)
    return hits, scene2, packed2


def trace_packets_refit_frames(packed: PackedScene, scene, frames_tri_pos,
                               rays: Rays, mode: str = "closest",
                               watertight: bool = True,
                               interpret: bool | None = None,
                               p_pk: int | None = None,
                               hbm_tris: bool | None = None,
                               dual: bool | None = None,
                               pkt: int | None = None,
                               narrow: bool | None = None,
                               sort_rays: bool | None = None,
                               ordered: bool | None = None,
                               islab: bool | None = None,
                               leaf_loop: bool | None = None,
                               defer_uv: bool = False):
    """Animation sub-stepping: refit, repack and trace F deformation
    frames of one topology against one ray batch.

    frames_tri_pos: (F, T, 3, 3) per-frame vertices in soup order (an
    array, a tensor, or a sequence of F frames).  Returns a list of F
    PacketHits in frame order; the index tables are shared (the topology
    is fixed) and tri_v is each frame's own, so lazy fields (.u/.v under
    defer_uv, vertex_position) read the frame they belong to.

    The coherence sort permutes the same batch the same way on every
    frame, so the key and the sort run once, ahead of the loop; each
    frame's outputs are put back in the caller's order once.  The frames
    run as a plain loop (refit, repack, launch, next frame) with no
    synchronisation between them, and one frame's node and triangle
    tables are released when the next frame's are made: the reference's
    batched preparation of all F frames' tables, which spreads its
    dispatch cost, is not carried over.  Frame f equals
    trace_packets_refit of that frame bit for bit.  The flags are checked
    as trace_packets_refit checks them.
    """
    _check_flags(packed, narrow=narrow, leaf_loop=leaf_loop,
                 hbm_tris=hbm_tris)
    _check_front(packed, rays, mode)
    steps = front_steps(rays.device)
    comps, idx = _ray_rows(steps, rays, sort_rays)
    out = []
    for tri_pos in frames_tri_pos:
        _, packed2 = _refit_repack(steps, scene, packed, tri_pos)
        out.append(_traverse(steps, packed2, rays, comps, idx, mode,
                             watertight, None, defer_uv))
    return out
