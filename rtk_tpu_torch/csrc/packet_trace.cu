// Packet-table traversal kernel for Hopper (sm_90a): the nearest (or any)
// watertight hit of each ray over the packed 8- or 16-wide BVH tables
// built by rtk_tpu_torch/trace/packed.py.
//
// Replaces rtk_tpu/ops/pallas_trace.py::_make_kernel (the TPU kernel that
// _run_kernel launches through pl.pallas_call).  Same tables, same
// semantics; not the same schedule.  The TPU kernel advances packets of
// 128+ rays in lockstep because the TPU pays per scalar instruction and
// wins on wide vector tiles.  Here one thread traces one ray with its own
// stack in local memory (L1-cached, and touched only where a node has
// more than one hit child), rtk's own shape (rtk.c:390-539).
//
// What bounds it on an H100, as measured (tools/torch_kernel_ladder.py,
// PERF.md section 6): the instructions it executes and the divergence of
// a warp, not the latency of its fetches.  The tables of the blob(6) scene
// are about 6 MB: they sit in L2 and their hot rows in L1, so a dependent
// fetch is short, and the many resident warps of a 48-56 register kernel
// cover it.  Every build that bought fewer round trips with registers or
// shared memory was slower: a node's sixteen loads started ahead of its
// masks, four triangles loaded ahead of their tests, the stack in shared
// memory (which takes L1 from the tables), the near-to-far order kept in
// registers.  What paid was fewer instructions a test and fewer warps
// running a node and a leaf in turn.  Tables past L2 (a 2.1M-triangle
// grid, 154 MB) and short instanced rounds change neither finding: a
// persisting-L2 window over the node table and a leaf's rows prefetched
// as a lane reaches it gained nothing there, and persistent warps that
// fetch rays from a counter (Aila and Laine, HPG 2009) lost to the card's
// own block scheduler, which keeps a block's four warps on neighbouring
// rays and so on the same L1 lines.  The card's tensor cores and TMA
// have nothing to offer: the loop is scalar f32 arithmetic on rows whose
// addresses are known one fetch ahead, with no matrix product and no tile
// to copy; its means are registers (few, so that many warps stay
// resident), L1 (left whole), 16-byte read-only loads and the warp's
// convergence.
// What the design does about it:
//   * every fetch is a 16-byte (or 8-byte) read-only load (__ldg) of a
//     contiguous row, a node's sixteen from one 256-byte span; the caller
//     sorts rays by a Morton coherence key so the rays of a warp walk
//     nearly the same nodes and share cache lines; 128-thread blocks;
//   * the min and max of the box and triangle tests are single
//     NaN-propagating instructions (test_max/test_min), a third of a box
//     test's instructions before;
//   * a triangle whose edge functions differ in sign leaves before the
//     divide and the distance;
//   * children are ordered near to far (ties by slot) so best_t shrinks
//     early; the nearest hit child stays in a register and only the
//     others are pushed, so most nodes touch the stack not at all;
//   * a lane keeps descending until it holds a leaf, and the warp tests
//     its leaves together: lanes at a node and lanes at a leaf would make
//     the warp run both paths in turn;
//   * the leaf test is compiled once per shear axis, so vertex components
//     are chosen at compile time instead of by three-way selects a
//     triangle.  A warp takes the per-axis copy only when all its active
//     lanes (those at a leaf) share the ray's kz, one match instruction a
//     leaf phase: lanes of different axes would run the copies in turn,
//     and the rays of an incoherent batch (bounces, after the coherence
//     sort) hold two or three axes in most warps.  A mixed warp runs one
//     copy that selects each vertex component by the ray's axis: the same
//     operations on the same values, so the same bits.  Measured slower
//     (PERF.md section 6): the choice made once a ray, for the whole
//     traversal, in one loop or in a loop of its own (mixed warps lose the
//     octant copies and the leaf phases whose lanes share kz); the mixed
//     traversal as a function of its own, not inlined (ptxas spilled in
//     its leaf loop); selects on kz == 0 and kz == 1 kept from the ray's
//     start (the coherent loop's registers moved);
//   * on flat tables (8 and 16 wide) the child box test is compiled once
//     per sign octant of the ray's direction, so each axis's near and far
//     planes are chosen at compile time instead of by six selects a child.
//     A warp takes the octant copy only when all its active lanes share
//     the octant (one match instruction a traversal): lanes in different
//     octants would run their copies in turn, so a mixed warp (incoherent
//     bounces) takes the copy that reads the signs from the ray;
//   * __launch_bounds__(128, 10): ten blocks an SM, 48 registers.
//
// Numerics: built with -fmad=false, so no a*b+c is contracted into an FMA.
// The shared-edge functions of two triangles are then exact negations,
// which watertightness rests on, and every value equals the plain PyTorch
// version in rtk_tpu_torch/ops/packet_trace.py bit for bit.  Exact-zero
// edge functions are recomputed in f64 and rounded to f32 (rtk.c:294-336).
//
// Two product variants of the TPU kernel ride the same source:
//   * stats (pallas_trace.py:514-530): a nullable (5, n) int32 `counts`
//     output, per ray: entries popped, internal pops, leaf pops, child
//     box tests and triangle tests (the last two are the traversal's
//     arithmetic work, beyond the TPU kernel's three lanes).  The counters
//     live in registers; null skips the final store.
//   * filter_fn (pallas_trace.py:1003-1018, :1146-1156): built with
//     -DRTK_FILTER and a generated header (ops/filter_capture.py) that
//     defines rtk_filter_pred, the caller's predicate captured from Python
//     and emitted as C++.  Each distinct predicate is its own build, as
//     each is its own kernel on the TPU.  The predicate sees (t, u, v,
//     mesh, triangle, caller ray index) of a candidate that passed the
//     geometric test and is ANDed into the accept test; u and v are
//     computed for it even under defer_uv.
// Any-hit (pallas_trace.py:450, :1174) is a mode of the same build: the
// ray ends at its first hit leaf.  Its batches idle more lanes than
// closest's (shadow and AO rays end at random depths: up to 37% of a
// warp's instruction slots), but a lane that took up the next ray of its
// block's run when its own ended (Aila and Laine 2009, section 4) lost
// 53-146% to the scattered rays and the refill's own code, and an
// instantiation of its own was no faster (PERF.md section 6).
// The mask (pallas_trace.py:997) is a mode too: the leaf test rejects a
// row whose mask bits miss the caller's before any arithmetic (the
// compiler loads the mask word with the first vertices and the rest after
// the test).  The mask rejects about half the leaf loop's rows on the
// measured tables, yet its time a pop is within 2.5% of a closest trace's
// on the same rays: what a row costs is its loads and the loop, not the
// arithmetic, and the mask's extra time is its longer traversal (more
// pops), which its counts fix.  Measured no faster: the mask word tested
// before the vertices, and a loop over the rows that pass, gathered first
// as a bit set (in the shared instantiation or one of its own; the mask
// words loaded one by one or four at a time), whose gathering cost what
// the skipped rows saved.
// And the two variants that change the traversal's shape, each its own
// template instantiation (its own registers; the 8-wide build pays
// nothing for them):
//   * w_arity=16 (pallas_trace.py:163-174, :805-828): 16-wide node tables,
//     16 rows a node and the leaf mask in bits 16-31 of the masks word.
//     The near-to-far order stays the stable insertion by entry distance
//     (ties by slot), the one-thread form of the TPU's 63-comparator
//     Batcher network; a 16-wide node pushes up to 16 entries, so the
//     stack holds trees up to 17 levels deep.  What bounds it is what
//     bounds the 8-wide kernel, instructions a child box test, at 13-15
//     box tests a pop (7 at 8 wide).  Sixteen unrolled tests that each
//     carry an insertion into arrays in local memory make octant copies
//     too large to pay, so the tests only note a hit child's bit and
//     entry distance, and the hit children are inserted after them in
//     slot order (a node with one hit child, the common case, skips
//     that): an octant copy's code is then about the size of an 8-wide
//     one's, and the copies pay as they do at 8 wide.  Measured slower
//     (PERF.md section 6): a loop over two groups of eight children kept
//     rolled, with and without octant copies; the nearest hit child kept
//     in registers and the others inserted straight onto the stack; 8
//     blocks an SM for this width.
//   * march (pallas_trace.py:387-427, :1190-1292): the fused macro-grid
//     march over a table with one root row per grid cell (root row ==
//     cell id, testing/grid.py).  Each ray enters the grid by a slab test
//     (Amanatides-Woo), traverses its cell's tree with best_t carried from
//     cell to cell, and retires when its best hit precedes the cell's
//     exit (or, any-hit, at its first hit); otherwise it takes one DDA
//     step, and stops when the step leaves the grid.  The TPU kernel's
//     packets adopt one pending cell at a time and keep an in-cell mask,
//     because 128 lanes share a stack; here each ray walks its own cell
//     chain, and only the result is shared: the nearest hit over it.
//     What bound it on the H100 was a barrier in the loop's shape, not
//     its arithmetic: a loop that traversed one cell at a time made a
//     warp wait, cell by cell, for its slowest lane, 2.9-3.1x the largest
//     lane's own steps on the atrium's bounces (PERF.md section 6).  So
//     the DDA step is the pop of an empty stack: a lane that finishes a
//     cell steps and descends through the next cell's root in the same
//     loop, as a TPU packet adopts its next pending cell.  Empty cells (a
//     third of those crossed) are stepped over from a bit per cell, their
//     childless root rows never read, and the step recomputes cs * |rcp|
//     where the loop would hold it.  Every ray's cells, nodes and
//     triangles, and its counts, are as before.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef RTK_FILTER
#ifndef RTK_FILTER_DEFINED
#error "RTK_FILTER builds force-include a generated rtk_filter_pred header"
#endif
#endif

#define RTK_MAX_STACK 256  // entries; the wrapper refuses deeper trees
#define RTK_BLOCK 128
// Blocks an SM the launch bounds promise: 10 x 128 threads leave each
// thread 51 registers.  Told so, ptxas spends 48 (a few bytes spill in
// some instantiations), and the tenth block an SM holds pays on every
// batch measured; with 8, ptxas spends 52-56 (PERF.md section 6).
#define RTK_MIN_BLOCKS 10

namespace {

constexpr float kBig = 3.0e38f;

// NaN-propagating max/min: torch.maximum/minimum (and jnp.maximum).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// Clamped reciprocal: finite +-3e38 instead of inf, so (b - o) * r is
// never 0 * inf; d == 0 (either sign) gives +3e38 (pallas_trace.py:260).
__device__ __forceinline__ float crcp(float d) {
  return d == 0.0f ? (d >= 0.0f ? kBig : -kBig) : 1.0f / d;
}

__device__ __forceinline__ float sel3(int k, float a, float b, float c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

__device__ __forceinline__ float edge_f64(float ax, float ay, float bx,
                                          float by) {
  return (float)((double)ax * (double)by - (double)ay * (double)bx);
}

// The macro-grid of a march trace: cells per axis, the grid's low corner
// and cell size (f32 as GridScene stores them), and its high corner
// f32(lo + cs * dims), rounded once from f64 on the host as the
// reference's Python-float constant is (grid.py:937-941).
// occ: a bit per cell, set where the cell's root row has a child
// (testing/grid.py's occupancy words).
struct Grid {
  int dx, dy, dz;
  float lox, loy, loz, csx, csy, csz, hix, hiy, hiz;
  const unsigned* occ;
};

// Per-ray constants of the traversal: origin, clamped reciprocal
// direction, min_t, and the shear (rtk.c:550-567): kz the dominant axis
// (kx and ky follow it cyclically), the shear factors and the origin in
// (kx, ky, kz) order.
struct RayC {
  float ox, oy, oz, rx, ry, rz, mint;
  int kz;
  float sx, sy, sz, okx, oky, okz;
};

// max/min of the box and triangle tests, NaN if either operand is NaN as
// max_nan/min_nan are, in one instruction (FMNMX.NAN) where those take a
// compare, a NaN test and a select.  Results feed comparisons only, so the
// sign of a zero and a NaN's payload, where the two forms may differ,
// never reach an output.
__device__ __forceinline__ float test_max(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return max_nan(a, b);
#endif
}
__device__ __forceinline__ float test_min(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return min_nan(a, b);
#endif
}

// A shear axis known at compile time (0, 1, 2), or -1: read from the ray.
template <int N>
struct Axis {
  static constexpr int value = N;
};

// A ray's sign octant (bit 0: x, 1: y, 2: z direction >= 0) known at
// compile time, or -1: read from the ray.
template <int O>
struct Oct {
  static constexpr int value = O;
};

// The third int4 of a triangle row: filter builds read its mesh and
// triangle columns, the others stop at the mask.
#ifdef RTK_FILTER
typedef float4 TriTail;
#else
typedef float2 TriTail;
#endif

// Depth-first traversal of the W-wide tree rooted at entry `root` (a node
// row, or a leaf in the stack's encoding -2 - l, which descend passes
// straight to the leaf test: a shallow cut's subtree bins), with the
// best hit so far carried in and out (a march trace carries it from cell
// to cell; a miss leaves it as it was).  Counters add up.  When the stack
// runs dry, next(cur) either sets cur to the root row of the ray's next
// tree and returns true (the march's next cell: the traversal goes on in
// the same loop, with no wait for the warp's other lanes) or returns false
// (the ray is done).
template <int W, bool OCT, class Next>
__device__ __forceinline__ void traverse(
    int root, const int4* __restrict__ nodes, const float4* __restrict__ tris,
    int leaf_size, int mode_any, int watertight, int use_mask, int qmask,
    int defer_uv, int rid, const RayC& r, float& best_t, float& best_u,
    float& best_v, int& best_slot, int& n_int, int& n_leaf, int& n_box,
    int& n_tri, Next next) {
  constexpr unsigned kMask = (1u << W) - 1u;
  const bool px = r.rx >= 0.0f, py = r.ry >= 0.0f, pz = r.rz >= 0.0f;
  int stack[RTK_MAX_STACK];
  int sp = 0;
  // The entry being visited: the nearest hit child of a node stays here
  // and is never pushed; it counts as a pop all the same.
  int cur = root;

  // One internal node: W child rows of 8 int32, 2 int4 per row.  Row 0
  // carries (first_child, first_leaf) in cols 6-7, row 1 the masks
  // (internal in bits 0..W-1, leaf in bits W..2W-1: read unsigned).
  // Pushes the hit children but the nearest, far first, and returns true
  // with the nearest in `cur`; false if no child is hit.
  auto node = [&](auto oct) -> bool {
    // The ray's sign octant: known at compile time in a per-octant copy
    // (O >= 0), read from the ray otherwise.
    constexpr int O = decltype(oct)::value;
    const bool sx = O < 0 ? px : (O & 1) != 0;
    const bool sy = O < 0 ? py : (O & 2) != 0;
    const bool sz = O < 0 ? pz : (O & 4) != 0;
    ++n_int;
    const int4* row = nodes + (size_t)cur * (2 * W);
    const int4 m0 = __ldg(row + 1);
    const int4 m1 = __ldg(row + 3);
    const int fc = m0.z, fl = m0.w;
    const unsigned mz = (unsigned)m1.z;
    const int im = (int)(mz & kMask), lm = (int)((mz >> W) & kMask);
    n_box += __popc(im | lm);  // every live child is box-tested
    float key[W];
    int ent[W];
    int cnt = 0;
    // Stable insertion by entry distance: ties keep slot order.
    auto insert = [&](const float enter, const int entry) {
      int j = cnt++;
      while (j > 0 && key[j - 1] > enter) {
        key[j] = key[j - 1];
        ent[j] = ent[j - 1];
        --j;
      }
      key[j] = enter;
      ent[j] = entry;
    };
    auto entry_of = [&](const int bit) -> int {
      const int below = bit - 1;
      return (im & bit) ? fc + __popc(im & below)
                        : -(fl + __popc(lm & below)) - 2;
    };
    // 16 wide: the box tests note each hit child's bit and entry distance,
    // and the hit children are ordered after them, so that the unrolled
    // tests hold no insertion code (sixteen copies of it in each octant
    // copy make the octant copies lose).
    unsigned hm = 0u;
    float kv[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int bit = 1 << w;
      if (!((im | lm) & bit)) continue;
      const int4 a = __ldg(row + 2 * w);
      const int2 b = w == 0   ? make_int2(m0.x, m0.y)
                     : w == 1 ? make_int2(m1.x, m1.y)
                              : __ldg((const int2*)(row + 2 * w + 1));
      const float mnx = __int_as_float(a.x), mny = __int_as_float(a.y),
                  mnz = __int_as_float(a.z), mxx = __int_as_float(a.w),
                  mxy = __int_as_float(b.x), mxz = __int_as_float(b.y);
      const float nx = ((sx ? mnx : mxx) - r.ox) * r.rx;
      const float fx = ((sx ? mxx : mnx) - r.ox) * r.rx;
      const float ny = ((sy ? mny : mxy) - r.oy) * r.ry;
      const float fy = ((sy ? mxy : mny) - r.oy) * r.ry;
      const float nz = ((sz ? mnz : mxz) - r.oz) * r.rz;
      const float fz = ((sz ? mxz : mnz) - r.oz) * r.rz;
      const float enter = test_max(test_max(nx, ny), test_max(nz, r.mint));
      const float exit = test_min(test_min(fx, fy), test_min(fz, best_t));
      if (!(enter <= exit)) continue;
      if constexpr (W == 16) {
        hm |= (unsigned)bit;
        kv[w] = enter;
      } else {
        insert(enter, entry_of(bit));
      }
    }
    if constexpr (W == 16) {
      if (hm == 0u) return false;
      // One hit child (most nodes): nothing to order.
      if ((hm & (hm - 1u)) == 0u) {
        cur = entry_of((int)hm);
        return true;
      }
      // In slot order, so ties keep it.
      do {
        const int w = __ffs((int)hm) - 1;
        hm &= hm - 1u;
        insert(kv[w], entry_of(1 << w));
      } while (hm);
    }
    // Far first, so the next nearest child is on top of the stack.
    for (int j = cnt - 1; j > 0; --j) stack[sp++] = ent[j];
    if (cnt == 0) return false;
    cur = ent[0];
    return true;
  };

  // The component kz + k (mod 3) of (x, y, z): k = 1 gives kx, 2 ky and 0
  // kz.  Folded at compile time in a per-axis copy, selected by the ray's
  // axis otherwise (KZ < 0).
  auto shear_comp = [&](auto axis, const int k, const float x,
                        const float y, const float z) -> float {
    constexpr int KZ = decltype(axis)::value;
    if constexpr (KZ >= 0) {
      return sel3((KZ + k) % 3, x, y, z);
    } else {
      const int c = r.kz + k;
      return sel3(c >= 3 ? c - 3 : c, x, y, z);
    }
  };

  // One triangle row against the ray, with the shear axes of `axis`.
  auto test = [&](auto axis, const float4 q0, const float4 q1,
                  const TriTail q2, const int slot) {
    // Padding rows (NaN vertices) can never hit; masked-out rows are
    // rejected before any arithmetic.
    if (q0.x != q0.x) return;
    if (use_mask && ((int)q2.y & qmask) == 0) return;
    ++n_tri;
    const float vx[3] = {q0.x, q0.w, q1.z};
    const float vy[3] = {q0.y, q1.x, q1.w};
    const float vz[3] = {q0.z, q1.y, q2.x};
    float xs[3], ys[3], zs[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // Translate before shearing (pallas_trace.py:953-968).
      const float tx = shear_comp(axis, 1, vx[j], vy[j], vz[j]) - r.okx;
      const float ty = shear_comp(axis, 2, vx[j], vy[j], vz[j]) - r.oky;
      const float tz = shear_comp(axis, 0, vx[j], vy[j], vz[j]) - r.okz;
      xs[j] = tx + r.sx * tz;
      ys[j] = ty + r.sy * tz;
      zs[j] = r.sz * tz;
    }
    float u = xs[1] * ys[2] - ys[1] * xs[2];
    float v = xs[2] * ys[0] - ys[2] * xs[0];
    float w = xs[0] * ys[1] - ys[0] * xs[1];
    // NaN edge values never take this path (NaN == 0 is false).
    if (watertight && (u == 0.0f || v == 0.0f || w == 0.0f)) {
      u = edge_f64(xs[1], ys[1], xs[2], ys[2]);
      v = edge_f64(xs[2], ys[2], xs[0], ys[0]);
      w = edge_f64(xs[0], ys[0], xs[1], ys[1]);
    }
    const float lo = test_min(test_min(u, v), w);
    const float hi = test_max(test_max(u, v), w);
    // Edge functions of both signs: a miss, before the divide (a rejected
    // triangle's 1/det is never read).
    if (lo < 0.0f && hi > 0.0f) return;
    const float rcp_det = 1.0f / (u + v + w);
    const float t = (u * zs[0] + v * zs[1] + w * zs[2]) * rcp_det;
    // Accept inside (min_t, best): the first hit found wins a tie.
    bool accept = t > r.mint && t < best_t;
#ifdef RTK_FILTER
    // Mesh and triangle ids are exact float columns (< 2^24).
    accept = accept && rtk_filter_pred(t, u * rcp_det, v * rcp_det,
                                       (int)q2.z, (int)q2.w, rid);
#endif
    if (accept) {
      best_t = t;
      best_slot = slot;
      if (!defer_uv) {
        best_u = u * rcp_det;
        best_v = v * rcp_det;
      }
    }
  };

  // Leaf l: triangle rows [l*K, (l+1)*K), 16 floats each:
  // [v0 v1 v2 | mask mesh prim | pad], tested in slot order.
  auto leaf = [&](auto axis) {
    ++n_leaf;
    const int base = (-cur - 2) * leaf_size;
    const float4* tr = tris + (size_t)base * 4;
    for (int k = 0; k < leaf_size; ++k)
      test(axis, __ldg(tr + k * 4), __ldg(tr + k * 4 + 1),
           __ldg((const TriTail*)(tr + k * 4 + 2)), base + k);
  };

  // Every lane descends through internal nodes until it holds a leaf (->
  // false) or has nothing left (-> true); then the warp tests its leaves
  // together.  Lanes of a warp at a node and at a leaf would run both in
  // turn.
  auto descend = [&](auto oct) -> bool {
    while (cur >= 0) {
      if (node(oct)) continue;
      if (sp == 0) {
        if (next(cur)) continue;
        return true;
      }
      cur = stack[--sp];
    }
    return false;
  };

  // The octant copies only where every active lane of the warp shares the
  // ray's octant: lanes in different octants would run their copies in
  // turn (incoherent rays), so a mixed warp takes the copy that reads the
  // signs from the ray.
  const int oct = (int)px | (int)py << 1 | (int)pz << 2;
  bool same_oct = false;
  if constexpr (OCT) {
    const unsigned active = __activemask();
    same_oct = __match_any_sync(active, oct) == active;
  }

  for (;;) {
    bool done;
    if (same_oct) {
      switch (oct) {
        case 0: done = descend(Oct<0>{}); break;
        case 1: done = descend(Oct<1>{}); break;
        case 2: done = descend(Oct<2>{}); break;
        case 3: done = descend(Oct<3>{}); break;
        case 4: done = descend(Oct<4>{}); break;
        case 5: done = descend(Oct<5>{}); break;
        case 6: done = descend(Oct<6>{}); break;
        default: done = descend(Oct<7>{}); break;
      }
    } else {
      done = descend(Oct<-1>{});
    }
    if (done) break;
    // The per-axis copies of the leaf test only where every lane at a leaf
    // shares the ray's kz: lanes of different axes would run their copies
    // in turn, so a mixed warp takes the copy that reads the axis.
    const unsigned active = __activemask();
    if (__match_any_sync(active, r.kz) != active) leaf(Axis<-1>{});
    else if (r.kz == 0) leaf(Axis<0>{});
    else if (r.kz == 1) leaf(Axis<1>{});
    else leaf(Axis<2>{});
    if (mode_any && best_slot >= 0) break;
    if (sp == 0) {
      if (next(cur)) continue;
      break;
    }
    cur = stack[--sp];
  }
}

// The hook of a traversal that ends when its stack runs dry.
struct NoNext {
  __device__ __forceinline__ bool operator()(int&) const { return false; }
};

// One thread per ray.  W: the node table's width (8 or 16).  MARCH: the
// grid march (roots unused: a cell's root row is its id).
// roots: null (every ray starts at row 0) or (n,) per-ray entries of a
// multi-root table, node rows or leaves -2 - l (pallas_trace.py:347-360
// takes one per 128-ray packet and pushes it as it is; a thread per ray
// makes the per-ray root the natural form).
// ray_index: read by filter builds only; null (the caller's index is i) or
// (n,) caller indices of coherence-sorted rays (pallas_trace.py:1475-1481).
// counts: null or (5, n) per-ray steps, internal pops, leaf pops, box
// tests, triangle tests (a march sums them over the ray's cells).
template <int W, bool MARCH>
__global__ void __launch_bounds__(RTK_BLOCK, RTK_MIN_BLOCKS)
packet_trace_kernel(const int4* __restrict__ nodes,
                    const float4* __restrict__ tris,
                    const float* __restrict__ rays,
                    const int* __restrict__ roots,
                    const int* __restrict__ ray_index, int n, int leaf_size,
                    int mode_any, int watertight, int use_mask, int qmask,
                    int defer_uv, Grid grid, float* __restrict__ out_t,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int* __restrict__ out_slot, int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
#ifdef RTK_FILTER
  const int rid = ray_index ? __ldg(ray_index + i) : i;
#else
  const int rid = 0;
#endif
  // The octant copies of the box test pay on flat tables of both widths,
  // at 16 wide because its box tests hold no insertion code (with it, the
  // copies lost 35-41%).  The march's per-cell trees make the copies lose
  // more than they save (PERF.md section 6).
  constexpr bool kOct = !MARCH;
  const size_t sn = (size_t)n;
  const float ox = rays[i], oy = rays[sn + i], oz = rays[2 * sn + i];
  const float dx = rays[3 * sn + i], dy = rays[4 * sn + i],
              dz = rays[5 * sn + i];
  const float mint = rays[6 * sn + i], maxt = rays[7 * sn + i];

  float best_t = maxt, best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;
  // Internal and leaf pops, child box tests, triangle tests (stats).
  int n_int = 0, n_leaf = 0, n_box = 0, n_tri = 0;

  // Dead rays (max_t <= min_t) do no traversal (pallas_trace.py:385).
  if (!(maxt <= mint)) {
    RayC r;
    r.ox = ox;
    r.oy = oy;
    r.oz = oz;
    r.rx = crcp(dx);
    r.ry = crcp(dy);
    r.rz = crcp(dz);
    r.mint = mint;
    // Shear basis (rtk.c:550-567): kz = dominant |d| axis, ties x, y, z.
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const float maxc = max_nan(ax, max_nan(ay, az));
    r.kz = ax == maxc ? 0 : (ay == maxc ? 1 : 2);
    const int kx = r.kz == 2 ? 0 : r.kz + 1;
    const int ky = kx == 2 ? 0 : kx + 1;
    const float dkz = sel3(r.kz, dx, dy, dz);
    r.sx = -sel3(kx, dx, dy, dz) / dkz;
    r.sy = -sel3(ky, dx, dy, dz) / dkz;
    r.sz = 1.0f / dkz;
    r.okx = sel3(kx, ox, oy, oz);
    r.oky = sel3(ky, ox, oy, oz);
    r.okz = sel3(r.kz, ox, oy, oz);

    if (!MARCH) {
      traverse<W, kOct>(roots ? __ldg(roots + i) : 0, nodes, tris,
                        leaf_size, mode_any, watertight, use_mask, qmask,
                        defer_uv, rid, r, best_t, best_u, best_v, best_slot,
                        n_int, n_leaf, n_box, n_tri, NoNext{});
    } else {
      // Grid entry: the slab test against the grid box
      // (pallas_trace.py:397-403).  A ray that misses it does no work.
      float near = -kBig, far = kBig;
      {
        const float t0 = (grid.lox - ox) * r.rx, t1 = (grid.hix - ox) * r.rx;
        near = max_nan(near, min_nan(t0, t1));
        far = min_nan(far, max_nan(t0, t1));
      }
      {
        const float t0 = (grid.loy - oy) * r.ry, t1 = (grid.hiy - oy) * r.ry;
        near = max_nan(near, min_nan(t0, t1));
        far = min_nan(far, max_nan(t0, t1));
      }
      {
        const float t0 = (grid.loz - oz) * r.rz, t1 = (grid.hiz - oz) * r.rz;
        near = max_nan(near, min_nan(t0, t1));
        far = min_nan(far, max_nan(t0, t1));
      }
      if (near <= far && !(far < 0.0f)) {
        // First cell and per-axis next-boundary t (pallas_trace.py:404-
        // 425): cell = clip(floor((o + d*s0 - lo) / cs)), the boundary
        // ahead lo + (cell + (d >= 0)) * cs, reached at (b - o) * rcp.
        const float s0 = max_nan(near, 0.0f);
        const float fx = floorf((ox + dx * s0 - grid.lox) / grid.csx);
        const float fy = floorf((oy + dy * s0 - grid.loy) / grid.csy);
        const float fz = floorf((oz + dz * s0 - grid.loz) / grid.csz);
        int cx = (int)fminf(fmaxf(fx, 0.0f), (float)(grid.dx - 1));
        int cy = (int)fminf(fmaxf(fy, 0.0f), (float)(grid.dy - 1));
        int cz = (int)fminf(fmaxf(fz, 0.0f), (float)(grid.dz - 1));
        const bool sx = dx >= 0.0f, sy = dy >= 0.0f, sz = dz >= 0.0f;
        float tmx = (grid.lox + (float)(cx + sx) * grid.csx - ox) * r.rx;
        float tmy = (grid.loy + (float)(cy + sy) * grid.csy - oy) * r.ry;
        float tmz = (grid.loz + (float)(cz + sz) * grid.csz - oz) * r.rz;
        // Retire: the cell's exit bounds every later cell's entry, so a
        // hit at or before it is final (pallas_trace.py:1214-1219).  Else
        // one DDA step across the nearest boundary, ties x, y, z
        // (pallas_trace.py:1221-1235); leaving the grid ends the march.
        // A step's t across a cell, cs * |rcp|, is formed where it is
        // added (the same product, so the same bits): three registers
        // fewer over the loop.
        auto step = [&]() -> bool {
          const float exit_t = min_nan(tmx, min_nan(tmy, tmz));
          if (best_t <= exit_t || (mode_any && best_slot >= 0)) return false;
          const bool mx = tmx <= tmy && tmx <= tmz;
          const bool my = !mx && tmy <= tmz;
          if (mx) {
            cx += sx ? 1 : -1;
            tmx += grid.csx * fabsf(r.rx);
            return cx >= 0 && cx < grid.dx;
          }
          if (my) {
            cy += sy ? 1 : -1;
            tmy += grid.csy * fabsf(r.ry);
            return cy >= 0 && cy < grid.dy;
          }
          cz += sz ? 1 : -1;
          tmz += grid.csz * fabsf(r.rz);
          return cz >= 0 && cz < grid.dz;
        };
        // An empty cell's root row is childless: its pop is counted as
        // traverse would count it, without reading the row.
        auto occupied = [&](int c) -> bool {
          return (__ldg(grid.occ + (c >> 5)) >> (c & 31)) & 1u;
        };
        // The next occupied cell of the chain, or -1 when the ray retires.
        auto next_cell = [&]() -> int {
          for (;;) {
            if (!step()) return -1;
            const int c = (cx * grid.dy + cy) * grid.dz + cz;
            if (occupied(c)) return c;
            ++n_int;
          }
        };
        int c0 = (cx * grid.dy + cy) * grid.dz + cz;
        if (!occupied(c0)) {
          ++n_int;
          c0 = next_cell();
        }
        // One traversal loop over the whole chain: a lane whose stack runs
        // dry in a cell steps on and descends through the next cell's
        // root while the warp's other lanes are still in theirs.
        if (c0 >= 0)
          traverse<W, kOct>(c0, nodes, tris, leaf_size, mode_any, watertight,
                            use_mask, qmask, defer_uv, rid, r, best_t, best_u,
                            best_v, best_slot, n_int, n_leaf, n_box, n_tri,
                            [&](int& cur) -> bool {
                              const int c = next_cell();
                              if (c < 0) return false;
                              cur = c;
                              return true;
                            });
      }
    }
  }
  out_t[i] = best_t;  // a miss keeps t = max_t, slot = -1
  out_u[i] = best_u;
  out_v[i] = best_v;
  out_slot[i] = best_slot;
  if (counts) {
    counts[i] = n_int + n_leaf;
    counts[sn + i] = n_int;
    counts[2 * sn + i] = n_leaf;
    counts[3 * sn + i] = n_box;
    counts[4 * sn + i] = n_tri;
  }
}

template <int W, bool MARCH>
int launch(const void* nodes, const void* tris, const void* rays,
           const void* roots, const void* ray_index, int n, int leaf_size,
           int mode_any, int watertight, int use_mask, int qmask,
           int defer_uv, Grid grid, void* out_t, void* out_u, void* out_v,
           void* out_slot, void* counts, void* stream) {
  if (n > 0) {
    const int blocks = (n + RTK_BLOCK - 1) / RTK_BLOCK;
    packet_trace_kernel<W, MARCH>
        <<<blocks, RTK_BLOCK, 0, (cudaStream_t)stream>>>(
            (const int4*)nodes, (const float4*)tris, (const float*)rays,
            (const int*)roots, (const int*)ray_index, n, leaf_size, mode_any,
            watertight, use_mask, qmask, defer_uv, grid, (float*)out_t,
            (float*)out_u, (float*)out_v, (int*)out_slot, (int*)counts);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rtk_packet_trace_max_stack() { return RTK_MAX_STACK; }

// rays: (8, n) f32 [ox oy oz dx dy dz min_t max_t]; nodes (Nd*w, 8) i32
// with w = 8 or 16, and tris (Tp, 16) f32, both 16-byte aligned; roots:
// null or (n,) i32 entries, rows in [0, Nd) or leaves -2 - l with l in
// [0, Tp / leaf_size); ray_index: null or (n,) i32 caller
// indices (filter builds); counts: null or (5, n) i32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success, -1 for a width
// the library does not hold); does not synchronise.
int rtk_packet_trace(const void* nodes, const void* tris, const void* rays,
                     const void* roots, const void* ray_index, int n,
                     int leaf_size, int w, int mode_any, int watertight,
                     int use_mask, int qmask, int defer_uv, void* out_t,
                     void* out_u, void* out_v, void* out_slot, void* counts,
                     void* stream) {
  const Grid none = {};
  if (w == 8)
    return launch<8, false>(nodes, tris, rays, roots, ray_index, n,
                            leaf_size, mode_any, watertight, use_mask, qmask,
                            defer_uv, none, out_t, out_u, out_v, out_slot,
                            counts, stream);
  if (w == 16)
    return launch<16, false>(nodes, tris, rays, roots, ray_index, n,
                             leaf_size, mode_any, watertight, use_mask,
                             qmask, defer_uv, none, out_t, out_u, out_v,
                             out_slot, counts, stream);
  return -1;
}

#ifndef RTK_FILTER
// The grid march over an 8-wide table with one root row per cell (row ==
// cell id): dims d*, low corner lo*, cell size cs*, high corner hi* =
// f32(lo + cs * dims); occ: (ceil(cells / 32),) u32, bit c set
// where cell c's root row has a child.  Other arguments as
// rtk_packet_trace's.
int rtk_packet_march(const void* nodes, const void* tris, const void* rays,
                     int n, int leaf_size, int mode_any, int watertight,
                     int use_mask, int qmask, int dx, int dy, int dz,
                     float lox, float loy, float loz, float csx, float csy,
                     float csz, float hix, float hiy, float hiz,
                     const void* occ, void* out_t, void* out_u, void* out_v,
                     void* out_slot, void* counts, void* stream) {
  const Grid grid = {dx,  dy,  dz,  lox, loy, loz, csx,
                     csy, csz, hix, hiy, hiz, (const unsigned*)occ};
  return launch<8, true>(nodes, tris, rays, nullptr, nullptr, n, leaf_size,
                         mode_any, watertight, use_mask, qmask, 0, grid,
                         out_t, out_u, out_v, out_slot, counts, stream);
}
#endif

}  // extern "C"
