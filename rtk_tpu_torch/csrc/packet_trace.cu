// Packet-table traversal kernel for Hopper (sm_90a): the nearest (or any)
// watertight hit of each ray over the packed BVH8 tables built by
// rtk_tpu_torch/trace/packed.py.
//
// Replaces rtk_tpu/ops/pallas_trace.py::_make_kernel (the TPU kernel that
// _run_kernel launches through pl.pallas_call).  Same tables, same
// semantics; not the same schedule.  The TPU kernel advances packets of
// 128+ rays in lockstep because the TPU pays per scalar instruction and
// wins on wide vector tiles.  Here one thread traces one ray with its own
// stack in local memory, rtk's own shape (rtk.c:390-539).
//
// What bounds it on an H100: not arithmetic but the latency of dependent
// fetches (a node's 256-byte child block, then its children, then the
// leaf's triangle rows, each address known only after the previous load),
// and warp divergence (the 32 rays of a warp visit different nodes and
// leave the loop at different times).  The tables of the blob(6) scene
// are about 6 MB, so after the first touches they sit in the 50 MB L2.
// What the design does about it: every fetch is a 16-byte read-only load
// (__ldg) of a contiguous row, so a node costs 16 loads from one 256-byte
// span; children are pushed near-to-far (ties by slot) so best_t shrinks
// early and fewer subtrees are entered; the caller sorts rays by a Morton
// coherence key so the rays of a warp walk nearly the same nodes and share
// cache lines; 128-thread blocks keep many warps resident to cover latency.
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

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef RTK_FILTER
#ifndef RTK_FILTER_DEFINED
#error "RTK_FILTER builds force-include a generated rtk_filter_pred header"
#endif
#endif

#define RTK_W 8
#define RTK_MAX_STACK 256  // entries; the wrapper refuses deeper trees
#define RTK_BLOCK 128

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

// roots: null (every ray starts at row 0) or (n,) per-ray entry rows of a
// multi-root table (pallas_trace.py:347-360 takes one per 128-ray packet;
// a thread per ray makes the per-ray root the natural form).
// ray_index: read by filter builds only; null (the caller's index is i) or
// (n,) caller indices of coherence-sorted rays (pallas_trace.py:1475-1481).
// counts: null or (5, n) per-ray steps, internal pops, leaf pops, box
// tests, triangle tests.
__global__ void __launch_bounds__(RTK_BLOCK)
packet_trace_kernel(const int4* __restrict__ nodes,
                    const float4* __restrict__ tris,
                    const float* __restrict__ rays,
                    const int* __restrict__ roots,
                    const int* __restrict__ ray_index, int n, int leaf_size,
                    int mode_any, int watertight, int use_mask, int qmask,
                    int defer_uv, float* __restrict__ out_t,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int* __restrict__ out_slot, int* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
#ifdef RTK_FILTER
  const int rid = ray_index ? __ldg(ray_index + i) : i;
#endif
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
    const float rx = crcp(dx), ry = crcp(dy), rz = crcp(dz);
    const bool px = rx >= 0.0f, py = ry >= 0.0f, pz = rz >= 0.0f;

    // Shear basis (rtk.c:550-567): kz = dominant |d| axis, ties x, y, z.
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const float maxc = max_nan(ax, max_nan(ay, az));
    const int kz = ax == maxc ? 0 : (ay == maxc ? 1 : 2);
    const int kx = kz == 2 ? 0 : kz + 1;
    const int ky = kx == 2 ? 0 : kx + 1;
    const float dkz = sel3(kz, dx, dy, dz);
    const float sx = -sel3(kx, dx, dy, dz) / dkz;
    const float sy = -sel3(ky, dx, dy, dz) / dkz;
    const float sz = 1.0f / dkz;
    const float okx = sel3(kx, ox, oy, oz);
    const float oky = sel3(ky, ox, oy, oz);
    const float okz = sel3(kz, ox, oy, oz);

    int stack[RTK_MAX_STACK];
    int sp = 0;
    stack[sp++] = roots ? __ldg(roots + i) : 0;  // the ray's root row
    while (sp > 0) {
      const int e = stack[--sp];
      if (e >= 0) {
        ++n_int;
        // Internal node: 8 child rows of 8 int32, 2 int4 per row.  Row 0
        // carries (first_child, first_leaf) in cols 6-7, row 1 the masks.
        const int4* row = nodes + (size_t)e * (2 * RTK_W);
        const int4 m0 = __ldg(row + 1);
        const int4 m1 = __ldg(row + 3);
        const int fc = m0.z, fl = m0.w;
        const int im = m1.z & 0xFF, lm = (m1.z >> 8) & 0xFF;
        n_box += __popc(im | lm);  // every live child is box-tested
        float key[RTK_W];
        int ent[RTK_W];
        int cnt = 0;
#pragma unroll
        for (int w = 0; w < RTK_W; ++w) {
          const int bit = 1 << w;
          if (!((im | lm) & bit)) continue;
          const int4 a = __ldg(row + 2 * w);
          const int4 b = __ldg(row + 2 * w + 1);
          const float mnx = __int_as_float(a.x), mny = __int_as_float(a.y),
                      mnz = __int_as_float(a.z), mxx = __int_as_float(a.w),
                      mxy = __int_as_float(b.x), mxz = __int_as_float(b.y);
          const float nx = ((px ? mnx : mxx) - ox) * rx;
          const float fx = ((px ? mxx : mnx) - ox) * rx;
          const float ny = ((py ? mny : mxy) - oy) * ry;
          const float fy = ((py ? mxy : mny) - oy) * ry;
          const float nz = ((pz ? mnz : mxz) - oz) * rz;
          const float fz = ((pz ? mxz : mnz) - oz) * rz;
          const float enter = max_nan(max_nan(nx, ny), max_nan(nz, mint));
          const float exit = min_nan(min_nan(fx, fy), min_nan(fz, best_t));
          if (!(enter <= exit)) continue;
          const int below = bit - 1;
          const int entry = (im & bit) ? fc + __popc(im & below)
                                       : -(fl + __popc(lm & below)) - 2;
          // Stable insertion by entry distance: ties keep slot order.
          int j = cnt++;
          while (j > 0 && key[j - 1] > enter) {
            key[j] = key[j - 1];
            ent[j] = ent[j - 1];
            --j;
          }
          key[j] = enter;
          ent[j] = entry;
        }
        // Far first, so the nearest child is on top of the stack.
        for (int j = cnt - 1; j >= 0; --j) stack[sp++] = ent[j];
      } else {
        // Leaf l: triangle rows [l*K, (l+1)*K), 16 floats each:
        // [v0 v1 v2 | mask mesh prim | pad].
        ++n_leaf;
        const int base = (-e - 2) * leaf_size;
        for (int k = 0; k < leaf_size; ++k) {
          const float4* tr = tris + (size_t)(base + k) * 4;
          const float4 q0 = __ldg(tr), q1 = __ldg(tr + 1), q2 = __ldg(tr + 2);
          // Padding rows (NaN vertices) can never hit; masked-out rows
          // are rejected before any arithmetic.
          if (q0.x != q0.x) continue;
          if (use_mask && ((int)q2.y & qmask) == 0) continue;
          ++n_tri;
          const float vx[3] = {q0.x, q0.w, q1.z};
          const float vy[3] = {q0.y, q1.x, q1.w};
          const float vz[3] = {q0.z, q1.y, q2.x};
          float xs[3], ys[3], zs[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            // Translate before shearing (pallas_trace.py:953-968).
            const float tx = sel3(kx, vx[j], vy[j], vz[j]) - okx;
            const float ty = sel3(ky, vx[j], vy[j], vz[j]) - oky;
            const float tz = sel3(kz, vx[j], vy[j], vz[j]) - okz;
            xs[j] = tx + sx * tz;
            ys[j] = ty + sy * tz;
            zs[j] = sz * tz;
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
          const float lo = min_nan(min_nan(u, v), w);
          const float hi = max_nan(max_nan(u, v), w);
          const float rcp_det = 1.0f / (u + v + w);
          const float t = (u * zs[0] + v * zs[1] + w * zs[2]) * rcp_det;
          // Accept inside (min_t, best): the first hit found wins a tie.
          bool accept = !(lo < 0.0f && hi > 0.0f) && t > mint && t < best_t;
#ifdef RTK_FILTER
          // Mesh and triangle ids are exact float columns (< 2^24).
          accept = accept && rtk_filter_pred(t, u * rcp_det, v * rcp_det,
                                             (int)q2.z, (int)q2.w, rid);
#endif
          if (accept) {
            best_t = t;
            best_slot = base + k;
            if (!defer_uv) {
              best_u = u * rcp_det;
              best_v = v * rcp_det;
            }
          }
        }
        if (mode_any && best_slot >= 0) break;
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

}  // namespace

extern "C" {

int rtk_packet_trace_max_stack() { return RTK_MAX_STACK; }

// rays: (8, n) f32 [ox oy oz dx dy dz min_t max_t]; nodes (Nd*8, 8) i32
// and tris (Tp, 16) f32, both 16-byte aligned; roots: null or (n,) i32
// rows in [0, Nd); ray_index: null or (n,) i32 caller indices (filter
// builds); counts: null or (5, n) i32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int rtk_packet_trace(const void* nodes, const void* tris, const void* rays,
                     const void* roots, const void* ray_index, int n,
                     int leaf_size, int mode_any, int watertight,
                     int use_mask, int qmask, int defer_uv, void* out_t,
                     void* out_u, void* out_v, void* out_slot, void* counts,
                     void* stream) {
  if (n > 0) {
    const int grid = (n + RTK_BLOCK - 1) / RTK_BLOCK;
    packet_trace_kernel<<<grid, RTK_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int4*)nodes, (const float4*)tris, (const float*)rays,
        (const int*)roots, (const int*)ray_index, n, leaf_size, mode_any,
        watertight, use_mask, qmask, defer_uv, (float*)out_t, (float*)out_u,
        (float*)out_v, (int*)out_slot, (int*)counts);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
