// The per-row glue of an instanced candidate round for Hopper (sm_90a):
// the round's object-space rays in one launch, and its better hits written
// back to the frame's best records in another.
//
// A candidate round of instancing.py::_instanced_rounds takes the rays
// still live for their s-th candidate instance, sorted by instance, moves
// each into its instance's object space and traces it from the instance's
// BLAS root with its best t so far as the upper bound; the hits that
// improve on the best are written back.  Around the traversal, the plain
// version (round_rays_reference, round_scatter_reference) is some fifty
// eager ops a round: the (M, 3, 4) affine gather, the origin and direction
// gathers and eleven products and sums of _object_rays, the gathers of
// min t, best t and the two-step root, then the better mask, six
// boolean-mask indexes (each a nonzero and a host sync) and five
// index-puts.  Each is some microseconds of the host's time, and each sync
// drains the queue, so the card idles while the host issues the rest.
// The reference does this inside its jitted program
// (rtk_tpu/instancing.py), outside any Pallas kernel, so these kernels
// replace no Pallas kernel; they are the port's own.
//
// Here one thread a row does each half.  round_rays reads a row's world
// origin and direction, min t and best t through its ray index, and its
// instance's 3x4 object_from_world (the rows are sorted by instance, so a
// warp's rows mostly share one affine, a broadcast from L1); it writes the
// object-space origin and direction, min t and max t (= best t), the
// packed root of the instance's BLAS and the instance id as i32.
// round_scatter reads a row's hit flag, t and best t and, where the hit is
// better (hit && t < best t), writes t, u, v, slot and instance at the
// row's ray index.  A round's rows are distinct rays (they come from
// nonzero), so no two threads write one ray, and no mask or count leaves
// the card.
//
// What bounds them: the bytes.  round_rays reads 48 a row (ray and
// instance ids, origin, direction, min t, best t) and writes 40; the
// scatter reads 17 a row (ray id, hit, t, best t) and 16 more and writes
// 20 where the row improves.  Both are a few microseconds at the rounds'
// sizes; what they save is the host's issue.
//
// Numerics, bit for bit the plain version's: each object-space component
// is ((m0 * x + m1 * y) + m2 * z) + m3, in _object_rays' order, each
// product and sum rounded on its own (the library is built with
// -fmad=false, so nothing contracts to an FMA); the rest moves bits.
#include <cuda_runtime.h>

namespace {

constexpr int ROUND_BLOCK = 256;  // threads a block

__global__ void __launch_bounds__(ROUND_BLOCK)
    round_rays(const long long* __restrict__ rows,
               const long long* __restrict__ inst, long long m,
               const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ min_t,
               const float* __restrict__ best_t,
               const float* __restrict__ object_from_world,
               const int* __restrict__ instance_blas,
               const int* __restrict__ packed_roots,
               float* __restrict__ out_origin,
               float* __restrict__ out_direction,
               float* __restrict__ out_min_t, float* __restrict__ out_max_t,
               int* __restrict__ out_roots, int* __restrict__ out_inst) {
  const long long i = (long long)blockIdx.x * ROUND_BLOCK + threadIdx.x;
  if (i >= m) return;
  const long long r = rows[i];
  const long long k = inst[i];
  const float ox = origin[3 * r], oy = origin[3 * r + 1],
              oz = origin[3 * r + 2];
  const float dx = direction[3 * r], dy = direction[3 * r + 1],
              dz = direction[3 * r + 2];
  const float* a = object_from_world + 12 * k;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float m0 = __ldg(a + 4 * c), m1 = __ldg(a + 4 * c + 1),
                m2 = __ldg(a + 4 * c + 2), m3 = __ldg(a + 4 * c + 3);
    out_origin[3 * i + c] = ((m0 * ox + m1 * oy) + m2 * oz) + m3;
    out_direction[3 * i + c] = (m0 * dx + m1 * dy) + m2 * dz;
  }
  out_min_t[i] = min_t[r];
  out_max_t[i] = best_t[r];
  out_roots[i] = __ldg(packed_roots + __ldg(instance_blas + k));
  out_inst[i] = (int)k;
}

__global__ void __launch_bounds__(ROUND_BLOCK)
    round_scatter(const long long* __restrict__ rows, long long m,
                  const unsigned char* __restrict__ hit,
                  const float* __restrict__ t, const float* __restrict__ u,
                  const float* __restrict__ v, const int* __restrict__ slot,
                  const float* __restrict__ bt, const int* __restrict__ inst,
                  float* __restrict__ best_t, float* __restrict__ best_u,
                  float* __restrict__ best_v, int* __restrict__ best_slot,
                  int* __restrict__ best_inst) {
  const long long i = (long long)blockIdx.x * ROUND_BLOCK + threadIdx.x;
  if (i >= m) return;
  const float ti = t[i];
  if (!(hit[i] && ti < bt[i])) return;
  const long long r = rows[i];
  best_t[r] = ti;
  best_u[r] = u[i];
  best_v[r] = v[i];
  best_slot[r] = slot[i];
  best_inst[r] = inst[i];
}

}  // namespace

extern "C" {

// rows: (m,) i64, the round's ray indices (distinct); inst: (m,) i64, each
// row's instance; origin, direction: (n, 3) f32 and min_t, best_t: (n,)
// f32, the frame's world rays and best t; object_from_world: (I, 3, 4)
// f32; instance_blas: (I,) i32; packed_roots: (B,) i32, rows of the packed
// tables.  Written: out_origin, out_direction (m, 3) f32, out_min_t,
// out_max_t (m,) f32, out_roots, out_inst (m,) i32.  Every id must be in
// range (the caller's gathers made them).  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int rtk_instanced_round_rays(const void* rows, const void* inst, long long m,
                             const void* origin, const void* direction,
                             const void* min_t, const void* best_t,
                             const void* object_from_world,
                             const void* instance_blas,
                             const void* packed_roots, void* out_origin,
                             void* out_direction, void* out_min_t,
                             void* out_max_t, void* out_roots, void* out_inst,
                             void* stream) {
  if (m > 0) {
    const unsigned blocks = (unsigned)((m + ROUND_BLOCK - 1) / ROUND_BLOCK);
    round_rays<<<blocks, ROUND_BLOCK, 0, (cudaStream_t)stream>>>(
        (const long long*)rows, (const long long*)inst, m,
        (const float*)origin, (const float*)direction, (const float*)min_t,
        (const float*)best_t, (const float*)object_from_world,
        (const int*)instance_blas, (const int*)packed_roots,
        (float*)out_origin, (float*)out_direction, (float*)out_min_t,
        (float*)out_max_t, (int*)out_roots, (int*)out_inst);
  }
  return (int)cudaGetLastError();
}

// rows: (m,) i64, distinct ray indices; hit: (m,) bool; t, u, v, bt: (m,)
// f32 (bt: each row's best t when the round started); slot, inst: (m,)
// i32.  Where hit && t < bt, writes t, u, v, slot and inst at rows[i] of
// best_t, best_u, best_v (n,) f32 and best_slot, best_inst (n,) i32, in
// place.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.
int rtk_instanced_round_scatter(const void* rows, long long m,
                                const void* hit, const void* t, const void* u,
                                const void* v, const void* slot,
                                const void* bt, const void* inst,
                                void* best_t, void* best_u, void* best_v,
                                void* best_slot, void* best_inst,
                                void* stream) {
  if (m > 0) {
    const unsigned blocks = (unsigned)((m + ROUND_BLOCK - 1) / ROUND_BLOCK);
    round_scatter<<<blocks, ROUND_BLOCK, 0, (cudaStream_t)stream>>>(
        (const long long*)rows, m, (const unsigned char*)hit,
        (const float*)t, (const float*)u, (const float*)v, (const int*)slot,
        (const float*)bt, (const int*)inst, (float*)best_t, (float*)best_u,
        (float*)best_v, (int*)best_slot, (int*)best_inst);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
