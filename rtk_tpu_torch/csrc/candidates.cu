// The instance candidate slab of instancing.py for Hopper (sm_90a): each
// ray's nearest C instance boxes by entry distance, and the (C+1)-th
// distance, in one launch.
//
// The top level of an instanced trace (instancing.py::_instance_candidates)
// tests every ray against every instance's world box and keeps the C
// nearest by entry distance, the first instance on ties, with the
// (C+1)-th distance as the bound that proves the cap exact.  Its plain
// version (_instance_candidates_impl) does this as a dense rays x boxes
// slab over chunks of rays: about 17 elementwise passes, then C rounds of
// min, isfinite, where and scatter_ and a last min, each a launch of its
// own over (chunk, B) tensors in device memory.  At configuration 5 (125
// instances, C = 12, 1024^2 rays) that is some 69 launches and 50-200 MB
// of intermediates a chunk.  The reference takes the nearest C with C
// passes of argmin in XLA (rtk_tpu/instancing.py:183), outside any Pallas
// kernel, so this kernel replaces no Pallas kernel; it is the port's own.
//
// Here one thread a ray computes the ray's clamped reciprocal once and
// walks the B boxes in index order.  Every thread of a warp reads the
// same box at the same time, so each __ldg is a broadcast, and B boxes
// (3 KB at 125) stay in L1.  The K smallest (score, index) pairs live in
// registers as a sorted list that a fully unrolled insertion chain keeps
// (no dynamic index, so nothing spills to local memory).  A box enters
// only below the K-th entry, strictly, and boxes come in index order, so
// on a tie the first instance wins, as torch.min(dim=1) chooses.  K is a
// template parameter, the least of 4, 8, 16 and 32 that holds the C+1
// ranks; more ranks (the exactness residual asks for all B) take passes
// of 32, each rescanning the boxes for the 32 smallest pairs that come
// strictly after the last pair of the pass before in (score, index) order.
// No shared memory and no barrier: a block's threads are independent.
//
// What bounds it on an H100: about 30 f32 operations a box test (six
// subtractions, six products, six minima and maxima for near and far, six
// for enter and exit, the compare, the select and the list's tests), 125
// tests a ray at configuration 5; the bytes are 32 read a ray (origin,
// direction, min_t, max_t) and 8 C + 4 written (100 at C = 12): about 132
// a ray.  So the operations bind it: 1,048,576 rays x 125 boxes x 30 is
// 3.9 G, 0.12 ms at 33.5 T f32 operations/s.  Nothing goes through device
// memory between the box test and the ranks, and the boxes are read once
// a warp.
//
// Numerics, bit for bit the plain version's on each device: the
// reciprocal is IEEE division (nvcc's default -prec-div=true, as torch's
// reciprocal), the library is built with -fmad=false so no FMA contracts
// (lo - o) * rcp, and the minima and maxima are torch's fmin and fmax: on
// the card the same instruction (torch's CUDA kernel calls ::fmin), off
// it torch's CPU form, which keeps the first operand on a tie of zeros.
// A score is never NaN (a NaN enter or exit fails enter <= exit), so the
// (score, index) order is total.
#include <cuda_runtime.h>

namespace {

constexpr int CAND_BLOCK = 256;  // threads a block
constexpr int CAND_MAX_K = 32;   // the longest list; more ranks take passes
constexpr float CAND_BIG = 3.0e38f;  // the clamped reciprocal of a zero

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// torch.fmin and torch.fmax on the device that runs this code.
__device__ __forceinline__ float slab_min(float a, float b) {
#ifdef __CUDA_ARCH__
  return fminf(a, b);
#else
  return b != b ? a : (a != a ? b : (b < a ? b : a));
#endif
}

__device__ __forceinline__ float slab_max(float a, float b) {
#ifdef __CUDA_ARCH__
  return fmaxf(a, b);
#else
  return b != b ? a : (a != a ? b : (b > a ? b : a));
#endif
}

// torch.where(d == 0, torch.where(d >= 0, BIG, -BIG), 1 / d): -0.0 takes
// +BIG, as d >= 0 holds for it.
__device__ __forceinline__ float clamped_rcp(float d) {
  return d == 0.0f ? (d >= 0.0f ? CAND_BIG : -CAND_BIG) : 1.0f / d;
}

// Ranks [0, c] of each ray's (score, index) pairs: ranks below c go to
// cand_idx (-1 where the score is not finite) and cand_t, rank c to
// overflow.  A rank past the last finite or -inf score reads inf.
template <int K>
__global__ void __launch_bounds__(CAND_BLOCK)
    nearest_boxes(const float* __restrict__ lo, const float* __restrict__ hi,
                  int n_box, const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ min_t,
                  const float* __restrict__ max_t, long long n, int c,
                  int* __restrict__ cand_idx, float* __restrict__ cand_t,
                  float* __restrict__ overflow) {
  const long long i = (long long)blockIdx.x * CAND_BLOCK + threadIdx.x;
  if (i >= n) return;
  const float inf = inf_f();
  const float ox = origin[3 * i], oy = origin[3 * i + 1],
              oz = origin[3 * i + 2];
  const float rx = clamped_rcp(direction[3 * i]),
              ry = clamped_rcp(direction[3 * i + 1]),
              rz = clamped_rcp(direction[3 * i + 2]);
  const float tmin = min_t[i], tmax = max_t[i];
  // The last pair of the pass before: every pair comes after (-inf, -1).
  float last_s = -inf;
  int last_i = -1;
  bool rest_inf = false;  // the pass before ran out of boxes
  for (int base = 0; base <= c; base += K) {
    float ks[K];
    int ki[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ks[j] = inf;
      ki[j] = -1;
    }
    for (int b = 0; !rest_inf && b < n_box; ++b) {
      const float* l = lo + 3 * b;
      const float* h = hi + 3 * b;
      const float t0x = (__ldg(l) - ox) * rx, t1x = (__ldg(h) - ox) * rx;
      const float t0y = (__ldg(l + 1) - oy) * ry,
                  t1y = (__ldg(h + 1) - oy) * ry;
      const float t0z = (__ldg(l + 2) - oz) * rz,
                  t1z = (__ldg(h + 2) - oz) * rz;
      const float enter =
          slab_max(slab_max(slab_min(t0x, t1x), slab_min(t0y, t1y)),
                   slab_max(slab_min(t0z, t1z), tmin));
      const float exit =
          slab_min(slab_min(slab_max(t0x, t1x), slab_max(t0y, t1y)),
                   slab_min(slab_max(t0z, t1z), tmax));
      const float s = enter <= exit ? enter : inf;
      if (!(s < ks[K - 1]) || s < last_s || (s == last_s && b <= last_i))
        continue;
      // Insert below the entries it is not less than: slot j takes slot
      // j - 1's pair where s goes above that, else s where it goes at j.
#pragma unroll
      for (int j = K - 1; j > 0; --j) {
        if (s < ks[j - 1]) {
          ks[j] = ks[j - 1];
          ki[j] = ki[j - 1];
        } else if (s < ks[j]) {
          ks[j] = s;
          ki[j] = b;
        }
      }
      if (s < ks[0]) {
        ks[0] = s;
        ki[0] = b;
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int r = base + j;
      if (r < c) {
        cand_t[i * c + r] = ks[j];
        cand_idx[i * c + r] = (ks[j] > -inf && ks[j] < inf) ? ki[j] : -1;
      } else if (r == c) {
        overflow[i] = ks[j];
      }
    }
    last_s = ks[K - 1];
    last_i = ki[K - 1];
    rest_inf = !(last_s < inf);
  }
}

template <int K>
void launch_nearest(unsigned blocks, const float* lo, const float* hi,
                    int n_box, const float* origin, const float* direction,
                    const float* min_t, const float* max_t, long long n,
                    int c, int* cand_idx, float* cand_t, float* overflow,
                    cudaStream_t stream) {
  const auto kern = nearest_boxes<K>;
  kern<<<blocks, CAND_BLOCK, 0, stream>>>(lo, hi, n_box, origin, direction,
                                          min_t, max_t, n, c, cand_idx,
                                          cand_t, overflow);
}

}  // namespace

extern "C" {

// lo, hi: (n_box, 3) f32 box corners; origin, direction: (n, 3) f32;
// min_t, max_t: (n,) f32; all contiguous.  c: the candidates a ray keeps,
// 1 <= c <= n_box.  Written: cand_idx (n, c) i32 (-1 where the distance is
// not finite), cand_t (n, c) f32, overflow (n,) f32 (the (c+1)-th
// distance, inf when c == n_box).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); allocates nothing and does not
// synchronise.
int rtk_instance_candidates(const void* lo, const void* hi, int n_box,
                            const void* origin, const void* direction,
                            const void* min_t, const void* max_t,
                            long long n, int c, void* cand_idx, void* cand_t,
                            void* overflow, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + CAND_BLOCK - 1) / CAND_BLOCK);
    const int ranks = c + 1;
    void (*launch)(unsigned, const float*, const float*, int, const float*,
                   const float*, const float*, const float*, long long, int,
                   int*, float*, float*, cudaStream_t) =
        launch_nearest<CAND_MAX_K>;
    if (ranks <= 4)
      launch = launch_nearest<4>;
    else if (ranks <= 8)
      launch = launch_nearest<8>;
    else if (ranks <= 16)
      launch = launch_nearest<16>;
    launch(blocks, (const float*)lo, (const float*)hi, n_box,
           (const float*)origin, (const float*)direction,
           (const float*)min_t, (const float*)max_t, n, c, (int*)cand_idx,
           (float*)cand_t, (float*)overflow, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
