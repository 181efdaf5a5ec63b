// Ray coherence key for Hopper (sm_90a): the 30-bit Morton code of a probe
// point pushed along each ray, the key trace_packets' front end sorts a
// batch by before the traversal (ops/packet_trace.py::_ray_rows).
//
// Computes rtk_tpu/ops/morton.py::ray_coherence_key (:61-83), which the
// reference leaves to XLA under jit (one fusion, no Pallas kernel), and
// the port's plain version, ops/morton.py::ray_coherence_key_reference,
// which is about fifty eager tensor operations.  On the card each of those
// was a launch of its own, and for a batch of 16,384 to a few million
// rays the host's time to issue them, not the card's, was the call's
// cost.  Here the key is one call into this library: a memset and three
// launches, in stream order:
//   1. origin_bounds: each thread folds a grid-stride slice of the origins
//      into a running minimum and maximum per axis; a warp reduces them
//      (one instruction each) and its first lane folds them into global
//      slots with atomicMin where they improve on what the slot holds;
//   2. probe_bounds: each thread computes the probes of its slice
//      (normalised direction times the scale, from the origin bounds, plus
//      the origin) and folds their bounds the same way;
//   3. morton_key: one thread per ray computes its probe again (the same
//      instructions, so the same bits) and quantises it inside the probe
//      bounds into the Morton code.
// The probe is recomputed rather than stored: storing it would write and
// read 12 bytes a ray more than reading the origin and direction again
// (24 bytes) costs, and it would take an (n, 3) buffer.
//
// What bounds it on an H100: the bytes.  The key reads 24 bytes a ray and
// writes 4; these launches read the origin three times and the direction
// twice (60 bytes) and write 4, so they take at best about 2.3 times the
// bound of 28 bytes a ray.  The arithmetic (a square root and four
// divides a ray in steps 2 and 3) hides under the loads.  Min and max are
// exact in any order, so the atomics' order changes nothing: the keys are
// the same bits in every run.
//
// Numerics: every f32 operation is the plain version's, in its order, and
// the library is built with -fmad=false.  The two norms are written as the
// reference's reduction computes them on the CPU (XLA's and torch's, both
// measured): sqrt(fma(z, z, fma(y, y, x * x))), with explicit fmaf, which
// -fmad=false leaves as it is.  The float-to-int conversion truncates, as
// the reference's f32 -> u32 convert does for values in [0, 1023].  A NaN
// coordinate is outside the contract: its axis quantises to 0 (fmaxf drops
// the NaN) and the bounds, hence other rays' keys, may move; every key is
// still a 30-bit value and nothing is read or written outside the batch.
#include <cuda_runtime.h>

namespace {

constexpr int KEY_BLOCK = 256;            // threads a block
constexpr int KEY_REDUCE_BLOCKS = 1024;   // most blocks of steps 1 and 2
constexpr unsigned KEY_EMPTY = 0xFFFFFFFFu;  // a slot no value reached

// The 12 u32 slots of the bounds, each holding a minimum, so that one
// memset of 0xFF bytes starts them all: [0, 3) enc(min origin), [3, 6)
// ~enc(max origin), [6, 9) enc(min probe), [9, 12) ~enc(max probe).
constexpr int SLOTS = 12;

// An order-preserving map of f32 bits onto u32 (a < b as floats, neither
// NaN, iff enc(a) < enc(b); -0 sorts below +0, which no step below can
// tell apart), and its inverse.
__device__ __forceinline__ unsigned enc(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float dec(unsigned e) {
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7FFFFFFFu) : ~e);
}

__device__ __forceinline__ unsigned umin(unsigned a, unsigned b) {
  return a < b ? a : b;
}

// An (n, 3) f32 view with element strides (an expanded origin has row
// stride 0).
struct View {
  const float* p;
  long long sr, sc;
};

__device__ __forceinline__ float at(const View& v, long long i, int k) {
  return v.p[i * v.sr + k * v.sc];
}

// Fold a thread's running minimum into *slot: the warp's minimum first,
// then one atomic from its lowest lane, only where the slot does not hold
// a value as small already.  The slot is read past L1 (volatile); a read
// that is behind other warps' atomics costs an atomic, never a wrong
// bound, since a slot only falls.  Every lane of the warp calls it.
__device__ __forceinline__ void fold(unsigned* slot, unsigned v) {
  const unsigned lanes = __ballot_sync(0xFFFFFFFFu, true);
  v = __reduce_min_sync(lanes, v);
  if ((int)(threadIdx.x & 31) == __ffs((int)lanes) - 1 &&
      v < *(volatile unsigned*)slot)
    atomicMin(slot, v);
}

// sqrt(fma(z, z, fma(y, y, x * x))): the norm as the reference computes it.
__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(fmaf(z, z, fmaf(y, y, x * x)));
}

// scale = max(0.5 |o_hi - o_lo|, 1e-2 (1 + max |o_hi|)) from the origin
// bounds (morton.py:75-77).
__device__ __forceinline__ float probe_scale(const unsigned* b) {
  const float l0 = dec(b[0]), l1 = dec(b[1]), l2 = dec(b[2]);
  const float h0 = dec(~b[3]), h1 = dec(~b[4]), h2 = dec(~b[5]);
  const float diag = norm3(h0 - l0, h1 - l1, h2 - l2);
  const float m = fmaxf(fmaxf(fabsf(h0), fabsf(h1)), fabsf(h2));
  return fmaxf(0.5f * diag, 0.01f * (1.0f + m));
}

// probe = o + (d / max(|d|, 1e-30)) * scale (morton.py:71-72, :78).
__device__ __forceinline__ void probe_of(const View& o, const View& d,
                                         long long i, float scale,
                                         float p[3]) {
  const float dx = at(d, i, 0), dy = at(d, i, 1), dz = at(d, i, 2);
  const float len = fmaxf(norm3(dx, dy, dz), 1e-30f);
  p[0] = at(o, i, 0) + (dx / len) * scale;
  p[1] = at(o, i, 1) + (dy / len) * scale;
  p[2] = at(o, i, 2) + (dz / len) * scale;
}

// The low 10 bits of v spread to every third bit (expand_bits10).
__device__ __forceinline__ unsigned spread10(unsigned v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// One coordinate quantised to 10 bits inside [lo, hi] (morton3d).
__device__ __forceinline__ unsigned quantise(float p, float lo, float hi) {
  const float extent = fmaxf(hi - lo, 1e-30f);
  const float q = (p - lo) / extent;
  return (unsigned)(int)fminf(fmaxf(q * 1023.0f, 0.0f), 1023.0f);
}

__global__ void __launch_bounds__(KEY_BLOCK)
    origin_bounds(View o, long long n, unsigned* __restrict__ b) {
  unsigned m[6] = {KEY_EMPTY, KEY_EMPTY, KEY_EMPTY,
                   KEY_EMPTY, KEY_EMPTY, KEY_EMPTY};
  const long long stride = (long long)gridDim.x * KEY_BLOCK;
  for (long long i = (long long)blockIdx.x * KEY_BLOCK + threadIdx.x; i < n;
       i += stride) {
    for (int k = 0; k < 3; ++k) {
      const unsigned e = enc(at(o, i, k));
      m[k] = umin(m[k], e);
      m[3 + k] = umin(m[3 + k], ~e);
    }
  }
  for (int s = 0; s < 6; ++s) fold(b + s, m[s]);
}

__global__ void __launch_bounds__(KEY_BLOCK)
    probe_bounds(View o, View d, long long n, unsigned* __restrict__ b) {
  const float scale = probe_scale(b);
  unsigned m[6] = {KEY_EMPTY, KEY_EMPTY, KEY_EMPTY,
                   KEY_EMPTY, KEY_EMPTY, KEY_EMPTY};
  const long long stride = (long long)gridDim.x * KEY_BLOCK;
  for (long long i = (long long)blockIdx.x * KEY_BLOCK + threadIdx.x; i < n;
       i += stride) {
    float p[3];
    probe_of(o, d, i, scale, p);
    for (int k = 0; k < 3; ++k) {
      const unsigned e = enc(p[k]);
      m[k] = umin(m[k], e);
      m[3 + k] = umin(m[3 + k], ~e);
    }
  }
  for (int s = 0; s < 6; ++s) fold(b + 6 + s, m[s]);
}

__global__ void __launch_bounds__(KEY_BLOCK)
    morton_key(View o, View d, long long n, const unsigned* __restrict__ b,
               int* __restrict__ key) {
  const long long i = (long long)blockIdx.x * KEY_BLOCK + threadIdx.x;
  if (i >= n) return;
  float p[3];
  probe_of(o, d, i, probe_scale(b), p);
  unsigned code = 0;
  for (int k = 0; k < 3; ++k) {
    const unsigned q = quantise(p[k], dec(b[6 + k]), dec(~b[9 + k]));
    code |= spread10(q) << (2 - k);
  }
  key[i] = (int)code;
}

}  // namespace

extern "C" {

// origin, direction: (n, 3) f32 on the card with element strides (so_r,
// so_c) and (sd_r, sd_c); bounds: SLOTS u32 of scratch; key: (n,) i32.
// Launches the memset and the three kernels on `stream` and returns the
// first CUDA error (0 on success); does not synchronise.
int rtk_coherence_key(const void* origin, long long so_r, long long so_c,
                      const void* direction, long long sd_r, long long sd_c,
                      long long n, void* bounds, void* key, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = (int)cudaMemsetAsync(bounds, 0xFF, SLOTS * sizeof(unsigned),
                                       s);
  if (err) return err;
  const View o = {(const float*)origin, so_r, so_c};
  const View d = {(const float*)direction, sd_r, sd_c};
  unsigned* b = (unsigned*)bounds;
  const long long ray_blocks = (n + KEY_BLOCK - 1) / KEY_BLOCK;
  const unsigned blocks = (unsigned)ray_blocks;
  const unsigned reduce_blocks = (unsigned)(
      ray_blocks < KEY_REDUCE_BLOCKS ? ray_blocks : KEY_REDUCE_BLOCKS);
  origin_bounds<<<reduce_blocks, KEY_BLOCK, 0, s>>>(o, n, b);
  probe_bounds<<<reduce_blocks, KEY_BLOCK, 0, s>>>(o, d, n, b);
  morton_key<<<blocks, KEY_BLOCK, 0, s>>>(o, d, n, b, (int*)key);
  return (int)cudaGetLastError();
}

}  // extern "C"
