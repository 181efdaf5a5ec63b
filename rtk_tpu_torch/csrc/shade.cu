// The shade pass of render_path for Hopper (sm_90a): one bounce's
// emission, next rays, throughput, liveness and order key in one launch.
//
// models/path.py::render_path traces a bounce batch, then shades it: the
// hit's emission (or the sky) times the path's throughput is added to the
// path's radiance; a cosine-weighted direction is drawn about the hit's
// geometric normal; the next ray starts on the surface, the throughput
// takes the albedo, and a path whose hit missed or whose throughput fell
// under the floor ends.  Its plain version, models/path.py::_shade_sample,
// is about eighty eager tensor operations (the record's gathers, wheres,
// stacks, products), each a launch of its own on the card, and the host's
// time to issue them, not the card's, was the pass's cost.  The reference
// runs the same pass under jit, fused by XLA (rtk_tpu/models/path.py:98),
// outside any Pallas kernel.  Here it is one thread a ray:
//   1. the record through one row into the triangle tables: a PacketHits'
//      slot into (tri_v, tri_mesh), masked by the hit flag; a plain Hits'
//      own vertex_position and mesh_index, row i;
//   2. the material index clamped to the material count;
//   3. radiance[index[i]] += throughput * (emission on a hit, else the
//      background): index holds no duplicates, so a plain read-modify-write
//      equals index_add_ bit for bit;
//   4. on every bounce but the last: the geometric normal (an instanced
//      record's mapped from the hit instance's object space to world
//      space) flipped to face the ray, the cosine direction from the two
//      uniforms of draws[j]
//      (j = draw_index[i] for the uniforms handed in by ray, else i), the
//      origin on the surface pushed off by epsilon along the normal, the
//      throughput times the albedo, the liveness, the bounds and the int32
//      order key (dead rays to the back, then the direction octant and the
//      Morton code of the origin, models/path.py::_ray_sort_key);
//   5. the live count: a block's sum (__syncthreads_count), then one atomic
//      add a block; integers add the same in any order.
//
// What bounds it on an H100: the bytes, about 170 a ray (the record's 13,
// the triangle's 36 and its mesh, the ray's 24, throughput and index 20,
// the two uniforms, radiance read and written, and the next ray,
// throughput and key written: 48); an instanced record adds its instance
// and the 36 bytes of that instance's linear part.  The triangle, the
// uniforms and the radiance are read where the row, the path's index and
// the sort put them, so their sectors are partly wasted; the writes are
// coalesced.
//
// Numerics: every f32 operation is the eager pass's, in its order, and
// the library is built with -fmad=false, so each elementwise operation of
// the plain version is one rounding here.  Inside torch's reductions the
// order and contraction differ by device, and so does this kernel:
// torch's CUDA norm of a row of three runs two threads a row (elements 0
// and 2 in one, each square rounded, then 1), its CPU norm is one fused
// chain, sqrt(fma(z, z, fma(y, y, x * x))); the flip's sum of three
// products is (p0 + p2) + p1 on the card and (p0 + p1) + p2 on the CPU.
// torch's cross product contracts x * y - z * w into fma(x, y, -(z * w))
// on both.  The norm's root is __fsqrt_rn, the correctly rounded root
// torch's norm takes on both devices (sqrtf's on the card); the sample's
// sqrtf, cosf and sinf are the functions torch.sqrt, torch.cos and
// torch.sin call on the card, and division is IEEE's.  A host build of
// this file (the tests' g++ build, handed torch's CPU sqrt, cos and sin)
// takes the CPU's forms, so it is held bit for bit against the plain
// version on the CPU, and the nvcc build against the eager pass on the
// card.
#include <cuda_runtime.h>

namespace {

constexpr int SHADE_BLOCK = 256;  // threads a block

// An (n, 3) f32 view with element strides (a camera's expanded origin has
// row stride 0).
struct View3 {
  const float* p;
  long long s0, s1;
};

}  // namespace

extern "C" {

// One bounce batch's shade pass; every pointer is on the card and every
// tensor without strides is contiguous.
struct RtkShadeArgs {
  long long n;                   // rays in the batch
  long long rows;                // rows of tri_v / tri_mesh (packet: Tp)
  int packet;                    // 1: a PacketHits (slot, t, origin,
                                 // direction); 0: a plain Hits (u, v)
  int last;                      // 1: the radiance only
  int sort_rays;                 // 1: Morton below the octant in the key
  int materials;                 // rows of albedo / emission
  const unsigned char* hit;      // (n,) bool
  const float* t;                // (n,) packet
  const int* slot;               // (n,) packet
  const float* u;                // (n,) plain
  const float* v;                // (n,) plain
  const float* tri_v;            // (rows, 3, 3)
  const int* tri_mesh;           // (rows,)
  View3 origin;                  // the traced rays (packet: position)
  View3 direction;
  View3 ray_direction;           // the bounce's rays (the flip)
  const float* throughput;       // (n, 3)
  const long long* index;        // (n,) the path of each slot
  float* radiance;               // (paths, 3), updated in place
  const float* albedo;           // (materials, 3)
  const float* emission;         // (materials, 3)
  const float* background;       // (3,)
  const float* lo;               // (3,) scene bounds
  const float* hi;               // (3,)
  const float* draws;            // u1 at draws[j * ds0], u2 at + ds1
  long long ds0, ds1;
  const long long* draw_index;   // null: j = i
  float epsilon;                 // the next rays' offset and min_t
  float min_throughput;          // a path under it in every channel ends
  float live_max_t;              // a live next ray's max_t
  float* next_origin;            // (n, 3)
  float* next_direction;         // (n, 3)
  float* next_min_t;             // (n,)
  float* next_max_t;             // (n,)
  float* next_throughput;        // (n, 3)
  int* key;                      // (n,) the order key
  unsigned long long* alive;     // 0-d, zeroed by the entry point
  // An instanced record (packet only; null on a flat one): the hit
  // instance of each ray (-1 on a miss, clamped to the table as the plain
  // version's gather clamps it) and the instances' affines.
  const int* instance;           // (n,)
  const float* object_from_world;  // (instances, 3, 4)
  long long instances;
};

}  // extern "C"

namespace {

__device__ __forceinline__ float at(const View3& a, long long i, int c) {
  return a.p[i * a.s0 + c * a.s1];
}

// torch's clamp_min and clamp of a float: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Squared length of the cross product's row, in the order torch's norm
// reduces it on the device it runs on (see the numerics above).
__device__ __forceinline__ float norm_sq(float x, float y, float z) {
#ifdef __CUDA_ARCH__
  return (x * x + z * z) + y * y;
#else
  return fmaf(z, z, fmaf(y, y, x * x));
#endif
}

// The flip's sum of the three products, in torch's order on the device.
__device__ __forceinline__ float sum3(float p0, float p1, float p2) {
#ifdef __CUDA_ARCH__
  return (p0 + p2) + p1;
#else
  return (p0 + p1) + p2;
#endif
}

// ops/morton.py::expand_bits10 on u32 (the int32 values are the same).
__device__ __forceinline__ unsigned expand_bits10(unsigned v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

// models/path.py::_ray_sort_key of one ray: the direction octant at bits
// 24-26 above morton3d(origin, lo, hi, bits=8).
__device__ __forceinline__ unsigned sort_key(const float o[3],
                                             const float d[3],
                                             const float* lo,
                                             const float* hi) {
  unsigned ex[3];
  for (int c = 0; c < 3; ++c) {
    const float extent = clamp_min(hi[c] - lo[c], 1e-30f);
    const float q = clampf(((o[c] - lo[c]) / extent) * 255.0f, 0.0f, 255.0f);
    // Truncation, as torch's f32 -> i32 convert on each device.
    ex[c] = expand_bits10((unsigned)(int)q << 2);
  }
  const unsigned code = (ex[0] << 2) | (ex[1] << 1) | ex[2];
  const unsigned octant = (unsigned)(d[0] >= 0.0f)
                          | ((unsigned)(d[1] >= 0.0f) << 1)
                          | ((unsigned)(d[2] >= 0.0f) << 2);
  return (octant << 24) | code;
}

__global__ void __launch_bounds__(SHADE_BLOCK)
    shade_sample(const RtkShadeArgs a) {
  const long long i = (long long)blockIdx.x * SHADE_BLOCK + threadIdx.x;
  bool alive = false;
  if (i < a.n) {
    const bool hit = a.hit[i] != 0;
    // 1. The record's row (a PacketHits' slot clamped to the table, as
    // its gathers clamp it; -1: a miss, whose fields the record masks)
    // and mesh.
    long long row = i;
    if (a.packet) {
      row = a.slot[i];
      row = !hit ? -1 : row < 0 ? 0 : (row > a.rows - 1 ? a.rows - 1 : row);
    }
    int mesh = row < 0 ? -1 : a.tri_mesh[row];
    // 2. torch's clamp(0, materials - 1).
    mesh = mesh < 0 ? 0 : (mesh > a.materials - 1 ? a.materials - 1 : mesh);
    // 3. The emission or the sky, times the throughput, into the path.
    float tp[3];
    const long long path = a.index[i];
    for (int c = 0; c < 3; ++c) {
      tp[c] = a.throughput[i * 3 + c];
      const float add = hit ? a.emission[mesh * 3 + c] + 0.0f
                            : 0.0f + a.background[c];
      float* r = a.radiance + path * 3 + c;
      *r = *r + tp[c] * add;
    }
    if (!a.last) {
      // 4a. geometric_normal: the cross product of the two edges, over its
      // length (at least 1e-20), facing the incoming ray.
      float tv[9];
      for (int k = 0; k < 9; ++k)
        tv[k] = row < 0 ? 0.0f : a.tri_v[row * 9 + k];
      float e1[3], e2[3];
      for (int c = 0; c < 3; ++c) {
        e1[c] = tv[3 + c] - tv[c];
        e2[c] = tv[6 + c] - tv[c];
      }
      float nrm[3] = {fmaf(e1[1], e2[2], -(e1[2] * e2[1])),
                      fmaf(e1[2], e2[0], -(e1[0] * e2[2])),
                      fmaf(e1[0], e2[1], -(e1[1] * e2[0]))};
      if (a.instance) {
        // models/path.py::world_normal: L^T n, L the linear part of the
        // hit instance's object_from_world, in its order of sums.
        long long k = a.instance[i];
        k = k < 0 ? 0 : (k > a.instances - 1 ? a.instances - 1 : k);
        const float* m = a.object_from_world + k * 12;
        float w[3];
        for (int c = 0; c < 3; ++c)
          w[c] = (m[c] * nrm[0] + m[4 + c] * nrm[1]) + m[8 + c] * nrm[2];
        for (int c = 0; c < 3; ++c) nrm[c] = w[c];
      }
      const float len = clamp_min(__fsqrt_rn(norm_sq(nrm[0], nrm[1], nrm[2])),
                                  1e-20f);
      for (int c = 0; c < 3; ++c) nrm[c] = nrm[c] / len;
      const float facing = sum3(nrm[0] * at(a.ray_direction, i, 0),
                                nrm[1] * at(a.ray_direction, i, 1),
                                nrm[2] * at(a.ray_direction, i, 2));
      if (facing > 0.0f)
        for (int c = 0; c < 3; ++c) nrm[c] = -nrm[c];
      // 4b. cosine_sample about the normal (Frisvad's basis).
      const long long j = a.draw_index ? a.draw_index[i] : i;
      const float u1 = a.draws[j * a.ds0];
      const float u2 = a.draws[j * a.ds0 + a.ds1];
      const float r = sqrtf(u1);
      const float phi = 6.28318530717958647692f * u2;
      const float x = r * cosf(phi);
      const float y = r * sinf(phi);
      const float z = sqrtf(clamp_min(1.0f - u1, 0.0f));
      const float sign = nrm[2] >= 0.0f ? 1.0f : -1.0f;
      const float ra = -(1.0f / (sign + nrm[2]));
      const float b = (nrm[0] * nrm[1]) * ra;
      const float t1[3] = {1.0f + (sign * (nrm[0] * nrm[0])) * ra, sign * b,
                           -sign * nrm[0]};
      const float t2[3] = {b, sign + (nrm[1] * nrm[1]) * ra, -nrm[1]};
      float dir[3], org[3];
      for (int c = 0; c < 3; ++c)
        dir[c] = (x * t1[c] + y * t2[c]) + z * nrm[c];
      // 4c. The hit position (a PacketHits': o + t d, zero on a miss; a
      // Hits': u v0 + v v1 + w v2), pushed off along the normal.
      if (a.packet) {
        const float t = a.t[i];
        for (int c = 0; c < 3; ++c)
          org[c] = hit ? at(a.origin, i, c) + t * at(a.direction, i, c)
                       : 0.0f;
      } else {
        const float bu = a.u[i], bv = a.v[i];
        const float bw = (1.0f - bu) - bv;
        for (int c = 0; c < 3; ++c)
          org[c] = (bu * tv[c] + bv * tv[3 + c]) + bw * tv[6 + c];
      }
      for (int c = 0; c < 3; ++c) org[c] = org[c] + a.epsilon * nrm[c];
      // 4d. The throughput takes the albedo; torch's amax keeps a NaN.
      float most = 0.0f;
      for (int c = 0; c < 3; ++c) {
        tp[c] = tp[c] * (hit ? a.albedo[mesh * 3 + c] : 0.0f);
        most = c == 0 || tp[c] != tp[c] || tp[c] > most ? tp[c] : most;
        if (most != most) break;
      }
      alive = hit && most > a.min_throughput;
      for (int c = 0; c < 3; ++c) {
        a.next_origin[i * 3 + c] = org[c];
        a.next_direction[i * 3 + c] = dir[c];
        a.next_throughput[i * 3 + c] = tp[c];
      }
      a.next_min_t[i] = a.epsilon;
      a.next_max_t[i] = alive ? a.live_max_t : 0.0f;
      // 4e. Dead rays to the back; the Morton order within the live run.
      unsigned key = alive ? 0u : 1u;
      if (a.sort_rays)
        key = (key << 28) | (sort_key(org, dir, a.lo, a.hi) >> 4);
      a.key[i] = (int)key;
    }
  }
  if (a.last) return;
  // 5. The live count.  The host build runs one thread at a time, with no
  // block to sum over: each live ray adds itself.
#ifdef __CUDA_ARCH__
  const int live = __syncthreads_count(alive);
  if (threadIdx.x == 0 && live) atomicAdd(a.alive, (unsigned long long)live);
#else
  if (alive) *a.alive += 1;
#endif
}

}  // namespace

extern "C" {

// Launches the shade pass of `args` on `stream` (zeroing the live count
// first when it is not the last bounce) and returns cudaGetLastError() (0
// on success); allocates nothing and does not synchronise.
int rtk_shade(const RtkShadeArgs* args, void* stream) {
  if (!args->last)
    cudaMemsetAsync(args->alive, 0, sizeof(unsigned long long),
                    (cudaStream_t)stream);
  if (args->n > 0) {
    const unsigned blocks =
        (unsigned)((args->n + SHADE_BLOCK - 1) / SHADE_BLOCK);
    shade_sample<<<blocks, SHADE_BLOCK, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
