// The unsort of trace_packets' sorted front end for Hopper (sm_90a): the
// traversal's outputs, written in the coherence-sorted order, put back in
// the caller's order in one launch.
//
// The front end (ops/packet_trace.py::_traverse) sorts a batch by its
// coherence key, traces the sorted rows and scatters each output back:
// out[idx[i]] = sorted[i] for t, u, v and the slot (and, with stats=True,
// each of the five rows of per-ray counts).  Its plain version is an
// empty_like and an index-put an output, each a launch of its own and
// each some microseconds of the host's time; a call of a few hundred
// thousand rays is bound by those.  Here one thread per ray moves all of
// a ray's outputs.  The reference unsorts inside its jitted program, with
// one multi-operand sort by the caller's index
// (rtk_tpu/ops/pallas_trace.py:1534-1541), so this kernel replaces no
// Pallas kernel.
//
// What bounds it: the bytes, 8 for the index and 16 read and 16 written
// for the four outputs (40 more with counts).  The reads are coalesced and
// the writes scattered through the permutation; rays that are neighbours
// in the coherence order are neighbours on the screen for camera batches,
// so the writes of a warp fall on few lines.  A permutation moves bits, so
// the outputs equal the plain version's exactly.
#include <cuda_runtime.h>

namespace {

constexpr int UNSORT_BLOCK = 256;  // threads a block

__global__ void __launch_bounds__(UNSORT_BLOCK)
    unsort_outputs(const long long* __restrict__ idx, long long n,
                   const float* __restrict__ t, const float* __restrict__ u,
                   const float* __restrict__ v, const int* __restrict__ slot,
                   const int* __restrict__ counts, float* __restrict__ out_t,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int* __restrict__ out_slot, int* __restrict__ out_counts) {
  const long long i = (long long)blockIdx.x * UNSORT_BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long j = idx[i];
  out_t[j] = t[i];
  out_u[j] = u[i];
  out_v[j] = v[i];
  out_slot[j] = slot[i];
  if (counts)
    for (int r = 0; r < 5; ++r) out_counts[r * n + j] = counts[r * n + i];
}

}  // namespace

extern "C" {

// idx: (n,) i64, a permutation of [0, n) (the caller's index of each
// sorted ray); t, u, v (n,) f32 and slot (n,) i32 in the sorted order;
// counts: null or (5, n) i32; out_*: the same shapes, written in the
// caller's order.  Launches on `stream` and returns cudaGetLastError() (0
// on success); does not synchronise.
int rtk_unsort(const void* idx, long long n, const void* t, const void* u,
               const void* v, const void* slot, const void* counts,
               void* out_t, void* out_u, void* out_v, void* out_slot,
               void* out_counts, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + UNSORT_BLOCK - 1) / UNSORT_BLOCK);
    unsort_outputs<<<blocks, UNSORT_BLOCK, 0, (cudaStream_t)stream>>>(
        (const long long*)idx, n, (const float*)t, (const float*)u,
        (const float*)v, (const int*)slot, (const int*)counts, (float*)out_t,
        (float*)out_u, (float*)out_v, (int*)out_slot, (int*)out_counts);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
