// The rows of trace_packets' front end for Hopper (sm_90a): the caller's
// rays stacked into the (8, n) f32 rows [ox oy oz dx dy dz min_t max_t]
// that the traversal reads, in the coherence-sorted order, in one pass.
//
// The front end (ops/packet_trace.py::_ray_rows) sorts a batch by its
// coherence key and hands the traversal the rows in the sorted order.  Its
// plain version stacks the four ray tensors into (8, n) rows in the
// caller's order (a torch.cat) and then gathers the columns through the
// sort's permutation (an index kernel): the rows are written twice and
// read once between, with the index read once a row.  Here thread by
// thread ray i of the output reads ray j = idx[i] of the caller's tensors
// through their element strides (a camera's expanded origin, or a
// direction sliced from a wider tensor, is read in place) and writes its
// eight values once.  An unsorted batch (idx null) is the same pass with
// j = i.  The reference stacks and gathers inside its jitted program in
// XLA (rtk_tpu/ops/pallas_trace.py), so this kernel replaces no Pallas
// kernel.
//
// What bounds it on an H100: the bytes, 72 a sorted ray (the index 8, the
// origin and direction 24, the two bounds 8; 32 written) and 64 an
// unsorted one.  The writes are coalesced along each row.  The reads are
// scattered only as far as the permutation scatters them: rays that are
// neighbours in the coherence order are neighbours on the screen for
// camera batches, so the reads of a warp fall on few lines.  One thread a
// ray: on the card, at 8192^2 and on a 1024^2 bounce batch, two to eight
// rays a thread, 128 or 512 threads a block and 16-byte stores each
// measured as fast or slower.  A permutation and a copy move bits, so the
// rows equal the plain version's exactly.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS_BLOCK = 256;  // threads a block

// The caller's ray tensors: (n, 3) origin and direction and (n,) bounds,
// f32 with element strides.
struct RayViews {
  const float* o;
  long long os0, os1;
  const float* d;
  long long ds0, ds1;
  const float* mn;
  long long ms;
  const float* mx;
  long long xs;
};

__global__ void __launch_bounds__(ROWS_BLOCK)
    ray_rows(const long long* __restrict__ idx, long long n, RayViews r,
             float* __restrict__ rows) {
  const long long i = (long long)blockIdx.x * ROWS_BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long j = idx ? idx[i] : i;
  float v[8];
  for (int c = 0; c < 3; ++c) {
    v[c] = r.o[j * r.os0 + c * r.os1];
    v[3 + c] = r.d[j * r.ds0 + c * r.ds1];
  }
  v[6] = r.mn[j * r.ms];
  v[7] = r.mx[j * r.xs];
  for (int c = 0; c < 8; ++c) rows[c * n + i] = v[c];
}

}  // namespace

extern "C" {

// idx: null (an unsorted batch) or (n,) i64, a permutation of [0, n) (the
// caller's index of each sorted ray); origin, direction: (n, 3) f32 with
// element strides (os0, os1) and (ds0, ds1); min_t, max_t: (n,) f32 with
// element strides ms and xs; rows: (8, n) f32, contiguous, written in the
// order of idx.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); allocates nothing and does not synchronise.
int rtk_ray_rows(const void* idx, long long n, const void* origin,
                 long long os0, long long os1, const void* direction,
                 long long ds0, long long ds1, const void* min_t,
                 long long ms, const void* max_t, long long xs, void* rows,
                 void* stream) {
  if (n > 0) {
    const RayViews r = {(const float*)origin, os0, os1,
                        (const float*)direction, ds0, ds1,
                        (const float*)min_t, ms, (const float*)max_t, xs};
    const unsigned blocks = (unsigned)((n + ROWS_BLOCK - 1) / ROWS_BLOCK);
    ray_rows<<<blocks, ROWS_BLOCK, 0, (cudaStream_t)stream>>>(
        (const long long*)idx, n, r, (float*)rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
