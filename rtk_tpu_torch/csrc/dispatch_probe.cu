// Dispatch probe for Hopper (sm_90a): o[i] = x[i] + 1.0f over n float32
// values, one thread per value.
//
// Replaces the trivial Pallas kernel `triv` of tools/profile_trace.py
// (:60-65), which the JAX round launched on an (8, 128) f32 block to
// measure the fixed cost of one pallas_call.  Here it measures the fixed
// cost of one launch through this package's own binding: built with the
// traversal kernel's flags, loaded with ctypes and launched on the
// caller's current stream, as ops/packet_trace.py::_launch launches
// csrc/packet_trace.cu (tools/torch_profile_trace.py::dispatch_probe).
//
// What bounds it on an H100: nothing the card does.  At its one shape,
// (8, 128) f32, it reads 4 KiB and writes 4 KiB; 8 KiB over 3.35 TB/s is
// about 2.4 ns, and its 1,024 adds take less.  The launch itself (the
// host's call into the driver, the card's fetch of the launch and the
// start of one block) is the whole cost, and that is what the probe is
// for.  So the design does nothing to speed it up: four warps, one
// coalesced 4-byte load and store a thread, no shared memory, no loop.
#include <cuda_runtime.h>

namespace {

constexpr int PROBE_BLOCK = 128;  // threads a block

__global__ void __launch_bounds__(PROBE_BLOCK)
    dispatch_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int n) {
  const int i = blockIdx.x * PROBE_BLOCK + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// x, out: (n,) f32 on the card.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int rtk_dispatch_probe(const void* x, void* out, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + PROBE_BLOCK - 1) / PROBE_BLOCK;
    dispatch_probe_kernel<<<blocks, PROBE_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
