// A deforming frame's refit and repack for Hopper (sm_90a): the Scene's
// bounds and vertices moved to a new frame in two launches (three with
// wide node arrays), and the packed kernel tables regathered in one.
//
// scene.py::refit keeps a built LBVH's topology and moves it to a frame's
// vertices: the frame is gathered in the sorted order through `perm`, each
// leaf's box is the fold of its rows' vertices, and each internal node's
// box the fold of its leaf range.  Its plain version does this with about
// a hundred eager tensor operations (the gather, the leaf reductions, a
// sparse table of range minima and maxima over 13 levels at 2,304 leaves,
// two row gathers), and trace/packed.py::repack_bounds regathers the
// kernel's node rows and triangle table with twenty more.  Each is a launch
// of its own, and at 18,432 triangles the host's time to issue them, not
// the card's, is the frame's cost.  The reference refits in XLA under jit
// (rtk_tpu/scene.py), outside any Pallas kernel, so this file replaces no
// Pallas kernel.  Here:
//   1. rtk_refit_parents, one thread an internal node: each child's parent
//      (the Scene stores none) and the node's arrival count set to 0;
//   2. rtk_refit_leaves, one thread a leaf: the leaf's rows gathered from
//      the frame through perm (padding rows 0), its 3 * leaf_size vertices
//      folded into its box (padding rows as +-inf), then the climb of
//      Karras (HPG 2012, section 4): after a fence, one atomicAdd on the
//      parent's count; the first child to arrive stops, the second folds
//      the two children's boxes, the left child first, and goes on up; the
//      root's box is the scene's bounds.  O(leaves) work; its serial chain
//      is the tree's depth;
//   3. rtk_refit_slots (only for a Scene with wide node arrays), one thread
//      a wide child slot: the slot's box from its binary node or leaf, or
//      the empty slot's inverted box (1, -1);
//   4. rtk_repack, one thread a packed node slot and a packed triangle row:
//      the node row's box as int32 bits with the metadata in slots 0 and 1,
//      the packed vertices through tri_perm, and the triangle row (NaN for
//      padding, the old table's mask column, mesh, prim, four zeros).
//
// What bounds it on an H100: the bytes.  At 18,432 triangles the frame's
// soup is 663 KB read, the sorted vertices and the boxes about 0.9 MB
// written; the repack reads the sorted vertices and writes the packed
// vertices and the two tables, about 2.6 MB.  A few microseconds at 3.35
// TB/s, so one launch's fixed cost on the card is the bound that matters,
// and each pass is one thread an element with no shared memory.
//
// Numerics: a gather and a copy move bits, and a fold of minima and maxima
// has exact values.  Only the sign of a zero depends on the grouping:
// min(-0.0, +0.0) may be either.  Every fold here runs left to right in
// range order and keeps the left operand on a tie (min_left, max_left;
// NaN propagates as torch.minimum's does), so each box is the leftmost
// extreme of its range.  torch's CPU reductions of the plain version
// (amin and amax over a leaf, over all leaves) give the same; where its
// sparse table pairs vectorised minima, whose tie keeps the right operand,
// the sign of a zero bound can differ, and nothing else.
#include <cuda_runtime.h>

namespace {

constexpr int REFIT_BLOCK = 256;  // threads a block
constexpr int NODE_ROW = 8;       // int32 a packed node slot
constexpr int TRI_ROW = 16;       // f32 a packed triangle row
constexpr int MASK_COL = 9;

__device__ __forceinline__ float min_left(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__device__ __forceinline__ float max_left(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// The box of a binary child: an internal node's (c >= 0) or a leaf's
// (c <= -2), read through L2 (__ldcg): another thread of the launch wrote
// it, and the L1 of this SM may hold a stale line.
__device__ __forceinline__ void child_box(int c, const float* bin_min,
                                          const float* bin_max,
                                          const float* leaf_min,
                                          const float* leaf_max, float* lo,
                                          float* hi) {
  const float* pmin = c >= 0 ? bin_min + 3LL * c : leaf_min + 3LL * (-c - 2);
  const float* pmax = c >= 0 ? bin_max + 3LL * c : leaf_max + 3LL * (-c - 2);
  for (int k = 0; k < 3; ++k) {
    lo[k] = __ldcg(pmin + k);
    hi[k] = __ldcg(pmax + k);
  }
}

__global__ void __launch_bounds__(REFIT_BLOCK)
    refit_parents(const int* __restrict__ left, const int* __restrict__ right,
                  long long n_int, int* __restrict__ parent,
                  int* __restrict__ leaf_parent, int* __restrict__ arrivals) {
  const long long i = (long long)blockIdx.x * REFIT_BLOCK + threadIdx.x;
  if (i >= n_int) return;
  if (i == 0) parent[0] = -1;  // the root is no node's child
  arrivals[i] = 0;
  const int children[2] = {left[i], right[i]};
  for (int s = 0; s < 2; ++s) {
    const int c = children[s];
    if (c >= 0) parent[c] = (int)i;
    else if (c <= -2) leaf_parent[-c - 2] = (int)i;
  }
}

__global__ void __launch_bounds__(REFIT_BLOCK)
    refit_leaves(const float* __restrict__ soup, long long num_tris,
                 const int* __restrict__ perm, long long n_leaf,
                 int leaf_size, const int* __restrict__ left,
                 const int* __restrict__ right,
                 const int* __restrict__ parent,
                 const int* __restrict__ leaf_parent, int* arrivals,
                 float* __restrict__ tri_v, float* leaf_min, float* leaf_max,
                 float* bin_min, float* bin_max,
                 float* __restrict__ bounds_min,
                 float* __restrict__ bounds_max) {
  const long long l = (long long)blockIdx.x * REFIT_BLOCK + threadIdx.x;
  if (l >= n_leaf) return;
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf};
  float hi[3] = {-inf, -inf, -inf};
  for (int k = 0; k < leaf_size; ++k) {
    const long long r = l * leaf_size + k;
    const int j = perm[r];
    float v[9];
    if (j >= 0) {
      const float* src = soup + 9 * clamp_index(j, num_tris);
      for (int e = 0; e < 9; ++e) v[e] = src[e];
    } else {
      for (int e = 0; e < 9; ++e) v[e] = 0.0f;
    }
    for (int e = 0; e < 9; ++e) tri_v[9 * r + e] = v[e];
    // A sorted row is real by position: padding enters as +-inf.
    const bool real = r < num_tris;
    for (int e = 0; e < 9; ++e) {
      lo[e % 3] = min_left(lo[e % 3], real ? v[e] : inf);
      hi[e % 3] = max_left(hi[e % 3], real ? v[e] : -inf);
    }
  }
  for (int k = 0; k < 3; ++k) {
    leaf_min[3 * l + k] = lo[k];
    leaf_max[3 * l + k] = hi[k];
  }
  if (n_leaf == 1) {  // the one-leaf scene: no internal node to climb
    for (int k = 0; k < 3; ++k) {
      bounds_min[k] = lo[k];
      bounds_max[k] = hi[k];
    }
    return;
  }
  for (int node = leaf_parent[l]; node >= 0; node = parent[node]) {
    __threadfence();  // this thread's boxes before its arrival
    if (atomicAdd(&arrivals[node], 1) == 0) return;  // the sibling folds
    __threadfence();
    float a_lo[3], a_hi[3], b_lo[3], b_hi[3];
    child_box(left[node], bin_min, bin_max, leaf_min, leaf_max, a_lo, a_hi);
    child_box(right[node], bin_min, bin_max, leaf_min, leaf_max, b_lo, b_hi);
    for (int k = 0; k < 3; ++k) {
      lo[k] = min_left(a_lo[k], b_lo[k]);
      hi[k] = max_left(a_hi[k], b_hi[k]);
      bin_min[3LL * node + k] = lo[k];
      bin_max[3LL * node + k] = hi[k];
    }
    if (node == 0) {
      for (int k = 0; k < 3; ++k) {
        bounds_min[k] = lo[k];
        bounds_max[k] = hi[k];
      }
    }
  }
}

__global__ void __launch_bounds__(REFIT_BLOCK)
    refit_slots(const int* __restrict__ node_child, long long n_slots,
                long long n_int, long long n_leaf,
                const float* __restrict__ bin_min,
                const float* __restrict__ bin_max,
                const float* __restrict__ leaf_min,
                const float* __restrict__ leaf_max,
                float* __restrict__ node_min, float* __restrict__ node_max) {
  const long long s = (long long)blockIdx.x * REFIT_BLOCK + threadIdx.x;
  if (s >= n_slots) return;
  const int c = node_child[s];
  for (int k = 0; k < 3; ++k) {
    float lo = 1.0f, hi = -1.0f;  // an empty slot's inverted box
    if (c >= 0) {
      const long long i = clamp_index(c, n_int);
      lo = bin_min[3 * i + k];
      hi = bin_max[3 * i + k];
    } else if (c <= -2) {
      const long long i = clamp_index(-(long long)c - 2, n_leaf);
      lo = leaf_min[3 * i + k];
      hi = leaf_max[3 * i + k];
    }
    node_min[3 * s + k] = lo;
    node_max[3 * s + k] = hi;
  }
}

struct RepackIn {
  const int* slot_src;   // (nd * w,) binary node / leaf code / -1
  const int* meta;       // (nd, 4)
  const float* bin_min;  // (n_bin, 3)
  const float* bin_max;
  const float* leaf_min;  // (n_leaf, 3)
  const float* leaf_max;
  const int* tri_perm;   // (tp,) sorted row of each packed row
  const float* scene_v;  // (scene_rows, 3, 3) sorted vertices
  const int* tri_mesh;   // (tp,)
  const int* tri_prim;   // (tp,) -1 on padding rows
  const float* old_tris;  // (tp, 16): the mask column is carried over
};

__global__ void __launch_bounds__(REFIT_BLOCK)
    repack(RepackIn in, long long n_rows, int w, long long n_bin,
           long long n_leaf, long long tp, long long scene_rows,
           int* __restrict__ nodes, float* __restrict__ tris,
           float* __restrict__ tri_v) {
  const long long i = (long long)blockIdx.x * REFIT_BLOCK + threadIdx.x;
  if (i < n_rows) {
    const int c = in.slot_src[i];
    const float* pmin = nullptr;
    const float* pmax = nullptr;
    if (c >= 0) {
      const long long b = clamp_index(c, n_bin);
      pmin = in.bin_min + 3 * b;
      pmax = in.bin_max + 3 * b;
    } else if (c <= -2) {
      const long long b = clamp_index(-(long long)c - 2, n_leaf);
      pmin = in.leaf_min + 3 * b;
      pmax = in.leaf_max + 3 * b;
    }
    int row[NODE_ROW];
    for (int k = 0; k < 3; ++k) {
      row[k] = __float_as_int(pmin ? pmin[k] : 1.0f);
      row[3 + k] = __float_as_int(pmax ? pmax[k] : -1.0f);
    }
    const long long n = i / w;
    const int slot = (int)(i % w);
    row[6] = slot == 0 ? in.meta[4 * n] : (slot == 1 ? in.meta[4 * n + 2]
                                                     : 0);
    row[7] = slot == 0 ? in.meta[4 * n + 1] : 0;
    for (int k = 0; k < NODE_ROW; ++k) nodes[NODE_ROW * i + k] = row[k];
  }
  if (i < tp) {
    const float* src =
        in.scene_v + 9 * clamp_index(in.tri_perm[i], scene_rows);
    const bool real = in.tri_prim[i] >= 0;
    const float nan = __int_as_float(0x7fc00000);
    float* row = tris + TRI_ROW * i;
    for (int e = 0; e < 9; ++e) {
      const float v = src[e];
      tri_v[9 * i + e] = v;
      row[e] = real ? v : nan;
    }
    row[MASK_COL] = in.old_tris[TRI_ROW * i + MASK_COL];
    row[10] = (float)in.tri_mesh[i];
    row[11] = (float)in.tri_prim[i];
    for (int e = 12; e < TRI_ROW; ++e) row[e] = 0.0f;
  }
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + REFIT_BLOCK - 1) / REFIT_BLOCK);
}

}  // namespace

extern "C" {

// Every pointer is on the card and every array contiguous; each entry
// launches on `stream` and returns cudaGetLastError() (0 on success); none
// allocates or synchronises.  Node children: >= 0 an internal node, -1
// empty, <= -2 leaf -c - 2 (builder/lbvh.py).

// left, right: (n_int,) i32 children of the internal nodes, node 0 the
// root; scratch: (2 * n_int + n_leaf,) i32, written: each internal node's
// parent (-1 for the root), each leaf's parent, each node's arrival count
// (0), the counts rtk_refit_leaves takes.
int rtk_refit_parents(const void* left, const void* right, long long n_int,
                      long long n_leaf, void* scratch, void* stream) {
  if (n_int > 0) {
    int* s = (int*)scratch;
    const unsigned blocks = blocks_for(n_int);
    refit_parents<<<blocks, REFIT_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)left, (const int*)right, n_int, s, s + n_int,
        s + n_int + n_leaf);
  }
  return (int)cudaGetLastError();
}

// soup: (num_tris, 3, 3) f32, the frame in the build's order; perm:
// (n_leaf * leaf_size,) i32, the soup row of each sorted row (-1 padding);
// left, right: (n_int,) i32 with n_int = n_leaf - 1 (unread for one leaf);
// scratch: as rtk_refit_parents wrote it.  Written: tri_v (n_leaf *
// leaf_size, 3, 3), leaf_min, leaf_max (n_leaf, 3), bin_min, bin_max
// (n_int, 3) and bounds_min, bounds_max (3,), all f32.
int rtk_refit_leaves(const void* soup, long long num_tris, const void* perm,
                     long long n_leaf, int leaf_size, const void* left,
                     const void* right, void* scratch, void* tri_v,
                     void* leaf_min, void* leaf_max, void* bin_min,
                     void* bin_max, void* bounds_min, void* bounds_max,
                     void* stream) {
  if (n_leaf > 0) {
    int* s = (int*)scratch;
    const long long n_int = n_leaf - 1;
    const unsigned blocks = blocks_for(n_leaf);
    refit_leaves<<<blocks, REFIT_BLOCK, 0, (cudaStream_t)stream>>>(
        (const float*)soup, num_tris, (const int*)perm, n_leaf, leaf_size,
        (const int*)left, (const int*)right, s, s + n_int, s + n_int + n_leaf,
        (float*)tri_v, (float*)leaf_min, (float*)leaf_max, (float*)bin_min,
        (float*)bin_max, (float*)bounds_min, (float*)bounds_max);
  }
  return (int)cudaGetLastError();
}

// node_child: (n_slots,) i32, the wide nodes' child slots; bin_min,
// bin_max: (n_int, 3); leaf_min, leaf_max: (n_leaf, 3); written: node_min,
// node_max (n_slots, 3) f32.
int rtk_refit_slots(const void* node_child, long long n_slots,
                    long long n_int, long long n_leaf, const void* bin_min,
                    const void* bin_max, const void* leaf_min,
                    const void* leaf_max, void* node_min, void* node_max,
                    void* stream) {
  if (n_slots > 0) {
    const unsigned blocks = blocks_for(n_slots);
    refit_slots<<<blocks, REFIT_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int*)node_child, n_slots, n_int, n_leaf,
        (const float*)bin_min, (const float*)bin_max, (const float*)leaf_min,
        (const float*)leaf_max, (float*)node_min, (float*)node_max);
  }
  return (int)cudaGetLastError();
}

// slot_src: (nd * w,) i32; meta: (nd, 4) i32; bin_min, bin_max: (n_bin,
// 3) f32; leaf_min, leaf_max: (n_leaf, 3) f32; tri_perm, tri_mesh,
// tri_prim: (tp,) i32; scene_v: (scene_rows, 3, 3) f32; old_tris: (tp,
// 16) f32.  Written: nodes (nd * w, 8) i32, tris (tp, 16) f32, tri_v (tp,
// 3, 3) f32.
int rtk_repack(const void* slot_src, const void* meta, long long nd, int w,
               const void* bin_min, const void* bin_max, long long n_bin,
               const void* leaf_min, const void* leaf_max, long long n_leaf,
               const void* tri_perm, const void* scene_v,
               long long scene_rows, const void* tri_mesh,
               const void* tri_prim, const void* old_tris, long long tp,
               void* nodes, void* tris, void* tri_v, void* stream) {
  const long long n_rows = nd * w;
  const long long n = n_rows > tp ? n_rows : tp;
  if (n > 0) {
    const RepackIn in = {(const int*)slot_src,  (const int*)meta,
                         (const float*)bin_min, (const float*)bin_max,
                         (const float*)leaf_min, (const float*)leaf_max,
                         (const int*)tri_perm,  (const float*)scene_v,
                         (const int*)tri_mesh,  (const int*)tri_prim,
                         (const float*)old_tris};
    const unsigned blocks = blocks_for(n);
    repack<<<blocks, REFIT_BLOCK, 0, (cudaStream_t)stream>>>(
        in, n_rows, w, n_bin, n_leaf, tp, scene_rows, (int*)nodes,
        (float*)tris, (float*)tri_v);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
