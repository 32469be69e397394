// BVH traversal: closest hit or any hit of each ray against cone or
// triangle leaf clusters.
//
// Replaces ba_pathtracing_fur_tpu/ops/pallas/traverse.py::traverse_vmem
// (_make_kernel, _cone_block, _tri_block). Contract: for each ray (o, d,
// t_max) the nearest row of the reordered pack with t in (t_min, t_max),
// returned as (t, row, found); t is t_max on a miss, row = cluster *
// leaf_k + within (-1 on a miss). The any-hit variant stops at the first
// acceptance and returns t = 0 there.
//
// Design: the leaf-tile core of csrc/leaf_tiles.cuh on the flat heap (bmin/
// bmax [2C-1, 3], children 2i+1 / 2i+2, leaves at C-1 .. 2C-2), cut at
// F = min(C, CHUNK) leaves: each ray of a tile of coherent (entry-morton
// sorted) rays walks the heap above that level with a stack of log2(C/F) + 1
// entries in shared memory, the tile visits the leaves its rays enter once
// each, copying the leaf's [W, K] block (5.6 KB for the fur patch's 88
// cones) into shared memory with cp.async, and a warp tests each (ray,
// leaf) pair there, lanes over rows. All boxes are read from the heap.
//
// What bounds it: operations and latency. The work is data dependent: the
// box tests of the nodes a ray opens and ~90 flops per cone row of every
// leaf it enters, against 37 bytes of ray I/O; the leaf geometry (2.9 MB on
// the fur patch) sits in L2 and is read once per tile that enters it.
//
// Rows: the lexicographic minimum (t, row) over every row with t in (t_min,
// t_max), the brute-force twin's row on every ray, exact t ties across
// clusters included. Cone arithmetic: that of ops/bvh.py::_cone_core,
// including its o.v sum in the order y, x, z (the Pallas _cone_block sums
// x, y, z). Built without --use_fast_math and with -fmad=false
// (kernels/__init__.py SOURCE_FLAGS): every multiply and add rounds on its
// own, as in the plain torch twin's separate ops, so the two agree bit for
// bit on t and found. (With contraction the thin-cone quadratic moved t by
// up to 1e-4 relative and flipped a grazing hit in 2,304 fur-patch rays.)

#include "leaf_tiles.cuh"

namespace {

// Every box from the heap arrays: walk nodes 0 .. 2S-2 as they are, child c
// of super s at heap node (C-1) + s*F + c.
struct HeapBoxes {
  const float* __restrict__ bmin;
  const float* __restrict__ bmax;
  int n_sup, fanout, first_leaf;

  __device__ __forceinline__ float node(int n, int a) const {
    return a < 3 ? bmin[3 * n + a] : bmax[3 * n + a - 3];
  }
  __device__ __forceinline__ float child(int s, int c, int a) const {
    return node(first_leaf + s * fanout + c, a);
  }
};

template <bool kCone, bool kAnyHit>
__global__ void __launch_bounds__(fur::THREADS, fur::MIN_BLOCKS) traverse_kernel(
    HeapBoxes bx, int n_rays, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const float* __restrict__ packed,
    const float* __restrict__ uboxes, int leaf_k, int depth, float t_min,
    float* __restrict__ t_out, int* __restrict__ row_out, unsigned char* __restrict__ found_out) {
  fur::tile_traverse<kCone, kAnyHit>(bx, n_rays, o, d, t_max, packed, uboxes, leaf_k, depth,
                                     t_min, t_out, row_out, found_out);
}

template <bool kCone, bool kAnyHit>
cudaError_t launch(const HeapBoxes& bx, int n_rays, const float* o, const float* d,
                   const float* t_max, const float* packed, const float* uboxes, int leaf_k,
                   float t_min, float* t_out, int* row_out, unsigned char* found_out,
                   cudaStream_t st) {
  const int depth = fur::walk_depth(bx.n_sup);
  const size_t bytes =
      4u * static_cast<size_t>(fur::tile_layout(kCone ? 16 : 9, leaf_k, bx.n_sup, depth).words);
  if (bytes > static_cast<size_t>(fur::MAX_SHARED)) return cudaErrorInvalidValue;
  static size_t opted = 0;  // the dynamic shared memory this instance may use
  if (bytes > opted) {
    cudaError_t e = cudaFuncSetAttribute(traverse_kernel<kCone, kAnyHit>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    opted = bytes;
  }
  const int grid = (n_rays + fur::TILE - 1) / fur::TILE;
  traverse_kernel<kCone, kAnyHit><<<grid, fur::THREADS, bytes, st>>>(
      bx, n_rays, o, d, t_max, packed, uboxes, leaf_k, depth, t_min, t_out, row_out,
      found_out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take: a leaf count that is
// not a power of two, leaf buffers beyond shared memory).
extern "C" int traverse_launch(int n_rays, const float* o, const float* d, const float* t_max,
                               const float* bmin, const float* bmax, const float* packed,
                               const float* uboxes, int n_leaves, int leaf_k, int cone,
                               int any_hit, float t_min, float* t_out, int* row_out,
                               unsigned char* found_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (n_leaves < 1 || (n_leaves & (n_leaves - 1)) || leaf_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int f = n_leaves < fur::CHUNK ? n_leaves : fur::CHUNK;
  const HeapBoxes bx = {bmin, bmax, n_leaves / f, f, n_leaves - 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto launcher) {
    return launcher(bx, n_rays, o, d, t_max, packed, uboxes, leaf_k, t_min, t_out, row_out,
                    found_out, st);
  };
  const cudaError_t e = cone ? (any_hit ? go(launch<true, true>) : go(launch<true, false>))
                             : (any_hit ? go(launch<false, true>) : go(launch<false, false>));
  return static_cast<int>(e);
}
