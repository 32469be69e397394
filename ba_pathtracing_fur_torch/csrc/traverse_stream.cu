// Two-level BVH traversal with the leaf geometry streamed from device
// memory: closest hit or any hit of each ray against cone or triangle leaf
// clusters.
//
// Replaces ba_pathtracing_fur_tpu/ops/pallas/stream.py::traverse_stream
// (_make_stream_kernel, _slab6). Contract as csrc/traverse.cu: for each ray
// (o, d, t_max) the nearest row of the reordered pack with t in (t_min,
// t_max), returned as (t, row, found); t is t_max on a miss and 0 for an
// accepted any hit, row = cluster * leaf_k + within (-1 on a miss).
//
// The case it exists for: leaf geometry far bigger than any cache (the
// 1M-fiber hair ball: 32,768 leaves x 280 cones x 16 floats = 587 MB
// against a 50 MB L2), so every leaf a ray enters comes from HBM. A kernel
// that reads a leaf once per (ray, leaf) pair moves ~47 GB a camera
// wavefront; the tile of coherent rays of csrc/leaf_tiles.cuh reads each
// leaf it enters once per tile into shared memory (cp.async, double-
// buffered) and tests every pair there. The super boxes come from the
// cached [6, S] table and the children of a super from the [S, 6, F] table,
// one coalesced block per round of CHUNK children.
//
// Mixed mode (ops/pallas/stream.py::traverse_stream's is_any, the TPU
// kernel's _make_stream_kernel(mixed=True)): a third instance takes each
// ray's any-hit flag from is_any [R], so the joint closest+shadow pass
// (ops/traverse.py::joint_closest_any) traces a bounce's closest-hit rays
// and the previous bounce's shadow rays, interleaved in pairs that share an
// origin, in one launch: a pair shares its tile, its schedule and its leaf
// copies. Each ray's result is the one its own instance gives.
//
// What bounds it: operations (93 flops a cone row, ~700 rows a camera ray)
// once the leaf bytes are shared; the cone arithmetic is built with
// -fmad=false (kernels/__init__.py SOURCE_FLAGS) so t agrees with the twin
// bit for bit, which forgoes FMA. Rows: the lexicographic minimum (t, row),
// the brute-force twin's row on every ray.

#include "leaf_tiles.cuh"

namespace {

// Walk nodes above the supers from the heap arrays, the supers from
// sboxes [6, S], the children of super s from cboxes [S, 6, F].
struct StreamBoxes {
  const float* __restrict__ bmin;
  const float* __restrict__ bmax;
  const float* __restrict__ sboxes;
  const float* __restrict__ cboxes;
  int n_sup, fanout;

  __device__ __forceinline__ float node(int n, int a) const {
    if (n >= n_sup - 1) return sboxes[a * n_sup + n - (n_sup - 1)];
    return a < 3 ? bmin[3 * n + a] : bmax[3 * n + a - 3];
  }
  __device__ __forceinline__ float child(int s, int c, int a) const {
    return cboxes[(static_cast<size_t>(s) * 6 + a) * fanout + c];
  }
};

template <bool kCone, bool kAnyHit, bool kMixed>
__global__ void __launch_bounds__(fur::THREADS, fur::MIN_BLOCKS) stream_kernel(
    StreamBoxes bx, int n_rays, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const float* __restrict__ packed,
    const float* __restrict__ uboxes, int leaf_k, int depth, float t_min,
    float* __restrict__ t_out, int* __restrict__ row_out, unsigned char* __restrict__ found_out,
    const unsigned char* __restrict__ is_any) {
  fur::tile_traverse<kCone, kAnyHit, kMixed>(bx, n_rays, o, d, t_max, packed, uboxes, leaf_k,
                                             depth, t_min, t_out, row_out, found_out, is_any);
}

template <bool kCone, bool kAnyHit, bool kMixed>
cudaError_t launch(const StreamBoxes& bx, int n_rays, const float* o, const float* d,
                   const float* t_max, const float* packed, const float* uboxes, int leaf_k,
                   float t_min, float* t_out, int* row_out, unsigned char* found_out,
                   const unsigned char* is_any, cudaStream_t st) {
  const int depth = fur::walk_depth(bx.n_sup);
  const size_t bytes =
      4u * static_cast<size_t>(fur::tile_layout(kCone ? 16 : 9, leaf_k, bx.n_sup, depth).words);
  if (bytes > static_cast<size_t>(fur::MAX_SHARED)) return cudaErrorInvalidValue;
  static size_t opted = 0;  // the dynamic shared memory this instance may use
  if (bytes > opted) {
    cudaError_t e = cudaFuncSetAttribute(stream_kernel<kCone, kAnyHit, kMixed>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    opted = bytes;
  }
  const int grid = (n_rays + fur::TILE - 1) / fur::TILE;
  stream_kernel<kCone, kAnyHit, kMixed><<<grid, fur::THREADS, bytes, st>>>(
      bx, n_rays, o, d, t_max, packed, uboxes, leaf_k, depth, t_min, t_out, row_out,
      found_out, is_any);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take: fanout and the super
// count powers of two, the leaf buffers within shared memory, any_hit with
// is_any). is_any [R] (1 = shadow ray) makes the launch mixed; null leaves
// it closest or any hit by any_hit.
extern "C" int stream_launch(int n_rays, const float* o, const float* d, const float* t_max,
                             const float* bmin, const float* bmax, const float* sboxes,
                             const float* cboxes, const float* packed, const float* uboxes,
                             int n_sup, int fanout, int leaf_k, int cone, int any_hit,
                             const unsigned char* is_any, float t_min, float* t_out,
                             int* row_out, unsigned char* found_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (fanout <= 0 || (fanout & (fanout - 1)) || n_sup < 1 || (n_sup & (n_sup - 1)) ||
      leaf_k <= 0 || (any_hit && is_any))
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamBoxes bx = {bmin, bmax, sboxes, cboxes, n_sup, fanout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto launcher) {
    return launcher(bx, n_rays, o, d, t_max, packed, uboxes, leaf_k, t_min, t_out, row_out,
                    found_out, is_any, st);
  };
  cudaError_t e;
  if (is_any)
    e = cone ? go(launch<true, false, true>) : go(launch<false, false, true>);
  else if (cone)
    e = any_hit ? go(launch<true, true, false>) : go(launch<true, false, false>);
  else
    e = any_hit ? go(launch<false, true, false>) : go(launch<false, false, false>);
  return static_cast<int>(e);
}

