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
// Two more variants of the TPU kernel (traverse_stream's mxu=True and a
// pack_prim_hbm(dtype=bfloat16) pack), each in closest, any and mixed mode:
//   * bf16 leaves (cone and triangle): the pack at half the bytes, tested in
//     unit-major runs of the rays that enter each unit of a leaf: a lane's
//     row held in registers (two bf16 a word) across the run, each value
//     widened exactly at its use by the f32 test, so a row's t is the
//     twin's over the upcast pack bit for bit; its boxes bound the rounded rows
//     (ops/cuda/stream.py::pack_prim_hbm). Config 5's 587 MB of leaves
//     become 294 MB.
//   * mxu (cones, f32 or bf16 leaves): the six ray.frame projections of each
//     (ray, row) on the tensor cores, in unit-major tiles of the rays that
//     enter a unit (leaf_tiles.cuh kMxu: mma.sync m16n8k8 TF32, the ray's
//     hi/lo halves folded into the depth: two passes a frame vector on f32
//     rows, one on bf16 rows), each row's b.u, b.v, b.w once a leaf, p = o.u -
//     b.u and the quadratic of cone_row on the FP32 pipe
//     (leaf_tests.cuh::cone_uw, cone_v). The projections are 30 of a cone
//     row's 93 flops. Its rows agree with the twin's
//     (traverse_stream_ref(mxu=True)) but for near ties: the matrix products
//     round otherwise than its f32 sums.
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

template <bool kCone, bool kAnyHit, bool kMixed, bool kMxu, class T>
__global__ void __launch_bounds__(fur::THREADS, fur::MIN_BLOCKS)
    stream_kernel(StreamBoxes bx, int n_rays, const float* __restrict__ o,
                  const float* __restrict__ d, const float* __restrict__ t_max,
                  const T* __restrict__ packed, const float* __restrict__ uboxes, int leaf_k,
                  int depth, float t_min, float* __restrict__ t_out, int* __restrict__ row_out,
                  unsigned char* __restrict__ found_out, const unsigned char* __restrict__ is_any) {
  fur::tile_traverse<kCone, kAnyHit, kMixed, kMxu>(bx, n_rays, o, d, t_max, packed, uboxes,
                                                   leaf_k, depth, t_min, t_out, row_out,
                                                   found_out, is_any);
}

// The dynamic shared memory of an instance for this BVH (the block's
// TileLayout), opted in to once it grows; cudaErrorInvalidValue past
// MAX_SHARED.
template <bool kCone, bool kAnyHit, bool kMixed, bool kMxu, class T>
cudaError_t prepare(int n_sup, int leaf_k, size_t* bytes) {
  *bytes = 4u * static_cast<size_t>(fur::tile_layout(kCone ? 16 : 9, leaf_k, n_sup,
                                                     fur::walk_depth(n_sup), sizeof(T), kMxu)
                                        .words);
  if (*bytes > static_cast<size_t>(fur::MAX_SHARED)) return cudaErrorInvalidValue;
  static size_t opted = 0;  // the dynamic shared memory this instance may use
  if (*bytes > opted) {
    cudaError_t e = cudaFuncSetAttribute(stream_kernel<kCone, kAnyHit, kMixed, kMxu, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*bytes));
    if (e != cudaSuccess) return e;
    opted = *bytes;
  }
  return cudaSuccess;
}

template <bool kCone, bool kAnyHit, bool kMixed, bool kMxu, class T>
cudaError_t launch(const StreamBoxes& bx, int n_rays, const float* o, const float* d,
                   const float* t_max, const void* packed, const float* uboxes, int leaf_k,
                   float t_min, float* t_out, int* row_out, unsigned char* found_out,
                   const unsigned char* is_any, cudaStream_t st) {
  size_t bytes = 0;
  cudaError_t e = prepare<kCone, kAnyHit, kMixed, kMxu, T>(bx.n_sup, leaf_k, &bytes);
  if (e != cudaSuccess) return e;
  const int grid = (n_rays + fur::TILE - 1) / fur::TILE;
  stream_kernel<kCone, kAnyHit, kMixed, kMxu, T><<<grid, fur::THREADS, bytes, st>>>(
      bx, n_rays, o, d, t_max, static_cast<const T*>(packed), uboxes, leaf_k,
      fur::walk_depth(bx.n_sup), t_min, t_out, row_out, found_out, is_any);
  return cudaGetLastError();
}

// The dynamic shared memory of an instance a block, and the blocks of it one
// SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <bool kCone, bool kAnyHit, bool kMixed, bool kMxu, class T>
cudaError_t occupancy(int n_sup, int leaf_k, int* bytes, int* blocks) {
  size_t b = 0;
  cudaError_t e = prepare<kCone, kAnyHit, kMixed, kMxu, T>(n_sup, leaf_k, &b);
  if (e != cudaSuccess) return e;
  *bytes = static_cast<int>(b);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, stream_kernel<kCone, kAnyHit, kMixed, kMxu, T>, fur::THREADS, b);
}

// The closest, any or mixed instance of one (kind, test, element type).
template <bool kCone, bool kMxu, class T>
cudaError_t launch_mode(int any_hit, const unsigned char* is_any, const StreamBoxes& bx,
                        int n_rays, const float* o, const float* d, const float* t_max,
                        const void* packed, const float* uboxes, int leaf_k, float t_min,
                        float* t_out, int* row_out, unsigned char* found_out, cudaStream_t st) {
  const auto go = [&](auto launcher) {
    return launcher(bx, n_rays, o, d, t_max, packed, uboxes, leaf_k, t_min, t_out, row_out,
                    found_out, is_any, st);
  };
  if (is_any) return go(launch<kCone, false, true, kMxu, T>);
  return any_hit ? go(launch<kCone, true, false, kMxu, T>)
                 : go(launch<kCone, false, false, kMxu, T>);
}

template <bool kCone, bool kMxu, class T>
cudaError_t occupancy_mode(int any_hit, int mixed, int n_sup, int leaf_k, int* bytes,
                           int* blocks) {
  if (mixed) return occupancy<kCone, false, true, kMxu, T>(n_sup, leaf_k, bytes, blocks);
  return any_hit ? occupancy<kCone, true, false, kMxu, T>(n_sup, leaf_k, bytes, blocks)
                 : occupancy<kCone, false, false, kMxu, T>(n_sup, leaf_k, bytes, blocks);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it does not take: fanout and the super
// count powers of two, the leaf buffers within shared memory, any_hit with
// is_any, mxu with triangle leaves). is_any [R] (1 = shadow ray) makes the
// launch mixed; null leaves it closest or any hit by any_hit. packed is
// [C, W, K] float, or bf16 when bf16 is set; mxu takes the tensor-core
// cone test.
extern "C" int stream_launch(int n_rays, const float* o, const float* d, const float* t_max,
                             const float* bmin, const float* bmax, const float* sboxes,
                             const float* cboxes, const void* packed, const float* uboxes,
                             int n_sup, int fanout, int leaf_k, int cone, int any_hit, int bf16,
                             int mxu, const unsigned char* is_any, float t_min, float* t_out,
                             int* row_out, unsigned char* found_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (fanout <= 0 || (fanout & (fanout - 1)) || n_sup < 1 || (n_sup & (n_sup - 1)) ||
      leaf_k <= 0 || (any_hit && is_any) || (mxu && !cone))
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamBoxes bx = {bmin, bmax, sboxes, cboxes, n_sup, fanout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const auto go = [&](auto launcher) {
    return launcher(any_hit, is_any, bx, n_rays, o, d, t_max, packed, uboxes, leaf_k, t_min,
                    t_out, row_out, found_out, st);
  };
  cudaError_t e;
  if (mxu)
    e = bf16 ? go(launch_mode<true, true, bf>) : go(launch_mode<true, true, float>);
  else if (cone)
    e = bf16 ? go(launch_mode<true, false, bf>) : go(launch_mode<true, false, float>);
  else
    e = bf16 ? go(launch_mode<false, false, bf>) : go(launch_mode<false, false, float>);
  return static_cast<int>(e);
}

// The dynamic shared memory a block (*bytes) and the blocks an SM holds
// (*blocks) of the instance stream_launch would take for these arguments
// (mixed for the is_any launch); cudaErrorInvalidValue where it would refuse
// the shape.
extern "C" int stream_occupancy(int n_sup, int leaf_k, int cone, int any_hit, int mixed,
                                int bf16, int mxu, int* bytes, int* blocks) {
  if (n_sup < 1 || leaf_k <= 0 || (any_hit && mixed) || (mxu && !cone))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (mxu)
    e = bf16 ? occupancy_mode<true, true, bf>(any_hit, mixed, n_sup, leaf_k, bytes, blocks)
             : occupancy_mode<true, true, float>(any_hit, mixed, n_sup, leaf_k, bytes, blocks);
  else if (cone)
    e = bf16 ? occupancy_mode<true, false, bf>(any_hit, mixed, n_sup, leaf_k, bytes, blocks)
             : occupancy_mode<true, false, float>(any_hit, mixed, n_sup, leaf_k, bytes, blocks);
  else
    e = bf16 ? occupancy_mode<false, false, bf>(any_hit, mixed, n_sup, leaf_k, bytes, blocks)
             : occupancy_mode<false, false, float>(any_hit, mixed, n_sup, leaf_k, bytes, blocks);
  return static_cast<int>(e);
}
