// Brute-force nearest hit of each ray against every primitive of a
// BVH-less pack (triangles or cones).
//
// Replaces ba_pathtracing_fur_tpu/ops/pallas/intersect.py::tri_closest /
// cone_closest (_closest, _tri_kernel, _cone_kernel). Contract: for each
// ray (o, d) the nearest t > t_min over the component-major pack [W, P]
// (INF on a miss) and its index (-1 on a miss); on equal t the lowest
// index wins. No t_max enters the test (the caller takes t < t_max); a
// dead ray (t_max <= 0) skips the loop and returns a miss.
//
// Design: one thread per ray, 128 rays a block. The block stages the pack
// through shared memory in [W, TILE] tiles (SoA, coalesced loads) and every
// thread tests its ray against the tile's primitives in index order with a
// strict `<`, which keeps the lowest index among equal t as the TPU
// kernel's per-tile argmin and strict cross-tile compare do. All threads
// read the same primitive at once, a shared-memory broadcast. A block
// whose rays are all dead skips the pack.
//
// What bounds it: operations. Every live ray tests every primitive (55
// flops a triangle, 93 a cone); the pack is read once per block from L2
// (the hair ball's 768 scalp triangles are 28 KB, the fur patch's 45,000
// cones 2.9 MB) and the ray I/O is 36 bytes a ray.
//
// Arithmetic: exactly the Pallas kernels' (Möller-Trumbore; the cone
// quadratic with o.v summed x, y, z, sqrt(max(disc, 1e-12)), t >= 1e-4),
// built with -fmad=false (kernels/__init__.py SOURCE_FLAGS) so t and the
// index agree bit for bit with the plain twin (ops/cuda/intersect.py).

#include "leaf_tests.cuh"

namespace {

using fur::INF;
using fur::Ray;
constexpr int BLOCK = 128;
constexpr int TILE = 256;

// _tri_kernel's test of one primitive in column k of a [9, TILE] tile: the
// shared Möller-Trumbore row with no cap (a t at or beyond INF never wins).
__device__ __forceinline__ float tri_test(const Ray& r, const float* p, int k, float t_min) {
  return fur::tri_row(r, p + k, TILE, t_min, INF);
}

// _cone_kernel's test of one primitive in column k of a [16, TILE] tile. It
// sums o.v in the order x, y, z (the Pallas kernel's), where the traversal
// twins' fur::cone_row sums y, x, z, so it keeps its own arithmetic.
__device__ __forceinline__ float cone_test(const Ray& r, const float* p, int k,
                                           float t_min) {
  float bx = p[0 * TILE + k], by = p[1 * TILE + k], bz = p[2 * TILE + k];
  float ux = p[3 * TILE + k], uy = p[4 * TILE + k], uz = p[5 * TILE + k];
  float vx = p[6 * TILE + k], vy = p[7 * TILE + k], vz = p[8 * TILE + k];
  float wx = p[9 * TILE + k], wy = p[10 * TILE + k], wz = p[11 * TILE + k];
  float slope = p[12 * TILE + k], r_base = p[13 * TILE + k];
  float min_d = p[14 * TILE + k], max_d = p[15 * TILE + k];
  float rx = r.ox - bx, ry = r.oy - by, rz = r.oz - bz;
  float px = rx * ux + ry * uy + rz * uz;
  float py = rx * vx + ry * vy + rz * vz;
  float pz = rx * wx + ry * wy + rz * wz;
  float dx = r.dx * ux + r.dy * uy + r.dz * uz;
  float dy = r.dx * vx + r.dy * vy + r.dz * vz;
  float dz = r.dx * wx + r.dy * wy + r.dz * wz;
  float a = dx * dx + dz * dz - slope * slope * dy * dy;
  float b = px * dx + pz * dz + r_base * slope * dy - slope * slope * py * dy;
  float c_lin = r_base - slope * py;
  float c = px * px + pz * pz - c_lin * c_lin;
  float disc = b * b - a * c;
  if (!(disc >= 0.0f)) return INF;
  float sq = sqrtf(fmaxf(disc, 1e-12f));
  float a_safe = fabsf(a) < 1e-12f ? 1e-12f : a;
  float ra = (-b - sq) / a_safe, rb = (-b + sq) / a_safe;
  float t1 = fminf(ra, rb), t2 = fmaxf(ra, rb);
  float ov = r.ox * vx + r.oy * vy + r.oz * vz;
  float ax1 = ov + t1 * dy, ax2 = ov + t2 * dy;
  if (t1 >= 1e-4f && t1 > t_min && ax1 >= min_d && ax1 <= max_d) return t1;
  if (t2 >= 1e-4f && t2 > t_min && ax2 >= min_d && ax2 <= max_d) return t2;
  return INF;
}

template <bool kCone>
__global__ void __launch_bounds__(BLOCK) brute_kernel(
    int n_rays, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const float* __restrict__ prims, int n_prims,
    float t_min, float* __restrict__ t_out, int* __restrict__ idx_out) {
  constexpr int W = kCone ? 16 : 9;
  __shared__ float tile[W][TILE];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n_rays && t_max[i] > 0.0f;
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  }
  float best = INF;
  int best_i = -1;
  if (__syncthreads_or(live)) {
    for (int base = 0; base < n_prims; base += TILE) {
      const int n = min(TILE, n_prims - base);
      for (int j = threadIdx.x; j < W * TILE; j += BLOCK) {
        int c = j / TILE, k = j - c * TILE;
        tile[c][k] = k < n ? prims[static_cast<size_t>(c) * n_prims + base + k] : 0.0f;
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < n; ++k) {
          float t = kCone ? cone_test(r, &tile[0][0], k, t_min)
                          : tri_test(r, &tile[0][0], k, t_min);
          if (t < best) { best = t; best_i = base + k; }
        }
      }
      __syncthreads();
    }
  }
  if (i < n_rays) {
    t_out[i] = best;
    idx_out[i] = best_i;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int bruteforce_launch(int n_rays, const float* o, const float* d, const float* t_max,
                                 const float* prims, int n_prims, int cone, float t_min,
                                 float* t_out, int* idx_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int grid = (n_rays + BLOCK - 1) / BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cone)
    brute_kernel<true><<<grid, BLOCK, 0, st>>>(n_rays, o, d, t_max, prims, n_prims, t_min,
                                               t_out, idx_out);
  else
    brute_kernel<false><<<grid, BLOCK, 0, st>>>(n_rays, o, d, t_max, prims, n_prims, t_min,
                                                t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
