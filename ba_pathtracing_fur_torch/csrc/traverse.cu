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
// Design: one thread per ray walks the implicit binary heap (bmin/bmax
// [2C-1, 3], children 2i+1 / 2i+2, leaves at C-1 .. 2C-2) with a small
// per-thread stack, nearer child first; a node is pruned when its entry
// distance is not below the best hit so far. Leaf tests read `packed`
// [C, W, K] straight from global memory (2.9 MB for the 45,000-cone fur
// patch), which L2 (50 MB) holds after the first touch. The TPU kernel's
// [8, R] ray packing, 128-lane K padding, dense [T, C] entry grid and
// shared per-tile schedule are not carried over: each ray has its own
// schedule. Two-level BVHs (fanout > 0: the hair ball's, whose leaves do
// not fit in L2) go to csrc/traverse_stream.cu instead.
//
// What bounds it: operations and latency. The work is data dependent: the
// box tests of the inner nodes a ray opens and ~90 flops per cone row of
// every leaf it enters, against 37 bytes of ray I/O; the leaf geometry is
// re-read from L2. Divergence between the rays of a warp (different walk
// lengths) is the cost this simple first version accepts.
//
// Ties: within a leaf the lowest index wins (strict t < t_best in index
// order); across clusters the strictly smaller t wins, so rows equal the
// brute-force twin's except on exact t ties between clusters.
//
// Cone arithmetic: that of ops/bvh.py::_cone_core, including its o.v sum
// in the order y, x, z (the Pallas _cone_block sums x, y, z). Built without
// --use_fast_math and, unlike the shading kernels, with -fmad=false
// (kernels/__init__.py SOURCE_FLAGS): every multiply and add rounds on its
// own, as in the plain torch twin's separate ops, so the two agree bit for
// bit on t and found. (With contraction the thin-cone quadratic moved t by
// up to 1e-4 relative and flipped a grazing hit in 2,304 fur-patch rays.)

#include <cuda_runtime.h>

namespace {

constexpr float INF = 3.4e38f;
constexpr float TRI_EPS = 1.1920929e-7f;
constexpr int BLOCK = 128;
constexpr int STACK = 64;  // >= depth + 1 for any heap of up to 2^63 leaves

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// One cone row of a leaf (ops/bvh.py::_cone_core); INF where not hit.
__device__ __forceinline__ float cone_test(const Ray& r, const float* p, int k, float t_min,
                                           float t_best) {
  float bx = p[0 * k], by = p[1 * k], bz = p[2 * k];
  float ux = p[3 * k], uy = p[4 * k], uz = p[5 * k];
  float vx = p[6 * k], vy = p[7 * k], vz = p[8 * k];
  float wx = p[9 * k], wy = p[10 * k], wz = p[11 * k];
  float slope = p[12 * k], r_base = p[13 * k], min_d = p[14 * k], max_d = p[15 * k];
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
  float ov = r.oy * vy + r.ox * vx + r.oz * vz;
  float ax1 = ov + t1 * dy, ax2 = ov + t2 * dy;
  if (t1 >= 1e-4f && t1 > t_min && t1 < t_best && ax1 >= min_d && ax1 <= max_d) return t1;
  if (t2 >= 1e-4f && t2 > t_min && t2 < t_best && ax2 >= min_d && ax2 <= max_d) return t2;
  return INF;
}

// One triangle row of a leaf (ops/bvh.py::_tri_core); INF where not hit.
__device__ __forceinline__ float tri_test(const Ray& r, const float* p, int k, float t_min,
                                          float t_best) {
  float v0x = p[0 * k], v0y = p[1 * k], v0z = p[2 * k];
  float e1x = p[3 * k], e1y = p[4 * k], e1z = p[5 * k];
  float e2x = p[6 * k], e2y = p[7 * k], e2z = p[8 * k];
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  if (fabsf(det) < TRI_EPS) return INF;
  float inv_det = 1.0f / det;
  float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  float u = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  bool ok = u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < t_best;
  return ok ? t : INF;
}

// Slab test of heap node `n` (the TPU kernel's phase-1 arithmetic): the
// entry distance max(tnear, 0), or INF when missed or not below t_best.
__device__ __forceinline__ float box_entry(const Ray& r, float ix, float iy, float iz,
                                           const float* __restrict__ bmin,
                                           const float* __restrict__ bmax, int n,
                                           float t_best) {
  const float* lo = bmin + 3 * n;
  const float* hi = bmax + 3 * n;
  float t0x = (lo[0] - r.ox) * ix, t1x = (hi[0] - r.ox) * ix;
  float t0y = (lo[1] - r.oy) * iy, t1y = (hi[1] - r.oy) * iy;
  float t0z = (lo[2] - r.oz) * iz, t1z = (hi[2] - r.oz) * iz;
  float tnear = fmaxf(fmaxf(fmaxf(-INF, fminf(t0x, t1x)), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tfar = fminf(fminf(fminf(INF, fmaxf(t0x, t1x)), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  bool hit = tnear <= tfar && tfar >= 0.0f && tnear < t_best;
  return hit ? fmaxf(tnear, 0.0f) : INF;
}

__device__ __forceinline__ float safe_inv(float x) {
  const float eps = 1e-20f;
  return 1.0f / (fabsf(x) < eps ? (x < 0.0f ? -eps : eps) : x);
}

template <bool kCone, bool kAnyHit>
__global__ void __launch_bounds__(BLOCK) traverse_kernel(
    int n_rays, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const float* __restrict__ bmin,
    const float* __restrict__ bmax, const float* __restrict__ packed, int n_leaves, int leaf_k,
    float t_min, float* __restrict__ t_out, int* __restrict__ row_out,
    unsigned char* __restrict__ found_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  constexpr int W = kCone ? 16 : 9;
  const int first_leaf = n_leaves - 1;

  float t_best = t_max[i];
  int best = -1;
  int stack_node[STACK];
  float stack_entry[STACK];
  int sp = 0;
  float e_root = t_best > 0.0f ? box_entry(r, ix, iy, iz, bmin, bmax, 0, t_best) : INF;
  if (e_root < INF) { stack_node[0] = 0; stack_entry[0] = e_root; sp = 1; }
  while (sp > 0) {
    --sp;
    int node = stack_node[sp];
    if (!(stack_entry[sp] < t_best)) continue;  // pruned by a nearer hit found since
    if (node >= first_leaf) {
      int leaf = node - first_leaf;
      const float* blk = packed + static_cast<size_t>(leaf) * W * leaf_k;
      bool stop = false;
      for (int k = 0; k < leaf_k; ++k) {
        float t = kCone ? cone_test(r, blk + k, leaf_k, t_min, t_best)
                        : tri_test(r, blk + k, leaf_k, t_min, t_best);
        if (t < t_best) {
          best = leaf * leaf_k + k;
          if (kAnyHit) { t_best = 0.0f; stop = true; break; }
          t_best = t;
        }
      }
      if (stop) break;
    } else {
      int c0 = 2 * node + 1, c1 = c0 + 1;
      float e0 = box_entry(r, ix, iy, iz, bmin, bmax, c0, t_best);
      float e1 = box_entry(r, ix, iy, iz, bmin, bmax, c1, t_best);
      int near = c0, far = c1;
      float en = e0, ef = e1;
      if (e1 < e0) { near = c1; far = c0; en = e1; ef = e0; }
      if (ef < INF) { stack_node[sp] = far; stack_entry[sp] = ef; ++sp; }
      if (en < INF) { stack_node[sp] = near; stack_entry[sp] = en; ++sp; }
    }
  }
  t_out[i] = t_best;
  row_out[i] = best;
  found_out[i] = best >= 0 ? 1 : 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int traverse_launch(int n_rays, const float* o, const float* d, const float* t_max,
                               const float* bmin, const float* bmax, const float* packed,
                               int n_leaves, int leaf_k, int cone, int any_hit, float t_min,
                               float* t_out, int* row_out, unsigned char* found_out,
                               void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int grid = (n_rays + BLOCK - 1) / BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUR_TRAVERSE(C, A)                                                                  \
  traverse_kernel<C, A><<<grid, BLOCK, 0, s>>>(n_rays, o, d, t_max, bmin, bmax, packed,     \
                                               n_leaves, leaf_k, t_min, t_out, row_out,     \
                                               found_out)
  if (cone) {
    if (any_hit) FUR_TRAVERSE(true, true); else FUR_TRAVERSE(true, false);
  } else {
    if (any_hit) FUR_TRAVERSE(false, true); else FUR_TRAVERSE(false, false);
  }
#undef FUR_TRAVERSE
  return static_cast<int>(cudaGetLastError());
}
