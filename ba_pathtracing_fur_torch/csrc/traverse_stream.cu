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
// against a 50 MB L2), so every leaf a ray enters is read from HBM. The
// TPU kernel keeps the super and child boxes resident, runs a tile-shared
// near-to-far schedule over them and DMAs each visited [W, K] leaf block
// into VMEM. Here:
//
//   * each lane walks the heap above the super-clusters on its own (nodes
//     0 .. S-2 from bmin/bmax, the S supers from sboxes [6, S]), nearer
//     child first, with a stack bounded by log2(S) + 1;
//   * when a lane reaches a super-cluster, the warp takes that (ray, super)
//     pair together: the 32 lanes test its F <= 256 child boxes (one
//     coalesced [6, F] block of cboxes [S, 6, F], F/32 children a lane, in
//     registers), then visit the children near to far by a warp argmin of
//     their entries; each visited leaf's [W, K] block is read coalesced,
//     K/32 rows a lane, and the nearest (t, row) is reduced through
//     shuffles. Every lane with a pending super is served in turn.
//
// What bounds it: operations (93 flops a cone row) for the leaves it
// enters and the HBM bytes of those leaves (18 KB a leaf); the warp-wide
// leaf test keeps every lane busy on rows and every load coalesced, where
// the per-ray heap walk of csrc/traverse.cu reads a leaf row by row, one
// ray a lane. The price: a (ray, leaf) pair costs ceil(K/32) row steps
// even when its ray needs one row, and the lanes of a warp wait for each
// other's supers.
//
// Rows: the warp keeps the lowest row among equal t, and a node or child
// whose entry equals the best t is still visited, so the result is the
// lexicographic minimum (t, row) over all rows: the brute-force twin's row
// on every ray, exact t ties across clusters included. The leaf tests are
// csrc/traverse.cu's, capped at t_max (the twin's cap), and the file is
// built with -fmad=false (kernels/__init__.py SOURCE_FLAGS), so t agrees
// with the twin bit for bit.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr float INF = 3.4e38f;
constexpr float TRI_EPS = 1.1920929e-7f;
constexpr int BLOCK = 128;
constexpr int STACK = 32;    // >= log2(S) + 1 for any super count below 2^31
constexpr int MAX_CPL = 8;   // children a lane: fanout <= 8 * 32
constexpr unsigned FULL = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// One cone row (ops/bvh.py::_cone_core with t_best = cap); INF where not hit.
__device__ __forceinline__ float cone_row(const Ray& r, const float* p, int k, float t_min,
                                          float cap) {
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
  if (t1 >= 1e-4f && t1 > t_min && t1 < cap && ax1 >= min_d && ax1 <= max_d) return t1;
  if (t2 >= 1e-4f && t2 > t_min && t2 < cap && ax2 >= min_d && ax2 <= max_d) return t2;
  return INF;
}

// One triangle row (ops/bvh.py::_tri_core with t_best = cap); INF where not hit.
__device__ __forceinline__ float tri_row(const Ray& r, const float* p, int k, float t_min,
                                         float cap) {
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
  bool ok = u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < cap;
  return ok ? t : INF;
}

// Slab test of a box: the entry distance max(tnear, 0), or INF when missed
// or when the entry lies beyond t_best (an entry equal to t_best is kept).
__device__ __forceinline__ float slab(const Ray& r, float ix, float iy, float iz, float lox,
                                      float loy, float loz, float hix, float hiy, float hiz,
                                      float t_best) {
  float t0x = (lox - r.ox) * ix, t1x = (hix - r.ox) * ix;
  float t0y = (loy - r.oy) * iy, t1y = (hiy - r.oy) * iy;
  float t0z = (loz - r.oz) * iz, t1z = (hiz - r.oz) * iz;
  float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  bool hit = tnear <= tfar && tfar >= 0.0f && tnear <= t_best;
  return hit ? fmaxf(tnear, 0.0f) : INF;
}

__device__ __forceinline__ float safe_inv(float x) {
  const float eps = 1e-20f;
  return 1.0f / (fabsf(x) < eps ? (x < 0.0f ? -eps : eps) : x);
}

// Entry of heap node n of the top walk: supers (n >= S-1) from sboxes,
// the nodes above them from the heap arrays.
__device__ __forceinline__ float node_entry(const Ray& r, float ix, float iy, float iz,
                                            const float* __restrict__ bmin,
                                            const float* __restrict__ bmax,
                                            const float* __restrict__ sboxes, int n_sup, int n,
                                            float t_best) {
  if (n >= n_sup - 1) {
    int s = n - (n_sup - 1);
    return slab(r, ix, iy, iz, sboxes[s], sboxes[n_sup + s], sboxes[2 * n_sup + s],
                sboxes[3 * n_sup + s], sboxes[4 * n_sup + s], sboxes[5 * n_sup + s], t_best);
  }
  const float* lo = bmin + 3 * n;
  const float* hi = bmax + 3 * n;
  return slab(r, ix, iy, iz, lo[0], lo[1], lo[2], hi[0], hi[1], hi[2], t_best);
}

// Lexicographic (value, index) minimum over the warp.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, off);
    int oi = __shfl_xor_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

template <bool kCone, bool kAnyHit>
__global__ void __launch_bounds__(BLOCK) stream_kernel(
    int n_rays, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const float* __restrict__ bmin,
    const float* __restrict__ bmax, const float* __restrict__ sboxes,
    const float* __restrict__ cboxes, const float* __restrict__ packed, int n_sup, int fanout,
    int leaf_k, float t_min, float* __restrict__ t_out, int* __restrict__ row_out,
    unsigned char* __restrict__ found_out) {
  constexpr int W = kCone ? 16 : 9;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;  // lanes past the end stay for the shuffles

  Ray r = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float cap = 0.0f;
  if (in_range) {
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
    cap = t_max[i];
  }
  float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  float t_best = cap;
  int best = -1;
  int stack_node[STACK];
  float stack_entry[STACK];
  int sp = 0;
  bool done = true;
  if (cap > 0.0f) {
    float e = node_entry(r, ix, iy, iz, bmin, bmax, sboxes, n_sup, 0, t_best);
    if (e < INF) { stack_node[0] = 0; stack_entry[0] = e; sp = 1; done = false; }
  }
  int pending = -1;  // the super-cluster this lane's walk waits at

  while (true) {
    // Each lane walks its top heap on to the next super-cluster to visit.
    if (!done && pending < 0) {
      while (sp > 0) {
        --sp;
        int node = stack_node[sp];
        if (stack_entry[sp] > t_best) continue;  // pruned by a nearer hit found since
        if (node >= n_sup - 1) { pending = node - (n_sup - 1); break; }
        int c0 = 2 * node + 1, c1 = c0 + 1;
        float e0 = node_entry(r, ix, iy, iz, bmin, bmax, sboxes, n_sup, c0, t_best);
        float e1 = node_entry(r, ix, iy, iz, bmin, bmax, sboxes, n_sup, c1, t_best);
        int near = c0, far = c1;
        float en = e0, ef = e1;
        if (e1 < e0) { near = c1; far = c0; en = e1; ef = e0; }
        if (ef < INF) { stack_node[sp] = far; stack_entry[sp] = ef; ++sp; }
        if (en < INF) { stack_node[sp] = near; stack_entry[sp] = en; ++sp; }
      }
      if (pending < 0) done = true;
    }
    unsigned todo = __ballot_sync(FULL, pending >= 0);
    if (todo == 0) break;

    // The warp serves each waiting lane's (ray, super) pair in turn.
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      Ray q;
      q.ox = __shfl_sync(FULL, r.ox, src); q.oy = __shfl_sync(FULL, r.oy, src);
      q.oz = __shfl_sync(FULL, r.oz, src); q.dx = __shfl_sync(FULL, r.dx, src);
      q.dy = __shfl_sync(FULL, r.dy, src); q.dz = __shfl_sync(FULL, r.dz, src);
      const float qix = __shfl_sync(FULL, ix, src), qiy = __shfl_sync(FULL, iy, src),
                  qiz = __shfl_sync(FULL, iz, src);
      const float qcap = __shfl_sync(FULL, cap, src);
      float tb = __shfl_sync(FULL, t_best, src);
      int bb = __shfl_sync(FULL, best, src);
      const int s = __shfl_sync(FULL, pending, src);

      // child boxes of super s: lane holds children lane + 32 j
      const float* cb = cboxes + static_cast<size_t>(s) * 6 * fanout;
      float ce[MAX_CPL];
#pragma unroll
      for (int j = 0; j < MAX_CPL; ++j) {
        int c = lane + 32 * j;
        ce[j] = c < fanout ? slab(q, qix, qiy, qiz, cb[c], cb[fanout + c], cb[2 * fanout + c],
                                  cb[3 * fanout + c], cb[4 * fanout + c], cb[5 * fanout + c], tb)
                           : INF;
      }
      bool stop = false;
      while (true) {
        float m = INF;
        int mc = INT_MAX;
#pragma unroll
        for (int j = 0; j < MAX_CPL; ++j)
          if (ce[j] < m) { m = ce[j]; mc = lane + 32 * j; }
        warp_argmin(m, mc);
        if (!(m < INF && m <= tb)) break;

        // leaf s * fanout + mc: K/32 rows a lane, coalesced per component
        const int leaf = s * fanout + mc;
        const float* blk = packed + static_cast<size_t>(leaf) * W * leaf_k;
        float lt = INF;
        int lr = INT_MAX;
        for (int k = lane; k < leaf_k; k += 32) {
          float t = kCone ? cone_row(q, blk + k, leaf_k, t_min, qcap)
                          : tri_row(q, blk + k, leaf_k, t_min, qcap);
          if (t < lt) { lt = t; lr = k; }
        }
        warp_argmin(lt, lr);
        if (lt < qcap) {
          const int row = leaf * leaf_k + lr;
          if (kAnyHit) { tb = 0.0f; bb = row; stop = true; break; }
          if (lt < tb || (lt == tb && row < bb)) { tb = lt; bb = row; }
        }
#pragma unroll
        for (int j = 0; j < MAX_CPL; ++j)
          if (mc == lane + 32 * j) ce[j] = INF;
      }
      if (lane == src) {
        t_best = tb;
        best = bb;
        pending = -1;
        if (stop) done = true;
      }
    }
  }
  if (in_range) {
    t_out[i] = t_best;
    row_out[i] = best;
    found_out[i] = best >= 0 ? 1 : 0;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int stream_launch(int n_rays, const float* o, const float* d, const float* t_max,
                             const float* bmin, const float* bmax, const float* sboxes,
                             const float* cboxes, const float* packed, int n_sup, int fanout,
                             int leaf_k, int cone, int any_hit, float t_min, float* t_out,
                             int* row_out, unsigned char* found_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (fanout <= 0 || fanout > 32 * MAX_CPL || n_sup < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = (n_rays + BLOCK - 1) / BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FUR_STREAM(C, A)                                                                     \
  stream_kernel<C, A><<<grid, BLOCK, 0, st>>>(n_rays, o, d, t_max, bmin, bmax, sboxes,       \
                                              cboxes, packed, n_sup, fanout, leaf_k, t_min,  \
                                              t_out, row_out, found_out)
  if (cone) {
    if (any_hit) FUR_STREAM(true, true); else FUR_STREAM(true, false);
  } else {
    if (any_hit) FUR_STREAM(false, true); else FUR_STREAM(false, false);
  }
#undef FUR_STREAM
  return static_cast<int>(cudaGetLastError());
}
