// Brute-force nearest hit of each ray against every primitive of a
// BVH-less pack (triangles or cones), culled by ray tiles and padded boxes.
//
// Replaces ba_pathtracing_fur_tpu/ops/pallas/intersect.py::tri_closest /
// cone_closest (_closest, _tri_kernel, _cone_kernel). Contract: for each
// ray (o, d, t_max) the nearest t in (t_min, t_max) over the component-major
// pack [W, P] (INF on a miss) and its index (-1 on a miss); on equal t the
// lowest index wins; a dead ray (t_max <= 0) misses. The plain twin
// (ops/cuda/intersect.py::closest_ref) gives the same t and index bit for
// bit.
//
// What bounds it: operations. Testing every pair (the TPU kernel's way, and
// this kernel's before the cull) costs ~85 issued instructions a triangle
// pair and more a cone pair, and a tile of coherent rays can hit only a few
// of the pack's primitives, so the design does less work instead:
//
//   1. A block owns a tile of TILE consecutive rays (entry-morton sorted on
//      the main path when the scene has a BVH, ops/traverse.py) and forms
//      its bundle: the box of its live origins, per axis the range of 1/d,
//      and its largest t_max. A tile without a live ray skips the pack.
//   2. It streams the padded boxes [6, P] (ops/cuda/intersect.py::
//      padded_boxes) through shared memory in chunks of CHUNK, by cp.async
//      into a double buffer (the next chunk loads while this one is
//      tested; a box lands as two float4s), tests each box against the bundle (one box a thread:
//      bundle_hit, whose bounds dominate every live ray's own slab values),
//      and compacts the survivors' indices into shared memory in ascending
//      order (a ballot per warp, a prefix sum over the warps). The
//      survivors' W rows are gathered into shared memory.
//   3. Each ray walks the survivors in index order, SPLIT threads a ray
//      taking every SPLIT-th survivor: the slab test of the survivor's
//      padded box with the ray's own 1/d, pruned only beyond PRUNE times
//      its best t so far, and only where it enters, the exact
//      test (fur::tri_row, or cone_test below); strict `<` keeps the lowest
//      index on equal t. The SPLIT partial results merge as 64-bit keys
//      (ordered t bits, index) by atomicMin: the (t, index) minimum.
//
// Every pair the exact test accepts has its padded box entered by its ray
// at or before PRUNE times its t (ops/cuda/intersect.py::padded_boxes,
// cull_margin), so neither box test drops such a pair: the result is exact.
//
// Arithmetic: exactly the Pallas kernels' (Möller-Trumbore; the cone
// quadratic with o.v summed x, y, z, sqrt(max(disc, 1e-12)), t >= 1e-4),
// built with -fmad=false (kernels/__init__.py SOURCE_FLAGS) so t and the
// index agree bit for bit with the twin.

#include "leaf_tiles.cuh"

namespace {

using fur::INF;
using fur::Ray;

constexpr int TILE = 128;     // rays of a block
constexpr int THREADS = 256;  // threads of a block
constexpr int SPLIT = THREADS / TILE;  // threads a ray
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS;  // boxes culled a round, one a thread
constexpr int NB = 13;          // bundle values: o min, -o max, 1/d min, -1/d max, -t_max max
// A box is pruned only where its entry lies beyond PRUNE times the ray's
// best t (the tile's largest t_max in the bundle test): the exact test
// accepts a grazing cone root before the ray reaches the cone's box, by
// the O(sqrt(eps)) relative error of a near-double root, so a prune at the
// best t itself could drop the winner. 1 + 2^-6 (ops/cuda/intersect.py
// PRUNE_SLACK; tests/test_torch_bruteforce.py has rays that need it).
constexpr float PRUNE = 1.015625f;
static_assert(THREADS % TILE == 0 && TILE % 32 == 0 && THREADS <= 256,
              "tile shape: THREADS a multiple of TILE, TILE of 32, static shared memory");

// _cone_kernel's test of one primitive in column k of a [16, CHUNK] block. It
// sums o.v in the order x, y, z (the Pallas kernel's), where the traversal
// twins' fur::cone_row sums y, x, z, so it keeps its own arithmetic.
__device__ __forceinline__ float cone_test(const Ray& r, const float* p, int k, float t_min) {
  float bx = p[0 * CHUNK + k], by = p[1 * CHUNK + k], bz = p[2 * CHUNK + k];
  float ux = p[3 * CHUNK + k], uy = p[4 * CHUNK + k], uz = p[5 * CHUNK + k];
  float vx = p[6 * CHUNK + k], vy = p[7 * CHUNK + k], vz = p[8 * CHUNK + k];
  float wx = p[9 * CHUNK + k], wy = p[10 * CHUNK + k], wz = p[11 * CHUNK + k];
  float slope = p[12 * CHUNK + k], r_base = p[13 * CHUNK + k];
  float min_d = p[14 * CHUNK + k], max_d = p[15 * CHUNK + k];
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

// The tile's bundle: origin box, range of 1/d per axis, largest t_max.
struct Bundle {
  float olo[3], ohi[3], ilo[3], ihi[3], tmax;
};

// Can a live ray of the bundle enter the box (lo, hi)? On an axis where 1/d
// has one sign over the tile, the least entry and the largest exit over the
// bundle come from one corner each: a rounded (box - origin) times a 1/d
// bound, which by monotone rounding bound every ray's own slab values
// (fur::slab); an axis of mixed signs bounds nothing. The box passes when
// the largest least entry (and 0) is at or below the least largest exit and
// PRUNE times the tile's largest t_max. ops/cuda/intersect.py::bundle_hits
// is this test in torch.
__device__ __forceinline__ bool bundle_hit(const Bundle& b, const float* lo, const float* hi) {
  float near = 0.0f, far = __int_as_float(0x7f800000);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (b.ilo[a] > 0.0f) {
      const float xl = lo[a] - b.ohi[a], xh = hi[a] - b.olo[a];
      near = fmaxf(near, xl * (xl >= 0.0f ? b.ilo[a] : b.ihi[a]));
      far = fminf(far, xh * (xh >= 0.0f ? b.ihi[a] : b.ilo[a]));
    } else if (b.ihi[a] < 0.0f) {
      const float xh = hi[a] - b.olo[a], xl = lo[a] - b.ohi[a];
      near = fmaxf(near, xh * (xh >= 0.0f ? b.ilo[a] : b.ihi[a]));
      far = fminf(far, xl * (xl >= 0.0f ? b.ihi[a] : b.ilo[a]));
    }
  }
  return near <= far && near <= b.tmax;
}

// This thread's share of the boxes [base, base + CHUNK) into dst [CHUNK][8]:
// box k as two float4s (lo xyz, -; hi xyz, -), so a ray reads a box with two
// 16-byte shared loads.
__device__ __forceinline__ void load_boxes(float* dst, const float* __restrict__ boxes,
                                           int n_prims, int base) {
  const int k = threadIdx.x;
  if (base + k < n_prims) {
#pragma unroll
    for (int a = 0; a < 6; ++a)
      fur::cp_async4(dst + 8 * k + a + a / 3,
                     boxes + static_cast<size_t>(a) * n_prims + base + k);
  }
}

template <bool kCone>
__global__ void __launch_bounds__(THREADS) brute_kernel(
    int n_rays, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const float* __restrict__ prims,
    const float* __restrict__ boxes, int n_prims, float t_min, float* __restrict__ t_out,
    int* __restrict__ idx_out) {
  constexpr int W = kCone ? 16 : 9;
  __shared__ __align__(16) float s_box[2][8 * CHUNK];
  __shared__ float s_row[W * CHUNK];
  __shared__ int s_surv[CHUNK];
  __shared__ int s_count[WARPS];
  __shared__ float s_red[WARPS][NB];
  __shared__ float s_bundle[NB];
  __shared__ unsigned long long s_key[TILE];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q = t % TILE, part = t / TILE;
  const int i = blockIdx.x * TILE + q;
  Ray r = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float cap = 0.0f;
  if (i < n_rays) {
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
    cap = t_max[i];
  }
  const bool live = i < n_rays && cap > 0.0f;
  const float ix = fur::safe_inv(r.dx), iy = fur::safe_inv(r.dy), iz = fur::safe_inv(r.dz);

  // The bundle: 13 minima over the live rays (maxima as minima of negatives).
  {
    const float inf = __int_as_float(0x7f800000);
    float v[NB] = {r.ox, r.oy, r.oz, -r.ox, -r.oy, -r.oz, ix, iy, iz, -ix, -iy, -iz, -cap};
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      float x = live ? v[k] : inf;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(fur::FULL, x, off));
      if (lane == 0) s_red[warp][k] = x;
    }
    if (part == 0) s_key[q] = ~0ull;
    __syncthreads();
    if (t < NB) {
      float x = s_red[0][t];
      for (int w = 1; w < WARPS; ++w) x = fminf(x, s_red[w][t]);
      s_bundle[t] = x;
    }
    __syncthreads();
  }
  if (!(s_bundle[0] < __int_as_float(0x7f800000))) {  // no live ray: the pack is skipped
    if (part == 0 && i < n_rays) { t_out[i] = INF; idx_out[i] = -1; }
    return;
  }
  Bundle bd;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    bd.olo[a] = s_bundle[a]; bd.ohi[a] = -s_bundle[3 + a];
    bd.ilo[a] = s_bundle[6 + a]; bd.ihi[a] = -s_bundle[9 + a];
  }
  bd.tmax = -s_bundle[12] * PRUNE;

  // a t at or beyond t_max (or INF) is a miss, as in the twin
  float best = fminf(cap, INF);
  int best_i = -1;
  const int n_chunks = (n_prims + CHUNK - 1) / CHUNK;
  load_boxes(s_box[0], boxes, n_prims, 0);
  fur::cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * CHUNK, cur = c & 1;
    const float4* bx = reinterpret_cast<const float4*>(s_box[cur]);
    fur::cp_async_wait<0>();
    __syncthreads();  // this chunk's boxes are in; the last walk is done
    bool take = false;
    if (base + t < n_prims) {
      const float4 l = bx[2 * t], h = bx[2 * t + 1];
      const float lo[3] = {l.x, l.y, l.z}, hi[3] = {h.x, h.y, h.z};
      take = bundle_hit(bd, lo, hi);
    }
    const unsigned m = __ballot_sync(fur::FULL, take);
    if (lane == 0) s_count[warp] = __popc(m);
    if (c + 1 < n_chunks) load_boxes(s_box[cur ^ 1], boxes, n_prims, base + CHUNK);
    fur::cp_async_commit();
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int n = s_count[w];
      off += w < warp ? n : 0;
      total += n;
    }
    if (total == 0) continue;  // uniform: every thread has the same total
    if (take) s_surv[off + __popc(m & ((1u << lane) - 1u))] = t;
    __syncthreads();
    for (int x = t; x < W * total; x += THREADS) {
      const int a = x / total, s = x - a * total;
      s_row[a * CHUNK + s] = __ldg(prims + static_cast<size_t>(a) * n_prims + base + s_surv[s]);
    }
    __syncthreads();
    if (live) {
      float prune = best * PRUNE;
#pragma unroll 4
      for (int s = part; s < total; s += SPLIT) {
        const int k = s_surv[s];
        const float4 l = bx[2 * k], h = bx[2 * k + 1];
        if (!(fur::slab(r, ix, iy, iz, l.x, l.y, l.z, h.x, h.y, h.z, prune) < INF))
          continue;
        const float tt = kCone ? cone_test(r, s_row, s, t_min)
                               : fur::tri_row(r, s_row + s, CHUNK, t_min, INF);
        if (tt < best) {
          best = tt;
          best_i = base + k;
          prune = best * PRUNE;
        }
      }
    }
  }
  if (best_i >= 0) atomicMin(&s_key[q], fur::ray_key(best, static_cast<unsigned>(best_i)));
  __syncthreads();
  if (part == 0 && i < n_rays) {
    const unsigned long long kq = s_key[q];
    const bool found = kq != ~0ull;
    t_out[i] = found ? fur::unord(static_cast<unsigned>(kq >> 32)) : INF;
    idx_out[i] = found ? static_cast<int>(static_cast<unsigned>(kq)) : -1;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int bruteforce_launch(int n_rays, const float* o, const float* d, const float* t_max,
                                 const float* prims, const float* boxes, int n_prims, int cone,
                                 float t_min, float* t_out, int* idx_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int grid = (n_rays + TILE - 1) / TILE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cone)
    brute_kernel<true><<<grid, THREADS, 0, st>>>(n_rays, o, d, t_max, prims, boxes, n_prims,
                                                 t_min, t_out, idx_out);
  else
    brute_kernel<false><<<grid, THREADS, 0, st>>>(n_rays, o, d, t_max, prims, boxes, n_prims,
                                                  t_min, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
