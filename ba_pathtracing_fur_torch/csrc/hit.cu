// Hit assembly (K6): the closest Hit of each ray from the winner rows that
// the traversal kernels picked, in one launch.
//
// Replaces no TPU kernel: the JAX package's ops/traverse.py::_assemble_hit
// (with the winner-t recompute before it) is plain JAX that XLA fuses into a
// few loops. The port's torch assembly (ops/traverse.py::_torch_hit and
// _assemble_hit, this kernel's plain version and the path autograd records
// through) ran as ~374 small torch launches a bounce on the H100.
// Contract (ops/cuda/hit.py): for each ray (o, d, t_max) and each kind
// (triangles, cones) its winner row and either `found` (the winner's t is
// then recomputed from the row by the leaf test, fur::tri_row /
// fur::cone_row, capped at t_max) or the dense grid's t; the kinds merge as
// `_assemble_hit` merges them (a cone wins only at a strictly smaller t),
// and every field of bruteforce.Hit is written: the losing kind's fields
// and a miss's are 0, PRIM_NONE and t = INF.
//
// What bounds it: bytes. A ray reads 24 B of o and d, 4 B of t_max and
// 5 B of row and flag a kind, one winner row where found (76 B a cone, 136
// B a triangle, scattered over the table, so a few 32 B sectors each), and
// writes 86 B of Hit: about 0.2 GB a bounce at 1M rays, 0.06 ms at 3.35
// TB/s. The arithmetic (the leaf test, then an interpolation or a cone's
// normal, texcoord and root classification; ~300 flops) is far below
// that. The design: one thread a ray, every intermediate in registers, every
// output written once and coalesced across the warp, a kind's row gathered
// only where it won a t; the winner's row is read again for its fields from
// L1/L2. On an H100 80GB HBM3 (700 W) it takes 0.056-0.072 ms a bounce of
// the 1M-fiber hair ball at 1024^2, 1.1-1.4x that bound; the torch
// assembly took 4.1 ms of kernels and 5-8 ms of host enqueue a bounce.
//
// Rounding: every field is bit-equal to the torch assembly's on the card.
// Built with -fmad=false (kernels/__init__.py SOURCE_FLAGS), so each
// multiply and add rounds on its own as torch's separate ops do; dot is
// torch's (a * b).sum(-1), (x + z) + y from a +0 accumulator (tdot on
// sc::dot), and cross torch.linalg.cross's FMA form (sc::cross,
// shade_core.cuh); a division by a Python scalar is torch's multiplication
// by the scalar's float reciprocal; clamp, minimum and maximum pass NaN
// through as torch's do.

#include "leaf_tests.cuh"
#include "shade_core.cuh"

namespace {

using namespace sc;  // float3 operators
using fur::INF;

constexpr int THREADS = 256;
constexpr int TRI_COLS = 34;   // ops/traverse.py::tri_aos
constexpr int CONE_COLS = 19;  // ops/traverse.py::cone_aos
constexpr int PRIM_NONE = -1, PRIM_TRI = 0, PRIM_CONE = 1;  // ops/bruteforce.py
// the Python scalars of ops/intersect.py::cone_texcoord_rows as torch takes
// them: converted to float, and a division by 2 pi as a product with the
// float reciprocal of float(2 pi)
constexpr float TWO_PI = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float INV_TWO_PI = 1.0f / TWO_PI;
constexpr float ACOS_LO = static_cast<float>(-1.0 + 1e-7), ACOS_HI = static_cast<float>(1.0 - 1e-7);

// One kind's winners (ops/traverse.py::_hit_of_rows): `aos` its row table
// (null when the scene has none of the kind: t is INF and the kind's fields
// stay 0), `row` [R] the winner row (0 on a miss), and either `found` [R]
// (t recomputed from the row) or `t` [R] (the dense grid's, taken as it
// is); `perm` maps a row to the primitive's id (null: the row is the id).
struct Kind {
  const float* __restrict__ aos;
  const int* __restrict__ row;
  const unsigned char* __restrict__ found;
  const float* __restrict__ t;
  const int* __restrict__ perm;
};

struct Out {
  float* __restrict__ t;
  unsigned char* __restrict__ valid;
  int* __restrict__ prim_type;
  int* __restrict__ prim_id;
  int* __restrict__ mat_id;
  float* __restrict__ position;
  float* __restrict__ normal;
  float* __restrict__ uv;
  unsigned char* __restrict__ enter;
  float* __restrict__ fiber_u;
  float* __restrict__ fiber_v;
  float* __restrict__ fiber_w;
};

// torch's (a * b).sum(-1): sc::dot's order, from a +0 accumulator, so a sum
// of -0 products is +0 (a degenerate scalp triangle, e1 = 0, has q = +-0
// and v = +0 in torch; its zero normal keeps the sign of v * n2)
__device__ __forceinline__ float tdot(float3 a, float3 b) { return sc::dot(a, b) + 0.0f; }

// torch.minimum, torch.maximum and torch.clamp on the card: NaN passes through
__device__ __forceinline__ float tminimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmaximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The kind's t: the dense grid's, or the winner row's leaf test where found
// (ops/traverse.py::_recompute_t_tri / _recompute_t_cone), INF elsewhere.
template <bool kCone>
__device__ __forceinline__ float kind_t(const Kind& k, const fur::Ray& r, int i, float t_min,
                                        float cap) {
  if (k.aos == nullptr) return INF;
  if (k.t != nullptr) return k.t[i];
  if (!k.found[i]) return INF;
  const float* g = k.aos + static_cast<size_t>(k.row[i]) * (kCone ? CONE_COLS : TRI_COLS);
  if (kCone) return fur::cone_row(r, g, 1, t_min, cap);
  // tri_row takes (v0, e1, e2); the table holds v0, v1, v2, and e = v - v0
  // rounds as _recompute_t_tri's edges do
  float c[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = g[a];
    c[3 + a] = g[3 + a] - c[a];
    c[6 + a] = g[6 + a] - c[a];
  }
  return fur::tri_row(r, static_cast<const float*>(c), 1, t_min, cap);
}

// ops/intersect.py::cone_normal_rows
__device__ __forceinline__ float3 cone_normal(float3 pos, float3 base, float3 va, float base_d,
                                              float slope) {
  const float t_axis = tdot(pos, va) - base_d;
  const float3 q1 = pos - va * t_axis;
  return sc::normalize(sc::normalize(q1 - base) + va * slope);
}

// ops/intersect.py::cone_texcoord_rows
__device__ __forceinline__ float2 cone_texcoord(float3 pos, float3 base, float3 ua, float3 va,
                                                float3 wa, float r_base, float slope,
                                                float height) {
  const float3 rel = pos - base;
  const float u = tdot(rel, ua), v = tdot(rel, va), w = tdot(rel, wa);
  const float r = r_base - slope * v;
  const float tmp = tclamp(w / (fabsf(r) < 1e-12f ? 1e-12f : r), ACOS_LO, ACOS_HI);
  const float ac = acosf(tmp);
  const float phi = u < 0.0f ? TWO_PI - ac : ac;
  return make_float2(phi * INV_TWO_PI, v / height);
}

// ops/traverse.py::_cone_enter_rows: is t nearer the entering root?
__device__ __forceinline__ bool cone_enter(float3 o, float3 d, float3 base, float3 ua,
                                           float3 va, float3 wa, float slope, float r_base,
                                           float t) {
  const float3 rel = o - base;
  const float px = tdot(rel, ua), py = tdot(rel, va), pz = tdot(rel, wa);
  const float dx = tdot(d, ua), dy = tdot(d, va), dz = tdot(d, wa);
  const float ss = slope * slope;
  const float a = dx * dx + dz * dz - ss * dy * dy;
  const float b = px * dx + pz * dz + r_base * slope * dy - ss * py * dy;
  const float c_lin = r_base - slope * py;
  const float disc = b * b - a * (px * px + pz * pz - c_lin * c_lin);
  const float sq = sqrtf(disc != disc ? disc : fmaxf(disc, 0.0f));
  const float a_safe = fabsf(a) < 1e-12f ? 1e-12f : a;
  const float ra = (-b - sq) / a_safe, rb = (-b + sq) / a_safe;
  const float t1 = tminimum(ra, rb), t2 = tmaximum(ra, rb);
  return fabsf(t - t1) <= fabsf(t - t2);
}

__global__ void __launch_bounds__(THREADS) hit_kernel(int n_rays, const float* __restrict__ o,
                                                      const float* __restrict__ d,
                                                      const float* __restrict__ t_max,
                                                      float t_min, Kind tri, Kind cone, Out out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_rays) return;
  const float3 ro = ld3(o + 3 * i), rd = ld3(d + 3 * i);
  const float cap = t_max[i];
  const fur::Ray ray = {ro.x, ro.y, ro.z, rd.x, rd.y, rd.z};
  const float t_tri = kind_t<false>(tri, ray, i, t_min, cap);
  const float t_cone = kind_t<true>(cone, ray, i, t_min, cap);
  const bool cone_wins = t_cone < t_tri;
  const float t = cone_wins ? t_cone : t_tri;
  const bool valid = t < cap;
  const int prim_type = !valid ? PRIM_NONE : (cone_wins ? PRIM_CONE : PRIM_TRI);
  const float3 pos = ro + rd * t;

  float3 n = f3(0.0f), fu = f3(0.0f), fv = f3(0.0f), fw = f3(0.0f);
  float2 uv = make_float2(0.0f, 0.0f);
  int mat_id = 0, prim_id = 0;
  bool enter = false;
  if (prim_type == PRIM_TRI && tri.aos != nullptr) {
    // ops/intersect.py::triangle_interpolate_rows
    const int row = tri.row[i];
    const float* g = tri.aos + static_cast<size_t>(row) * TRI_COLS;
    const float3 v0 = ld3(g), e1 = ld3(g + 3) - v0, e2 = ld3(g + 6) - v0;
    const float3 p = sc::cross(rd, e2);
    const float det = tdot(e1, p);
    const float inv_det = 1.0f / (fabsf(det) < fur::TRI_EPS ? 1.0f : det);
    const float3 tv = ro - v0;
    const float u = tdot(tv, p) * inv_det;
    const float v = tdot(rd, sc::cross(tv, e1)) * inv_det;
    const float w = 1.0f - u - v;
    n = sc::normalize(ld3(g + 9) * w + ld3(g + 12) * u + ld3(g + 15) * v);
    uv = make_float2(g[18] * w + g[20] * u + g[22] * v, g[19] * w + g[21] * u + g[23] * v);
    fu = ld3(g + 24);
    fv = ld3(g + 27);
    fw = ld3(g + 30);
    mat_id = __float_as_int(g[33]);
    prim_id = tri.perm != nullptr ? tri.perm[row] : row;
  } else if (prim_type == PRIM_CONE && cone.aos != nullptr) {
    const int row = cone.row[i];
    const float* g = cone.aos + static_cast<size_t>(row) * CONE_COLS;
    const float3 base = ld3(g), ua = ld3(g + 3), va = ld3(g + 6), wa = ld3(g + 9);
    const float slope = g[12], r_base = g[13];
    n = cone_normal(pos, base, va, g[16], slope);
    uv = cone_texcoord(pos, base, ua, va, wa, r_base, slope, g[17]);
    fu = ua;
    fv = va;
    fw = wa;
    mat_id = __float_as_int(g[18]);
    enter = cone_enter(ro, rd, base, ua, va, wa, slope, r_base, t);
    prim_id = cone.perm != nullptr ? cone.perm[row] : row;
  }

  out.t[i] = valid ? t : INF;
  out.valid[i] = valid;
  out.prim_type[i] = prim_type;
  out.prim_id[i] = prim_id;
  out.mat_id[i] = mat_id;
  st3(out.position + 3 * i, pos);
  st3(out.normal + 3 * i, n);
  out.uv[2 * i] = uv.x;
  out.uv[2 * i + 1] = uv.y;
  out.enter[i] = enter;
  st3(out.fiber_u + 3 * i, fu);
  st3(out.fiber_v + 3 * i, fv);
  st3(out.fiber_w + 3 * i, fw);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Per kind (triangles, then
// cones): aos row found t perm, each null where `Kind` says. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int hit_launch(int n_rays, const float* o, const float* d, const float* t_max,
                          float t_min, const float* tri_aos, const int* tri_row,
                          const unsigned char* tri_found, const float* tri_t,
                          const int* tri_perm, const float* cone_aos, const int* cone_row,
                          const unsigned char* cone_found, const float* cone_t,
                          const int* cone_perm, float* t_out, unsigned char* valid,
                          int* prim_type, int* prim_id, int* mat_id, float* position,
                          float* normal, float* uv, unsigned char* enter, float* fiber_u,
                          float* fiber_v, float* fiber_w, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const Kind tri = {tri_aos, tri_row, tri_found, tri_t, tri_perm};
  const Kind cone = {cone_aos, cone_row, cone_found, cone_t, cone_perm};
  const Out out = {t_out, valid, prim_type, prim_id, mat_id, position,
                   normal, uv, enter, fiber_u, fiber_v, fiber_w};
  const int grid = (n_rays + THREADS - 1) / THREADS;
  hit_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(n_rays, o, d, t_max,
                                                                      t_min, tri, cone, out);
  return static_cast<int>(cudaGetLastError());
}
