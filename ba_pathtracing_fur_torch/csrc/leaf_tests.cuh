// The ray-primitive and ray-box tests shared by the traversal kernels
// (csrc/traverse.cu, csrc/traverse_stream.cu, through csrc/leaf_tiles.cuh)
// and the brute-force kernel's triangle test (csrc/bruteforce.cu).
//
// The arithmetic is that of the plain torch twins (ops/bvh.py::_cone_core,
// _tri_core; ops/cuda/traverse.py::_slab_entry, _cone_core_mxu): every file
// that includes this header is built with -fmad=false (kernels/__init__.py
// SOURCE_FLAGS), so each multiply and add rounds on its own, as in the
// twins' separate ops, and t agrees with them bit for bit.
//
// A leaf block is float or bf16 (the streaming kernel's half-size pack,
// ops/cuda/stream.py::pack_prim_hbm): `ld` reads either as f32, a bf16
// value exactly (its 8 significant bits fit f32's 24), so a bf16 row is
// tested in f32 as its upcast copy is by the twin. The streaming kernel's
// bf16 instances hold a row in registers for a run of rays (Bf16Row) and
// pass cone_row and tri_row a reference into it (k = 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fur {

constexpr float INF = 3.4e38f;
constexpr float TRI_EPS = 1.1920929e-7f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// A row of N bf16 values held in registers, two to a word (the streaming
// kernel's bf16 tiles, leaf_tiles.cuh), and a pointer-like reference into
// it for cone_row and tri_row: ld of element i widens it to f32, exactly (a
// bf16 value's bits are the high half of its f32's).
template <int N>
struct Bf16Row {
  unsigned w[(N + 1) / 2];
};

template <int N>
struct Bf16RowRef {
  const Bf16Row<N>* row;
  int i;
  __device__ __forceinline__ Bf16RowRef operator+(int d) const { return {row, i + d}; }
};

template <int N>
__device__ __forceinline__ float ld(Bf16RowRef<N> p) {
  const unsigned v = p.row->w[p.i >> 1];
  return __uint_as_float(p.i & 1 ? v & 0xffff0000u : v << 16);
}

// One cone row of a component-major leaf block (component c of the row at
// p[c * k]; p a pointer or a Bf16RowRef): ops/bvh.py::_cone_core with t_best = cap, including its o.v
// sum in the order y, x, z. INF where not hit.
template <class P>
__device__ __forceinline__ float cone_row(const Ray& r, P p, int k, float t_min, float cap) {
  float bx = ld(p + 0 * k), by = ld(p + 1 * k), bz = ld(p + 2 * k);
  float ux = ld(p + 3 * k), uy = ld(p + 4 * k), uz = ld(p + 5 * k);
  float vx = ld(p + 6 * k), vy = ld(p + 7 * k), vz = ld(p + 8 * k);
  float wx = ld(p + 9 * k), wy = ld(p + 10 * k), wz = ld(p + 11 * k);
  float slope = ld(p + 12 * k), r_base = ld(p + 13 * k), min_d = ld(p + 14 * k),
        max_d = ld(p + 15 * k);
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

// One cone row from the ray's frame projections, in two steps, with
// ops/pallas/stream.py::_cone_block_mxu's order (p = o.u - b.u, the axis slab
// from o.v) and cone_row's quadratic, rounding for rounding: cone_uw takes
// the u and w projections (ou, ow = o.u, o.w of the ray's origin; du, dw =
// d.u, d.w) and the row's b.u, b.w into the u, w parts of a, b and c, and
// cone_v finishes the row from them and the v projections (ov = o.v, dv =
// d.v) and b.v. The tensor-core leaf loop of the streaming kernel
// (leaf_tiles.cuh, kMxu) computes the projections as matrix products, u and
// w before v, so that fewer of them are live at once. INF where not hit.
struct ConeUW {
  float a, b, c;  // dx*dx + dz*dz, px*dx + pz*dz, px*px + pz*pz
};

__device__ __forceinline__ ConeUW cone_uw(float ou, float ow, float du, float dw, float bu,
                                          float bw) {
  const float px = ou - bu, pz = ow - bw;
  return {du * du + dw * dw, px * du + pz * dw, px * px + pz * pz};
}

__device__ __forceinline__ float cone_v(const ConeUW& uw, float ov, float dy, float bv,
                                        float slope, float r_base, float min_d, float max_d,
                                        float t_min, float cap) {
  float py = ov - bv;
  float a = uw.a - slope * slope * dy * dy;
  float b = uw.b + r_base * slope * dy - slope * slope * py * dy;
  float c_lin = r_base - slope * py;
  float c = uw.c - c_lin * c_lin;
  float disc = b * b - a * c;
  if (!(disc >= 0.0f)) return INF;
  float sq = sqrtf(fmaxf(disc, 1e-12f));
  float a_safe = fabsf(a) < 1e-12f ? 1e-12f : a;
  float ra = (-b - sq) / a_safe, rb = (-b + sq) / a_safe;
  float t1 = fminf(ra, rb), t2 = fmaxf(ra, rb);
  float ax1 = ov + t1 * dy, ax2 = ov + t2 * dy;
  if (t1 >= 1e-4f && t1 > t_min && t1 < cap && ax1 >= min_d && ax1 <= max_d) return t1;
  if (t2 >= 1e-4f && t2 > t_min && t2 < cap && ax2 >= min_d && ax2 <= max_d) return t2;
  return INF;
}

// One Möller-Trumbore row (v0, e1, e2 at p[c * k]): ops/bvh.py::_tri_core
// with t_best = cap. INF where not hit.
template <class P>
__device__ __forceinline__ float tri_row(const Ray& r, P p, int k, float t_min, float cap) {
  float v0x = ld(p + 0 * k), v0y = ld(p + 1 * k), v0z = ld(p + 2 * k);
  float e1x = ld(p + 3 * k), e1y = ld(p + 4 * k), e1z = ld(p + 5 * k);
  float e2x = ld(p + 6 * k), e2y = ld(p + 7 * k), e2z = ld(p + 8 * k);
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

// Slab test of a box (lo xyz, hi xyz) with the ray's inverse direction:
// the entry distance max(tnear, 0), or INF when missed or when the entry
// lies beyond t_best (an entry equal to t_best is kept). An inverted box
// (lo > hi: a padding leaf or unit, which holds no row) is never entered:
// min/max of its slab terms would span the whole line and let every ray
// in at 0, and the morton and grid builds put whole runs of padding
// leaves at the end of the tree.
__device__ __forceinline__ float slab(const Ray& r, float ix, float iy, float iz, float lox,
                                      float loy, float loz, float hix, float hiy, float hiz,
                                      float t_best) {
  float t0x = (lox - r.ox) * ix, t1x = (hix - r.ox) * ix;
  float t0y = (loy - r.oy) * iy, t1y = (hiy - r.oy) * iy;
  float t0z = (loz - r.oz) * iz, t1z = (hiz - r.oz) * iz;
  float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  bool hit = lox <= hix && tnear <= tfar && tfar >= 0.0f && tnear <= t_best;
  return hit ? fmaxf(tnear, 0.0f) : INF;
}

__device__ __forceinline__ float safe_inv(float x) {
  const float eps = 1e-20f;
  return 1.0f / (fabsf(x) < eps ? (x < 0.0f ? -eps : eps) : x);
}

}  // namespace fur
