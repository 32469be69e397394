// The ray-primitive and ray-box tests shared by the traversal kernels
// (csrc/traverse.cu, csrc/traverse_stream.cu, through csrc/leaf_tiles.cuh)
// and the brute-force kernel's triangle test (csrc/bruteforce.cu).
//
// The arithmetic is that of the plain torch twins (ops/bvh.py::_cone_core,
// _tri_core; ops/cuda/traverse.py::_slab_entry): every file that includes
// this header is built with -fmad=false (kernels/__init__.py SOURCE_FLAGS),
// so each multiply and add rounds on its own, as in the twins' separate
// ops, and t agrees with them bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace fur {

constexpr float INF = 3.4e38f;
constexpr float TRI_EPS = 1.1920929e-7f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// One cone row of a component-major leaf block (component c of the row at
// p[c * k]): ops/bvh.py::_cone_core with t_best = cap, including its o.v
// sum in the order y, x, z. INF where not hit.
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

// One Möller-Trumbore row (v0, e1, e2 at p[c * k]): ops/bvh.py::_tri_core
// with t_best = cap. INF where not hit.
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

// Slab test of a box (lo xyz, hi xyz) with the ray's inverse direction:
// the entry distance max(tnear, 0), or INF when missed or when the entry
// lies beyond t_best (an entry equal to t_best is kept).
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

}  // namespace fur
