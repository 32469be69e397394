// The level-2 full-bounce kernel for small untextured triangle scenes.
//
// Replaces ba_pathtracing_fur_tpu/ops/pallas/shade.py::_full_bounce_kernel
// (shade_bounce_full). One thread per ray does the whole bounce:
//   1. Möller-Trumbore closest hit over the triangle table (_tri_scalar_t,
//      t_min 1e-4, strict t < t_best so the first triangle wins ties);
//   2. the barycentric normal and the material row;
//   3. the shading body (shade_core.cuh, sc::shade_bounce_core);
//   4. the NEE shadow any-hit over the same table;
//   5. the masked add of the NEE term.
// It reads and writes the port's [R,3] / [R] f32 and i32 ray-state tensors
// directly; the TPU kernel's [C, R/128, 128] packing and 1024-ray padding
// are not carried over.
//
// What bounds it: compute and latency. Each ray runs ~60 flops per triangle
// per pass over ~34 Cornell triangles, twice (closest + shadow), plus the
// shading body, against ~130 bytes of ray state in and out. Every thread of
// a block reads the same triangle row in the same loop step, so the tables
// (tris [T<=512,19], mats [M,20], lights [L,29], <= 39 KB for 512
// triangles) are staged once per block in shared memory, where such a read
// is a broadcast. This first version is kept simple: no BVH, no warp-level
// tricks, no RNG fusion.
//
// Built without --use_fast_math (approximate division and denormal flush
// would move 1/det against the 1.19e-7 threshold). FMA contraction stays
// on: it moves t and u/v by ulps against the plain torch version, so the
// tests compare with image gates, never bit equality.

#include <cuda_runtime.h>

#include "shade_core.cuh"

namespace {

using namespace sc;  // float3 operators

constexpr int TRI_COLS = 19;  // v0 e1 e2 n0 n1 n2 mat_id
constexpr float T_MIN = 1e-4f;
constexpr int BLOCK = 128;

// Candidate hit of ONE triangle row (the arithmetic of _tri_scalar_t).
__device__ __forceinline__ bool tri_hit(float3 o, float3 d, const float* row, float t_max,
                                        float& t, float& u, float& v) {
  float3 v0 = sc::ld3(row), e1 = sc::ld3(row + 3), e2 = sc::ld3(row + 6);
  float3 p = sc::cross(d, e2);
  float det = sc::dot(e1, p);
  if (fabsf(det) < 1.1920929e-7f) return false;
  float inv_det = 1.0f / det;
  float3 tv = o - v0;
  u = sc::dot(tv, p) * inv_det;
  float3 q = sc::cross(tv, e1);
  v = sc::dot(d, q) * inv_det;
  t = sc::dot(e2, q) * inv_det;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > T_MIN && t < t_max;
}

__global__ void __launch_bounds__(BLOCK) full_bounce_kernel(
    int n_rays, const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ radiance, const float* __restrict__ color,
    const int* __restrict__ flags, const float* __restrict__ theta_i,
    const float* __restrict__ prev_pdf, const float* __restrict__ u_bsdf,
    const float* __restrict__ u_pick, const float* __restrict__ u_light,
    const float* __restrict__ u_rr, const float* __restrict__ tris, int n_tris,
    const float* __restrict__ mats, int n_mats, const float* __restrict__ lights, int n_lights,
    const float* __restrict__ env, sc::Cfg cfg, float* __restrict__ origin_out,
    float* __restrict__ direction_out, float* __restrict__ radiance_out,
    float* __restrict__ color_out, int* __restrict__ flags_out,
    float* __restrict__ theta_out, float* __restrict__ prev_pdf_out) {
  extern __shared__ float smem[];
  float* s_tris = smem;
  float* s_mats = s_tris + n_tris * TRI_COLS;
  float* s_lights = s_mats + n_mats * sc::MAT_COLS;
  for (int k = threadIdx.x; k < n_tris * TRI_COLS; k += blockDim.x) s_tris[k] = tris[k];
  for (int k = threadIdx.x; k < n_mats * sc::MAT_COLS; k += blockDim.x) s_mats[k] = mats[k];
  for (int k = threadIdx.x; k < n_lights * sc::LIGHT_COLS; k += blockDim.x) s_lights[k] = lights[k];
  __syncthreads();

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  sc::PathState st;
  st.origin = sc::ld3(origin + 3 * i);
  st.direction = sc::ld3(direction + 3 * i);
  st.radiance = sc::ld3(radiance + 3 * i);
  st.color = sc::ld3(color + 3 * i);
  st.flags = flags[i];
  st.theta_i = theta_i[i];
  st.prev_pdf = prev_pdf[i];

  // closest hit (bruteforce._closest_chunk semantics); dead rays trace nothing
  bool do_trace = !sc::is_zero(st.radiance) && !sc::is_zero(st.direction);
  float t_cap = do_trace ? sc::INF : 0.0f;
  float t_best = sc::INF, u_b = 0.0f, v_b = 0.0f;
  int best = -1;
  for (int j = 0; j < n_tris; ++j) {
    float t, u, v;
    if (tri_hit(st.origin, st.direction, s_tris + j * TRI_COLS, t_cap, t, u, v) && t < t_best) {
      t_best = t; u_b = u; v_b = v; best = j;
    }
  }
  sc::Hit hit;
  hit.valid = best >= 0;
  hit.t = hit.valid ? t_best : sc::INF;
  hit.pos = hit.valid ? st.origin + st.direction * t_best : sc::f3(0.0f);
  hit.normal = sc::f3(0.0f, 1.0f, 0.0f);
  int mat_id = 0;
  if (hit.valid) {
    const float* row = s_tris + best * TRI_COLS;
    float w_b = 1.0f - u_b - v_b;
    hit.normal = sc::normalize(sc::ld3(row + 9) * w_b + sc::ld3(row + 12) * u_b
                               + sc::ld3(row + 15) * v_b);
    mat_id = static_cast<int>(row[18]);
    if (mat_id < 0 || mat_id >= n_mats) mat_id = 0;  // as the TPU kernel's one-hot select
  }
  sc::Mat mp = sc::load_mat(s_mats + mat_id * sc::MAT_COLS);

  sc::Uniforms un;
  un.bsdf1 = u_bsdf[2 * i];
  un.bsdf2 = u_bsdf[2 * i + 1];
  un.pick = u_pick[i];
  un.light1 = u_light[2 * i];
  un.light2 = u_light[2 * i + 1];
  un.rr = cfg.rr ? u_rr[i] : 0.0f;

  sc::Shadow sh = sc::shade_bounce_core(st, hit, mp, sc::ld3(env), sc::ld3(env + 3), s_lights, un,
                                        cfg);

  // shadow any-hit (bruteforce._any_chunk semantics), then the NEE add;
  // no triangle can block a ray with tmax <= T_MIN, and direct_rgb is 0
  // on rays that cast no shadow ray
  bool blocked = false;
  if (sh.tmax > T_MIN) {
    for (int j = 0; j < n_tris && !blocked; ++j) {
      float t, u, v;
      blocked = tri_hit(sh.o, sh.d, s_tris + j * TRI_COLS, sh.tmax, t, u, v);
    }
  }
  if (!blocked) st.color = st.color + sh.direct_rgb;

  sc::st3(origin_out + 3 * i, st.origin);
  sc::st3(direction_out + 3 * i, st.direction);
  sc::st3(radiance_out + 3 * i, st.radiance);
  sc::st3(color_out + 3 * i, st.color);
  flags_out[i] = st.flags;
  theta_out[i] = st.theta_i;
  prev_pdf_out[i] = st.prev_pdf;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int full_bounce_launch(
    int n_rays, const float* origin, const float* direction, const float* radiance,
    const float* color, const int* flags, const float* theta_i, const float* prev_pdf,
    const float* u_bsdf, const float* u_pick, const float* u_light, const float* u_rr,
    const float* tris, int n_tris, const float* mats, int n_mats, const float* lights,
    int n_lights, const float* env, int mis, int rr, int rr_gate, float clamp_throughput,
    unsigned bsdfs_present, float* origin_out, float* direction_out, float* radiance_out,
    float* color_out, int* flags_out, float* theta_out, float* prev_pdf_out, void* stream) {
  sc::Cfg cfg;
  cfg.n_lights = n_lights;
  cfg.mis = mis != 0;
  cfg.rr = rr != 0;
  cfg.rr_gate = rr_gate != 0;
  cfg.clamp_throughput = clamp_throughput;
  cfg.bsdfs_present = bsdfs_present;
  size_t smem = sizeof(float) * (static_cast<size_t>(n_tris) * TRI_COLS
                                 + static_cast<size_t>(n_mats) * sc::MAT_COLS
                                 + static_cast<size_t>(n_lights) * sc::LIGHT_COLS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(full_bounce_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int grid = (n_rays + BLOCK - 1) / BLOCK;
  full_bounce_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      n_rays, origin, direction, radiance, color, flags, theta_i, prev_pdf, u_bsdf, u_pick,
      u_light, u_rr, tris, n_tris, mats, n_mats, lights, n_lights, env, cfg, origin_out,
      direction_out, radiance_out, color_out, flags_out, theta_out, prev_pdf_out);
  return static_cast<int>(cudaGetLastError());
}
