// The fused per-bounce shade stage, after the scene traversal.
//
// Replaces ba_pathtracing_fur_tpu/ops/pallas/shade.py::_shade_kernel
// (shade_bounce). One thread per ray runs sc::shade_bounce_core
// (shade_core.cuh): the analytic light hits, env/light termination with the
// MIS weight, ambient, the NEE light pick and sample (it emits the shadow
// ray and the unoccluded direct term), the surface BSDF cascade or the
// Marschner/d'Eon hair automaton, and the throughput/flag/RR/clamp update.
// The caller traces the shadow ray and adds direct_rgb where it is not
// blocked. shadow_o/shadow_d are defined where shadow_tmax > 0; on the
// other rays the kernel leaves (0, +y) there (the plain version computes
// them for every ray; no traversal reads them when tmax is 0).
//
// It reads the port's per-ray tensors directly ([R,3] / [R] f32 and i32,
// the hit flag as bytes: 59 f32 + 4 i32 values in, 24 f32 + 1 i32 out per
// ray; 56 f32 in when the environment colour is a constant, passed once as
// 3 floats, and 55 without Russian roulette, whose draw is then not read);
// the TPU kernel's [C, R/128, 128] packing and 1024-ray padding are not
// carried over. The light table is staged once per block in shared
// memory, where every thread reading the same light row is a broadcast.
//
// What bounds it: bytes, then latency. About 250 bytes move per ray against
// a few hundred flops of shading (more on hair rays: the automaton's trig
// and exp), so at the fur patch's 262,144-ray wavefront the kernel is near
// the memory rate when the hair branch does not diverge within a warp.
// Branches follow each lane's own material, as in the full-bounce kernel.
//
// Built without --use_fast_math (see full_bounce.cu); native trig replaces
// the Cephes forms of the TPU kernel, so values move by ulps against the
// JAX package and the tests compare with per-field gates.

#include <cuda_runtime.h>

#include "shade_core.cuh"

// Per-ray input and output pointers; the field order is that of
// ops/cuda/shade.py SHADE_IN_FIELDS / SHADE_OUT_FIELDS.
struct ShadeIn {
  const float *origin, *direction, *radiance, *color, *theta_i, *prev_pdf;
  const int* flags;
  const float* hit_t;
  const unsigned char* hit_valid;
  const float *hit_pos, *hit_normal, *fib_u, *fib_v, *fib_w;
  const float *diffuse, *specular, *volume, *emission, *ior, *transparency, *reflectivity,
      *roughness, *hair_alpha, *hair_beta;
  const int *bsdf_id, *shader_id;
  const float *env_color, *env_ambient, *u_bsdf, *u_pick, *u_light, *u_hairp, *u_rr;
};

struct ShadeOut {
  float *origin, *direction, *radiance, *color, *theta_i, *prev_pdf;
  int* flags;
  float *shadow_o, *shadow_d, *shadow_tmax, *direct_rgb;
};

namespace {

using namespace sc;  // float3 operators

constexpr int BLOCK = 128;

template <bool kHair>
__global__ void __launch_bounds__(BLOCK) shade_kernel(int n_rays, ShadeIn in, ShadeOut out,
                                                      const float* __restrict__ lights,
                                                      sc::Cfg cfg, bool hair_p_random,
                                                      bool env_per_ray) {
  extern __shared__ float s_lights[];
  for (int k = threadIdx.x; k < cfg.n_lights * sc::LIGHT_COLS; k += blockDim.x)
    s_lights[k] = lights[k];
  __syncthreads();

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  sc::PathState st;
  st.origin = sc::ld3(in.origin + 3 * i);
  st.direction = sc::ld3(in.direction + 3 * i);
  st.radiance = sc::ld3(in.radiance + 3 * i);
  st.color = sc::ld3(in.color + 3 * i);
  st.flags = in.flags[i];
  st.theta_i = in.theta_i[i];
  st.prev_pdf = in.prev_pdf[i];

  sc::Hit hit;
  hit.t = in.hit_t[i];
  hit.valid = in.hit_valid[i] != 0;
  hit.pos = sc::ld3(in.hit_pos + 3 * i);
  hit.normal = sc::ld3(in.hit_normal + 3 * i);

  sc::Mat mp;
  mp.diffuse = sc::ld3(in.diffuse + 3 * i);
  mp.specular = sc::ld3(in.specular + 3 * i);
  mp.volume = sc::ld3(in.volume + 3 * i);
  mp.emission = sc::ld3(in.emission + 3 * i);
  mp.ior = in.ior[i];
  mp.transparency = in.transparency[i];
  mp.reflectivity = in.reflectivity[i];
  mp.roughness = in.roughness[i];
  mp.bsdf_id = in.bsdf_id[i];
  mp.shader_id = in.shader_id[i];
  mp.hair_alpha = in.hair_alpha[i];
  mp.hair_beta = in.hair_beta[i];

  sc::Uniforms un;
  un.bsdf1 = in.u_bsdf[2 * i];
  un.bsdf2 = in.u_bsdf[2 * i + 1];
  un.pick = in.u_pick[i];
  un.light1 = in.u_light[2 * i];
  un.light2 = in.u_light[2 * i + 1];
  un.rr = cfg.rr ? in.u_rr[i] : 0.0f;

  sc::Fiber fib;
  float u_hairp = 0.0f;
  if (kHair) {
    fib.u = sc::ld3(in.fib_u + 3 * i);
    fib.v = sc::ld3(in.fib_v + 3 * i);
    fib.w = sc::ld3(in.fib_w + 3 * i);
    u_hairp = in.u_hairp[i];
  }

  float3 env_color = sc::ld3(in.env_color + (env_per_ray ? 3 * i : 0));
  sc::Shadow sh = sc::shade_bounce_core<kHair>(st, hit, mp, env_color,
                                               sc::ld3(in.env_ambient), s_lights, un, cfg, fib,
                                               u_hairp, hair_p_random);

  sc::st3(out.origin + 3 * i, st.origin);
  sc::st3(out.direction + 3 * i, st.direction);
  sc::st3(out.radiance + 3 * i, st.radiance);
  sc::st3(out.color + 3 * i, st.color);
  out.theta_i[i] = st.theta_i;
  out.prev_pdf[i] = st.prev_pdf;
  out.flags[i] = st.flags;
  sc::st3(out.shadow_o + 3 * i, sh.o);
  sc::st3(out.shadow_d + 3 * i, sh.d);
  out.shadow_tmax[i] = sh.tmax;
  sc::st3(out.direct_rgb + 3 * i, sh.direct_rgb);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int shade_launch(int n_rays, const ShadeIn* in, const ShadeOut* out,
                            const float* lights, int n_lights, int mis, int rr, int rr_gate,
                            float clamp_throughput, unsigned bsdfs_present, int has_hair,
                            int hair_p_random, int env_per_ray, void* stream) {
  sc::Cfg cfg;
  cfg.n_lights = n_lights;
  cfg.mis = mis != 0;
  cfg.rr = rr != 0;
  cfg.rr_gate = rr_gate != 0;
  cfg.clamp_throughput = clamp_throughput;
  cfg.bsdfs_present = bsdfs_present;
  size_t smem = sizeof(float) * static_cast<size_t>(n_lights) * sc::LIGHT_COLS;
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int grid = (n_rays + BLOCK - 1) / BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_hair)
    shade_kernel<true><<<grid, BLOCK, smem, s>>>(n_rays, *in, *out, lights, cfg,
                                                 hair_p_random != 0, env_per_ray != 0);
  else
    shade_kernel<false><<<grid, BLOCK, smem, s>>>(n_rays, *in, *out, lights, cfg,
                                                  hair_p_random != 0, env_per_ray != 0);
  return static_cast<int>(cudaGetLastError());
}
