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
// The TPU kernel takes drawn uniforms and gathered material rows, because
// its [C, R/128, 128] blocks have no per-lane table reads and XLA fuses the
// draws into one pass. Here each ray reads its threefry key and its
// material id instead, and the kernel
//   * stages the material and light tables in shared memory once a block
//     and reads the hit's row there (a negative id wraps and one past the
//     end clamps, as the JAX package's jnp gather does);
//   * draws, bit for bit as core/rng.bounce_uniform (threefry.cuh), only
//     what its branch reads: u_pick and u_light on a geometry hit with
//     lights, u_bsdf on surface BSDFs, u_hairp on hair with hair_p_random,
//     u_rr under RR and its gate. Draw j of a tag depends only on counter
//     j, so a draw not made changes no other.
// That takes the eager torch threefry (some 360 launches a bounce) and the
// 12-field gather off the path, and 84 bytes a ray out of the kernel's
// reads. The TPU kernel's packing and 1024-ray padding are not carried
// over: per-ray tensors are read as they are ([R,3] / [R] f32 and i32,
// the hit flag as bytes, the key as two int64 words).
//
// What bounds it: bytes. Up to about 245 bytes move per ray on hair scenes
// (fewer on misses and dead rays, which read no hit fields and no key)
// against 400-800 flops and 200-300 integer operations of threefry
// (ops/cuda/shade.work_ref counts them per branch). Branches follow each
// lane's own material and walk state: on pixel-ordered wavefronts the
// classes come in regions, and grouping a block's rays by shading branch
// measured no gain (PERF.md), so the kernel does not.
//
// Built without --use_fast_math (see full_bounce.cu); native trig replaces
// the Cephes forms of the TPU kernel, so values move by ulps against the
// JAX package and the tests compare with per-field gates.

#include <cuda_runtime.h>

#include "shade_core.cuh"
#include "threefry.cuh"

// Per-ray input and output pointers; the field order is that of
// ops/cuda/shade.py SHADE_IN_FIELDS / SHADE_OUT_FIELDS.
struct ShadeIn {
  const float *origin, *direction, *radiance, *color, *theta_i, *prev_pdf;
  const int* flags;
  const float* hit_t;
  const unsigned char* hit_valid;
  const float *hit_pos, *hit_normal, *fib_u, *fib_v, *fib_w;
  const int* mat_id;
  const long long* keys;
  const float *env_color, *env_ambient;
};

struct ShadeOut {
  float *origin, *direction, *radiance, *color, *theta_i, *prev_pdf;
  int* flags;
  float *shadow_o, *shadow_d, *shadow_tmax, *direct_rgb;
};

namespace {

using namespace sc;  // float3 operators

constexpr int BLOCK = 128;
// the draw tags of a bounce (models/pathtracer.py, JAX pathtracer.py:366-371)
enum { TAG_BSDF = 0, TAG_PICK = 1, TAG_LIGHT = 2, TAG_HAIRP = 3, TAG_RR = 4 };

// One ray's draws at one bounce, made when shade_bounce_core asks for them
// (the overloads of sc::draw_pick and its siblings for this type).
struct KeyDraws {
  uint2 key;
  int bounce;
};

__device__ __forceinline__ float2 draw2(const KeyDraws& d, int tag) {
  uint2 k = tf::bounce_key(d.key, d.bounce, tag);
  return make_float2(tf::uniform_at(k, 0), tf::uniform_at(k, 1));
}
__device__ __forceinline__ float draw1(const KeyDraws& d, int tag) {
  return tf::uniform_at(tf::bounce_key(d.key, d.bounce, tag), 0);
}
__device__ __forceinline__ float draw_pick(const KeyDraws& d) { return draw1(d, TAG_PICK); }
__device__ __forceinline__ float2 draw_light(const KeyDraws& d) { return draw2(d, TAG_LIGHT); }
__device__ __forceinline__ float2 draw_bsdf(const KeyDraws& d) { return draw2(d, TAG_BSDF); }
__device__ __forceinline__ float draw_hairp(const KeyDraws& d) { return draw1(d, TAG_HAIRP); }
__device__ __forceinline__ float draw_rr(const KeyDraws& d) { return draw1(d, TAG_RR); }

// The material row of id `id` in a table of n_mats rows, as jnp indexing
// gathers it: a negative id counts from the end, and the result clamps.
__device__ __forceinline__ int mat_row(int id, int n_mats) {
  if (id < 0) id += n_mats;
  return min(max(id, 0), n_mats - 1);
}

template <bool kHair>
__global__ void __launch_bounds__(BLOCK) shade_kernel(int n_rays, ShadeIn in, ShadeOut out,
                                                      const float* __restrict__ lights,
                                                      const float* __restrict__ mats, int n_mats,
                                                      int bounce, sc::Cfg cfg, bool hair_p_random,
                                                      bool env_per_ray) {
  extern __shared__ float smem[];
  float* s_lights = smem;  // [n_lights, LIGHT_COLS]
  float* s_mats = smem + cfg.n_lights * sc::LIGHT_COLS;  // [n_mats, MAT_COLS]
  for (int k = threadIdx.x; k < cfg.n_lights * sc::LIGHT_COLS; k += blockDim.x)
    s_lights[k] = lights[k];
  for (int k = threadIdx.x; k < n_mats * sc::MAT_COLS; k += blockDim.x) s_mats[k] = mats[k];
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

  sc::Mat mp = sc::load_mat(s_mats + mat_row(in.mat_id[i], n_mats) * sc::MAT_COLS);
  KeyDraws draws{tf::load_key(in.keys, i), bounce};

  sc::Fiber fib;
  if (kHair) {
    fib.u = sc::ld3(in.fib_u + 3 * i);
    fib.v = sc::ld3(in.fib_v + 3 * i);
    fib.w = sc::ld3(in.fib_w + 3 * i);
  }

  float3 env_color = sc::ld3(in.env_color + (env_per_ray ? 3 * i : 0));
  sc::Shadow sh = sc::shade_bounce_core<kHair>(st, hit, mp, env_color, sc::ld3(in.env_ambient),
                                               s_lights, draws, cfg, fib, hair_p_random);

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

// Test-only: the first two draws of tags 0..n_tags-1 of every ray, through
// the same KeyDraws as shade_kernel, into out [n_tags, R, 2] (the layout of
// core/rng.bounce_uniforms(keys, bounce, n_tags, 2)). No path calls it.
__global__ void __launch_bounds__(BLOCK) draws_kernel(int n_rays,
                                                      const long long* __restrict__ keys,
                                                      int bounce, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  int tag = blockIdx.y;
  float2 u = draw2(KeyDraws{tf::load_key(keys, i), bounce}, tag);
  float* o = out + 2 * (static_cast<size_t>(tag) * n_rays + i);
  o[0] = u.x;
  o[1] = u.y;
}

template <bool kHair>
cudaError_t launch_shade(int grid, size_t smem, cudaStream_t s, int n_rays, const ShadeIn& in,
                         const ShadeOut& out, const float* lights, const float* mats, int n_mats,
                         int bounce, const sc::Cfg& cfg, bool hair_p_random, bool env_per_ray) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(shade_kernel<kHair>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  shade_kernel<kHair><<<grid, BLOCK, smem, s>>>(n_rays, in, out, lights, mats, n_mats, bounce, cfg,
                                                hair_p_random, env_per_ray);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int shade_launch(int n_rays, const ShadeIn* in, const ShadeOut* out,
                            const float* lights, int n_lights, const float* mats, int n_mats,
                            int bounce, int mis, int rr, int rr_gate, float clamp_throughput,
                            unsigned bsdfs_present, int has_hair, int hair_p_random,
                            int env_per_ray, void* stream) {
  sc::Cfg cfg;
  cfg.n_lights = n_lights;
  cfg.mis = mis != 0;
  cfg.rr = rr != 0;
  cfg.rr_gate = rr_gate != 0;
  cfg.clamp_throughput = clamp_throughput;
  cfg.bsdfs_present = bsdfs_present;
  size_t smem = sizeof(float) * (static_cast<size_t>(n_lights) * sc::LIGHT_COLS
                                 + static_cast<size_t>(n_mats) * sc::MAT_COLS);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int grid = (n_rays + BLOCK - 1) / BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = has_hair
      ? launch_shade<true>(grid, smem, s, n_rays, *in, *out, lights, mats, n_mats, bounce, cfg,
                           hair_p_random != 0, env_per_ray != 0)
      : launch_shade<false>(grid, smem, s, n_rays, *in, *out, lights, mats, n_mats, bounce, cfg,
                            hair_p_random != 0, env_per_ray != 0);
  return static_cast<int>(e);
}

// Test-only entry point of draws_kernel (see there).
extern "C" int shade_draws_launch(int n_rays, const long long* keys, int bounce, int n_tags,
                                  float* out, void* stream) {
  if (n_rays <= 0 || n_tags <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid((n_rays + BLOCK - 1) / BLOCK, n_tags);
  draws_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(n_rays, keys, bounce, out);
  return static_cast<int>(cudaGetLastError());
}
