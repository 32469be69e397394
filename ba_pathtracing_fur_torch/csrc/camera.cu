// The camera wavefront (K7): each pixel's threefry key, its subpixel jitter,
// its camera ray and the ray's initial state, in one launch a sample.
//
// Replaces no TPU kernel: the JAX package's models/pathtracer.py::
// camera_wavefront is plain JAX that XLA fuses. The port's torch chain
// (ops/cuda/camera.py::camera_rays_ref, this kernel's plain version: four
// threefry2x32 passes of masked int64 ops in core/rng.py, then
// core/camera.py::rays_from_pixels and the initial state) ran as ~715 small
// torch launches a pass on the H100, and the card idled while the host
// enqueued them.
// Contract (ops/cuda/camera.py): for each global pixel id p of `pixel_ids`
// and the sample index s, with the base key b read from device memory:
//
//   key     k = fold_in(fold_in(b, s), p)            (core/rng.keys_for_pixels)
//   jitter  draws 0, 1 of fold_in(k, 7)               (bounce_uniform(k, -1, 2, tag=7))
//           or, with qmc, remainder(h + draws 0, 1 of fold_in(fold_in(b, 0x9A3), p), 1)
//           for the sample's Hammersley point h       (core/rng.qmc_jitter)
//   ray     x = (p % w) + jx, y = (p // w) + jy,
//           d = ((bl + (x * ps) * ax) + (y * ps) * ay) - pos, o = pos
//   DoF     with draws 0, 1 of fold_in(k, 8): the thin lens of
//           core/camera.rays_from_pixels
//   state   radiance 1, colour 0, flags 0, theta_i 0, prev_pdf -1
//
// written at slot first + i of the outputs (a sample's slice of the
// wavefront).
//
// What bounds it: bytes. A ray reads its 8 B pixel id and writes 76 B (16 B
// of key, 24 B of o and d, 24 B of radiance and colour, 12 B of flags,
// theta_i and prev_pdf): 88 MB at 1M rays, 0.026 ms at 3.35 TB/s. The
// integer work (five threefry2x32 of 79 operations, seven with DoF) is
// 0.012 ms at 33.5 TOP/s. The design: one thread a ray, the camera's four
// vectors read once a thread through the read-only cache (every thread
// reads the same 48 B), every output written once and coalesced across the
// warp.
//
// Rounding: every output is bit-equal to the torch chain's on the card.
// Built with -fmad=false (kernels/__init__.py SOURCE_FLAGS), so each
// multiply and add rounds on its own as torch's separate ops do, in torch's
// order; a Python scalar is the float torch converts it to (the wrapper
// passes 3 * aperture so rounded, and the Hammersley point as the CPU
// computes it); sqrtf, cosf and sinf are the CUDA math library's, which
// torch's sqrt, cos and sin call for float32; torch.remainder(a, 1) is
// fmodf(a, 1), exact for a in [0, 2); the pixel's coordinates are torch's
// floor division and modulo of the int64 id, converted to float by
// rounding to nearest.

#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int JITTER_TAG = 7, DOF_TAG = 8;  // models/pathtracer.py's bounce -1 tags
constexpr uint32_t QMC_KEY = 0x9A3u;        // core/rng.py::qmc_jitter's fold_in
// the Python scalar 2.0 * math.pi of core/camera.py as torch takes it
constexpr float TWO_PI = static_cast<float>(2.0 * 3.14159265358979323846);

struct Lens {
  const float* position;     // [3]
  const float* bottom_left;  // [3]
  const float* axis_x;       // [3]
  const float* axis_y;       // [3]
  float pixel_size, focus_distance, radius;  // radius: float(3 * aperture)
  int width;
  bool dof;
};

struct Qmc {
  bool on;
  float x, y;  // the sample's Hammersley point
};

struct Out {
  long long* keys;  // [N, 2]
  float* origin;    // [N, 3]
  float* direction;
  float* radiance;
  float* color;
  int* flags;  // [N]
  float* theta_i;
  float* prev_pdf;
};

__device__ __forceinline__ void st3(float* p, float x, float y, float z) {
  p[0] = x;
  p[1] = y;
  p[2] = z;
}

__global__ void __launch_bounds__(THREADS)
    camera_kernel(int n, const long long* __restrict__ base, uint32_t sample,
                  const long long* __restrict__ pixel_ids, Lens cam, Qmc qmc, int first,
                  Out out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint2 b = tf::load_key(base, 0);
  const long long pid = pixel_ids[i];
  const uint32_t pw = static_cast<uint32_t>(pid);  // fold_in takes the id's low 32 bits
  const uint2 k = tf::fold_in(tf::fold_in(b, sample), pw);

  float jx, jy;
  if (qmc.on) {
    const uint2 rk = tf::fold_in(tf::fold_in(b, QMC_KEY), pw);
    jx = fmodf(qmc.x + tf::uniform_at(rk, 0), 1.0f);
    jy = fmodf(qmc.y + tf::uniform_at(rk, 1), 1.0f);
  } else {
    const uint2 jk = tf::bounce_key(k, -1, JITTER_TAG);
    jx = tf::uniform_at(jk, 0);
    jy = tf::uniform_at(jk, 1);
  }

  // torch's // and % on int64: floor division, the remainder takes w's sign
  const long long w = cam.width;
  long long q = pid / w, r = pid - q * w;
  if (r != 0 && ((r < 0) != (w < 0))) {
    q -= 1;
    r += w;
  }
  const float xs = (static_cast<float>(r) + jx) * cam.pixel_size;
  const float ys = (static_cast<float>(q) + jy) * cam.pixel_size;
  float pos[3], ax[3], ay[3], d[3], o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pos[c] = __ldg(cam.position + c);
    ax[c] = __ldg(cam.axis_x + c);
    ay[c] = __ldg(cam.axis_y + c);
    d[c] = ((__ldg(cam.bottom_left + c) + xs * ax[c]) + ys * ay[c]) - pos[c];
    o[c] = pos[c];
  }

  if (cam.dof) {
    const uint2 dk = tf::bounce_key(k, -1, DOF_TAG);
    const float rad = cam.radius * sqrtf(tf::uniform_at(dk, 0));
    const float phi = TWO_PI * tf::uniform_at(dk, 1);
    const float rc = rad * cosf(phi), rs = rad * sinf(phi);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float focus = pos[c] + cam.focus_distance * d[c];
      o[c] = (pos[c] + rc * ax[c]) + rs * ay[c];
      d[c] = focus - o[c];
    }
  }

  const int s = first + i;
  reinterpret_cast<longlong2*>(out.keys)[s] = make_longlong2(k.x, k.y);
  st3(out.origin + 3 * s, o[0], o[1], o[2]);
  st3(out.direction + 3 * s, d[0], d[1], d[2]);
  st3(out.radiance + 3 * s, 1.0f, 1.0f, 1.0f);
  st3(out.color + 3 * s, 0.0f, 0.0f, 0.0f);
  out.flags[s] = 0;
  out.theta_i[s] = 0.0f;
  out.prev_pdf[s] = -1.0f;
}

}  // namespace

// Plain C entry point (loaded with ctypes): one sample's `n_rays` camera
// rays for `pixel_ids` [n_rays] int64, written at slots first ..
// first + n_rays - 1 of the outputs. `base_key` is the [2] int64 key on the
// device; the camera's vectors are [3] float32 on the device. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int camera_launch(int n_rays, const long long* base_key, unsigned sample,
                             const long long* pixel_ids, int width, const float* position,
                             const float* bottom_left, const float* axis_x,
                             const float* axis_y, float pixel_size, float focus_distance,
                             float lens_radius, int use_dof, int qmc, float qmc_x, float qmc_y,
                             int first, long long* keys, float* origin, float* direction,
                             float* radiance, float* color, int* flags, float* theta_i,
                             float* prev_pdf, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const Lens cam = {position,   bottom_left,    axis_x,      axis_y, pixel_size,
                    focus_distance, lens_radius, width,  use_dof != 0};
  const Qmc q = {qmc != 0, qmc_x, qmc_y};
  const Out out = {keys, origin, direction, radiance, color, flags, theta_i, prev_pdf};
  const int grid = (n_rays + THREADS - 1) / THREADS;
  camera_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      n_rays, base_key, sample, pixel_ids, cam, q, first, out);
  return static_cast<int>(cudaGetLastError());
}
