// Per-bounce shading body as CUDA __device__ functions, one thread per ray.
//
// Twin of models/shade_core.py (plain torch) and port of
// ba_pathtracing_fur_tpu/models/shade_core.py::shade_bounce_core: after the
// scene traversal, one bounce does the analytic light hits, env/light
// termination (MIS power weight), the NEE light pick and sample (emitting a
// shadow ray and the unoccluded direct term), the surface BSDF sample and
// the throughput/flag/ray update. Same epsilons and quirks as the reference:
// ids outside `bsdfs_present` fall through to Lambert, a grazing wi zeroes
// the reflectance, the light argmin is strict `<` (first light wins ties),
// and a quad light tests (v0,v1,v3) then (v2,v3,v1), the second overwriting.
//
// The JAX body is compute-all-select (Mosaic has no branches); here each
// lane branches on its own material and on each light's kind (uniform across
// the block). Native acosf/asinf/atan2f replace the Cephes forms. The
// Marschner/d'Eon hair automaton (models/fur.py twins, Bsdf.cpp:465-1051)
// sits behind the compile-time switch `kHair` of shade_bounce_core: the
// full-bounce kernel instantiates it without hair, the shade kernel
// (shade.cu) with and without.
//
// Build without --use_fast_math: approximate division and denormal flush
// would move results against the 1.19e-7 determinant threshold. The shade
// kernel (shade.cu) is built with -fmad=false, so its products and sums
// round as the plain version's separate ops do: with FMA contraction its
// hair paths drifted from the plain version's over a render's samples. The
// full-bounce kernel keeps contraction on, and its values move by ulps
// against the plain version. The CUDA transcendentals still differ from the
// CPU's by an ulp, which is why the tests compare with image gates, not bit
// equality.
#pragma once

#include <cuda_runtime.h>

namespace sc {

constexpr float EPS = 1e-7f;
constexpr float INF = 3.4e38f;
constexpr float TRI_EPS = 1.1920929e-7f;
constexpr float PI = 3.14159265358979323846f;
constexpr float INV_PI = 0.318309886183790671538f;
constexpr float RAD2DEG = 57.295779513082320876798f;
constexpr float DEG2RAD = 0.017453292519943295769f;
constexpr float DELTA_EPS = 1e-3f;

enum { BSDF_LAMBERT = 0, BSDF_SPECULAR_REFLECTION = 1, BSDF_SPECULAR_TRANSMISSION = 2,
       BSDF_GLOSSY = 3, BSDF_GLASS = 4, BSDF_MILK_GLASS = 5,
       BSDF_LAMBERT_TRANSMISSION = 6, BSDF_EMISSION = 7, BSDF_TRANSPARENT = 8,
       BSDF_MARSCHNER_HAIR = 9, BSDF_DEON_HAIR = 10 };
enum { LIGHT_POINT = 0, LIGHT_QUAD = 1, LIGHT_SPOT = 2, LIGHT_SUN = 3 };
enum { SHADER_SIMPLE = 0, SHADER_MARSCHNER_HAIR = 1 };
enum { MATFLAG_TRANSPARENT_BOUNCE = 1, MATFLAG_SPECULAR_BOUNCE = 2,
       MATFLAG_EMISSIVE_BOUNCE = 4, MATFLAG_CYLINDER_T_BOUNCE = 8,
       MATFLAG_CYLINDER_TR_BOUNCE = 16 };

constexpr int LIGHT_COLS = 29;  // kind color3 pos3 dir3 radius const lin quad verts12 inner outer area
constexpr int MAT_COLS = 20;    // diffuse3 specular3 volume3 emission3 ior transp refl rough bsdf shader alpha beta

// ---------------------------------------------------------------------------
// float3 arithmetic
// ---------------------------------------------------------------------------

__device__ __forceinline__ float3 f3(float x, float y, float z) { return make_float3(x, y, z); }
__device__ __forceinline__ float3 f3(float s) { return make_float3(s, s, s); }
__device__ __forceinline__ float3 ld3(const float* p) { return make_float3(p[0], p[1], p[2]); }
__device__ __forceinline__ void st3(float* p, float3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
__device__ __forceinline__ float3 operator+(float3 a, float3 b) { return f3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ float3 operator-(float3 a, float3 b) { return f3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ float3 operator-(float3 a) { return f3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float3 operator*(float3 a, float3 b) { return f3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ float3 operator*(float3 a, float s) { return f3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float3 operator*(float s, float3 a) { return a * s; }
__device__ __forceinline__ float3 operator/(float3 a, float s) { return f3(a.x / s, a.y / s, a.z / s); }
// dot and cross round as the plain version's torch ops do on the card:
// `(a * b).sum(-1)` adds the three products as (x + z) + y, and
// torch.linalg.cross's kernel contracts each component's first product into
// an FMA, a1 b2 - a2 b1 = fma(a1, b2, -(a2 b1)) (measured bit for bit on
// the H100). Thin fibers put many hits at grazing angles, where an ulp of
// a dot decides a branch (same_side of the NEE's evaluate_light).
__device__ __forceinline__ float dot(float3 a, float3 b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}
__device__ __forceinline__ float3 cross(float3 a, float3 b) {
  return f3(__fmaf_rn(a.y, b.z, -(a.z * b.y)), __fmaf_rn(a.z, b.x, -(a.x * b.z)),
            __fmaf_rn(a.x, b.y, -(a.y * b.x)));
}
__device__ __forceinline__ float length(float3 v) { return sqrtf(fmaxf(dot(v, v), 1e-20f)); }
__device__ __forceinline__ float3 normalize(float3 v) { return v / fmaxf(length(v), EPS); }
__device__ __forceinline__ bool is_zero(float3 v) { return v.x == 0.0f && v.y == 0.0f && v.z == 0.0f; }
__device__ __forceinline__ float max3(float3 v) { return fmaxf(v.x, fmaxf(v.y, v.z)); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

__device__ __forceinline__ float3 reflect(float3 i, float3 n) { return i - n * (2.0f * dot(i, n)); }

// glm::refract; the zero vector on total internal reflection
__device__ __forceinline__ float3 refract(float3 i, float3 n, float eta) {
  float cos_i = dot(n, i);
  float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  if (k < 0.0f) return f3(0.0f);
  return i * eta - n * (eta * cos_i + sqrtf(fmaxf(k, 1e-12f)));
}

// GLSL faceforward: n if dot(nref, i) < 0 else -n
__device__ __forceinline__ float3 faceforward(float3 n, float3 i, float3 nref) {
  return dot(nref, i) < 0.0f ? n : -n;
}

// Light::orthonormalBase
__device__ __forceinline__ void orthonormal_basis(float3 n, float3& s, float3& t) {
  if (fabsf(n.x) > fabsf(n.y)) {
    float inv = 1.0f / sqrtf(fmaxf(n.x * n.x + n.z * n.z, EPS));
    s = f3(-n.z * inv, 0.0f, n.x * inv);
  } else {
    float inv = 1.0f / sqrtf(fmaxf(n.y * n.y + n.z * n.z, EPS));
    s = f3(0.0f, n.z * inv, -n.y * inv);
  }
  t = cross(n, s);
}

// Math::localToWorldNormal (not the Light frame: the branch differs)
__device__ __forceinline__ float3 local_to_world_normal(float3 l, float3 n) {
  float3 s = normalize(n.y * n.y > n.x * n.x ? f3(0.0f, n.z, -n.y) : f3(-n.z, 0.0f, n.x));
  float3 t = normalize(cross(n, s));
  return s * l.x + t * l.y + n * l.z;
}

// ---------------------------------------------------------------------------
// Sampling and Fresnel (core/sampling.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dielectric_fresnel(float cos_theta, float eta_i, float eta_t) {
  float cos_i = clampf(cos_theta, -1.0f, 1.0f);
  if (!(cos_i > 0.0f)) { float tmp = eta_i; eta_i = eta_t; eta_t = tmp; }
  cos_i = fabsf(cos_i);
  float sin_i = sqrtf(fmaxf(1e-12f, 1.0f - cos_i * cos_i));
  float sin_t = eta_i / eta_t * sin_i;
  if (sin_t >= 1.0f) return 1.0f;
  float cos_t = sqrtf(fmaxf(1e-12f, 1.0f - sin_t * sin_t));
  auto safe = [](float x) { return fabsf(x) < EPS ? (x < 0.0f ? -EPS : EPS) : x; };
  float rparl = (eta_t * cos_i - eta_i * cos_t) / safe(eta_t * cos_i + eta_i * cos_t);
  float rperp = (eta_i * cos_i - eta_t * cos_t) / safe(eta_i * cos_i + eta_t * cos_t);
  return 0.5f * (rparl * rparl + rperp * rperp);
}

__device__ __forceinline__ float3 cosine_sample_hemisphere(float u1, float u2) {
  float ox = 2.0f * u1 - 1.0f, oy = 2.0f * u2 - 1.0f;
  float dx = 0.0f, dy = 0.0f;
  if (!(ox == 0.0f && oy == 0.0f)) {
    bool use_x = fabsf(ox) > fabsf(oy);
    float r = use_x ? ox : oy;
    float theta = use_x ? (PI / 4.0f) * (oy / ox) : PI / 2.0f - (PI / 4.0f) * (ox / oy);
    dx = r * cosf(theta);
    dy = r * sinf(theta);
  }
  return f3(dx, dy, sqrtf(fmaxf(1.0f - dx * dx - dy * dy, 0.0f)));
}

__device__ __forceinline__ float3 uniform_sphere_sample(float u1, float u2) {
  float phi = u2 * 2.0f * PI;
  float cos_t = 2.0f * u1 - 1.0f;
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  return f3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t);
}

__device__ __forceinline__ float3 sample_angle(float u1, float u2, float max_angle) {
  float phi = u1 * 2.0f * PI;
  float cos_t = 1.0f - u2 * (1.0f - cosf(max_angle));
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  return f3(cosf(phi) * sin_t, sinf(phi) * sin_t, cos_t);
}

// ---------------------------------------------------------------------------
// Table rows
// ---------------------------------------------------------------------------

struct Light {
  int kind;
  float3 color, position, direction;
  float radius, const_att, lin_att, quad_att;
  float3 v0, v1, v2, v3;
  float inner_angle, outer_angle, area;
};

__device__ __forceinline__ Light load_light(const float* r) {
  Light li;
  li.kind = static_cast<int>(r[0]);
  li.color = ld3(r + 1); li.position = ld3(r + 4); li.direction = ld3(r + 7);
  li.radius = r[10]; li.const_att = r[11]; li.lin_att = r[12]; li.quad_att = r[13];
  li.v0 = ld3(r + 14); li.v1 = ld3(r + 17); li.v2 = ld3(r + 20); li.v3 = ld3(r + 23);
  li.inner_angle = r[26]; li.outer_angle = r[27]; li.area = r[28];
  return li;
}

__device__ __forceinline__ bool area_like(const Light& li) {
  return li.kind == LIGHT_QUAD || li.kind == LIGHT_POINT;
}

struct Mat {
  float3 diffuse, specular, volume, emission;
  float ior, transparency, reflectivity, roughness;
  int bsdf_id, shader_id;
  float hair_alpha, hair_beta;
};

__device__ __forceinline__ Mat load_mat(const float* r) {
  Mat m;
  m.diffuse = ld3(r); m.specular = ld3(r + 3); m.volume = ld3(r + 6); m.emission = ld3(r + 9);
  m.ior = r[12]; m.transparency = r[13]; m.reflectivity = r[14]; m.roughness = r[15];
  m.bsdf_id = static_cast<int>(r[16]); m.shader_id = static_cast<int>(r[17]);
  m.hair_alpha = r[18]; m.hair_beta = r[19];
  return m;
}

// ---------------------------------------------------------------------------
// Light math
// ---------------------------------------------------------------------------

__device__ __forceinline__ float distance_attenuation(const Light& li, float dist) {
  if (li.const_att > 0.0f || (li.lin_att > 0.0f && li.quad_att > 0.0f))
    return 1.0f / fmaxf(li.const_att + li.lin_att * dist + li.quad_att * dist * dist, 1e-12f);
  return 1.0f;
}

// Möller-Trumbore against one triangle (ops/intersect._tri_t): strict
// |det| > eps and t > eps.
__device__ __forceinline__ bool tri_t(float3 o, float3 d, float3 a, float3 b, float3 c, float& t) {
  float3 e1 = b - a, e2 = c - a;
  float3 p = cross(d, e2);
  float det = dot(e1, p);
  if (!(fabsf(det) > TRI_EPS)) return false;
  float inv_det = 1.0f / det;
  float3 tv = o - a;
  float u = dot(tv, p) * inv_det;
  float3 q = cross(tv, e1);
  float v = dot(d, q) * inv_det;
  t = dot(e2, q) * inv_det;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > TRI_EPS;
}

// One light's analytic intersection: returns ok, t = INF when not ok.
__device__ __forceinline__ bool light_hit(float3 o, float3 d, const Light& li, float& t) {
  bool ok = false;
  t = INF;
  if (li.kind == LIGHT_POINT) {
    float3 oc = o - li.position;
    float a = dot(d, d);
    float b = 2.0f * dot(d, oc);
    float c = dot(li.position, li.position) + dot(o, o) - 2.0f * dot(o, li.position)
              - li.radius * li.radius;
    float disc = b * b - 4.0f * a * c;
    ok = li.radius * li.radius > 0.0f && !(dot(d, oc) > 0.0f) && disc >= 0.0f;
    if (ok) t = -0.5f * (b + sqrtf(fmaxf(disc, 1e-12f))) / (fabsf(a) < 1e-12f ? 1e-12f : a);
  } else if (li.kind == LIGHT_QUAD) {
    float t1 = INF, t2 = INF;
    bool ok1 = tri_t(o, d, li.v0, li.v1, li.v3, t1);
    bool ok2 = tri_t(o, d, li.v2, li.v3, li.v1, t2);
    ok = ok1 || ok2;
    if (ok) t = ok2 ? t2 : t1;
  } else if (li.kind == LIGHT_SPOT) {
    float3 s_ax, t_ax;
    orthonormal_basis(li.direction, s_ax, t_ax);
    float3 p = cross(d, t_ax);
    float det = dot(s_ax, p);
    if (fabsf(det) > TRI_EPS) {
      float inv_det = 1.0f / det;
      float3 tv = o - li.position;
      float uu = dot(tv, p) * inv_det;
      float3 q = cross(tv, s_ax);
      float vv = dot(d, q) * inv_det;
      float ts = dot(t_ax, q) * inv_det;
      ok = uu * uu + vv * vv <= li.radius * li.radius && ts > TRI_EPS && li.radius > 0.0f;
      if (ok) t = ts;
    }
  }
  return ok;
}

// Radiance seen on hitting the light (sampleLightSource per kind).
__device__ __forceinline__ float3 light_emitted(const Light& li, float3 ray_dir) {
  float cdiv = li.const_att > 0.0f ? li.const_att : 1.0f;
  if (li.kind == LIGHT_POINT) return li.color * (INV_PI / cdiv);
  if (li.kind == LIGHT_SUN) return li.color;
  bool facing = dot(normalize(-ray_dir), li.direction) >= 0.0f;
  return (facing ? li.color : f3(0.0f)) * (INV_PI / cdiv);
}

// A point on the light seen from pos: returns the target, sets attenuation.
__device__ __forceinline__ float3 light_sample_dir(const Light& li, float3 pos, float u1, float u2,
                                                   float& att) {
  if (li.kind == LIGHT_POINT) {
    float3 sphere_pt = uniform_sphere_sample(u1, u2);
    float3 target = li.position + sphere_pt * li.radius;
    float3 dir0 = normalize(li.position - pos);
    float dd = clampf(dot(sphere_pt, -dir0), 0.0f, 1.0f);
    att = dd * distance_attenuation(li, length(target - pos));
    return target;
  }
  if (li.kind == LIGHT_QUAD) {
    float3 x1 = li.v0 + (li.v1 - li.v0) * u1;
    float3 x2 = li.v3 + (li.v2 - li.v3) * u1;
    float3 target = x1 + (x2 - x1) * u2;
    float3 q_dir = target - pos;
    float dd = clampf(dot(normalize(-q_dir), li.direction), 0.0f, 1.0f);
    att = dd * distance_attenuation(li, length(q_dir));
    return target;
  }
  if (li.kind == LIGHT_SPOT) {
    float r = sqrtf(u1) * li.radius;
    float theta = 2.0f * PI * u2;
    float3 s_ax, t_ax;
    orthonormal_basis(li.direction, s_ax, t_ax);
    float3 target = li.position + s_ax * (r * cosf(theta)) + t_ax * (r * sinf(theta));
    float3 s_dir = target - pos;
    float ang = acosf(clampf(dot(normalize(-s_dir), li.direction), -1.0f + 1e-7f, 1.0f - 1e-7f))
                * RAD2DEG;
    float delta = 1.0f - clampf((ang - li.inner_angle)
                                / fmaxf(li.outer_angle - li.inner_angle, 1e-6f), 0.0f, 1.0f);
    float d2 = delta * delta;
    att = d2 * d2 * distance_attenuation(li, length(s_dir));
    return target;
  }
  float3 sun_pt = uniform_sphere_sample(u1, u2) * li.radius - li.direction;  // sun at 1e16
  att = 1.0f;
  return normalize(sun_pt) * 1e16f;
}

// Solid-angle pdf of sampling this light, with the uniform 1/N pick.
__device__ __forceinline__ float light_solid_angle_pdf(const Light& li, int n_lights, float3 dir,
                                                       float dist) {
  float p = 0.0f;
  if (li.kind == LIGHT_QUAD) {
    float cos_l = fabsf(dot(normalize(dir), li.direction));
    p = dist * dist / (fmaxf(li.area, 1e-12f) * fmaxf(cos_l, 1e-4f));
  } else if (li.kind == LIGHT_POINT) {
    float r = fmaxf(li.radius, 1e-6f);
    p = dist * dist / (PI * r * r);
  }
  return p / static_cast<float>(n_lights);
}

__device__ __forceinline__ float power_heuristic(float pf, float pg) {
  float pf2 = pf * pf;
  return pf2 / fmaxf(pf2 + pg * pg, 1e-20f);
}

// ---------------------------------------------------------------------------
// Surface BSDFs (models/bsdf.py)
// ---------------------------------------------------------------------------

struct BsdfSample {
  float3 refl, wo;
  float pdf;
  int flags;
};

__device__ __forceinline__ float abs_dot_safe(float3 a, float3 b) {
  return fmaxf(fabsf(dot(a, b)), EPS);
}

// A cone sample about `axis`, mirrored about the axis when it lands on the
// wrong side of nf (below for reflection, above for transmission).
__device__ __forceinline__ float3 glossy_lobe(float u1, float u2, float roughness, float3 axis,
                                              float3 nf, bool flip_when_below) {
  float rad = (180.0f - (1.0f - roughness) * 180.0f) * DEG2RAD;
  float3 s = sample_angle(u1, u2, rad);
  float3 wo = local_to_world_normal(s, axis);
  float side = dot(wo, nf);
  bool flip = flip_when_below ? side < 0.0f : side > 0.0f;
  return flip ? local_to_world_normal(f3(-s.x, -s.y, s.z), axis) : wo;
}

__device__ inline BsdfSample sample_surface(const Mat& mp, float3 wi, float3 n, float u1, float u2,
                                     int flags, unsigned present_mask) {
  BsdfSample bs;
  int bid = mp.bsdf_id;
  bool in_set = bid >= 1 && bid <= 8
                && (present_mask == 0u || ((present_mask >> bid) & 1u) != 0u);
  if (!in_set) bid = BSDF_LAMBERT;  // the deterministic Lambert fall-through
  bool entering = dot(wi, n) > 0.0f;
  switch (bid) {
    case BSDF_SPECULAR_REFLECTION: {
      bs.wo = reflect(-wi, faceforward(n, -wi, n));
      bs.refl = mp.specular * (1.0f / abs_dot_safe(bs.wo, n));
      bs.pdf = 1.0f;
      bs.flags = flags | MATFLAG_SPECULAR_BOUNCE;
      break;
    }
    case BSDF_SPECULAR_TRANSMISSION: {
      float eta_i = entering ? 1.0f : mp.ior, eta_t = entering ? mp.ior : 1.0f;
      float fresnel = dielectric_fresnel(fabsf(dot(wi, n)), eta_i, eta_t);
      bs.wo = refract(normalize(-wi), faceforward(n, -wi, n), eta_i / eta_t);
      bool refracted = dot(bs.wo, bs.wo) > 0.0f;
      float3 ft = mp.volume * ((1.0f - fresnel) * (eta_i * eta_i) / (eta_t * eta_t));
      bs.refl = refracted ? ft * (1.0f / abs_dot_safe(bs.wo, n)) : f3(0.0f);
      bs.pdf = 1.0f;
      bs.flags = flags | MATFLAG_SPECULAR_BOUNCE | (refracted ? MATFLAG_TRANSPARENT_BOUNCE : 0);
      break;
    }
    case BSDF_GLOSSY: {
      float3 nf = faceforward(n, -wi, n);
      bs.wo = glossy_lobe(u1, u2, mp.roughness, reflect(-wi, nf), nf, true);
      bs.refl = mp.specular * (1.0f / abs_dot_safe(bs.wo, n));
      bs.pdf = 1.0f;
      bs.flags = flags | MATFLAG_SPECULAR_BOUNCE;
      break;
    }
    case BSDF_GLASS:
    case BSDF_MILK_GLASS: {
      float3 win = normalize(wi);
      float eta_i = entering ? 1.0f : mp.ior, eta_t = entering ? mp.ior : 1.0f;
      float fresnel = dielectric_fresnel(fabsf(dot(win, n)), eta_i, eta_t);
      float3 nf = faceforward(n, -win, n);
      float3 refr = refract(-win, nf, eta_i / eta_t);
      bool choose_t = dot(refr, refr) > 0.0f && u2 > fresnel;
      if (choose_t) {
        float3 wo_t = refr;
        if (bid == BSDF_MILK_GLASS)
          wo_t = glossy_lobe(u1, u2, mp.roughness, refr, faceforward(n, -wi, n), false);
        float3 ft = mp.volume * ((1.0f - fresnel) * (eta_i * eta_i) / (eta_t * eta_t));
        bs.wo = wo_t;
        bs.refl = ft * (1.0f / abs_dot_safe(wo_t, n));
        bs.pdf = 1.0f - fresnel;
        bs.flags = flags | MATFLAG_SPECULAR_BOUNCE | MATFLAG_TRANSPARENT_BOUNCE;
      } else {
        float3 wo_r;
        if (bid == BSDF_MILK_GLASS) {
          float3 nf_unnorm = faceforward(n, -wi, n);
          wo_r = glossy_lobe(u1, u2, mp.roughness, reflect(-wi, nf_unnorm), nf_unnorm, true);
        } else {
          wo_r = reflect(-win, nf);
        }
        bs.wo = wo_r;
        bs.refl = mp.specular * (fresnel / abs_dot_safe(wo_r, n));
        bs.pdf = fresnel;
        bs.flags = flags | MATFLAG_SPECULAR_BOUNCE;
      }
      break;
    }
    case BSDF_LAMBERT_TRANSMISSION: {
      float sgn = entering ? -1.0f : 1.0f;
      bs.wo = local_to_world_normal(cosine_sample_hemisphere(u1, u2) * sgn, n);
      bs.pdf = fabsf(dot(bs.wo, n)) * INV_PI;
      bs.refl = bs.pdf == 0.0f ? f3(0.0f) : mp.volume * INV_PI;
      bs.flags = MATFLAG_TRANSPARENT_BOUNCE;
      break;
    }
    case BSDF_EMISSION: {
      bs.refl = f3(1.0f);
      bs.wo = f3(0.0f);
      bs.pdf = 1.0f;
      bs.flags = MATFLAG_EMISSIVE_BOUNCE;
      break;
    }
    case BSDF_TRANSPARENT: {
      bs.wo = -wi;
      bs.refl = mp.volume * (1.0f / abs_dot_safe(bs.wo, n));
      bs.pdf = 1.0f;
      bs.flags = MATFLAG_TRANSPARENT_BOUNCE | MATFLAG_SPECULAR_BOUNCE;
      break;
    }
    default: {  // Lambert
      float sgn = entering ? 1.0f : -1.0f;
      bs.wo = local_to_world_normal(cosine_sample_hemisphere(u1, u2) * sgn, n);
      bs.pdf = fabsf(dot(bs.wo, n)) * INV_PI;
      bs.refl = bs.pdf == 0.0f ? f3(0.0f) : mp.diffuse * INV_PI;
      bs.flags = 0;
      break;
    }
  }
  if (dot(wi, n) == 0.0f) bs.refl = f3(0.0f);  // grazing
  return bs;
}

__device__ __forceinline__ float3 evaluate_light(const Mat& mp, float3 n, float3 wi_light,
                                                 float3 wo_view) {
  bool same_side = dot(wi_light, n) * dot(wo_view, n) > 0.0f;
  bool lambert_like = mp.bsdf_id == BSDF_LAMBERT || mp.bsdf_id == BSDF_MARSCHNER_HAIR;
  bool translucent = mp.bsdf_id == BSDF_LAMBERT_TRANSMISSION;
  bool m = (lambert_like && same_side) || (translucent && !same_side);
  return m ? mp.diffuse * INV_PI : f3(0.0f);
}

__device__ __forceinline__ bool is_delta(const Mat& mp) {
  int bid = mp.bsdf_id;
  bool smooth = bid == BSDF_LAMBERT || bid == BSDF_LAMBERT_TRANSMISSION;
  bool glossy_wide = bid == BSDF_GLOSSY && mp.roughness > DELTA_EPS;
  return !(smooth || glossy_wide);
}

// models/bsdf.eval_pdf: returns f, sets pdf.
__device__ __forceinline__ float3 eval_pdf(const Mat& mp, float3 n, float3 wi_view, float3 wo,
                                           float& pdf) {
  int bid = mp.bsdf_id;
  float3 won = normalize(wo);
  float cos_o = dot(won, n);
  float cos_i = dot(normalize(wi_view), n);
  bool same_side = cos_o * cos_i > 0.0f;
  float abs_cos = fmaxf(fabsf(cos_o), EPS);
  float3 f = f3(0.0f);
  pdf = 0.0f;
  if (bid == BSDF_LAMBERT && same_side) {
    f = mp.diffuse * INV_PI;
    pdf = abs_cos * INV_PI;
  } else if (bid == BSDF_LAMBERT_TRANSMISSION && !same_side) {
    f = mp.volume * INV_PI;
    pdf = abs_cos * INV_PI;
  } else if (bid == BSDF_GLOSSY && mp.roughness > DELTA_EPS && same_side) {
    float3 nf = faceforward(n, -wi_view, n);
    float3 reflected = normalize(reflect(normalize(-wi_view), nf));
    float cos_max = cosf(mp.roughness * 180.0f * DEG2RAD);
    float inv_solid = 1.0f / fmaxf(2.0f * PI * (1.0f - cos_max), 1e-6f);
    if (dot(won, reflected) >= cos_max) {
      f = mp.specular * (inv_solid / abs_cos);
      pdf = inv_solid;
    }
  } else if ((bid == BSDF_MARSCHNER_HAIR || bid == BSDF_DEON_HAIR) && same_side) {
    f = mp.diffuse * INV_PI;
  }
  return f;
}

__device__ __forceinline__ float sample_pdf(const Mat& mp, float3 n, float3 wi_view, float3 wo) {
  float pdf;
  eval_pdf(mp, n, wi_view, wo, pdf);
  return is_delta(mp) ? -1.0f : fmaxf(pdf, 1e-8f);
}

// ---------------------------------------------------------------------------
// Hair automaton (models/shade_core.py: _marschner, _deon, sample_hair)
// ---------------------------------------------------------------------------

constexpr float HAIR_EPS = 1e-6f;  // fur._EPS
constexpr float INV_SQRT_2PI = 0.3989422804014327f;
constexpr float PI3 = 31.00627668029982f;  // pi ** 3

// The fiber frame at the hit: u, v (the fiber axis), w.
struct Fiber {
  float3 u, v, w;
};

struct HairSample {
  float3 refl, wo;
  float pdf;
  int flags;
  float theta_i;
};

// World -> Marschner cylinder space: component 0 is along the fiber axis
// (the reference passes the axes in (V, U, W) order, Bsdf.cpp:482).
__device__ __forceinline__ float3 to_cyl(float3 x, const Fiber& f) {
  return f3(dot(x, f.v), dot(x, f.u), dot(x, f.w));
}

__device__ __forceinline__ float hair_theta(float3 c) {
  return atan2f(sqrtf(fmaxf(c.x * c.x + c.z * c.z, 1e-20f)), c.y);
}

__device__ __forceinline__ float hair_phi(float3 c) {
  bool degenerate = fabsf(c.x) < 1e-12f && fabsf(c.y) < 1e-12f;
  return atan2f(c.x, degenerate ? 1.0f : c.y);
}

// Rodrigues rotation about `axis` (vm.rotate_about_axis).
__device__ __forceinline__ float3 rotate(float3 v, float3 axis, float angle) {
  float c = cosf(angle), s = sinf(angle);
  float3 a = normalize(axis);
  return v * c + cross(a, v) * s + a * (dot(a, v) * (1.0f - c));
}

__device__ __forceinline__ float angle_between(float3 a, float3 b) {
  return acosf(clampf(dot(normalize(a), normalize(b)), -1.0f + 1e-7f, 1.0f - 1e-7f));
}

__device__ __forceinline__ float clip1(float x) { return clampf(x, -1.0f + 1e-6f, 1.0f - 1e-6f); }

__device__ __forceinline__ float safe_div(float a, float b) {
  return a / (fabsf(b) < HAIR_EPS ? (b < 0.0f ? -HAIR_EPS : HAIR_EPS) : b);
}

__device__ __forceinline__ float gauss_pdf(float x, float stddev) {
  float a = x / stddev;
  return INV_SQRT_2PI / stddev * expf(-0.5f * a * a);
}

// Bessel J0 (Abramowitz & Stegun 9.4), as fur.bessel_j0.
__device__ __forceinline__ float bessel_j0(float x) {
  float ax = fabsf(x);
  if (ax < 8.0f) {
    float y = fminf(x * x, 64.0f);
    float p1 = 57568490574.0f + y * (-13362590354.0f + y * (651619640.7f
               + y * (-11214424.18f + y * (77392.33017f + y * -184.9052456f))));
    float q1 = 57568490411.0f + y * (1029532985.0f + y * (9494680.718f
               + y * (59272.64853f + y * (267.8532712f + y))));
    return p1 / q1;
  }
  float z = 8.0f / ax;
  float y2 = z * z;
  float xx = ax - 0.785398164f;
  float p2 = 1.0f + y2 * (-0.1098628627e-2f + y2 * (0.2734510407e-4f
             + y2 * (-0.2073370639e-5f + y2 * 0.2093887211e-6f)));
  float q2 = -0.1562499995e-1f + y2 * (0.1430488765e-3f + y2 * (-0.6911147651e-5f
             + y2 * (0.7621095161e-6f + y2 * -0.934935152e-7f)));
  return sqrtf(0.636619772f / ax) * (cosf(xx) * p2 - z * sinf(xx) * q2);
}

// Virtual (Bravais) indices (Bsdf.cpp:542-545).
__device__ __forceinline__ void bravais(float ior, float gamma_i, float& n1, float& n2) {
  float cg = cosf(gamma_i);
  float cg_safe = fabsf(cg) < HAIR_EPS ? HAIR_EPS : cg;
  float sg = sinf(gamma_i);
  float x1 = sqrtf(fmaxf(ior * ior - sg * sg, HAIR_EPS));
  n1 = x1 / cg_safe;
  n2 = ior * ior * cg_safe / x1;
}

// d'Eon longitudinal term M with the reference's mixed radians()/degrees()
// quirk on the R lobe (Bsdf.cpp:993-995) and MSVC _j0.
__device__ __forceinline__ float deon_M(float v, float theta_i, float theta_r, bool radians_quirk) {
  float v_safe = fmaxf(v, HAIR_EPS);
  float x, scale;
  if (radians_quirk) {
    x = (1.0f / v_safe) * DEG2RAD;
    scale = v_safe * RAD2DEG;
  } else {
    x = 1.0f / v_safe;
    scale = v_safe;
  }
  float s = sinf(-theta_i) * sinf(theta_r) / scale;
  float x_pos = fmaxf(x, HAIR_EPS);
  float log_m = -x_pos - logf(fmaxf(1.0f - expf(-2.0f * x_pos), 1e-30f)) - logf(v_safe) + s;
  float bes = bessel_j0(cosf(-theta_i) * cosf(theta_r) / scale);
  return expf(fminf(log_m, 80.0f)) * bes;
}

// d'Eon azimuthal detector: wrapped Gaussian over 21 periods.
__device__ __forceinline__ float deon_detector(float phi, float stddev_deg) {
  float acc = 0.0f;
  for (int k = -10; k <= 10; ++k) acc += gauss_pdf(phi - 2.0f * PI * static_cast<float>(k), stddev_deg);
  return acc;
}

__device__ __forceinline__ float3 exp3(float3 v) { return f3(expf(v.x), expf(v.y), expf(v.z)); }

// The first hit of the walk when it enters the fiber (p_choice 1 or 2).
__device__ __forceinline__ HairSample hair_enter(float3 nin, float3 nf, float ior, int p_choice) {
  HairSample hs;
  hs.refl = f3(0.0f);
  hs.wo = refract(-nin, nf, 1.0f / ior);
  hs.pdf = 1.0f;
  hs.flags = p_choice == 2 ? MATFLAG_CYLINDER_TR_BOUNCE : MATFLAG_CYLINDER_T_BOUNCE;
  hs.theta_i = 0.0f;
  return hs;
}

// The internal-reflection step of TR.
__device__ __forceinline__ HairSample hair_tr(float3 nin, float3 nf) {
  HairSample hs;
  hs.refl = f3(0.0f);
  hs.wo = reflect(-nin, nf);
  hs.pdf = 1.0f;
  hs.flags = MATFLAG_CYLINDER_TR_BOUNCE | MATFLAG_CYLINDER_T_BOUNCE | MATFLAG_SPECULAR_BOUNCE;
  hs.theta_i = 0.0f;
  return hs;
}

// MarschnerHairBSDF::localSample (Bsdf.cpp:465-769): the walk state in the
// flag bits picks R / entry, TT, TR or TRT. Degree-valued alpha/beta are
// fed to radian math, and the TRT lobe is boosted x10, as in the reference.
__device__ inline HairSample marschner_sample(const Mat& mp, float3 nin, float3 n, const Fiber& fb,
                                              int flags, int p_choice) {
  float alpha = mp.hair_alpha, beta = mp.hair_beta;
  float theta_i = hair_theta(to_cyl(nin, fb));
  float3 nf = faceforward(n, -nin, n);
  float gamma_i = angle_between(nin, normalize(n));
  float h = sinf(gamma_i);
  float b1, b2;
  bravais(mp.ior, gamma_i, b1, b2);
  float fresnel = dielectric_fresnel(gamma_i, b1, b2);
  bool t_set = (flags & MATFLAG_CYLINDER_T_BOUNCE) != 0;
  bool tr_set = (flags & MATFLAG_CYLINDER_TR_BOUNCE) != 0;
  HairSample hs;
  if (tr_set && !t_set) return hair_tr(nin, nf);
  if (!t_set && !tr_set) {
    if (p_choice != 0) return hair_enter(nin, nf, mp.ior, p_choice);
    // R
    float3 wo_r = rotate(reflect(-nin, nf), fb.v, -alpha);
    float th_r = hair_theta(to_cyl(wo_r, fb));
    float th_h = 0.5f * (th_r + theta_i), th_d = 0.5f * (th_r - theta_i);
    float pdf_r = gauss_pdf(th_h - alpha, beta);
    float dh_dphi = fabsf(safe_div(-2.0f, sqrtf(fmaxf(1.0f - h * h, HAIR_EPS))));
    float n_r = 0.5f * fresnel * dh_dphi;
    float cd = cosf(th_d);
    float scat = pdf_r * n_r / fmaxf(cd * cd, HAIR_EPS);
    hs.refl = f3(scat);
    hs.wo = wo_r;
    hs.pdf = pdf_r;
    hs.flags = MATFLAG_SPECULAR_BOUNCE;
    hs.theta_i = theta_i;
    return hs;
  }
  float c_tt = asinf(clip1(1.0f / b1));
  float inv_root = safe_div(1.0f, sqrtf(fmaxf(1.0f - h * h, HAIR_EPS)));
  if (t_set && !tr_set) {  // TT exit
    float3 wo = rotate(refract(-nin, nf, 1.0f), fb.v, alpha / 2.0f);
    float th_r = hair_theta(to_cyl(wo, fb));
    float th_h = 0.5f * (th_r + theta_i), th_d = 0.5f * (th_r - theta_i);
    float pdf = gauss_pdf(th_h + alpha / 2.0f, beta / 2.0f);
    float denom = inv_root * (-((24.0f * c_tt) * (1.0f / PI3)) * (gamma_i * gamma_i) +
                              ((6.0f * c_tt) * INV_PI - 2.0f));
    float dh = safe_div(1.0f, fabsf(denom));
    float cos_gamma_t = -2.0f * cosf(asinf(clip1(h / b1)));
    float inv_ctr = 1.0f / fmaxf(cosf(th_r), HAIR_EPS);
    float3 att = exp3(mp.diffuse * inv_ctr * cos_gamma_t) * ((1.0f - fresnel) * (1.0f - fresnel));
    float cd = cosf(th_d);
    hs.refl = att * (0.5f * dh) * (pdf / fmaxf(cd * cd, HAIR_EPS));
    hs.wo = wo;
    hs.pdf = pdf;
    hs.flags = 0;
    hs.theta_i = theta_i;
    return hs;
  }
  // TRT exit
  float3 wo = rotate(refract(-nin, nf, 1.0f), fb.v, 3.0f * alpha / 2.0f);
  float th_r = hair_theta(to_cyl(wo, fb));
  float th_h = 0.5f * (th_r + theta_i), th_d = 0.5f * (th_r - theta_i);
  float pdf = gauss_pdf(th_h + 3.0f * alpha / 2.0f, 2.0f * beta);
  float denom = inv_root * (-((48.0f * c_tt) * (1.0f / PI3)) * (gamma_i * gamma_i) +
                            ((12.0f * c_tt) * INV_PI - 2.0f));
  float dh = safe_div(1.0f, fabsf(denom));
  float gamma_t = asinf(clip1(h / b1));
  float fresnel_exit = dielectric_fresnel(gamma_t, 1.0f / b1, 1.0f / b2);
  float inv_ctr = 1.0f / fmaxf(cosf(th_r), HAIR_EPS);
  float3 e2 = exp3(mp.diffuse * inv_ctr * (-2.0f * cosf(gamma_t)));
  float3 att = (e2 * e2) * ((1.0f - fresnel) * (1.0f - fresnel) * fresnel_exit);
  float cd = cosf(th_d);
  hs.refl = att * (0.5f * dh) * (10.0f * pdf / fmaxf(cd * cd, HAIR_EPS));
  hs.wo = wo;
  hs.pdf = pdf;
  hs.flags = 0;
  hs.theta_i = theta_i;
  return hs;
}

// DEonHairBSDF::localSample (Bsdf.cpp:784-1051): the same walk states with
// d'Eon's energy-conserving longitudinal and azimuthal terms.
__device__ inline HairSample deon_sample(const Mat& mp, float3 nin, float3 n, const Fiber& fb,
                                         int flags, int p_choice) {
  float3 ic = to_cyl(nin, fb);
  float alpha = mp.hair_alpha * DEG2RAD, beta = mp.hair_beta * DEG2RAD;
  float ior = mp.ior;
  float theta_i = hair_theta(ic);
  float phi_i = hair_phi(ic);
  float gamma_i = angle_between(nin, normalize(n));
  float h = sinf(gamma_i);
  float3 nf = faceforward(n, -nin, n);
  bool t_set = (flags & MATFLAG_CYLINDER_T_BOUNCE) != 0;
  bool tr_set = (flags & MATFLAG_CYLINDER_TR_BOUNCE) != 0;
  HairSample hs;
  if (tr_set && !t_set) {
    hs = hair_tr(nin, nf);
    hs.theta_i = theta_i;
    return hs;
  }
  if (!t_set && !tr_set) {
    if (p_choice != 0) {
      hs = hair_enter(nin, nf, ior, p_choice);
      hs.theta_i = theta_i;
      return hs;
    }
    float3 wo_r = rotate(reflect(-nin, nf), fb.v, -alpha);
    float3 rc = to_cyl(wo_r, fb);
    float m_r = deon_M(beta * beta, theta_i, hair_theta(rc), true);
    float d_r = 0.25f * fabsf(cosf(hair_phi(rc) - phi_i / 2.0f));
    float fres = dielectric_fresnel(0.5f * acosf(clip1(dot(nin, normalize(wo_r)))), 1.0f, ior);
    hs.refl = f3(m_r * 0.5f * fres * d_r);
    hs.wo = wo_r;
    hs.pdf = m_r;
    hs.flags = MATFLAG_SPECULAR_BOUNCE;
    hs.theta_i = theta_i;
    return hs;
  }
  bool tt = t_set && !tr_set;  // else TRT
  float lobe_beta = tt ? beta / 2.0f : beta * 2.0f;
  float3 wo = rotate(refract(-nin, nf, 1.0f), fb.v, tt ? alpha / 2.0f : 3.0f * alpha / 2.0f);
  float3 xc = to_cyl(wo, fb);
  float theta_r = hair_theta(xc);
  float theta_d = 0.5f * (theta_r - theta_i);
  float m = deon_M(lobe_beta * lobe_beta, theta_i, theta_r, false);
  float phi = hair_phi(xc) - phi_i;
  float cos_td = cosf(theta_d);
  float sin_td = sinf(theta_d);
  float brav = sqrtf(fmaxf(ior * ior - sin_td * sin_td, HAIR_EPS)) / fmaxf(cos_td, HAIR_EPS);
  float det = deon_detector(phi, lobe_beta * RAD2DEG);
  float fres = dielectric_fresnel(acosf(clip1(cos_td * cosf(gamma_i))), ior, 1.0f);
  float cos_2gt = cosf(2.0f * asinf(clip1(h / brav)));
  float inv_c = 1.0f / fmaxf(cosf(theta_r), HAIR_EPS);
  float3 base = exp3(mp.diffuse * inv_c * (-2.0f * (1.0f + cos_2gt)));
  float3 att = tt ? base * ((1.0f - fres) * (1.0f - fres))
                  : (base * base) * ((1.0f - fres) * (1.0f - fres) * fres);
  hs.refl = att * (m * 0.5f * det);
  hs.wo = wo;
  hs.pdf = m;
  hs.flags = 0;
  hs.theta_i = theta_i;
  return hs;
}

// ---------------------------------------------------------------------------
// The bounce's shade stage
// ---------------------------------------------------------------------------

struct Cfg {
  int n_lights;
  bool mis, rr, rr_gate;  // rr_gate: bounce >= rr_start
  float clamp_throughput;
  unsigned bsdfs_present;  // bit b = bsdf b present; 0 = all
};

// The wavefront state of one ray, updated in place.
struct PathState {
  float3 origin, direction, radiance, color;
  int flags;
  float theta_i, prev_pdf;
};

struct Hit {
  float t;
  bool valid;
  float3 pos, normal;
};

// The draws of a bounce, made beforehand (full_bounce.cu).
struct Uniforms {
  float bsdf1, bsdf2, pick, light1, light2, rr;
  float hairp = 0.0f;  // the hair walk's choice (no hair in the full bounce)
};

// shade_bounce_core reads its draws through these, each on the one branch
// that needs it: u_pick and u_light on a geometry hit with lights, u_bsdf
// on surface BSDFs, u_hairp on hair with hair_p_random, u_rr under RR and
// its gate. A draws type that makes them on demand (shade.cu's, from the
// ray's threefry key) overloads the same five functions.
__device__ __forceinline__ float draw_pick(const Uniforms& u) { return u.pick; }
__device__ __forceinline__ float2 draw_light(const Uniforms& u) {
  return make_float2(u.light1, u.light2);
}
__device__ __forceinline__ float2 draw_bsdf(const Uniforms& u) {
  return make_float2(u.bsdf1, u.bsdf2);
}
__device__ __forceinline__ float draw_hairp(const Uniforms& u) { return u.hairp; }
__device__ __forceinline__ float draw_rr(const Uniforms& u) { return u.rr; }

// The NEE shadow ray and the unoccluded direct term it gates.
struct Shadow {
  float3 o, d;
  float tmax;  // 0 when there is no shadow ray
  float3 direct_rgb;
};

// One bounce after the traversal (models/shade_core.py::shade_bounce_core).
// `lights` holds n_lights rows of LIGHT_COLS floats. With kHair, materials
// of the hair shader take the Marschner/d'Eon automaton in the fiber frame
// `fib` (walk choice from u_hairp when `hair_p_random`); without it the
// function is the hair-free body the full-bounce kernel runs. `u` gives
// the draws (see draw_pick and its siblings above).
template <bool kHair = false, class Draws = Uniforms>
__device__ inline Shadow shade_bounce_core(PathState& st, const Hit& hit, const Mat& mp, float3 env_color,
                                    float3 env_ambient, const float* lights, const Draws& u,
                                    const Cfg& cfg, const Fiber& fib = Fiber{},
                                    bool hair_p_random = false) {
  Shadow sh;
  sh.o = f3(0.0f);
  sh.d = f3(0.0f, 1.0f, 0.0f);
  sh.tmax = 0.0f;
  sh.direct_rgb = f3(0.0f);
  bool do_trace = !is_zero(st.radiance) && !is_zero(st.direction);

  // analytic light intersections (traceRay:185-208), strict < argmin
  float t_light = INF;
  int light_ix = 0;
  for (int l = 0; l < cfg.n_lights; ++l) {
    float tl;
    light_hit(st.origin, st.direction, load_light(lights + l * LIGHT_COLS), tl);
    if (tl < t_light) { t_light = tl; light_ix = l; }
  }
  bool light_wins = cfg.n_lights > 0 && t_light < hit.t;
  bool miss = do_trace && !hit.valid && !light_wins;
  bool hit_light = do_trace && light_wins;
  bool hit_geom = do_trace && hit.valid && !light_wins;

  if (miss) st.color = st.color + env_color * st.radiance;
  if (hit_light) {
    Light li = load_light(lights + light_ix * LIGHT_COLS);
    float3 lrad = light_emitted(li, st.direction);
    if (cfg.mis) {
      float w;
      if (st.prev_pdf <= 0.0f) w = 1.0f;
      else if (area_like(li))
        w = power_heuristic(st.prev_pdf,
                            light_solid_angle_pdf(li, cfg.n_lights, st.direction, t_light));
      else w = 0.0f;
      lrad = lrad * w;
    }
    st.color = st.color + lrad * st.radiance;
  }
  if (miss || hit_light) st.radiance = f3(0.0f);
  if (!hit_geom) return sh;  // the rest only changes geometry-hit rays

  float3 n = hit.normal, pos = hit.pos;
  float3 counter = -normalize(st.direction);

  // NEE (calcDirectLight / calc_direct_light_mis), occlusion by the caller
  float3 direct = f3(0.0f);
  if (cfg.n_lights > 0) {
    int pick = min(static_cast<int>(draw_pick(u) * static_cast<float>(cfg.n_lights)),
                   cfg.n_lights - 1);
    Light lp = load_light(lights + pick * LIGHT_COLS);
    float att;
    float2 ul = draw_light(u);
    float3 target = light_sample_dir(lp, pos, ul.x, ul.y, att);
    float3 direction_l = target - pos;
    float dist = length(direction_l);
    float3 wi = normalize(direction_l);
    float3 contrib, sh_o;
    float t_max;
    if (cfg.mis) {
      sh_o = pos + faceforward(n, -wi, n) * 1e-4f;
      float bpdf;
      float3 f = eval_pdf(mp, n, -normalize(st.direction), wi, bpdf);
      float cos_x = fabsf(dot(wi, n));
      if (area_like(lp)) {
        float p_l = light_solid_angle_pdf(lp, cfg.n_lights, wi, dist);
        float w = power_heuristic(p_l, bpdf);
        contrib = light_emitted(lp, wi) * f * (cos_x * w / fmaxf(p_l, 1e-12f));
      } else {
        contrib = lp.color * f * (att * cos_x * static_cast<float>(cfg.n_lights));
      }
      t_max = dist * (1.0f - 1e-3f);
    } else {
      float3 lightpos = pos + direction_l;
      sh_o = pos + faceforward(n, pos - lightpos, n) * 1e-4f;
      float3 f = evaluate_light(mp, n, wi, -normalize(st.direction));
      contrib = lp.color * f * (att * fabsf(dot(wi, n)));
      t_max = length(lightpos - sh_o);
    }
    // light geometry also occludes (SimpleShader.h:135-144)
    bool light_blocked = false;
    for (int l = 0; l < cfg.n_lights; ++l) {
      if (cfg.mis && l == pick) continue;
      float tl;
      if (light_hit(sh_o, wi, load_light(lights + l * LIGHT_COLS), tl) && tl < t_max)
        light_blocked = true;
    }
    bool has_color = lp.color.x > 0.0f || lp.color.y > 0.0f || lp.color.z > 0.0f;
    if (has_color && !light_blocked) direct = contrib;
    sh.o = sh_o;
    sh.d = wi;
    sh.tmax = t_max;
  }
  sh.direct_rgb = direct * st.radiance;

  // ambient = env_ambient * evaluateLight(n, n) / pi (SimpleShader.h:47)
  float3 amb_rgb = (env_ambient * evaluate_light(mp, n, n, n) * INV_PI) * st.radiance;

  // the surface BSDF sample, or the hair automaton's step on hair materials
  // (without kHair every hair branch folds away at compile time)
  const bool is_hair = kHair && mp.shader_id == SHADER_MARSCHNER_HAIR;
  float hair_theta_i = st.theta_i;
  BsdfSample bs;
  if (is_hair) {
    int p_choice = hair_p_random ? min(static_cast<int>(draw_hairp(u) * 3.0f), 2) : 0;
    float3 nin = normalize(counter);
    HairSample hs = mp.bsdf_id == BSDF_DEON_HAIR
        ? deon_sample(mp, nin, n, fib, st.flags, p_choice)
        : marschner_sample(mp, nin, n, fib, st.flags, p_choice);
    bs.refl = hs.refl;
    bs.wo = hs.wo;
    bs.pdf = hs.pdf;
    bs.flags = hs.flags;
    hair_theta_i = hs.theta_i;
  } else {
    float2 ub = draw_bsdf(u);
    bs = sample_surface(mp, counter, n, ub.x, ub.y, st.flags, cfg.bsdfs_present);
  }
  bool kill = is_zero(bs.refl) || bs.pdf <= 1e-4f || (!cfg.rr && max3(st.radiance) < 0.01f);
  bool emissive = (bs.flags & MATFLAG_EMISSIVE_BOUNCE) != 0;
  bool mid_walk = (bs.flags & (MATFLAG_CYLINDER_T_BOUNCE | MATFLAG_CYLINDER_TR_BOUNCE)) != 0;
  bool specular = (bs.flags & MATFLAG_SPECULAR_BOUNCE) != 0;
  float3 offset = specular ? bs.wo * 1e-4f : faceforward(-1e-4f * n, n, bs.wo);

  float3 rad;
  if (is_hair) {
    // MarschnerHairShader: no NEE or ambient while the walk is inside the
    // fiber, and the throughput passes through unchanged there
    if (mid_walk) {
      sh.direct_rgb = f3(0.0f);
      sh.tmax = 0.0f;
      rad = st.radiance;
    } else {
      st.color = st.color + amb_rgb;
      rad = kill ? f3(0.0f) : st.radiance * bs.refl * (3.0f * fabsf(cosf(hair_theta_i)));
    }
  } else {
    // SimpleShader colour and throughput update
    float3 c = amb_rgb;
    if (emissive && !kill) c = c + mp.emission * st.radiance;
    st.color = st.color + c;
    rad = (kill || emissive)
        ? f3(0.0f)
        : st.radiance * bs.refl * (fabsf(dot(bs.wo, n)) * (1.0f / fmaxf(bs.pdf, 1e-20f)));
  }
  rad = f3(fminf(rad.x, cfg.clamp_throughput), fminf(rad.y, cfg.clamp_throughput),
           fminf(rad.z, cfg.clamp_throughput));
  if (cfg.rr && cfg.rr_gate && !mid_walk) {
    float q = clampf(max3(rad), 0.05f, 1.0f);
    rad = draw_rr(u) >= q ? f3(0.0f) : rad * (1.0f / q);
  }
  st.radiance = rad;

  // continuing rays take the new ray; the hair walk moves its ray (and
  // writes its flags and theta_i) even mid-walk
  if ((!kill && !emissive) || is_hair) {
    st.origin = pos + offset;
    st.direction = bs.wo;
    st.flags = bs.flags;
  }
  if (is_hair) st.theta_i = hair_theta_i;
  if (cfg.mis) st.prev_pdf = is_hair ? -1.0f : sample_pdf(mp, n, counter, bs.wo);
  return sh;
}

}  // namespace sc
