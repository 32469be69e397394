"""The port's public helpers against the JAX package's on the CPU, one
parametrised test a module: `core/rng.pixel_keys`; `core/vecmath`'s frame
and homogeneous transforms and `normal_matrix`; `core/sampling.bessel_i0`,
`log_bessel_i0` and `schlick_fresnel`; `ops/intersect.ray_aabb`,
`triangle_interpolate`, `cone_normal` and `cone_texcoord`;
`scene/types.BSDF_ID_TO_NAME`. Inputs come from numpy with a seed; JAX runs
op by op (no jit).

Bit-equal, except where the two libraries take different routes to the same
value, each with its tolerance: `bessel_i0`/`log_bessel_i0` and
`cone_texcoord` within 2 ulp (torch's and XLA's exp, sqrt, log and acos
each differ by up to an ulp; measured 1.55 ulp on I0's large-argument
branch), the 4x4 transforms within 4 ulp of the sum of the |products| of
each coordinate (a matmul: BLAS and XLA sum the 4 products in other
orders), and `normal_matrix` within 1e-5 relative (LAPACK's and XLA's LU
pivot and round differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_pathtracing_fur_torch.core import rng, sampling, vecmath as vm
from ba_pathtracing_fur_torch.ops import intersect
from ba_pathtracing_fur_torch.scene import builtins, types
from ba_pathtracing_fur_tpu.core import rng as jrng, sampling as jsampling, vecmath as jvm
from ba_pathtracing_fur_tpu.ops import intersect as jintersect
from ba_pathtracing_fur_tpu.scene import builtins as jbuiltins, types as jtypes

torch.set_num_threads(2)

F32_ULP = np.finfo(np.float32).eps


def _rs(seed=0):
    return np.random.default_rng(seed)


def _eq(got, want, err=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=err)


def _ulps(got, want, n, err=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = n * F32_ULP * np.abs(want)
    assert np.all(np.abs(got - want) <= tol), (err, np.max(np.abs(got - want) / (tol + 1e-300)))


def _frames(rs, n=256):
    q, _ = np.linalg.qr(rs.normal(size=(n, 3, 3)))
    return [q[:, :, i].astype(np.float32) for i in range(3)]


def _mat4(rs):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rs.normal(size=(3, 3)).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    m[:3, 3] = rs.normal(size=3).astype(np.float32)
    return m


@pytest.mark.parametrize("seed,n_pixels,sample", [(0, 64, 0), (7, 300, 5), (123, 1, 99)])
def test_rng_pixel_keys(seed, n_pixels, sample):
    import jax

    got = rng.pixel_keys(rng.key(seed, "cpu"), n_pixels, sample)
    want = jax.random.key_data(jrng.pixel_keys(jax.random.key(seed), n_pixels, sample))
    assert got.shape == (n_pixels, 2)
    _eq(got.numpy() & 0xFFFFFFFF, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("name", ["world_to_frame", "frame_to_world", "transform_point",
                                  "transform_dir", "normal_matrix"])
def test_vecmath(name):
    rs = _rs(1)
    v = rs.normal(size=(256, 3)).astype(np.float32)
    if name in ("world_to_frame", "frame_to_world"):
        u, w_, x = _frames(rs)
        got = getattr(vm, name)(*(torch.from_numpy(a) for a in (v, u, w_, x)))
        _eq(got.numpy(), getattr(jvm, name)(*(jnp.asarray(a) for a in (v, u, w_, x))), name)
        return
    m = _mat4(rs)
    if name == "normal_matrix":
        got, want = vm.normal_matrix(torch.from_numpy(m)), jvm.normal_matrix(jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
        return
    fn = {"transform_point": "homogeneous_transform_point",
          "transform_dir": "homogeneous_transform_dir"}[name]
    got = getattr(vm, fn)(torch.from_numpy(m), torch.from_numpy(v)).numpy()
    want = np.asarray(getattr(jvm, fn)(jnp.asarray(m), jnp.asarray(v)))
    w = 1.0 if name == "transform_point" else 0.0
    vh = np.concatenate([v, np.full((v.shape[0], 1), w, np.float32)], -1).astype(np.float64)
    terms = (np.abs(vh) @ np.abs(m.astype(np.float64)).T)[:, :3]  # sum of |products|
    assert np.all(np.abs(got - want) <= 4 * F32_ULP * terms), name


@pytest.mark.parametrize("name", ["bessel_i0", "log_bessel_i0", "schlick_fresnel"])
def test_sampling(name):
    rs = _rs(2)
    if name == "schlick_fresnel":
        view = rs.normal(size=(256, 3)).astype(np.float32)
        view /= np.linalg.norm(view, axis=-1, keepdims=True)
        normal = np.tile(np.float32([[0.0, 1.0, 0.0]]), (256, 1))
        ior = rs.uniform(1.0, 2.0, 256).astype(np.float32)
        args = (view, normal, ior, np.float32(1.0))
        got = sampling.schlick_fresnel(*(torch.from_numpy(np.asarray(a)) for a in args))
        want = jsampling.schlick_fresnel(*(jnp.asarray(a) for a in args))
        _eq(got.numpy(), want, name)
        return
    # both branches: the series below 12, the asymptotic form above
    x = np.concatenate([rs.uniform(-12, 12, 500), rs.uniform(12, 80, 100),
                        np.float32([0.0, 1e-3, 12.0, -12.0])]).astype(np.float32)
    got = getattr(sampling, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jsampling, name)(jnp.asarray(x)))
    assert np.all(np.isfinite(got))
    _ulps(got, want, 2, name)


@pytest.mark.parametrize("name", ["ray_aabb", "triangle_interpolate", "cone_normal",
                                  "cone_texcoord"])
def test_intersect(name):
    rs = _rs(3)
    n = 256
    o = rs.normal(size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    if name == "ray_aabb":
        inv_d = (1.0 / d).astype(np.float32)
        lo = rs.uniform(-1, 0, (n, 3)).astype(np.float32)
        hi = lo + rs.uniform(0.1, 1, (n, 3)).astype(np.float32)
        t_max = rs.uniform(0, 5, n).astype(np.float32)
        got = intersect.ray_aabb(*(torch.from_numpy(a) for a in (o, inv_d, lo, hi, t_max)))
        want = jintersect.ray_aabb(*(jnp.asarray(a) for a in (o, inv_d, lo, hi, t_max)))
        assert got[0].any() and not got[0].all()
        for g, w in zip(got, want):
            _eq(g.numpy(), w, name)
        return
    js, _ = jbuiltins.fur_patch(resolution=(4, 4), fibers_per_face=6, fiber_verts=4)
    ts, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=6, fiber_verts=4,
                               device="cpu")
    if name == "triangle_interpolate":
        ids = rs.integers(0, ts.tris.count, n).astype(np.int32)
        point = o + rs.uniform(0, 2, (n, 1)).astype(np.float32) * d
        got = intersect.triangle_interpolate(ts.tris, torch.from_numpy(ids),
                                             *(torch.from_numpy(a) for a in (point, o, d)))
        want = jintersect.triangle_interpolate(js.tris, jnp.asarray(ids),
                                               *(jnp.asarray(a) for a in (point, o, d)))
        for g, w, part in zip(got, want, ("normal", "uv", "barycentrics")):
            _eq(g.numpy(), w, part)
        return
    ids = rs.integers(0, ts.cones.count, n).astype(np.int32)
    point = (np.asarray(js.cones.base)[ids] + 0.01 * rs.normal(size=(n, 3))).astype(np.float32)
    got = getattr(intersect, name)(ts.cones, torch.from_numpy(ids), torch.from_numpy(point))
    want = getattr(jintersect, name)(js.cones, jnp.asarray(ids), jnp.asarray(point))
    if name == "cone_texcoord":
        _ulps(got.numpy(), want, 2, name)
    else:
        _eq(got.numpy(), want, name)


@pytest.mark.parametrize("name", ["BSDF_ID_TO_NAME"])
def test_types(name):
    assert getattr(types, name) == getattr(jtypes, name)
    assert getattr(types, name)[types.BSDF_MARSCHNER_HAIR] == "MarschnerHairBSDF"
