"""The level-2 full-bounce pass: one CUDA kernel per bounce, with its twin.

Counterpart of `ba_pathtracing_fur_tpu/ops/pallas/shade.py::
shade_bounce_full`. For small untextured triangle scenes without a BVH (the
Cornell class), the whole bounce is one pass: the Möller-Trumbore closest
hit over the triangle table, the barycentric normal, the material row, the
shading body (`models/shade_core.py`, `csrc/shade_core.cuh`), the NEE shadow
any-hit over the same table, and the masked add of the NEE term.

`shade_bounce_full` dispatches on the device of its tensors: CPU tensors
go to `shade_bounce_full_ref` (plain torch), CUDA tensors launch
`csrc/full_bounce.cu` or raise. `KERNEL_LAUNCHES` and `REF_CALLS` count
which of the two ran.
"""

from __future__ import annotations

import ctypes

import torch

from ...core import vecmath as vm
from ...models import shade_core as sc
from ...models.shade_core import CoreCfg, CoreLight, CoreMat
from ...scene.types import ENV_COLOR, DeviceScene, LightPack, MaterialTable, TrianglePack

MAX_FULL_FUSE_TRIS = 512
T_MIN = 1e-4  # bruteforce closest/any-hit t_min
TRI_COLS, MAT_COLS, LIGHT_COLS = 19, 20, 29
#: shared memory a block of the kernel may use for its tables (H100)
MAX_TABLE_BYTES = 227 * 1024

KERNEL_LAUNCHES = 0
REF_CALLS = 0


# ---------------------------------------------------------------------------
# Tables (the same columns as the JAX package's pack_*_smem)
# ---------------------------------------------------------------------------

def pack_lights_table(lights: LightPack) -> torch.Tensor:
    """[L, 29] f32: kind color3 pos3 dir3 radius const lin quad verts12
    inner outer area (the quad's bilinear-patch area, for MIS)."""
    v = lights.verts.to(torch.float32)  # [L,4,3]

    def norm(x):
        return torch.sqrt((x * x).sum(-1))

    a1 = 0.5 * norm(torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 3] - v[:, 0], dim=-1))
    a2 = 0.5 * norm(torch.linalg.cross(v[:, 1] - v[:, 2], v[:, 3] - v[:, 2], dim=-1))
    area = torch.clamp(a1 + a2, min=1e-12)
    col = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    return torch.cat([col(lights.kind), lights.color, lights.position, lights.direction,
                      col(lights.radius), col(lights.const_att), col(lights.lin_att),
                      col(lights.quad_att), v.reshape(v.shape[0], 12),
                      col(lights.inner_angle), col(lights.outer_angle), area[:, None]],
                     dim=1).contiguous()


def pack_tris_table(tris: TrianglePack) -> torch.Tensor:
    """[T, 19] f32: v0, e1 = v1 - v0, e2 = v2 - v0, n0, n1, n2, mat_id."""
    return torch.cat([tris.v0, tris.v1 - tris.v0, tris.v2 - tris.v0, tris.n0, tris.n1,
                      tris.n2, tris.mat_id.to(torch.float32)[:, None]], dim=1).contiguous()


def pack_mats_table(m: MaterialTable) -> torch.Tensor:
    """[M, 20] f32: diffuse3 specular3 volume3 emission3 ior transparency
    reflectivity roughness bsdf_id shader_id hair_alpha hair_beta."""
    col = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    return torch.cat([m.diffuse, m.specular, m.volume, m.emission, col(m.ior),
                      col(m.transparency), col(m.reflectivity), col(m.roughness),
                      col(m.bsdf_id), col(m.shader_id), col(m.hair_alpha),
                      col(m.hair_beta)], dim=1).contiguous()


def core_lights(table: torch.Tensor) -> list[CoreLight]:
    """CoreLights from the rows of a [L, 29] light table."""
    out = []
    for row in table.tolist():
        vec = lambda c: torch.tensor(row[c:c + 3], device=table.device)  # noqa: E731
        out.append(CoreLight(
            kind=int(row[0]), color=vec(1), position=vec(4), direction=vec(7),
            radius=row[10], const_att=row[11], lin_att=row[12], quad_att=row[13],
            v0=vec(14), v1=vec(17), v2=vec(20), v3=vec(23), inner_angle=row[26],
            outer_angle=row[27], area=row[28], has_color=any(c > 0.0 for c in row[1:4])))
    return out


def full_fuse_eligible(scene: DeviceScene) -> bool:
    """Whether the level-2 pass covers the scene: untextured, hair-free
    triangles only, at most MAX_FULL_FUSE_TRIS of them."""
    return (scene.cones.count == 0
            and 0 < scene.tris.count <= MAX_FULL_FUSE_TRIS
            and scene.textures is None
            and (scene.env.kind == ENV_COLOR or scene.env.texture is None)
            and not scene.has_hair)


def bsdfs_present_mask(present: tuple) -> int:
    """Bit b set for each bsdf id b in `present`; 0 means all."""
    mask = 0
    for b in present:
        mask |= 1 << int(b)
    return mask


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------

def tri_grid(o, d, table, t_min, t_max):
    """Candidate hits of every ray against every triangle row of `table`
    (the arithmetic of `_tri_scalar_t`): `[R, T]` (t, valid, u, v)."""
    o, d = o[:, None, :], d[:, None, :]
    v0, e1, e2 = table[None, :, 0:3], table[None, :, 3:6], table[None, :, 6:9]
    p = vm.cross(d, e2)
    det = vm.dot(e1, p)
    near_zero = det.abs() < 1.1920929e-7
    inv_det = 1.0 / torch.where(near_zero, 1.0, det)
    tv = o - v0
    u = vm.dot(tv, p) * inv_det
    q = vm.cross(tv, e1)
    v = vm.dot(d, q) * inv_det
    t = vm.dot(e2, q) * inv_det
    valid = (~near_zero & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min) & (t < t_max[:, None]))
    return t, valid, u, v


def shade_bounce_full_ref(*, origin, direction, radiance, color, flags, theta_i, prev_pdf,
                          mats_table, tris_table, lights_table, env_color3, env_ambient,
                          n_lights: int, n_tris: int, n_mats: int, u_bsdf, u_pick,
                          u_light, u_hairp, u_rr, rr_gate: bool, cfg: CoreCfg) -> dict:
    """One full bounce in plain torch: the `[R, T]` grid brute force, the
    shading body and the shadow any-hit. `u_hairp` is unused: the pass
    carries no hair."""
    global REF_CALLS
    REF_CALLS += 1
    tris = tris_table[:n_tris]
    do_trace = (radiance != 0.0).any(-1) & (direction != 0.0).any(-1)
    t_cap = torch.where(do_trace, sc.INF, 0.0)

    # closest hit: strict t < t_best in table order, so the first row wins ties
    t, valid, u, v = tri_grid(origin, direction, tris, T_MIN, t_cap)
    found = valid.any(-1)
    best = torch.where(valid, t, sc.INF).argmin(-1, keepdim=True)
    t_best = t.gather(-1, best)[:, 0]
    row = torch.where(found[:, None], tris[best[:, 0]], 0.0)
    u_b = torch.where(found, u.gather(-1, best)[:, 0], 0.0)
    v_b = torch.where(found, v.gather(-1, best)[:, 0], 0.0)
    w_b = 1.0 - u_b - v_b
    hit_normal = vm.normalize(row[:, 9:12] * w_b[:, None] + row[:, 12:15] * u_b[:, None]
                              + row[:, 15:18] * v_b[:, None])
    hit_t = torch.where(found, t_best, sc.INF)
    hit_pos = origin + direction * torch.where(found, t_best, 0.0)[:, None]

    # the material row; ids outside the table take row 0, as the one-hot
    # select of the TPU kernel does
    mat_id = row[:, 18].to(torch.int64)
    m = mats_table[torch.where((mat_id >= 0) & (mat_id < n_mats), mat_id, 0)]
    mp = CoreMat(diffuse=m[:, 0:3], specular=m[:, 3:6], volume=m[:, 6:9],
                 emission=m[:, 9:12], ior=m[:, 12], transparency=m[:, 13],
                 reflectivity=m[:, 14], roughness=m[:, 15],
                 bsdf_id=m[:, 16].to(torch.int32), shader_id=m[:, 17].to(torch.int32),
                 hair_alpha=m[:, 18], hair_beta=m[:, 19])

    out = sc.shade_bounce_core(
        origin=origin, direction=direction, radiance=radiance, color=color, flags=flags,
        theta_i=theta_i, prev_pdf=prev_pdf, hit_t=hit_t, hit_valid=found,
        hit_pos=hit_pos, hit_normal=hit_normal, mp=mp, env_color=env_color3,
        env_ambient=env_ambient, lights=core_lights(lights_table[:n_lights]),
        u_bsdf1=u_bsdf[:, 0], u_bsdf2=u_bsdf[:, 1], u_pick=u_pick,
        u_light1=u_light[:, 0], u_light2=u_light[:, 1], u_rr=u_rr, rr_gate=rr_gate,
        cfg=cfg)

    _, shadow_valid, _, _ = tri_grid(out.shadow_o, out.shadow_d, tris, T_MIN, out.shadow_tmax)
    blocked = shadow_valid.any(-1)
    final_color = out.color + torch.where(blocked[:, None], 0.0, out.direct_rgb)
    return dict(origin=out.origin, direction=out.direction, radiance=out.radiance,
                color=final_color, theta_i=out.theta_i, prev_pdf=out.prev_pdf,
                flags=out.flags)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"full_bounce: {name} must be a contiguous {dtype} {shape} "
                         f"tensor on {device}; got {x.dtype} {tuple(x.shape)} on {x.device}")


def _shade_bounce_full_cuda(*, origin, direction, radiance, color, flags, theta_i,
                            prev_pdf, mats_table, tris_table, lights_table, env_color3,
                            env_ambient, n_lights, n_tris, n_mats, u_bsdf, u_pick,
                            u_light, u_rr, rr_gate, cfg: CoreCfg) -> dict:
    from ...kernels import load_library

    global KERNEL_LAUNCHES
    if cfg.has_hair:
        raise NotImplementedError("the full-bounce kernel carries no hair (ROADMAP K1)")
    dev = origin.device
    r = origin.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, x, shape, dt in (
            ("origin", origin, (r, 3), f32), ("direction", direction, (r, 3), f32),
            ("radiance", radiance, (r, 3), f32), ("color", color, (r, 3), f32),
            ("flags", flags, (r,), i32), ("theta_i", theta_i, (r,), f32),
            ("prev_pdf", prev_pdf, (r,), f32), ("u_bsdf", u_bsdf, (r, 2), f32),
            ("u_pick", u_pick, (r,), f32), ("u_light", u_light, (r, 2), f32),
            ("tris_table", tris_table, (tris_table.shape[0], TRI_COLS), f32),
            ("mats_table", mats_table, (mats_table.shape[0], MAT_COLS), f32),
            ("lights_table", lights_table, (lights_table.shape[0], LIGHT_COLS), f32)):
        _check(name, x, shape, dt, dev)
    if cfg.rr:
        _check("u_rr", u_rr, (r,), f32, dev)
    if not (0 < n_tris <= min(tris_table.shape[0], MAX_FULL_FUSE_TRIS)
            and 0 < n_mats <= mats_table.shape[0] and 0 <= n_lights <= lights_table.shape[0]):
        raise ValueError(f"full_bounce: bad table counts T={n_tris} M={n_mats} L={n_lights}")
    table_bytes = 4 * (n_tris * TRI_COLS + n_mats * MAT_COLS + n_lights * LIGHT_COLS)
    if table_bytes > MAX_TABLE_BYTES:
        raise ValueError(f"full_bounce: tables of {table_bytes} B exceed shared memory")

    out = dict(origin=torch.empty_like(origin), direction=torch.empty_like(direction),
               radiance=torch.empty_like(radiance), color=torch.empty_like(color),
               theta_i=torch.empty_like(theta_i), prev_pdf=torch.empty_like(prev_pdf),
               flags=torch.empty_like(flags))
    # env colour then env ambient, read on the device (no host sync)
    env = torch.cat([env_color3.reshape(3), env_ambient.reshape(3)]).to(dev, f32).contiguous()
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    err = load_library().full_bounce_launch(
        ctypes.c_int(r), p(origin), p(direction), p(radiance), p(color), p(flags),
        p(theta_i), p(prev_pdf), p(u_bsdf), p(u_pick), p(u_light),
        p(u_rr) if cfg.rr else ctypes.c_void_p(None),
        p(tris_table), ctypes.c_int(n_tris), p(mats_table), ctypes.c_int(n_mats),
        p(lights_table), ctypes.c_int(n_lights), p(env),
        ctypes.c_int(int(cfg.mis)), ctypes.c_int(int(cfg.rr)), ctypes.c_int(int(rr_gate)),
        ctypes.c_float(cfg.clamp_throughput),
        ctypes.c_uint(bsdfs_present_mask(cfg.bsdfs_present)),
        p(out["origin"]), p(out["direction"]), p(out["radiance"]), p(out["color"]),
        p(out["flags"]), p(out["theta_i"]), p(out["prev_pdf"]),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"full_bounce kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out


def shade_bounce_full(*, origin, u_hairp=None, **kw) -> dict:
    """One full bounce. CPU tensors run the plain version; CUDA tensors
    launch the kernel (or raise). Returns the new RayState fields."""
    if origin.device.type == "cpu":
        return shade_bounce_full_ref(origin=origin, u_hairp=u_hairp, **kw)
    if origin.device.type == "cuda":
        return _shade_bounce_full_cuda(origin=origin, **kw)
    raise ValueError(f"shade_bounce_full: no kernel for device {origin.device}")
