"""The shading kernels of a bounce, each with its plain torch twin.

Counterparts of `ba_pathtracing_fur_tpu/ops/pallas/shade.py`:

  * `shade_bounce_full` (the level-2 pass, `csrc/full_bounce.cu`): for small
    untextured triangle scenes without a BVH (the Cornell class) the whole
    bounce is one pass: the Möller-Trumbore closest hit over the triangle
    table, the barycentric normal, the material row, the shading body
    (`models/shade_core.py`, `csrc/shade_core.cuh`), the NEE shadow any-hit
    over the same table, and the masked add of the NEE term.
    `KERNEL_LAUNCHES` and `REF_CALLS` count which of kernel and twin ran.
  * `shade_bounce` (`csrc/shade.cu`): the shade stage alone, after the
    traversal, for every other scene (fur, BVHs): light hits, NEE (it emits
    the shadow ray and the unoccluded direct term), the surface BSDFs or the
    hair automaton, and the throughput update. It takes each ray's threefry
    key and material id: the kernel draws the bounce's uniforms and reads
    the material row itself, the twin draws with `core/rng.bounce_uniforms`
    and gathers with `models/bsdf.gather_rows`. On a textured scene it also
    takes the hit's uv, the atlas and each material's texture ids
    (`pack_tex_table`): the kernel fetches the textured slots itself, the
    twin with `models/bsdf.fetch_textures`, as the unfused path's
    `gather_materials` does. `SHADE_LAUNCHES` and `SHADE_REF_CALLS` count
    which of kernel and twin ran.

Both dispatch on the device of their tensors: CPU tensors go to the plain
version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ...core import rng, vecmath as vm
from ...models import bsdf, shade_core as sc
from ...models.shade_core import CoreCfg, CoreLight
from ...scene.types import ENV_COLOR, DeviceScene, LightPack, MaterialTable, TrianglePack

MAX_FULL_FUSE_TRIS = 512
T_MIN = 1e-4  # bruteforce closest/any-hit t_min
TRI_COLS, MAT_COLS, LIGHT_COLS = 19, 20, 29
#: shared memory a block of the kernel may use for its tables (H100)
MAX_TABLE_BYTES = 227 * 1024

KERNEL_LAUNCHES = 0
REF_CALLS = 0
SHADE_LAUNCHES = 0
SHADE_REF_CALLS = 0

#: the per-ray tensors of `shade_bounce`, in the field order of the ShadeIn /
#: ShadeOut structs of csrc/shade.cu
SHADE_IN_FIELDS = (
    "origin", "direction", "radiance", "color", "theta_i", "prev_pdf", "flags", "hit_t",
    "hit_valid", "hit_pos", "hit_normal", "fib_u", "fib_v", "fib_w", "mat_id", "keys",
    "env_color", "env_ambient", "uv")
SHADE_OUT_FIELDS = ("origin", "direction", "radiance", "color", "theta_i", "prev_pdf",
                    "flags", "shadow_o", "shadow_d", "shadow_tmax", "direct_rgb")


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


def pack_tex_table(m: MaterialTable) -> torch.Tensor:
    """[M, 6] int32: each material's atlas id of the slots the shading
    consumes (`bsdf.CONSUMED_TEX_SLOTS`), -1 where untextured."""
    return torch.stack([getattr(m, f"{slot}_tex").to(torch.int32)
                        for slot in bsdf.CONSUMED_TEX_SLOTS], dim=1).contiguous()


def tex_slot_mask(tex_slots: tuple) -> int:
    """Bit j set for each slot j of `bsdf.CONSUMED_TEX_SLOTS` in `tex_slots`."""
    return sum(1 << j for j, slot in enumerate(bsdf.CONSUMED_TEX_SLOTS) if slot in tex_slots)


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
    triangles only, at most MAX_FULL_FUSE_TRIS of them, and no BVH."""
    return (scene.tri_bvh is None and scene.cone_bvh is None
            and scene.cones.count == 0
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
    mp = bsdf.material_rows(mats_table[torch.where((mat_id >= 0) & (mat_id < n_mats),
                                                   mat_id, 0)])

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
        raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
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
    # the kernel stages each row twice: the [T,19] rows and its float4 geometry
    table_bytes = 4 * (n_tris * (TRI_COLS + 9) + n_mats * MAT_COLS + n_lights * LIGHT_COLS)
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


# ---------------------------------------------------------------------------
# The shade stage alone (after the traversal)
# ---------------------------------------------------------------------------

def shade_bounce_ref(*, origin, direction, radiance, color, flags, theta_i, prev_pdf, hit_t,
                     hit_valid, hit_pos, hit_normal, fib_u, fib_v, fib_w, mat_id, mats_table,
                     keys, bounce: int, env_color, env_ambient, lights_table, n_lights: int,
                     rr_gate: bool, cfg: CoreCfg, uv=None, textures=None, tex_table=None,
                     tex_slots: tuple = ()) -> dict:
    """The shade stage in plain torch -> the CoreOut fields as a dict: the
    bounce's draws of tags 0-4 (`rng.bounce_uniforms`, u_rr only with RR),
    the material rows as the JAX package gathers them (with the textured
    slots fetched at `uv` when `textures` is given), and
    `models/shade_core.shade_bounce_core`."""
    global SHADE_REF_CALLS
    SHADE_REF_CALLS += 1
    u = rng.bounce_uniforms(keys, bounce, 5 if cfg.rr else 4, 2)  # [tags, R, 2]
    mp = bsdf.gather_rows(mats_table, mat_id)
    if textures is not None:
        ids = tex_table[bsdf.material_index(mat_id, tex_table.shape[0])]
        mp = bsdf.fetch_textures(mp, dict(zip(bsdf.CONSUMED_TEX_SLOTS, ids.unbind(1))), uv,
                                 textures, tex_slots)
    out = sc.shade_bounce_core(
        origin=origin, direction=direction, radiance=radiance, color=color, flags=flags,
        theta_i=theta_i, prev_pdf=prev_pdf, hit_t=hit_t, hit_valid=hit_valid,
        hit_pos=hit_pos, hit_normal=hit_normal, mp=mp,
        env_color=env_color, env_ambient=env_ambient,
        lights=core_lights(lights_table[:n_lights]), u_bsdf1=u[0, :, 0],
        u_bsdf2=u[0, :, 1], u_pick=u[1, :, 0], u_light1=u[2, :, 0], u_light2=u[2, :, 1],
        u_rr=u[4, :, 0] if cfg.rr else None, rr_gate=rr_gate, cfg=cfg, fib_u=fib_u,
        fib_v=fib_v, fib_w=fib_w, u_hairp=u[3, :, 0])
    return {f: getattr(out, f) for f in SHADE_OUT_FIELDS}


class _Ptrs(ctypes.Structure):
    """Base of the ctypes mirrors of ShadeIn / ShadeOut: one pointer a field."""

    @classmethod
    def of(cls, tensors: dict):
        """Null for a field whose tensor is None (the kernel does not read it)."""
        return cls(**{f: None if tensors[f] is None else tensors[f].data_ptr()
                      for f, _ in cls._fields_})


class _ShadeIn(_Ptrs):
    _fields_ = [(f, ctypes.c_void_p) for f in SHADE_IN_FIELDS]


class _ShadeOut(_Ptrs):
    _fields_ = [(f, ctypes.c_void_p) for f in SHADE_OUT_FIELDS]


class _TexIn(ctypes.Structure):
    """The ctypes mirror of csrc/shade.cu's TexIn."""

    _fields_ = [("atlas", ctypes.c_void_p), ("sizes", ctypes.c_void_p),
                ("ids", ctypes.c_void_p), ("n_tex", ctypes.c_int), ("ah", ctypes.c_int),
                ("aw", ctypes.c_int), ("slots", ctypes.c_uint)]


def _tex_in(textures, tex_table, tex_slots, n_mats: int, dev):
    """The kernel's TexIn of a textured scene, and the tensors it points at
    (which the caller keeps alive across the launch)."""
    images = textures.images
    nt, ah, aw = images.shape[:3]
    sizes = textures.sizes
    if sizes is None:  # every texture at the atlas' own size
        sizes = torch.tensor([[ah, aw]], dtype=torch.int32, device=dev).expand(nt, 2)
    sizes = sizes.to(torch.int32).contiguous()
    _check("atlas", images, (nt, ah, aw, 4), torch.float32, dev)
    _check("atlas sizes", sizes, (nt, 2), torch.int32, dev)
    _check("tex_table", tex_table, (n_mats, len(bsdf.CONSUMED_TEX_SLOTS)), torch.int32, dev)
    if nt == 0:
        raise ValueError("shade: a textured scene with an empty atlas")
    tex = _TexIn(atlas=images.data_ptr(), sizes=sizes.data_ptr(), ids=tex_table.data_ptr(),
                 n_tex=nt, ah=ah, aw=aw, slots=tex_slot_mask(tex_slots))
    return tex, (images, sizes, tex_table)


def _shade_bounce_cuda(*, origin, mats_table, bounce: int, n_lights: int, lights_table,
                       rr_gate: bool, cfg: CoreCfg, uv=None, textures=None, tex_table=None,
                       tex_slots: tuple = (), **rays) -> dict:
    from ...kernels import load_library

    global SHADE_LAUNCHES
    dev = origin.device
    r = origin.shape[0]
    f32, i32 = torch.float32, torch.int32
    textured = textures is not None
    ins = dict(rays, origin=origin, uv=uv if textured else None)
    # a constant environment colour ([3], or [R,3] broadcast from it) goes
    # to the kernel as its 3 floats
    env = ins["env_color"]
    env_per_ray = env.dim() == 2 and env.stride(0) != 0
    if not env_per_ray:
        ins["env_color"] = env.reshape(-1, 3)[0].to(dev, f32).contiguous()
    ins["env_ambient"] = ins["env_ambient"].reshape(3).to(dev, f32).contiguous()
    hair_only = () if cfg.has_hair else ("fib_u", "fib_v", "fib_w")  # read on hair only
    ins.update({f: None for f in hair_only})
    vec3 = {"origin", "direction", "radiance", "color", "hit_pos", "hit_normal", "fib_u",
            "fib_v", "fib_w", "env_color"}
    for f in SHADE_IN_FIELDS:
        if f == "env_ambient" or (f == "env_color" and not env_per_ray):
            _check(f, ins[f], (3,), f32, dev)
        elif f not in hair_only and not (f == "uv" and not textured):
            shape = (r, 3) if f in vec3 else (r, 2) if f in ("keys", "uv") else (r,)
            dtype = (i32 if f in ("flags", "mat_id") else torch.int64 if f == "keys"
                     else torch.bool if f == "hit_valid" else f32)
            _check(f, ins[f], shape, dtype, dev)
    n_mats = mats_table.shape[0]
    _check("mats_table", mats_table, (n_mats, MAT_COLS), f32, dev)
    _check("lights_table", lights_table, (lights_table.shape[0], LIGHT_COLS), f32, dev)
    if not (0 <= n_lights <= lights_table.shape[0] and n_mats > 0):
        raise ValueError(f"shade: bad table counts M={n_mats} L={n_lights}")
    table_bytes = 4 * (n_lights * LIGHT_COLS + n_mats * MAT_COLS
                       + (n_mats * len(bsdf.CONSUMED_TEX_SLOTS) if textured else 0))
    if table_bytes > MAX_TABLE_BYTES:
        raise ValueError(f"shade: tables of {table_bytes} B exceed shared memory")
    tex, keep = _tex_in(textures, tex_table, tex_slots, n_mats, dev) if textured \
        else (None, ())

    outs = {f: torch.empty_like(ins[f]) for f in SHADE_OUT_FIELDS if f in ins}
    outs.update(shadow_o=torch.empty_like(origin), shadow_d=torch.empty_like(origin),
                shadow_tmax=torch.empty((r,), dtype=f32, device=dev),
                direct_rgb=torch.empty_like(origin))
    s_in, s_out = _ShadeIn.of(ins), _ShadeOut.of(outs)
    err = load_library().shade_launch(
        ctypes.c_int(r), ctypes.byref(s_in), ctypes.byref(s_out),
        ctypes.c_void_p(lights_table.data_ptr()), ctypes.c_int(n_lights),
        ctypes.c_void_p(mats_table.data_ptr()), ctypes.c_int(n_mats), ctypes.c_int(bounce),
        ctypes.c_int(int(cfg.mis)), ctypes.c_int(int(cfg.rr)), ctypes.c_int(int(rr_gate)),
        ctypes.c_float(cfg.clamp_throughput),
        ctypes.c_uint(bsdfs_present_mask(cfg.bsdfs_present)), ctypes.c_int(int(cfg.has_hair)),
        ctypes.c_int(int(cfg.hair_p_random)), ctypes.c_int(int(env_per_ray)),
        ctypes.byref(tex) if textured else ctypes.c_void_p(None),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    del keep
    if err != 0:
        raise RuntimeError(f"shade kernel launch failed: CUDA error {err}")
    SHADE_LAUNCHES += 1
    return outs


def shade_bounce(*, origin, **kw) -> dict:
    """The shade stage of one bounce after the traversal, from the ray
    state, the hit, each ray's material id (`mat_id` [R] int32, into
    `mats_table` [M, 20]) and threefry key (`keys` [R, 2] int64) at
    `bounce`; on a textured scene also the hit's `uv` [R, 2], the scene's
    `textures` (TextureAtlas), `tex_table` [M, 6] (`pack_tex_table`) and
    `tex_slots`. CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise). Returns the new ray state and the NEE shadow ray
    with its direct term."""
    if origin.device.type == "cpu":
        return shade_bounce_ref(origin=origin, **kw)
    if origin.device.type == "cuda":
        return _shade_bounce_cuda(origin=origin, **kw)
    raise ValueError(f"shade_bounce: no kernel for device {origin.device}")


def kernel_draws(keys: torch.Tensor, bounce: int, n_tags: int) -> torch.Tensor:
    """`[n_tags, R, 2]`: the first two draws of tags 0..n_tags-1 as the
    shade kernel makes them from `keys` [R, 2] int64, for holding them to
    their plain version `rng.bounce_uniforms(keys, bounce, n_tags, 2)`
    (what CPU tensors get) bit for bit. A test and check launch: no path
    calls it."""
    from ...kernels import load_library

    if keys.device.type == "cpu":
        return rng.bounce_uniforms(keys, bounce, n_tags, 2)
    if keys.device.type != "cuda":
        raise ValueError(f"kernel_draws: no kernel for device {keys.device}")
    r = keys.shape[0]
    _check("keys", keys, (r, 2), torch.int64, keys.device)
    out = torch.empty((n_tags, r, 2), dtype=torch.float32, device=keys.device)
    err = load_library().shade_draws_launch(
        ctypes.c_int(r), ctypes.c_void_p(keys.data_ptr()), ctypes.c_int(bounce),
        ctypes.c_int(n_tags), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(keys.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"shade draws kernel launch failed: CUDA error {err}")
    return out


# ---------------------------------------------------------------------------
# The shade kernel's work (for its bound): operations per branch
# ---------------------------------------------------------------------------

#: Operations of csrc/shade_core.cuh, counted by hand per branch in FP32
#: operations: an add, multiply, compare, select, min, max or abs is 1 (an
#: FMA 2); a division, sqrtf or reciprocal DIV_OPS, a sinf, cosf, expf or
#: logf TRIG_OPS, an acosf, asinf or atan2f ATRIG_OPS (the non-fast-math
#: instruction sequences, rounded down).
DIV_OPS, TRIG_OPS, ATRIG_OPS = 4, 8, 16
#: integer operations of one threefry2x32 (csrc/threefry.cuh: 20 rounds of
#: add, rotate and xor, 5 key injections of 3 adds, 4 more) and the extra
#: ones of a draw (xor, shift, or)
THREEFRY_INT_OPS, DRAW_INT_OPS = 79, 3

_D, _T, _A = DIV_OPS, TRIG_OPS, ATRIG_OPS
_DOT, _CROSS = 5, 9
_LEN = _DOT + 1 + _D
_NORM = _LEN + 1 + 3 * _D
_REFLECT = _DOT + 7
_FACEFWD = _DOT + 4
_REFRACT = _DOT + 18 + _D
_ONB = 8 + 2 * _D + _CROSS  # orthonormal_basis
_L2W = 4 + 2 * _NORM + _CROSS + 15  # local_to_world_normal
_FRESNEL = 36 + 5 * _D
_SPHERE = 9 + _D + 2 * _T  # uniform_sphere_sample
_COSHEMI = 15 + 2 * _D + 2 * _T
_ANGLE_SAMPLE = 10 + _D + 3 * _T
_TRI = 59 + _D
_ATT = 8 + _D  # distance_attenuation
_GAUSS = 5 + 2 * _D + _T
_ROTATE = 2 * _T + _NORM + _CROSS + _DOT + 14
_THETA = 4 + _D + _A  # hair_theta
_PHI = 3 + _A
_CYL = 3 * _DOT
_ANGLE = 2 * _NORM + _DOT + 2 + _A  # angle_between
_SAFE_DIV = 3 + _D
_BESSEL = 28 + _D
_DEON_M = 12 + 4 * _T + 2 * _D + _BESSEL + 2 * _T
_DETECTOR = 21 * (_GAUSS + 3)
# light kinds 0 point, 1 quad, 2 spot, 3 sun
_LIGHT_HIT = (48 + 2 * _D, 2 * _TRI + 2, 49 + _D + _ONB + 2 * _CROSS, 3)
_LIGHT_EMIT = (4, _NORM + 13, _NORM + 13, 0)
_LIGHT_PDF = (9 + 2 * _D, _NORM + 11 + 2 * _D, 0, 0)  # light_solid_angle_pdf
_LIGHT_SAMPLE = (  # light_sample_dir
    _SPHERE + 9 + _NORM + 7 + _LEN + 3 + _ATT + 1,
    33 + _NORM + 7 + _LEN + _ATT + 1,
    3 + _D + _ONB + 16 + 2 * _T + 3 + _NORM + 7 + _A + 9 + _D + 2 + _LEN + _ATT,
    _SPHERE + 6 + _NORM + 3)
_POWER = 4 + _D
# surface BSDF samples by id (sample_surface), the grazing test included
_SURFACE = (_COSHEMI + 3 + _L2W + 6 + _D + 4,  # Lambert
            _FACEFWD + _REFLECT + 10 + _D,  # specular reflection
            _FRESNEL + _REFRACT + _NORM + _FACEFWD + 20 + _D,  # specular transmission
            _FACEFWD + _REFLECT + 6 + _ANGLE_SAMPLE + _L2W + 6 + 8 + _D,  # glossy
            _NORM + _FRESNEL + _FACEFWD + _REFRACT + 25 + 2 * _D,  # glass
            _NORM + _FRESNEL + _FACEFWD + _REFRACT + 25 + 2 * _D
            + 6 + _ANGLE_SAMPLE + _L2W + 6,  # milk glass
            _COSHEMI + 3 + _L2W + 6 + _D + 4,  # Lambert transmission
            0,  # emission
            10 + _D)  # transparent
_EVAL_PDF = 2 * _NORM + 2 * _DOT + 4 + 4 + _D
_GLOSSY_PDF = _FACEFWD + 2 * _NORM + _REFLECT + _T + 6 + _D + _DOT
# the hair walk by state: 0 R, 1 enter, 2 TR, 3 TT, 4 TRT
_M_COMMON = _CYL + _THETA + _FACEFWD + _ANGLE + _T + (2 * _T + 7 + 3 * _D) + _FRESNEL
_M_EXIT = 4 * _D + 2 * _A + 18 + _ROTATE + _REFRACT + 1 + _CYL + _THETA + 4 + _GAUSS + 12 \
    + 2 * _T + 14 + _D + 3 * _T + 12
_MARSCHNER = (_M_COMMON + _REFLECT + _ROTATE + _CYL + _THETA + 4 + _GAUSS + 2 * _SAFE_DIV
              + 6 + 2 * _T + 4,
              _M_COMMON + _REFRACT + 5,
              _M_COMMON + _REFLECT,
              _M_COMMON + _M_EXIT,
              _M_COMMON + _M_EXIT + _D + _A + 2 + _FRESNEL + 6)
_D_COMMON = _CYL + _THETA + _PHI + _ANGLE + _T + _FACEFWD
_D_EXIT = 1 + _ROTATE + _REFRACT + 1 + _CYL + _THETA + 2 + _DEON_M + _PHI + 1 + 2 * _T \
    + 13 + 2 * _D + _DETECTOR + _T + 3 + _A + _FRESNEL + 7 + _D + _A + _T + 13 + _D + 3 * _T \
    + 15
_DEON = (_D_COMMON + _REFLECT + _ROTATE + _CYL + _DEON_M + _THETA + _PHI + 3 + _T
         + _NORM + _DOT + 3 + _A + _FRESNEL + 4,
         _D_COMMON + _REFRACT + 5,
         _D_COMMON + _REFLECT,
         _D_COMMON + _D_EXIT,
         _D_COMMON + _D_EXIT + 3)
#: operations of one bilinear fetch (csrc/shade.cu fetch_bilinear): the
#: floor-mods, the texel coordinates and weights, then 9 a channel (two
#: lerps along x, one along y); a scalar slot adds its length (7 + a root)
_FETCH_COORDS, _FETCH_CHANNEL, _FETCH_LENGTH = 20, 9, 7 + _D
#: ray classes of `branch_classes`
DEAD, MISS, LIGHT_HIT, SURFACE, MARSCHNER, DEON = 0, 1, 2, 8, 20, 25
HAIR_STATES = ("R", "enter", "TR", "TT", "TRT")


def branch_classes(kw: dict) -> torch.Tensor:
    """The shading branch of every ray of `shade_bounce`'s inputs `kw`, as
    shade_core.cuh takes it: DEAD, MISS, LIGHT_HIT, SURFACE + bsdf id, or
    MARSCHNER / DEON + the walk state (HAIR_STATES; "enter" is the first
    step drawn into the fiber under hair_p_random)."""
    cfg = kw["cfg"]
    o, d = kw["origin"], kw["direction"]
    do_trace = (kw["radiance"] != 0.0).any(-1) & (d != 0.0).any(-1)
    t_light = torch.full_like(kw["hit_t"], sc.INF)
    for li in core_lights(kw["lights_table"][:kw["n_lights"]]):
        t_light = torch.minimum(t_light, sc.light_hit(o, d, li)[0])
    light_wins = t_light < kw["hit_t"]
    mp = bsdf.gather_rows(kw["mats_table"], kw["mat_id"])
    present = cfg.bsdfs_present
    bid = mp.bsdf_id.long()
    in_set = (bid >= 1) & (bid <= 8)
    if present:
        in_set &= torch.isin(bid, torch.tensor(present, device=bid.device))
    cls = SURFACE + torch.where(in_set, bid, 0)
    if cfg.has_hair:
        flags = kw["flags"]
        t_set, tr_set = (flags & sc.MATFLAG_CYLINDER_T_BOUNCE) != 0, \
            (flags & sc.MATFLAG_CYLINDER_TR_BOUNCE) != 0
        enter = torch.zeros_like(t_set)
        if cfg.hair_p_random:
            u = rng.bounce_uniform(kw["keys"], kw["bounce"], 1, tag=3)[:, 0]
            enter = (u * 3).to(torch.int32) != 0
        state = torch.where(tr_set & ~t_set, 2, torch.where(
            t_set & ~tr_set, 3, torch.where(t_set & tr_set, 4, torch.where(enter, 1, 0))))
        hair = (mp.shader_id == sc.SHADER_MARSCHNER_HAIR) & kw["hit_valid"]
        cls = torch.where(hair, torch.where(bid == sc.BSDF_DEON_HAIR, DEON, MARSCHNER) + state,
                          cls)
    cls = torch.where(kw["hit_valid"], cls, MISS)
    cls = torch.where(light_wins & (kw["n_lights"] > 0), LIGHT_HIT, cls)
    return torch.where(do_trace, cls, DEAD)


def work_ref(kw: dict, out: dict) -> dict:
    """The work `shade_bounce` must do on these inputs (`out` its plain
    outputs): FP32 operations per branch each ray takes (the per-branch
    counts above; the light loops over this scene's light kinds), the
    integer operations of the draws those branches read (a fold_in a tag,
    a threefry a draw), and the bytes these rays need: the ray state and
    the outputs of every ray once, the hit's t and valid flag of the live
    rays, its point, normal, material id, key and fiber frame of the
    geometry hits (a dead ray's or a miss's result does not depend on
    them), the tables once; on a textured scene also the uv of the
    geometry hits, and for each of their textured slots the fetch's
    operations and its 4 texels (RGB of a colour slot, RGBA of a scalar).
    `all_bytes` count every per-ray input of every ray; `old_bytes` are
    those of the interface before the kernel drew and gathered itself (the
    12 material fields and the draws per ray in place of the key and the
    id)."""
    cfg = kw["cfg"]
    cls = branch_classes(kw)
    r = cls.shape[0]
    lights = core_lights(kw["lights_table"][:kw["n_lights"]])
    kinds = [li.kind for li in lights]
    n_l = len(lights)
    live = cls != DEAD
    geom = cls >= SURFACE
    hair = cls >= MARSCHNER
    counts = torch.bincount(cls, minlength=DEON + 5).tolist()
    loop = sum(_LIGHT_HIT[k] + 2 for k in kinds)
    flops = int(live.sum()) * (6 + loop + 4) + counts[MISS] * 6
    # light hits: the emitted radiance of the nearest light (and its MIS weight)
    if counts[LIGHT_HIT]:
        t_best = torch.full((r,), sc.INF, device=cls.device)
        best = torch.zeros((r,), dtype=torch.long, device=cls.device)
        for l, li in enumerate(lights):
            t = sc.light_hit(kw["origin"], kw["direction"], li)[0]
            best = torch.where(t < t_best, l, best)
            t_best = torch.minimum(t, t_best)
        for l, k in enumerate(kinds):
            n = int(((cls == LIGHT_HIT) & (best == l)).sum())
            flops += n * (_LIGHT_EMIT[k] + 6 + ((_POWER + _LIGHT_PDF[k]) if cfg.mis else 0))
    n_geom = int(geom.sum())
    # every geometry hit: -normalize(direction), ambient, the throughput,
    # colour and ray update, the clamp
    flops += n_geom * (_NORM + 24 + 40 + 3)
    picks = torch.zeros((r,), dtype=torch.long, device=cls.device)
    if n_l:
        u = rng.bounce_uniform(kw["keys"], kw["bounce"], 1, tag=1)[:, 0]
        picks = torch.clamp((u * n_l).long(), max=n_l - 1)
        nee = (2 * _FACEFWD + 6 + _EVAL_PDF + _NORM + 6) if cfg.mis \
            else (3 + _FACEFWD + 6 + 15 + _NORM + 12 + 3 + _LEN)
        for l, k in enumerate(kinds):
            n = int((geom & (picks == l)).sum())
            pdf = (_LIGHT_PDF[k] + _POWER + _LIGHT_EMIT[k] + 13) if cfg.mis and k in (0, 1) \
                else 10
            flops += n * (3 + _LIGHT_SAMPLE[k] + 3 + _LEN + _NORM + nee + (pdf if cfg.mis else 0)
                          + loop + 9)
    for b, c in enumerate(_SURFACE):
        n = counts[SURFACE + b]
        flops += n * (c + 6 + ((_EVAL_PDF + 4 + (_GLOSSY_PDF if b == 3 else 0))
                               if cfg.mis else 0))
    for s in range(5):
        flops += (counts[MARSCHNER + s] * _MARSCHNER[s] + counts[DEON + s] * _DEON[s]
                  + (counts[MARSCHNER + s] + counts[DEON + s]) * (_NORM + 20))
    mid_walk = hair & (((cls - MARSCHNER) % 5 == 1) | ((cls - MARSCHNER) % 5 == 2))
    rr_rays = int((geom & ~mid_walk).sum()) if (cfg.rr and kw["rr_gate"]) else 0
    flops += rr_rays * 12
    # the draws these branches read: (fold_in + draws) threefry calls a tag
    tf, draws = 0, 0
    if n_l:
        tf, draws = tf + 5 * n_geom, draws + 3 * n_geom  # u_pick (1), u_light (2)
    n_surf = int((geom & ~hair).sum())
    tf, draws = tf + 3 * n_surf, draws + 2 * n_surf  # u_bsdf
    if cfg.hair_p_random:
        n_hair = int(hair.sum())
        tf, draws = tf + 2 * n_hair, draws + n_hair  # u_hairp
    tf, draws = tf + 2 * rr_rays, draws + rr_rays  # u_rr
    int_ops = tf * THREEFRY_INT_OPS + draws * DRAW_INT_OPS
    tex_bytes, fetches = 0, 0
    if kw.get("textures") is not None:
        ids = kw["tex_table"][bsdf.material_index(kw["mat_id"], kw["tex_table"].shape[0])]
        for j, slot in enumerate(bsdf.CONSUMED_TEX_SLOTS):
            if slot not in kw["tex_slots"]:
                continue
            n = int((geom & (ids[:, j] >= 0)).sum())
            color = slot in bsdf.COLOR_TEX_SLOTS
            fetches += n
            flops += n * (_FETCH_COORDS + (3 if color else 4) * _FETCH_CHANNEL
                          + (0 if color else _FETCH_LENGTH))
            tex_bytes += n * 4 * (3 if color else 4) * 4
        tex_bytes += n_geom * 8 + kw["tex_table"].numel() * 4  # uv, the id table

    def nb(*xs):
        return sum(x.numel() * x.element_size() for x in xs if x is not None)

    def row(f):  # bytes of one ray's row of input f
        return kw[f].numel() * kw[f].element_size() // r

    state = ["origin", "direction", "radiance", "color", "theta_i", "prev_pdf", "flags"]
    on_live = ["hit_t", "hit_valid"]
    on_geom = ["hit_pos", "hit_normal", "mat_id", "keys"]
    if cfg.has_hair:
        on_geom += ["fib_u", "fib_v", "fib_w"]
    env = kw["env_color"]
    env = env if env.dim() == 2 and env.stride(0) != 0 else env.reshape(-1, 3)[0]
    once = nb(*(kw[f] for f in state), env, kw["env_ambient"].reshape(-1)[:3],
              kw["lights_table"][:kw["n_lights"]], kw["mats_table"], *out.values())
    n_bytes = once + int(live.sum()) * sum(map(row, on_live)) \
        + n_geom * sum(map(row, on_geom)) + tex_bytes
    all_bytes = once + r * sum(map(row, on_live + on_geom)) + tex_bytes
    old = nb(kw["mat_id"], kw["keys"])
    new = r * 4 * (12 + 8 + 5 + (1 if cfg.has_hair else 0) + (1 if cfg.rr else 0))
    return dict(flops=flops, int_ops=int_ops, bytes=n_bytes, all_bytes=all_bytes,
                old_bytes=all_bytes - nb(kw["mats_table"]) - old + new, threefry=tf,
                draws=draws, fetches=fetches, tex_bytes=tex_bytes,
                classes={name: counts[c] for name, c in (
                    ("dead", DEAD), ("miss", MISS), ("light", LIGHT_HIT))} | {
                    f"surface_{b}": counts[SURFACE + b] for b in range(9) if counts[SURFACE + b]}
                | {f"{h}_{HAIR_STATES[s]}": counts[base + s] for h, base in (
                    ("marschner", MARSCHNER), ("deon", DEON)) for s in range(5)
                    if counts[base + s]})
