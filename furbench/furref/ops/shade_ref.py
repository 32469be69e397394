# Frozen copy of the plain shade stage of ba_pathtracing_fur_torch/ops/cuda/shade.py
# at commit 24f22d1 (`shade_bounce_ref` and the tables it reads; the call
# counter left out): the benchmark's reference of the shade kernel K1.
"""The shade stage of a fused bounce in plain torch (K1's plain version)."""

from __future__ import annotations

import torch

from ..core import rng
from ..models import bsdf, shade_core as sc
from ..models.shade_core import CoreCfg, CoreLight
from ..scene.types import LightPack, MaterialTable

SHADE_OUT_FIELDS = ("origin", "direction", "radiance", "color", "theta_i", "prev_pdf",
                    "flags", "shadow_o", "shadow_d", "shadow_tmax", "direct_rgb")


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


def shade_bounce_ref(*, origin, direction, radiance, color, flags, theta_i, prev_pdf, hit_t,
                     hit_valid, hit_pos, hit_normal, fib_u, fib_v, fib_w, mat_id, mats_table,
                     keys, bounce: int, env_color, env_ambient, lights_table, n_lights: int,
                     rr_gate: bool, cfg: CoreCfg) -> dict:
    """The shade stage in plain torch -> the CoreOut fields as a dict: the
    bounce's draws of tags 0-4 (`rng.bounce_uniforms`, u_rr only with RR),
    the material rows as the JAX package gathers them (untextured: the
    reference's scenes have no textures), and
    `models/shade_core.shade_bounce_core`."""
    u = rng.bounce_uniforms(keys, bounce, 5 if cfg.rr else 4, 2)  # [tags, R, 2]
    mp = bsdf.gather_rows(mats_table, mat_id)
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
