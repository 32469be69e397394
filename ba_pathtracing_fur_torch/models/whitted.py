"""Whitted raytracer with the single-pass closed-form Marschner fur shader.

Counterpart of `ba_pathtracing_fur_tpu/models/whitted.py` (KIRK's
SimpleCPURaytracer, Simple_CPU_Raytracer.cpp). The reference's recursion
trace -> shade -> {refraction, reflection} is a binary tree of weighted
rays; its children combine with `mix`, so the tree is linear in each child
and is evaluated as a lock-step per-ray depth-first walk: each ray holds its
current node and a stack of the deferred reflection siblings (one a level
at most). Each iteration traces and shades one wavefront of current nodes.

The JAX package's `lax.while_loop` is a Python loop here: one host sync an
iteration reads the live lanes, under the same cap of 2^(depth+1)
iterations. A node spawns its refraction child first; the reflection child
is pushed only when both spawn, and a ray without a child pops after the
stack pointer drops. Colour adds in that order, so the sum is the JAX
package's bit for bit where the per-ray arithmetic is.

The reference's quirks stay for parity (do not fix them):

  * `hair_lobes="r"` sums the R lobe only (:755); "all" adds TT and TRT
    with their second and third walls traced through the scene;
  * the Minweight gate's scalar weight multiplies the reflection child's
    colour a second time (:107, 228);
  * the Schlick term uses a hardcoded ior of 1.56 (:543);
  * the hair alpha is given in degrees and used as radians;
  * the nodes trace with t_max = inf (dead lanes 0), so a ray that misses
    everything is a hit on triangle row 0 at t = 3.4e38, as in the JAX
    package: the environment branch is never reached by a live ray.

Every traversal runs through `ops/traverse` (K2 on a flat BVH, K3 on a
two-level one, K5 on a big BVH-less pack; their twins on the CPU). The TT
and TRT traces give the lanes that are not hair t_max = 0: their results are
masked off, and the traversal then skips them. `LAST_QUEUE_LIVE` holds the live
lanes of each iteration of the last walks.

Spans (`utils/profiling`, off unless a profiler records): `whitted` around a
render; `node` around each DFS iteration (its bounce is the iteration's
index; counters `live`, the iteration's live lanes, and `miss`, the live
nodes whose closest hit found nothing: the quirk's rays above); `light`
around `light_shading` (counter `shadow_live`, the shadow rays with
t_max > 0); `lobes` around the TT and TRT traces of `_hair_color` (counter
`lobe_live`, their rays with t_max > 0). The traversal's own spans (`sort`,
`k3`, `k5`, `hit`) nest inside them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import camera as cam_mod, rng, sampling, vecmath as vm
from ..ops import compact, traverse
from ..scene.types import LIGHT_SUN, SHADER_MARSCHNER_HAIR, DeviceScene
from ..utils import profiling
from . import bsdf as bsdf_mod, fur, shading

MINWEIGHT = 0.01  # CVK_Defs.h:67
RAY_EPS = 1e-4  # Ray.h:9
_NODE = ("o", "d", "W", "w", "lvl")

#: the live lanes at the start of each DFS iteration, one list a
#: `_trace_queue` call, of the last `render_whitted`
LAST_QUEUE_LIVE: list = []


class WhittedConfig(NamedTuple):
    """The JAX package's WhittedConfig: the same fields and defaults."""

    depth: int = 8  # recursion depth, the reference default (CPU_Raytracer.h:75)
    supersamples: int = 1  # N x N subpixel grid (superSampling, :252-280)
    hair_lobes: str = "r"  # "r" (reference parity, :755) | "all" (R + TT + TRT)
    shadows: bool = True
    reflections: bool = True
    refractions: bool = True
    soft_shadows: bool = False  # jittered shadow rays toward light samples
    shadow_samples: int = 4  # visibility samples a light when soft
    dof: bool = False  # thin-lens rays averaged; needs camera.use_dof
    dof_samples: int = 4
    aa: str = "grid"  # subpixel pattern: "grid" | "poisson"
    adaptive: bool = False  # quadtree corner refinement, when supersamples == 1
    adaptive_threshold: float = 0.5
    adaptive_depth: int = 2
    ray_chunk: int = 16384  # sizes chunks in the JAX package only


def _w3(m: torch.Tensor, a, b):
    return torch.where(m[:, None], a, b)


def _bc(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A mask against a tensor of its shape plus trailing axes."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _norm_view_flip(norm, view):
    """The normal flipped toward the viewer (:97-103, :371-376)."""
    m_dot = vm.dot(norm, view)
    flipped = -vm.normalize(m_dot[:, None] * norm)
    return _w3(m_dot.abs() >= 1e-5, flipped, norm)


def _light_target_deterministic(lights, i: int, pos):
    """calcLightdir(randomize=False) for light i: a point, spot or quad
    light aims at its position, a sun at pos - direction * 1e16
    (Light.cpp:463-475)."""
    sun_target = pos - lights.direction[i][None] * 1e16
    return torch.where(lights.kind[i] == LIGHT_SUN, sun_target,
                       lights.position[i].expand_as(pos))


def light_shading(scene: DeviceScene, pos, norm, uv, view, mp, diff_color,
                  cfg: WhittedConfig, key=None, n_alive=None, active=None):
    """SimpleCPURaytracer::lightShading (:80-180): ambient plus every light's
    Phong diffuse and specular, each behind a hard shadow ray (bias 1e-2
    along the view-flipped normal, the unnormalized direction to the light,
    t_max = 1), or, with `cfg.soft_shadows` and a key, the mean visibility
    of `shadow_samples` jittered rays. `active` [R] bool: the lanes that
    shade; the others get t_max = 0 shadow rays. `n_alive` is passed to
    the shadow any-hit."""
    with profiling.span("light"):
        return _light_shading(scene, pos, norm, uv, view, mp, diff_color, cfg, key, n_alive,
                              active)


def _light_shading(scene: DeviceScene, pos, norm, uv, view, mp, diff_color,
                   cfg: WhittedConfig, key, n_alive, active):
    lights = scene.lights
    r = pos.shape[0]
    color = scene.env.ambient * diff_color  # ambient (:88)
    norm_view = _norm_view_flip(norm, view)
    shininess = 1.0 / torch.clamp(mp.roughness, min=1e-3)
    ones = torch.ones((r,), dtype=torch.float32, device=pos.device)
    shadow_t = ones if active is None else torch.where(active, 1.0, 0.0)

    for i in range(lights.count):
        target = _light_target_deterministic(lights, i, pos)
        ldir = target - pos
        n_ldir = vm.normalize(ldir)
        dist = vm.length(ldir)
        idx = torch.full((r,), i, dtype=torch.long, device=pos.device)
        att = shading.distance_attenuation(lights, idx, dist)
        # the angular attenuation of the kind; the light-to-point direction
        # is -n_ldir
        kind = lights.kind[i]
        laxis = lights.direction[i][None]
        dd = torch.clamp(vm.dot(-n_ldir, laxis), 0.0, 1.0)
        ang = torch.rad2deg(torch.acos(torch.clamp(vm.dot(-n_ldir, laxis), -1.0, 1.0)))
        inner, outer = lights.inner_angle[i], lights.outer_angle[i]
        delta = 1.0 - torch.clamp((ang - inner) / torch.clamp(outer - inner, min=1e-6),
                                  0.0, 1.0)
        delta2 = delta * delta
        att = torch.where(kind == 1, att * dd,  # a quad faces the point
                          torch.where(kind == 2, att * (delta2 * delta2), att))  # spot
        lit = (att > 0.0) & (vm.dot(norm_view, n_ldir) >= 0.0)
        # unlit lanes (a miss's point at o + INF d among them) take a finite
        # light direction and no attenuation: their term is dropped below,
        # and finite values keep NaN out of the parameters' backward
        n_ldir, att = _w3(lit, n_ldir, norm), torch.where(lit, att, 0.0)

        cos_phi = torch.clamp(vm.dot(norm, n_ldir), min=0.0)
        direct = cos_phi[:, None] * diff_color * lights.color[i] * att[:, None]
        refl = vm.reflect(n_ldir, norm)
        cos_psi = torch.clamp(vm.dot(refl, view), min=0.0) ** shininess
        direct = direct + (mp.reflectivity * cos_psi)[:, None] * mp.specular \
            * lights.color[i] * att[:, None]
        direct = _w3(lit, direct, 0.0)

        if cfg.shadows:
            origin = pos + 1e-2 * norm_view
            if cfg.soft_shadows and key is not None:
                # mean visibility over jittered light samples: a point or
                # spot within its sphere, a quad within its equivalent
                # radius, a sun within an angular disk at 1e16
                ns = max(1, cfg.shadow_samples)
                scale = torch.where(kind == LIGHT_SUN, 1e14, 1.0) * \
                    torch.clamp(lights.radius[i], min=1e-3)
                lkey = rng.fold_in(key, i)
                vis = torch.zeros((r,), dtype=torch.float32, device=pos.device)
                for s in range(ns):
                    u = rng.uniform(rng.fold_in(lkey, s), (r, 3))
                    sphere = sampling.uniform_sphere_sample(u[:, 0], u[:, 1]) \
                        * (u[:, 2:] ** (1.0 / 3.0))
                    sdir = target + scale * sphere - origin
                    profiling.count_nonzero("shadow_live", shadow_t)
                    blocked = traverse.any_hit(origin, sdir, scene, shadow_t,
                                               n_alive=n_alive)
                    vis = vis + torch.where(blocked, 0.0, 1.0 / ns)
                direct = direct * vis[:, None]
            else:
                sdir = target - origin
                profiling.count_nonzero("shadow_live", shadow_t)
                blocked = traverse.any_hit(origin, sdir, scene, shadow_t, n_alive=n_alive)
                direct = _w3(blocked, 0.0, direct)
        color = color + direct
    return color


def _count_lobe_live(t_max, r: int) -> None:
    """The `lobe_live` counter of one TT or TRT trace: its rays with t_max > 0
    (`t_max` a tensor, or INF for all r rays)."""
    if isinstance(t_max, torch.Tensor):
        profiling.count_nonzero("lobe_live", t_max)
    else:
        profiling.count("lobe_live", r)


def _hair_color(scene: DeviceScene, hit, view_n, mp, cfg: WhittedConfig, is_hair=None):
    """shadeMarschnerHair (:451-760): the closed-form lobes; with
    hair_lobes="all" the TT second wall and the TRT first-wall re-hit are
    traced through the scene from 1e-4 inside the fiber (their closest hit
    is the exiting root). `is_hair` [R]: the lanes whose result is kept;
    the others trace from the origin with t_max = 0 (their own origin may
    be a miss's o + INF d, whose backward would be NaN)."""
    nin, normal = view_n, hit.normal
    if cfg.hair_lobes == "all":
        with profiling.span("lobes"):
            if is_hair is None:
                t_max, live = traverse.INF, lambda o: o
            else:
                t_max = torch.where(is_hair, traverse.INF, 0.0)
                live = lambda o: _w3(is_hair, o, 0.0)  # noqa: E731
            nf = vm.faceforward(normal, -nin, normal)
            t_dir = vm.refract(-nin, nf, 1.0 / mp.ior)
            _count_lobe_live(t_max, nin.shape[0])
            t_hit = traverse.closest_hit(live(hit.position + 1e-4 * t_dir), t_dir, scene,
                                         t_max=t_max)
            t_normal = _w3(t_hit.valid, t_hit.normal, normal)
            t_pos = _w3(t_hit.valid, t_hit.position, hit.position)
            t_nf = vm.faceforward(t_normal, -vm.normalize(t_dir), t_normal)
            tr_dir = vm.reflect(-vm.normalize(t_dir), t_nf)
            _count_lobe_live(t_max, nin.shape[0])
            tr_hit = traverse.closest_hit(live(t_pos + 1e-4 * tr_dir), tr_dir, scene,
                                          t_max=t_max)
            tr_normal = _w3(tr_hit.valid, tr_hit.normal, normal)
    else:
        t_normal = tr_normal = normal
    lobes = fur.marschner_closed_form(mp, nin, normal, hit.fiber_v, t_normal, tr_normal)
    if cfg.hair_lobes == "all":
        return lobes.scat_r + lobes.scat_tt + lobes.scat_trt
    return lobes.scat_r  # the reference sums only R (:755)


def _radical2(i: int) -> float:
    """Van der Corput base 2: the deterministic lens points."""
    x, f, b = 0.0, 0.5, i
    while b:
        x, f, b = x + f * (b & 1), f * 0.5, b >> 1
    return x


def render_whitted(scene: DeviceScene, camera: cam_mod.Camera,
                   cfg: WhittedConfig = WhittedConfig(), key=None) -> torch.Tensor:
    """Deterministic Whitted render -> `[H, W, 3]` on the scene's device.
    `key` seeds the soft-shadow samples (`cfg.soft_shadows`), `rng.key(0)`
    by default."""
    with profiling.span("whitted"):
        return _render_whitted(scene, camera, cfg, key)


def _render_whitted(scene: DeviceScene, camera: cam_mod.Camera, cfg: WhittedConfig,
                    key) -> torch.Tensor:
    dev = scene.device
    LAST_QUEUE_LIVE.clear()
    if key is None and cfg.soft_shadows:
        key = rng.key(0, dev)
    w, h = camera.resolution
    px, py = cam_mod.pixel_grid(camera.resolution, device=dev)
    r = px.shape[0]
    image = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    n_ss = max(1, cfg.supersamples)
    use_dof = cfg.dof and camera.use_dof
    n_dof = max(1, cfg.dof_samples) if use_dof else 1

    def lens_u(s):
        if not use_dof:
            return None
        return torch.tensor([_radical2(s), (s + 0.5) / n_dof], dtype=torch.float32,
                            device=dev).expand(r, 2)

    if cfg.adaptive and n_ss == 1:
        # the else-if flag order of renderPixel (:30-38): supersampling wins;
        # with DoF each lens sample starts one level deep (:246)
        for s in range(n_dof):
            image = image + _adaptive_image(
                scene, px, py, camera, cfg, dof_u=lens_u(s), lvl0=1 if use_dof else 0,
                key=None if key is None else rng.fold_in(key, s)) / n_dof
        return image.reshape(h, w, 3)

    if n_ss == 1:
        offsets = [(0.5, 0.5)]
    elif cfg.aa == "poisson":
        offsets = [tuple(map(float, p)) for p in sampling.poisson_disk_pattern(n_ss * n_ss)]
    else:
        offsets = [((i + 0.5) / n_ss, (j + 0.5) / n_ss)
                   for j in range(n_ss) for i in range(n_ss)]

    for si, (ox, oy) in enumerate(offsets):
        jit = torch.tensor([ox, oy], dtype=torch.float32, device=dev).expand(r, 2)
        for s in range(n_dof):
            o, d = cam_mod.rays_from_pixels(camera, px, py, jit, lens_u(s))
            k_sd = None if key is None else rng.fold_in(key, si * n_dof + s)
            image = image + _trace_queue(scene, o, d, cfg, lvl0=1 if use_dof else 0,
                                         key=k_sd) / (len(offsets) * n_dof)
    return image.reshape(h, w, 3)


def render_whitted_jit(scene: DeviceScene, camera: cam_mod.Camera,
                       cfg: WhittedConfig = WhittedConfig()) -> torch.Tensor:
    """The JAX package's jitted entry point; a plain call here."""
    return render_whitted(scene, camera, cfg)


def _adaptive_image(scene, px, py, camera, cfg: WhittedConfig, dof_u=None, lvl0: int = 0,
                    key=None) -> torch.Tensor:
    """Adaptive supersampling (adaptiveSampling, :275-294): the pixel's four
    corners inset by 1/20, then quadtree refinement where they disagree."""
    step = 1.0 / 20.0
    r = px.shape[0]

    def ray(jx, jy):
        jit = torch.tensor([jx, jy], dtype=torch.float32, device=px.device).expand(r, 2)
        return cam_mod.rays_from_pixels(camera, px, py, jit, dof_u)

    # ray1 = (x1, y2), ray2 = (x2, y2), ray3 = (x1, y1), ray4 = (x2, y1) (:280-288)
    o, d1 = ray(step, 1.0 - step)
    _, d2 = ray(1.0 - step, 1.0 - step)
    _, d3 = ray(step, step)
    _, d4 = ray(1.0 - step, step)
    cs = [_trace_queue(scene, o, dd, cfg, lvl0=lvl0, key=key) for dd in (d1, d2, d3, d4)]
    return _adaptive_square(scene, o, (d1, d2, d3, d4), cs, cfg, 0, lvl0=lvl0, key=key)


def _adaptive_square(scene, o, dirs, colors, cfg: WhittedConfig, depth: int, lvl0: int = 0,
                     active=None, key=None):
    """adaptiveSamplingRecursive (:296-341): where a pairwise corner-colour
    distance passes the threshold, trace the five edge and centre midpoints
    and recurse into the four subsquares; other pixels keep the corners'
    mean. The refining pixels are compacted to the front of each midpoint
    wavefront (`n_alive` their count); `active` masks pixels whose parent
    did not refine."""
    d1, d2, d3, d4 = dirs
    c1, c2, c3, c4 = colors
    flat = (c1 + c2 + c3 + c4) / 4.0
    if depth >= cfg.adaptive_depth:
        return flat
    pairs = ((c1, c2), (c1, c3), (c1, c4), (c2, c3), (c2, c4), (c3, c4))
    diff = torch.stack([torch.linalg.norm(a - b, dim=-1) for a, b in pairs])
    refine = diff.amax(0) > cfg.adaptive_threshold
    if active is not None:
        refine = refine & active

    n1, n2, n3 = (d1 + d2) / 2.0, (d1 + d3) / 2.0, (d1 + d4) / 2.0
    n4, n5 = (d2 + d4) / 2.0, (d3 + d4) / 2.0
    perm, n_alive = compact.compaction_permutation(refine)
    perm = perm.long()
    inv = compact.invert_permutation(perm).long()
    o_c, act_c = o[perm], refine[perm]
    kd = None if key is None else rng.fold_in(key, depth)

    def tr(dd):
        return _trace_queue(scene, o_c, dd[perm], cfg, lvl0=lvl0, active=act_c,
                            n_alive=n_alive, key=kd)[inv]

    cn1, cn2, cn3, cn4, cn5 = tr(n1), tr(n2), tr(n3), tr(n4), tr(n5)
    sub = ((d1, n1, n2, n3), (c1, cn1, cn2, cn3)), ((n1, d2, n3, n4), (cn1, c2, cn3, cn4)), \
        ((n2, n3, d3, n5), (cn2, cn3, c3, cn5)), ((n3, n4, n5, d4), (cn3, cn4, cn5, c4))
    refined = sum(_adaptive_square(scene, o, ds, cs, cfg, depth + 1, lvl0, refine, key)
                  for ds, cs in sub) / 4.0
    return _w3(refine, refined, flat)


def _trace_queue(scene, o, d, cfg: WhittedConfig, lvl0: int = 0, active=None, n_alive=None,
                 key=None):
    """The lock-step per-ray DFS over the weighted recursion tree -> colour
    [R,3].

    A node is (o, d, colour weight W [R,3], scalar trace weight w [R],
    level). W is the product of the mix factors down from the root; w is the
    reference's scalar `weight`, which gates Minweight and multiplies the
    reflection child's colour again (:107, 228). Each iteration every live
    ray traces and shades its node; a spawned refraction child becomes the
    next node, a spawned reflection child is pushed when both spawned (or
    becomes the node when alone), and a ray without a child pops its stack.
    The walk ends when no lane is live, or after 2^(depth+1) iterations."""
    r = o.shape[0]
    depth, dcap = cfg.depth, max(cfg.depth, 1)
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    stack = {"o": torch.zeros((r, dcap, 3), **f32), "d": torch.zeros((r, dcap, 3), **f32),
             "W": torch.zeros((r, dcap, 3), **f32), "w": torch.zeros((r, dcap), **f32),
             "lvl": torch.zeros((r, dcap), dtype=torch.int32, device=dev)}
    cur = {"o": o, "d": d, "W": torch.ones((r, 3), **f32), "w": torch.ones((r,), **f32),
           "lvl": torch.full((r,), lvl0, dtype=torch.int32, device=dev)}
    slot = torch.arange(dcap, dtype=torch.int32, device=dev)[None]
    rows = torch.arange(r, device=dev)
    color = torch.zeros((r, 3), **f32)
    live = torch.ones((r,), dtype=torch.bool, device=dev) if active is None else active
    sp = torch.zeros((r,), dtype=torch.int32, device=dev)
    log = []
    LAST_QUEUE_LIVE.append(log)
    it = 0
    while it < 2 ** (depth + 1):
        n_live = int(live.sum())  # the iteration's one host sync
        if n_live == 0:
            break
        log.append(n_live)
        with profiling.span("node", bounce=it):
            profiling.count("live", n_live)
            kk = None if key is None else rng.fold_in(key, it)
            c, t_child, r_child, spawn_t, spawn_r = _trace_shade(
                scene, cur["o"], cur["d"], cur["W"], cur["w"], cur["lvl"], live, cfg,
                n_alive=n_alive, key=kk)
            color = color + c

            # push the reflection child when both children spawned
            push = live & spawn_t & spawn_r
            mask = push[:, None] & (slot == sp[:, None])  # [R, D] one-hot at sp
            stack = {k: torch.where(_bc(mask, stack[k]), r_child[k][:, None], stack[k])
                     for k in _NODE}
            sp = sp + push.to(torch.int32)

            # continue into a child, the refraction first (the reference's call order)
            cont = live & (spawn_t | spawn_r)
            take_t = live & spawn_t
            child = {k: torch.where(_bc(take_t, t_child[k]), t_child[k], r_child[k])
                     for k in _NODE}

            # no child: pop the deferred sibling, else the ray is done; sp ==
            # dcap reads the last slot, as jnp's clamped gather does (unused)
            pop = ~cont & (sp > 0)
            sp = sp - pop.to(torch.int32)
            top = torch.clamp(sp, max=dcap - 1).long()
            popped = {k: stack[k][rows, top] for k in _NODE}
            cur = {k: torch.where(_bc(cont, child[k]), child[k],
                                  torch.where(_bc(pop, popped[k]), popped[k], cur[k]))
                   for k in _NODE}
            live = cont | pop
        it += 1
    return color


def _trace_shade(scene, o, d, W, w, level, live, cfg: WhittedConfig, n_alive=None, key=None):
    """One wavefront of nodes: trace and shade. `level` [R] int32. ->
    (colour [R,3], refraction child, reflection child, spawn_t [R],
    spawn_r [R]); a child's payload is 0 where it did not spawn."""
    live = live & (W > 0.0).any(-1)
    t_cap = torch.where(live, float("inf"), 0.0)  # dead lanes trace nothing
    hit = traverse.closest_hit(o, d, scene, t_max=t_cap, n_alive=n_alive)
    profiling.count_nonzero("miss", lambda: (live & (hit.t == traverse.INF)).float())
    view = vm.normalize(d)

    # the background (:77)
    miss = live & ~hit.valid
    color = _w3(miss, W * shading.environment_color(scene.env, d), 0.0)

    mp = bsdf_mod.gather_materials(scene.materials, hit.mat_id, hit.uv, scene.textures,
                                   scene.tex_slots)
    is_hair = (mp.shader_id == SHADER_MARSCHNER_HAIR) & hit.valid & live
    is_surf = hit.valid & live & ~is_hair

    # surface shade (:356-449)
    base = light_shading(scene, hit.position, hit.normal, hit.uv, view, mp, mp.diffuse, cfg,
                         key=key, n_alive=n_alive, active=is_surf)
    norm = hit.normal
    norm_view = _norm_view_flip(norm, view)
    angle = vm.angle_between(-view, norm_view)
    r_0 = ((1.0 - 1.56) / (1.0 + 1.56)) ** 2  # the hardcoded 1.56 (:543)
    r_theta = r_0 + (1.0 - r_0) * (1.0 - torch.cos(angle)) ** 5
    fresnel = torch.clamp(mp.reflectivity ** 2 - mp.transparency ** 2
                          + r_theta * mp.reflectivity, 0.0, 1.0)

    can_recurse = level < cfg.depth
    child_lvl = level + 1
    r = o.shape[0]
    zeros3 = torch.zeros((r, 3), dtype=torch.float32, device=o.device)
    zero_child = {"o": zeros3, "d": zeros3, "W": zeros3, "w": torch.zeros_like(w),
                  "lvl": child_lvl}
    t_child, r_child = dict(zero_child), dict(zero_child)
    spawn_t = spawn_r = torch.zeros((r,), dtype=torch.bool, device=o.device)

    if cfg.refractions:
        ft = mp.transparency * (1.0 - fresnel)
        spawn_t = is_surf & can_recurse & (ft * w > MINWEIGHT)
        eta = torch.where(hit.enter, 1.0 / mp.ior, mp.ior)
        tdir = vm.refract(view, _w3(hit.enter, norm, -norm), eta)
        tir = (tdir == 0.0).all(-1) | torch.isnan(tdir[:, 0])
        # total internal reflection reflects instead (:230-232)
        rdir = vm.normalize(vm.reflect(view, norm_view))
        cdir = _w3(tir, rdir, vm.normalize(_w3(tir, rdir, tdir)))
        corig = _w3(tir, hit.position + 1e-2 * norm_view, hit.position + RAY_EPS * cdir)
        # mix(color, volume * (1 * trace(...)), T): the parent keeps 1 - T;
        # refraction() is called with weight 1 (:436), no extra scalar
        child_w = W * mp.volume * mp.transparency[:, None]
        t_child = {"o": corig, "d": cdir, "W": _w3(spawn_t, child_w, 0.0),
                   "w": torch.where(spawn_t, ft, 0.0), "lvl": child_lvl}
        base = _w3(spawn_t, base * (1.0 - mp.transparency)[:, None], base)

    if cfg.reflections:
        spawn_r = is_surf & can_recurse & (fresnel * w > MINWEIGHT)
        rdir = vm.normalize(vm.reflect(view, norm_view))
        rorig = hit.position + 1e-2 * norm_view
        # mix(c1, specular * (w * trace(...)), F): the child's colour is
        # scaled by specular, F and the scalar weight again (:107)
        child_w = W * mp.specular * (fresnel * w)[:, None]
        r_child = {"o": rorig, "d": rdir, "W": _w3(spawn_r, child_w, 0.0),
                   "w": torch.where(spawn_r, fresnel * w, 0.0), "lvl": child_lvl}
        base = _w3(spawn_r, base * (1.0 - fresnel)[:, None], base)

    color = color + _w3(is_surf, W * base, 0.0)
    # hair shade
    hair_c = _hair_color(scene, hit, view, mp, cfg, is_hair=is_hair)
    color = color + _w3(is_hair, W * hair_c, 0.0)
    return color, t_child, r_child, spawn_t, spawn_r


class HairPathRecord(NamedTuple):
    """Every segment of the Marschner walk for a batch of rays (the
    IntersectionTest analog, main.cpp:187-236): each field is [R, 2, 3] =
    (start, end); `valid` [R] marks rays that hit a fiber."""

    in_ray: torch.Tensor  # camera ray to the first fiber hit
    normal0: torch.Tensor  # normal at the first hit
    normal1: torch.Tensor  # normal at the second wall
    out_r: torch.Tensor  # R lobe exit
    out_tt: torch.Tensor  # TT exit at the second wall
    out_trt: torch.Tensor  # TRT exit at the first-wall re-hit
    valid: torch.Tensor  # [R]


def record_hair_paths(scene: DeviceScene, o, d, cfg: WhittedConfig = WhittedConfig(),
                      seg_len: float = 0.05) -> HairPathRecord:
    """Trace rays and record the fur R/TT/TRT walk's geometry
    (getInRays/getNormalRays/getOutRays, Simple_CPU_Raytracer.h:91-101)."""
    hit = traverse.closest_hit(o, d, scene)
    mp = bsdf_mod.gather_materials(scene.materials, hit.mat_id, hit.uv, scene.textures,
                                   scene.tex_slots)
    nin = vm.normalize(d)
    valid = hit.valid & (mp.shader_id == SHADER_MARSCHNER_HAIR)
    normal, pos = hit.normal, hit.position
    nf = vm.faceforward(normal, -nin, normal)

    out_r = vm.reflect(-nin, nf)
    t_dir = vm.refract(-nin, nf, 1.0 / mp.ior)
    t_hit = traverse.closest_hit(pos + 1e-4 * t_dir, t_dir, scene)
    t_n = _w3(t_hit.valid, t_hit.normal, normal)
    t_nf = vm.faceforward(t_n, -vm.normalize(t_dir), t_n)
    out_tt = vm.refract(-vm.normalize(t_dir), t_nf, 1.0)
    tr_dir = vm.reflect(-vm.normalize(t_dir), t_nf)
    tr_hit = traverse.closest_hit(t_hit.position + 1e-4 * tr_dir, tr_dir, scene)
    tr_n = _w3(tr_hit.valid, tr_hit.normal, normal)
    tr_nf = vm.faceforward(tr_n, -vm.normalize(tr_dir), tr_n)
    out_trt = vm.refract(-vm.normalize(tr_dir), tr_nf, torch.clamp(mp.ior, -1.0, 1.0))

    def seg(start, direction):
        nd = direction / torch.clamp(vm.length(direction)[:, None], min=1e-12)
        return torch.stack([start, start + seg_len * nd], 1)

    # a miss leaves its position at o + INF * d: the fallbacks anchor to the
    # previous point of the walk, so the segments stay finite
    t_pos = _w3(t_hit.valid, t_hit.position, pos)
    tr_pos = _w3(tr_hit.valid, tr_hit.position, t_pos)
    return HairPathRecord(in_ray=torch.stack([o, pos], 1), normal0=seg(pos, normal),
                          normal1=seg(t_pos, t_n), out_r=seg(pos, out_r),
                          out_tt=seg(t_pos, out_tt), out_trt=seg(tr_pos, out_trt), valid=valid)
