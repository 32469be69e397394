"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `ba_pathtracing_fur_torch/csrc` (one
nvcc per source, started together), checks each against its plain torch
version on the card, drives the main paths through the entry points a user
calls (`scene/builtins` -> `ops/traverse.attach_bvh` -> `models/pathtracer.
render_image`) and checks the images:

  * the Cornell path (the JAX package's bench configs 0 and 2) through the
    full-bounce kernel (K4), timed and bounded on config-0 bounces 0-3 and
    config-2 bounce 0;
  * the fur patch (bench config 4: 512x512, 45,000 cones, depth 4, spp 8,
    no cut) through the traversal kernel (cone BVH) and the shade kernel
    (K1), which draws its uniforms from each ray's key and reads its
    material rows itself: its draws are held to the torch threefry bit for
    bit, the kernel to its plain version on bounces 0-3, timed and bounded
    per shading branch;
  * a Cornell box with a triangle BVH through the traversal kernel's
    triangle leaves and the shade kernel, gated against the full-bounce
    render of the same box; the traversal is held against its plain
    version, timed and bounded on this box's camera wavefront and shadow
    rays. A soup of random triangles checks the triangle leaves on a deeper
    BVH; its numbers go under `soup` in the traverse_tri entry;
  * the hair ball (bench config 5: 1,000,000 fibers = 9,000,000 cones on a
    768-triangle scalp, 1024x1024, depth 4; spp cut from 16 to 4),
    generated and its BVH built on the card; its camera wavefront through
    the camera kernel (K7, `phase_camera`: keys, rays and the initial state
    bit for bit against its torch chain, one launch a sample, timed and
    bounded); then through the streaming
    traversal kernel (K3, two-level cone BVH), the brute-force kernel (K5,
    the BVH-less scalp) and the shade kernel (held to its plain version
    and its draws bit for bit on bounces 0-1, timed). K3 is held against its twin
    on ray subsets and against the heap-walk kernel (K2) on whole
    wavefronts, K5 against its twin on the camera and bounce-1 wavefronts
    and the bounce-0 shadow rays, each sorted and unsorted; both are timed
    and bounded (K5's bound from the exact tests these rays need, beside
    the TPU kernel's all-pairs work; its cull's margin measured on every
    wavefront). K5's cone variant runs on the fur patch without a BVH (its
    camera and bounce-1 wavefronts held whole, timed and bounded, then a
    render gated against the BVH render of the same patch),
    and a mid-size hair ball renders through the kernels and through the
    plain versions under the image gate;
  * the joint closest + shadow path on config 5 (`joint_shadows=True`,
    `phase_joint`): K3's mixed mode on the real bounce-1 pairs (the
    continuation rays and the bounce-0 shadow rays, pair-sorted) held bit
    for bit against K3's closest and any launches on every ray and against
    its plain version on TWIN_RAYS pairs, timed beside those two launches
    and bounded; the joint render through the mixed kernel (a launch a
    bounce, no plain call) bit for bit equal to the separate fused render,
    its compacted sample equal to the uncompacted one, rays/s of both
    renders in turns and a traced sample of each;
  * K3's last two variants on config 5 (`phase_stream_variants`): the
    tensor-core cone test (`traverse_stream(mxu=True)`, TF32 mma.sync in
    unit-major tiles) and bf16 leaves (`pack_prim_hbm(dtype=torch.bfloat16)`), each in
    closest, any and mixed mode, on the sorted camera and bounce-1
    wavefronts, the bounce-0 shadow rays and the bounce-1 pairs: the bf16
    instances bit for bit against their plain version and their drift
    from the f32 test reported, the mxu instances (f32 and bf16 packs)
    against their plain version and the f32 test on every ray (a found
    floor, every differing ray plausible, near ties and the row agreement
    reported), both f32 tests against an f64 brute force, each timed beside
    the f32 test and bounded; K3's triangle instances (f32 and bf16) on
    config 3's terrain on a two-level BVH; config 5 rendered through
    `render_sample_ids`' hooks (with the f32 test bit for bit
    render_image's image) with each variant (launches, the image's
    difference from the f32 render, rays/s and a traced sample beside it).

Configs 0, 3, 4 and 5 also render one sample with the JAX package's default
stream compaction (`compact=True`) and one without: the images must be
equal bit for bit; both sample times and the live share n_alive / R after
each bounce are printed. The gradient phase runs `diff.fit` on config 4's
fur patch at full width through the unfused bounce (K2 picking rows under
autograd, remat's recompute included, no plain version): every gradient
finite, the hair parameters' not all 0, a finite-difference check, and the
gradients with the kernels against those with the plain versions on the
card at 128x128; it prints the seconds of a forward, a forward plus
backward and a fit step, and the peak device memory with remat off and on.

The Whitted raytracer and BDPT run on the scenes of configs 4 and 5, each
through the entry point a user calls: `models/whitted.render_whitted` on
the fur patch at 512x512 with hair_lobes "all" (the reference's default
depth 8, hard shadows, the TT and TRT rays traced from inside the fibers)
and "r" (W4), and on the 1M-fiber hair ball at 1024x1024 (W5: K3 and K5);
`render_image(bdpt=True)` on the fur patch at 512x512, depth 4, spp 8,
every other field at the JAX package's default (B4). Each prints its wall
seconds, traced rays/s (every ray a traversal call receives with t_max > 0)
and pixels/s, the DFS's iterations and live lanes, its launches (each
traversal kernel once a traversal call, no plain version) and peak device
memory, and W4 and B4 a traced render. The traversal kernels are held to
their twins on the engines' first iteration or sample of traffic: the
nodes' rays, the shadow rays toward each light (t_max 1 on unnormalized
directions, |d| ~1e16 toward a sun, non-finite from a miss, dead lanes at
0), the TT and TRT rays, the light-subpath walks, and the connection and
splat rays with their per-ray t_max. At a small size each engine's image
through the kernels equals its image through the plain versions bit for
bit.

The command line (`python -m ba_pathtracing_fur_torch.cli`, driven in this
process through `cli.main`) runs last on a JSON scene it writes: the
reference's default fur workload (5 fibers a face x 10 vertices, radius
0.004) on a 64x64-quad OBJ skin with a noise-textured diffuse map, 368,640
cones, at the Demo's 1280x720, depth 5 (spp cut from 100 to 16): `convert`
(the b3df scene flattens to the OBJ scene's packs bit for bit), `render`
with every `--accel` build (median timed 3 times; sah, morton and grid at
spp 4; none at spp 1, K5 on both packs), each kernel held to its twin on
the first sample's traffic and each image gated against the median render,
`--engine whitted --hair-lobes all`, `--report`, the fused path on the same
scene (K1 held to its plain version, timed and bounded), and a 64x36 run
on the card against `--device cpu`. The fur hides the skin from bounces
0-1, so K1's texture fetch is held, timed and bounded at full size on
config 3's textured terrain through the fused path.

The multi-device layer (`parallel/`) runs after config 4's phases on the
same fur patch at full width, with the one card repeated in the mesh: dp 4
on the replicated median BVH and geo 4 on per-shard median BVHs at spp 8,
geo 2 without a BVH (K5 a shard) at spp 1, each image against
`render_image` of the same scene (rtol 2e-5, atol 2e-6), the geo-4 merged
camera Hit against the unsharded one, each kernel's launches those of the
mesh's shards and rows, K5 on a padded cone pack, two `train_step`s whose
loss falls, and `measure_scaling`. K1's fused images are gated at full
spp: config 4 at spp 8 against the render with K1's plain version, the CLI
skin at spp 16 against the unfused CLI render. Config 5's BVH is built
twice, the second time from the perm cache (a temporary directory).

The traversal kernels (K2, K3) run, as on the main path, on rays sorted by
the entry-morton key (`ops/traverse._entry_morton_perms`): each is held
against its plain version on the sorted rays (found, t and closest-hit rows
exact) and against itself on the unsorted rays, and timed on both; configs
4 and 5 are also rendered and traced once without the sort, which gives the
launches the sort adds a sample.

It exits non-zero, printing no result, when there is no CUDA device, when
any phase fails, or when the package is missing. The last line of its
output is `{"ok": true, "device": {...}}`; the line before it lists each
kernel with its launches on the main path, its error against the plain
version, its time beside the plain version's and its bound; the line before
that is the card's name and power limit. Before those lines it prints the
render times (rays/s) through the kernels and through the plain versions,
the BVH build times, the per-kernel work counts behind the bounds, and a
torch.profiler breakdown of one config-0, config-4 and config-5 sample. The
images go to `smoke_out/` (git-ignored): `smoke_config0.png`,
`smoke_fur_patch.png`, `smoke_hair_ball.png`, `smoke_config3.png`, the
Whitted renders `smoke_whitted_<scene>_<lobes>.png` and
`smoke_bdpt_fur_patch.png`; the CLI phase's scene, PNGs and report go to
`smoke_out/cli/`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Config 0: the reference Demo's default workload (Demo/main.cpp:209-210), Cornell
# diffuse at 1280x720, depth 5; spp cut from 100 to SPP for the smoke run.
CONFIG0 = dict(variant="diffuse", res=(1280, 720), depth=5, mis=False)
# Config 2: glossy Cornell 512^2, depth 4, MIS + Russian roulette.
CONFIG2 = dict(variant="glossy", res=(512, 512), depth=4, mis=True)
SPP = 16
# Config 4: the fur patch (bench.py:313-317, bench_fur), the reference's
# Fur_SmallSkinPatch workload: 2 x 2500 fibers x 9 cones, median cone BVH,
# 512^2, depth 4, spp 8 -- bench.py's own setting, no cut.
CONFIG4 = dict(res=(512, 512), fibers_per_face=2500, depth=4, spp=8)
# The triangle-BVH path: Cornell diffuse 512^2 with a BVH over its 34
# triangles (attach_bvh min_prims=1), depth 4; spp cut to 4.
TRI_BVH = dict(variant="diffuse", res=(512, 512), depth=4, mis=False, spp=4)
# K2 on its triangle leaves: a soup of random triangles, rays into it.
TRI_SOUP, SOUP_RAYS = 20_000, 262_144
# The multi-device phase: config 4 at full width on a mesh of the one card
# repeated (dp 4; geo 4 on per-shard BVHs; geo 2 without a BVH at spp 1),
# TRAIN_STEPS train_steps at geo 2 (spp 1, unfused, SGD at lr), and the
# scaling sweep at SCALING_SPP.
PARALLEL = dict(spp=8, train_steps=2, lr=0.05, scaling_spp=2)
# Config 5: the hair ball (bench.py:318-324, bench_fur): 1,000,000 fibers x
# 9 cones on a 768-triangle UV-sphere scalp, generated on the card, median
# cone BVH (32,768 leaves x 280, fanout 64), 1024^2, depth 4; spp cut from
# 16 to 4.
CONFIG5 = dict(res=(1024, 1024), n_fibers=1_000_000, depth=4, spp=4, bvh=(32768, 280, 64))
# K3's twin is a brute force over 9.2M rows: it runs on TWIN_RAYS rays spread
# over each wavefront; K3's work count (for its bound) on WORK_RAYS, scaled.
TWIN_RAYS, WORK_RAYS = 2048, 65_536
# K5's cone variant: config 4's fur patch without a BVH; its work count (for
# its bound) on K5_CONE_TILES tiles of each wavefront, scaled.
K5_CONE_TILES = 256
# Config 3: the textured terrain (bench.py:150-182): tri_terrain at 512^2
# with 100,000 triangles (99,458 of its 223^2 grid), a SAH BVH (512 leaves x
# 200 rows, flat: K2's triangle leaves), depth 4, spp 16, ray_chunk 2048 --
# bench.py's own setting, no cut -- through the unfused trace_bounce
# (fused_shading at its default, False).
CONFIG3 = dict(res=(512, 512), n_tris=100_000, depth=4, spp=16, ray_chunk=2048,
               bvh=(512, 200, 0))
# The kernels-vs-plain image gate on a small terrain (K2's twin brute-forces
# every row, so the full terrain is out of its reach).
SMALL_TERRAIN = dict(res=(128, 128), n_tris=20_000, depth=4, spp=2)
# The unfused bounce against the fused one on the card: the triangle-BVH
# Cornell and the fur patch, each rendered both ways with the same streams.
UNFUSED_VS_FUSED = dict(res=(256, 256), depth=4, spp=2)
# The kernel-vs-plain image gate on a mid-size hair ball (two-level BVH).
# Depth cut from 4 to 3 to make room for config 3's phases: its plain render
# is the slowest gate of the run.
MID_HAIRBALL = dict(res=(256, 256), n_fibers=20_000, depth=3, spp=1)
# The gradient phase: config 4's fur patch (45,000 cones, median BVH, 512^2,
# depth 4) at spp 1 through the unfused bounce with compaction on, the
# materials' parameters (make_params) fitted for FIT_STEPS Adam steps to a
# target rendered at the true parameters, with the fur's hair_beta moved by
# HAIR_BETA_SHIFT degrees; the finite-difference check on the fur
# material's diffuse red at FD_EPS against a black target (the skin's
# gradient is ~1e-9: 45,000 cones hide it); kernels against twins at
# GRAD_TWIN_RES.
GRAD = dict(depth=4, spp=1)
FIT_STEPS, HAIR_BETA_SHIFT, FD_EPS, FD_REL = 3, 3.0, 1e-2, 0.05
GRAD_TWIN_RES, GRAD_TWIN_TOL = (128, 128), 1e-4
# The Whitted raytracer and BDPT on the scenes of configs 4 and 5. W4: the
# fur patch at 512^2, WhittedConfig(hair_lobes="all") -- the reference's
# default depth 8 (CPU_Raytracer.h:75), hard shadows, all three lobes traced
# as the thesis does -- and once with the default hair_lobes="r"; W5: the
# 1M-fiber hair ball at 1024^2, hair_lobes="all"; B4: BDPT on the fur patch
# at 512^2, RenderConfig(depth=4, spp=8, bdpt=True) with every other field
# at the JAX package's default (compaction on, unfused, 8 samples a light,
# 3 bounces, the splat on). No cut.
B4 = dict(depth=4, spp=8)
# The traversal kernels held to their twins on the engines' traffic: K2 and
# K3 on TRAFFIC_TWIN_RAYS live rays (and 64 dead ones) of each wavefront.
TRAFFIC_TWIN_RAYS = 1024
# The engines' kernels-vs-plain bit-equality gates at a small size: the fur
# patch at 128^2 with 400 fibers a face (7,200 cones, a median cone BVH: K2)
# and a hair ball of 20,000 fibers at 160^2 (a two-level cone BVH: K3; 160^2
# rays x 768 scalp triangles reach K5's 2^24 pairs).
SMALL_FUR = dict(res=(128, 128), fibers_per_face=400)
SMALL_HAIRBALL = dict(res=(160, 160), n_fibers=20_000)
TIMED_REPS = 3
# The CLI phase: the user entry point (`python -m ba_pathtracing_fur_torch.cli
# render -s scene.json`) on a JSON scene of the reference's default fur
# workload (Fur_SmallSkinPatch/scene.json: 5 fibers a face x 10 vertices,
# radius 0.004) grown on a skin of CLI["quads"]^2 quads (8,192 triangles
# with UVs, an OBJ; its material a diffuse_map PNG of noise_texture(256) in
# the JSON's Material section): 40,960 fibers = 368,640 cones. The fur
# patch's camera, point and sun lights and environment. The Demo's
# defaults, 1280x720, depth 5, --accel median; spp cut from 100 to 16. The
# other builds at spp 4 (sah, morton, grid) and 1 (none: K5 on both packs),
# the report at spp 1. The small gate: a 16x16-quad skin at 64x36, spp 2.
CLI = dict(quads=64, res=(1280, 720), depth=5, spp=16, spp_methods=4, spp_none=1,
           spp_report=1)
CLI_SMALL = dict(quads=16, res=(64, 36), spp=2)
# The CLI wavefronts on which every traversal kernel is bounded: K3 (median
# and morton cone trees), K2 (their triangle trees) and K5 (`--accel none`,
# the 368,640-cone and the 8,192-triangle packs).
CLI_BOUND_TRAFFIC = ("bounce-0 closest", "bounce-0 shadow")
CLI_DIR = Path("smoke_out") / "cli"
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3;
# INT32 (the Hopper architecture white paper), for the shade kernel's threefry;
# TF32 on the tensor cores (dense), for K3's mxu variant.
PEAK_FP32_FLOPS, PEAK_BYTES, PEAK_INT32_OPS = 67e12, 3.35e12, 33.5e12
PEAK_TF32_FLOPS = 495e12
# K3's two variants (traverse_stream(mxu=True) and a pack_prim_hbm bf16 pack)
# on config 5's sorted wavefronts: their plain versions on VARIANT_PLAIN_RAYS
# rays spread over each (whole pairs on the mixed one), the f64 brute force on
# the same rays of the closest-hit wavefronts, their bounds from work_ref on
# VARIANT_WORK_RAYS rays, scaled; the phase's budget VARIANT_BUDGET_S.
VARIANT_PLAIN_RAYS, VARIANT_WORK_RAYS, VARIANT_BUDGET_S = 512, 16_384, 90.0
# The mxu test's row gate (`mxu_gate`), against the f32 test's kernel on
# every ray and against its plain version on the plain rays: found agreement
# at least MXU_FOUND_FLOOR, winner-row agreement on the both-found closest
# rays at least MXU_ROWS_FLOOR of the wavefront, and every ray where they
# differ a near tie (`near_ties` at TIE_REL). The floors lie under what this
# script read on an NVIDIA H100 80GB HBM3 at 700 W: found 0.99974-1.0; rows
# 0.9499-0.9501 against the f32 test on the camera wavefront (a far ray's
# quadratic rounds t by up to ~1e-3, a fifth of a fiber's radius: the f32
# test itself picks the f64 brute force's row on 0.960 of them, and its FMA
# build the f32 test's on 0.9484), 0.99991 on bounce 1 and the pairs.
# Shadow rays have no closest rows.
MXU_FOUND_FLOOR = 0.999
MXU_ROWS_FLOOR = {"camera": 0.94, "bounce1": 0.999, "shadow": 0.999, "pairs": 0.999}
# `near_ties`' bound on a decision's distance from flipping, in units of its
# f32 error scale (`cone_margins`): each of the test's ~10 steps rounds at
# 6e-8, so a decision of either f32 evaluation moves by ~1e-6 of its scale
# at most; TIE_REL leaves a factor 10.
TIE_REL = 1e-5
# Wrong kernels that the row gate must fail (`hold_k3_controls`, on the
# camera and bounce-1 wavefronts): copies of K3's source mutated as
# (file, lines, replacement), built beside the port's build; each one's lines
# occur once in csrc (tests/test_torch_stream_variants.py). "tf32" makes the
# lo half of every TF32 split 0 (the ray's, folded into the depth, and an f32
# row's), leaving one TF32 pass, x_hi.f_hi (10 mantissa bits); "row" takes a
# quad neighbour's row off by one in the (t, row) shuffle (the other row of
# its pair: within the leaf, so every row index stays valid).
MXU_MUTANTS = {
    "tf32": ("leaf_tiles.cuh", "  return tf32_rna(x - __uint_as_float(hi));\n",
             "  return 0u;\n"),
    "row": ("leaf_tiles.cuh", "                brow = orow;\n",
            "                brow = orow ^ 1;\n"),
}
# The image gate's control: the f32 test rounded another way (K3 built with
# FMA contraction, without the -fmad=false of kernels.SOURCE_FLAGS),
# rendered through the same hooks. The mxu render's difference from the f32
# render, per pixel (`image_diff`: mean |diff| and the share of pixels off by
# more than IMG_FLIP), is held to IMG_CONTROL_RATIO times the control's, and
# the MXU_MUTANTS rendered through the mxu hooks must fail that limit; the
# image gate of the plain-version checks (IMG_MEAN, IMG_FLIP_FRAC) is
# reported beside it. IMG_TILE: the tile of `image_diff`'s tile means.
IMG_CONTROL_RATIO = 1.5
IMG_TILE = 32
# K3's triangle instances, f32 and bf16: config 3's terrain (99,458
# triangles) on a two-level median BVH, its camera and shadow wavefronts.
TRI_STREAM = dict(res=(512, 512), n_tris=100_000, fanout=64)
# blocks an SM each K3 instance must keep (leaf_tiles.cuh MIN_BLOCKS: its
# launch bounds cap a thread at 64 registers so that two 512-thread blocks fit)
K3_MIN_BLOCKS = 2
# The full-bounce kernel's shading flops per ray, a rough count on
# shade_core.cuh: its bound is set by the triangle rows (config 0) or the
# bytes. The shade kernel's bound counts its branches (`cshade.work_ref`).
FULL_BOUNCE_SHADE_FLOPS = 400
# flops of one triangle row of full_bounce.cu's division-free test: the
# Möller-Trumbore numerators 45, |det| 1, sign flips 3, acceptance 7, and the
# cross-multiplied compare with the best row 3 (closest hit) or the scaled
# t_max compare 2 (shadow ray)
TRI_ROW_FLOPS, SHADOW_ROW_FLOPS = 55, 54
# Per-field gate of tests/test_fused_shade.py::test_fused_single_bounce_exact.
FIELD_ATOL, FIELD_RTOL, FIELD_MAX_FRAC = 1e-4, 1e-4, 0.02
# Image gate of tests/test_fused_shade.py::_compare.
IMG_MEAN, IMG_FLIP, IMG_FLIP_FRAC = 5e-3, 1e-3, 0.02
FIELDS = ("origin", "direction", "radiance", "color", "flags", "theta_i", "prev_pdf")
SHADE_FIELDS = FIELDS + ("shadow_tmax", "direct_rgb")
OUT_DIR = Path("smoke_out")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_bounces():
    """Route every kernel of a sample (the camera wavefront and each
    bounce) through its plain torch version, on any device."""
    from ba_pathtracing_fur_torch.ops.cuda import camera as ccamera, hit as chit, \
        intersect as cisect, shade as cshade, stream as cstream, traverse as ctraverse

    swaps = ((ccamera, "camera_rays", ccamera.camera_rays_ref),
             (cshade, "shade_bounce_full", cshade.shade_bounce_full_ref),
             (cshade, "shade_bounce", cshade.shade_bounce_ref),
             (ctraverse, "traverse", ctraverse.traverse_ref),
             (cstream, "traverse_stream", cstream.traverse_stream_ref),
             (cisect, "closest", cisect.closest_ref),
             (chit, "hit_of_rows", chit.hit_of_rows_ref))
    kernels_fns = [getattr(m, name) for m, name, _ in swaps]
    for m, name, ref in swaps:
        setattr(m, name, ref)
    try:
        yield
    finally:
        for (m, name, _), fn in zip(swaps, kernels_fns):
            setattr(m, name, fn)


@contextlib.contextmanager
def plain_hit_assembly():
    """Assemble every Hit by the torch assembly (K6's plain version), the
    traversal kernels left as they are."""
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit

    fn = chit.hit_of_rows
    chit.hit_of_rows = chit.hit_of_rows_ref
    try:
        yield
    finally:
        chit.hit_of_rows = fn


@contextlib.contextmanager
def hit_calls(seen: list):
    """Keep the arguments of every Hit assembly (`ops/cuda/hit.hit_of_rows`:
    the winner rows as closest_hit and joint_closest_any hand them over)."""
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit

    fn = chit.hit_of_rows

    def spy(*args):
        seen.append(args)
        return fn(*args)

    chit.hit_of_rows = spy
    try:
        yield
    finally:
        chit.hit_of_rows = fn


@contextlib.contextmanager
def alive_counts(out: list):
    """Record (n_alive, R) after each bounce of a compacted render."""
    from ba_pathtracing_fur_torch.ops import compact

    fn = compact.compaction_permutation

    def spy(alive):
        perm, n = fn(alive)
        out.append((n, alive.shape[0]))
        return perm, n

    compact.compaction_permutation = spy
    try:
        yield
    finally:
        compact.compaction_permutation = fn


@contextlib.contextmanager
def unsorted_rays():
    """Run closest_hit / any_hit without the entry-morton ray sort."""
    from ba_pathtracing_fur_torch.ops import traverse

    traverse.SORT_RAYS = False
    try:
        yield
    finally:
        traverse.SORT_RAYS = True


def reset_counts():
    """Every kernel wrapper's launch and plain-call counts to 0."""
    from ba_pathtracing_fur_torch.ops.cuda import camera as ccamera, hit as chit, \
        intersect as cisect, shade as cshade, stream as cstream, traverse as ctraverse

    ccamera.CAMERA_LAUNCHES = ccamera.CAMERA_REF_CALLS = 0
    chit.HIT_LAUNCHES = chit.HIT_REF_CALLS = chit.HIT_GRAD_CALLS = 0
    cshade.KERNEL_LAUNCHES = cshade.REF_CALLS = 0
    cshade.SHADE_LAUNCHES = cshade.SHADE_REF_CALLS = 0
    ctraverse.KERNEL_LAUNCHES = ctraverse.REF_CALLS = 0
    cstream.KERNEL_LAUNCHES = cstream.MIXED_LAUNCHES = cstream.REF_CALLS = 0
    cstream.MXU_LAUNCHES = cstream.BF16_LAUNCHES = 0
    cisect.TRI_LAUNCHES = cisect.CONE_LAUNCHES = cisect.REF_CALLS = 0


def read_counts() -> dict:
    """Every kernel wrapper's launch and plain-call counts, so every check
    requires the camera's torch chain calls (`camera_ref`) to be 0. Apart:
    K6's backward recomputes, `HIT_GRAD_CALLS`, which the gradient phases
    read, and K7's launches, which `phase_camera` and the config-5 render
    read."""
    from ba_pathtracing_fur_torch.ops.cuda import camera as ccamera, hit as chit, \
        intersect as cisect, shade as cshade, stream as cstream, traverse as ctraverse

    return dict(camera_ref=ccamera.CAMERA_REF_CALLS,
                full_bounce=cshade.KERNEL_LAUNCHES, full_bounce_ref=cshade.REF_CALLS,
                shade=cshade.SHADE_LAUNCHES, shade_ref=cshade.SHADE_REF_CALLS,
                traverse=ctraverse.KERNEL_LAUNCHES, traverse_ref=ctraverse.REF_CALLS,
                stream=cstream.KERNEL_LAUNCHES, stream_mixed=cstream.MIXED_LAUNCHES,
                stream_mxu=cstream.MXU_LAUNCHES, stream_bf16=cstream.BF16_LAUNCHES,
                stream_ref=cstream.REF_CALLS,
                bruteforce_tri=cisect.TRI_LAUNCHES, bruteforce_cone=cisect.CONE_LAUNCHES,
                bruteforce_ref=cisect.REF_CALLS, hit=chit.HIT_LAUNCHES,
                hit_ref=chit.HIT_REF_CALLS)


def check_counts(counts: dict, what: str, **want) -> None:
    """Fail unless each count equals `want` (0 where not named): the main
    path ran on exactly these kernels and no plain version."""
    bad = {k: v for k, v in counts.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: the main path did not run on the kernels alone: "
                             f"{counts}, expected {want}")


def timed(fn, reps: int) -> float:
    """Milliseconds per call of `fn` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def timed_median(fn, reps: int = TIMED_REPS) -> float:
    """Median milliseconds of `reps` calls of `fn` on the card, each between
    its own CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return float(np.median(ms))


def device_ms(fn, reps: int = 21) -> float:
    """Median device milliseconds of a call of `fn` (its launches alone)
    between CUDA events, with the stream held by a spin kernel while the
    host enqueues the call, so that the enqueue's host time stays out (a
    lone ctypes launch may not show in a torch.profiler trace)."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms of the card's clock
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return float(np.median(ms))


def kernel_label(mangled: str) -> str:
    """A readable name of a traversal kernel instance from its mangled name
    ("K3 cone closest mxu bf16", "K2 tri any"); other names as they are."""
    m = re.search(r"(stream_kernel|traverse_kernel)I((?:Lb[01]E)+)(f|13__nv_bfloat16)?E", mangled)
    if not m:
        return mangled
    flags = [c == "1" for c in re.findall(r"Lb([01])E", m[2])] + [False, False]
    mode = "mixed" if flags[2] else "any" if flags[1] else "closest"
    name = f"{'K3' if m[1] == 'stream_kernel' else 'K2'} {'cone' if flags[0] else 'tri'} {mode}"
    if m[1] == "stream_kernel":
        name += (" mxu" if flags[3] else "") + (" bf16" if m[3] and "bfloat16" in m[3] else " f32")
    return name


def ptxas_report() -> dict:
    """Registers, spill bytes, stack and static shared memory of each kernel
    of the last build (nvcc -Xptxas -v), by `kernel_label`."""
    from ba_pathtracing_fur_torch import kernels

    out, name = {}, None
    for line in kernels.LAST_BUILD_LOG.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_label(m[1])
            out[name] = {}
        elif name is not None:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"), ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    out[name][key] = int(m[1])
    return out


def dev_us(e) -> float:
    """Device microseconds of a torch.profiler key_averages() entry."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def bound(flops: float, n_bytes: float, int_ops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the FP32
    operations over the FP32 peak, the integer operations over the INT32
    peak and the bytes over the memory rate."""
    t_ops = max(flops / PEAK_FP32_FLOPS, int_ops / PEAK_INT32_OPS) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, int_ops=int_ops, bytes=n_bytes)


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def row_mismatch(a: torch.Tensor, b: torch.Tensor, rel: bool = False):
    """(fraction of rows off by more than atol + rtol*|a|, max |a - b|[,
    max |a - b| / max(|a|, 1)])."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    d = (a - b).abs()
    bad = (d > FIELD_ATOL + FIELD_RTOL * a.abs()).any(-1)
    out = (bad.double().mean().item(), d.max().item() if d.numel() else 0.0)
    if rel:
        out += ((d / a.abs().clamp(min=1.0)).max().item() if d.numel() else 0.0,)
    return out


def image_gate(a: np.ndarray, b: np.ndarray, what: str) -> dict:
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    mean, flips = float(d.mean()), float(np.mean(d.max(-1) > IMG_FLIP))
    log(f"{what}: mean |diff| {mean:.3e} (< {IMG_MEAN}), flipped pixels {flips:.4f} "
        f"(<= {IMG_FLIP_FRAC})")
    if not (mean < IMG_MEAN and flips <= IMG_FLIP_FRAC):
        raise AssertionError(f"{what}: image gate failed")
    return dict(mean=mean, flips=flips)


def check_image(img: torch.Tensor, shape, what: str) -> np.ndarray:
    a = img.cpu().numpy()
    if a.shape != shape or not np.all(np.isfinite(a)) or not a.max() > 0.01 \
            or np.ptp(a.reshape(-1, 3), axis=0).max() == 0.0:
        raise AssertionError(f"{what}: bad image shape={a.shape} finite={np.isfinite(a).all()} "
                             f"max={a.max()}")
    return a


def render_cfg(c, spp):
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    return pt.RenderConfig(depth=c["depth"], spp=spp, compact=False, fused_shading=True,
                           mis=c["mis"], rr=c["mis"])


def phase_kernel_vs_plain(dev) -> dict:
    """Each bounce 0-3 from a camera wavefront: kernel vs plain, per field."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins

    worst_frac, worst_abs = 0.0, 0.0
    cases = (("config0 diffuse 1280x720", dict(CONFIG0)),
             ("diffuse 256x256", dict(CONFIG0, res=(256, 256))),
             ("glossy 512x512 mis+rr", dict(CONFIG2)))
    for name, c in cases:
        scene, cam = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
        cfg = render_cfg(c, 1)
        tables = pt.BounceTables.of(scene)
        ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
        state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
        for bounce in range(4):
            kw = pt.full_bounce_inputs(state, scene, keys, bounce, cfg, tables)
            got = cshade.shade_bounce_full(**kw)
            ref = cshade.shade_bounce_full_ref(**kw)
            torch.cuda.synchronize()
            for f in FIELDS:
                frac, mx = row_mismatch(ref[f], got[f])
                worst_frac, worst_abs = max(worst_frac, frac), max(worst_abs, mx)
                if frac >= FIELD_MAX_FRAC:
                    raise AssertionError(f"{name} bounce {bounce} {f}: {frac:.4f} of rows "
                                         f"mismatched (max |diff| {mx:.3e})")
            log(f"kernel vs plain {name} bounce {bounce}: ok, "
                f"alive {int((ref['radiance'] != 0).any(-1).sum())}")
            state = pt.RayState(**ref)
    log(f"kernel vs plain: worst mismatched-row fraction {worst_frac:.5f} (gate: below "
        f"{FIELD_MAX_FRAC} of rows off by more than {FIELD_ATOL} + {FIELD_RTOL}*|plain|), "
        f"max |diff| {worst_abs:.3e}")
    return dict(max_abs_err=worst_abs, mismatch_frac=worst_frac)


def time_bounces(dev) -> dict:
    """Kernel time and bound of config-0 bounces 0-3 (921,600 rays, each
    wavefront from the plain version's last bounce) and of config-2 bounce
    0; the plain version's time on config-0 bounce 0."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins

    out = {}
    for name, c, bounces in (("config0", CONFIG0, 4), ("config2", CONFIG2, 1)):
        scene, cam = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
        cfg = render_cfg(c, 1)
        tables = pt.BounceTables.of(scene)
        ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
        state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
        for bounce in range(bounces):
            kw = pt.full_bounce_inputs(state, scene, keys, bounce, cfg, tables)
            res = dict(ms=timed(lambda: cshade.shade_bounce_full(**kw), 50),
                       **full_bounce_bound(kw))
            if (name, bounce) == ("config0", 0):
                res["plain_ms"] = timed(lambda: cshade.shade_bounce_full_ref(**kw), 5)
            log(f"full_bounce {name} bounce {bounce} ({ids.shape[0]} rays): kernel "
                f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms"
                + (f", plain {res['plain_ms']:.3f} ms" if "plain_ms" in res else ""))
            out[f"{name}_b{bounce}"] = res
            state = pt.RayState(**cshade.shade_bounce_full_ref(**kw))
    return out


def full_bounce_bound(kw) -> dict:
    """The full-bounce kernel's bound on these inputs: the triangle rows its
    closest hit must test (every row, for every ray that traces) at
    TRI_ROW_FLOPS and those its shadow any-hit must test (rows up to the
    first blocker, or all) at SHADOW_ROW_FLOPS, plus FULL_BOUNCE_SHADE_FLOPS;
    bytes are the per-ray state and draws read once and the new state
    written once."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    n_tris = kw["n_tris"]
    grids = []
    grid_fn = cshade.tri_grid

    def recording_grid(o, d, table, t_min, t_max):
        out = grid_fn(o, d, table, t_min, t_max)
        grids.append((out[1], t_max))
        return out

    cshade.tri_grid = recording_grid
    try:
        out = cshade.shade_bounce_full_ref(**kw)
    finally:
        cshade.tri_grid = grid_fn
    (_, cap), (shadow_valid, shadow_tmax) = grids
    tracing = int((cap > 0).sum())
    has_shadow = shadow_tmax > cshade.T_MIN
    first = torch.where(shadow_valid.any(-1), shadow_valid.int().argmax(-1) + 1, n_tris)
    shadow_rows = int(first[has_shadow].sum())
    flops = tracing * n_tris * TRI_ROW_FLOPS + shadow_rows * SHADOW_ROW_FLOPS \
        + kw["origin"].shape[0] * FULL_BOUNCE_SHADE_FLOPS
    io = [kw[k] for k in ("origin", "direction", "radiance", "color", "flags", "theta_i",
                          "prev_pdf", "u_bsdf", "u_pick", "u_light")] + list(out.values())
    res = bound(flops, nbytes(*io))
    log(f"full_bounce work: {tracing} tracing rays x {n_tris} rows + {shadow_rows} shadow "
        f"rows -> {flops:.4e} flops, {res['bytes']:.4e} bytes, bound {res['bound_ms']:.4f} "
        f"ms by {res['bound_by']}")
    return res


def render(scene, cam, key, cfg) -> torch.Tensor:
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    img = pt.render_image(scene, cam, key, cfg)
    torch.cuda.synchronize()
    return img


def phase_main_path(dev) -> dict:
    """render_image through the kernel on configs 0 and 2; counts and gates."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins
    from ba_pathtracing_fur_torch.utils import film

    launches = 0
    results = {}
    for name, c in (("config0", CONFIG0), ("config2", CONFIG2)):
        scene, cam = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
        cfg = render_cfg(c, SPP)
        key = rng.key(0, dev)
        reset_counts()
        img = render(scene, cam, key, cfg)
        n_k, n_ref = cshade.KERNEL_LAUNCHES, cshade.REF_CALLS
        log(f"{name}: KERNEL_LAUNCHES {n_k} (expected spp*depth = {SPP * c['depth']}), "
            f"REF_CALLS {n_ref}")
        if n_k != SPP * c["depth"] or n_ref != 0:
            raise AssertionError(f"{name}: the main path did not run on the kernel alone")
        launches += n_k
        w, h = c["res"]
        a = check_image(img, (h, w, 3), name)
        with plain_bounces():
            b = check_image(render(scene, cam, key, cfg), (h, w, 3), f"{name} plain")
        results[name] = image_gate(b, a, f"{name} kernel vs plain image")
        if name == "config0":
            OUT_DIR.mkdir(exist_ok=True)
            film.write_png(OUT_DIR / "smoke_config0.png", a)
            results["config0_scene"] = (scene, cam, key, cfg)
    results["launches"] = launches
    return results


def phase_small_reference(dev) -> None:
    """A small render through the kernel on the card against the plain
    version on the CPU: the port's own reference for this run."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.scene import builtins

    c = dict(CONFIG2, res=(32, 32), depth=3)
    cfg = render_cfg(c, 4)
    scene_g, cam_g = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
    scene_c, cam_c = builtins.cornell_box(resolution=c["res"], variant=c["variant"],
                                          device="cpu")
    a = render(scene_g, cam_g, rng.key(0, dev), cfg).cpu().numpy()
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    b = pt.render_image(scene_c, cam_c, rng.key(0, "cpu"), cfg).numpy()
    image_gate(b, a, "glossy 32x32 card kernel vs CPU plain")


def phase_timing(scene, cam, key, cfg, name="config0", with_plain=True) -> dict:
    """Median of TIMED_REPS renders, kernel and plain in turns."""
    w, h = cam.resolution
    rays = w * h * cfg.spp * cfg.depth
    kinds = ("kernel", "plain") if with_plain else ("kernel",)
    times = {k: [] for k in kinds}
    for rep in range(TIMED_REPS):
        for which in (kinds if rep % 2 == 0 else kinds[::-1]):
            ctx = plain_bounces() if which == "plain" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render(scene, cam, key, cfg)
                times[which].append(time.perf_counter() - t0)
    out = {}
    for which, ts in times.items():
        med = float(np.median(ts))
        out[which] = med
        out[f"{which}_reps"] = ts
        log(f"{name} render via {which}: median {med:.4f} s of {ts} "
            f"-> {rays / med:.4e} rays/s ({rays} rays: {w}x{h}, spp {cfg.spp}, "
            f"depth {cfg.depth})")
    return out


def phase_profile(scene, cam, key, cfg, name="config-0", marks=("full_bounce",)) -> dict:
    """Where one sample's time goes: `profile_call` of a spp-1 render."""
    cfg = dataclasses.replace(cfg, spp=1)
    return profile_call(lambda: render(scene, cam, key, cfg), f"{name} sample", marks)


def profile_call(fn, name, marks) -> dict:
    """Device time by kernel of one call of `fn` (ending in a sync) under
    torch.profiler, after a warm-up call, against the host wall clock of
    the same traced run; `kernel_ms` / `kernel_launches` are the device
    milliseconds and launches of the kernels whose names hold each of
    `marks`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    parts, kernel_ms, kernel_launches = [], {}, {}
    for mark in marks:
        t = sum(dev_us(e) for e in kernels if mark in e.key) / 1e6
        kernel_ms[mark] = t * 1e3
        kernel_launches[mark] = sum(e.count for e in kernels if mark in e.key)
        parts.append(f"{mark} {t:.5f} s = {t / max(busy, 1e-12):.4f} of device time "
                     f"({kernel_launches[mark]} launches)")
    log(f"profile, one {name} (traced): wall {wall:.4f} s, device busy {busy:.4f} s "
        f"(idle share {max(0.0, 1.0 - busy / wall):.3f}), {launches} kernel launches, "
        + ", ".join(parts))
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:100]}")
    return dict(wall=wall, busy=busy, launches=launches, kernel_ms=kernel_ms,
                kernel_launches=kernel_launches)


def per_launch(prof: dict, mark: str) -> float:
    """Device milliseconds a launch of the `mark` kernels in a traced sample
    (`phase_profile`)."""
    return prof["kernel_ms"][mark] / max(prof["kernel_launches"][mark], 1)


def phase_sort_effect(scene, cam, key, cfg, name, marks) -> dict:
    """The render and one traced sample without the ray sort, beside the
    sorted ones measured before: rays/s and the launches the sort adds."""
    with unsorted_rays():
        times = phase_timing(scene, cam, key, cfg, name=f"{name} (unsorted)", with_plain=False)
        prof = phase_profile(scene, cam, key, cfg, name=f"{name} (unsorted)", marks=marks)
    return dict(times=times, profile=prof)


def fur_scene(dev):
    """Config 4 through the entry points: the fur patch on the card and its
    median cone BVH (the ground's 2 triangles stay BVH-less)."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    scene, cam = builtins.fur_patch(resolution=CONFIG4["res"],
                                    fibers_per_face=CONFIG4["fibers_per_face"], device=dev)
    n_cones = scene.cones.count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = traverse.attach_bvh(scene, method="median")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b, st = scene.cone_bvh, traverse.LAST_BUILD_STATS["cone"]
    log(f"config4: {n_cones} cones, {scene.tris.count} triangles; cone BVH "
        f"{b.n_leaves} leaves x {b.leaf_size}, packed {tuple(b.packed.shape)}, built on the "
        f"card in {build_s:.3f} s (aabb {st['aabb']:.3f}, split {st['split']:.3f}, reorder + "
        f"pack {st['reorder_pack']:.3f}, layouts {st['layouts']:.3f} s)")
    if n_cones != 2 * CONFIG4["fibers_per_face"] * 9 or b is None or scene.tri_bvh is not None:
        raise AssertionError("config4: unexpected scene")
    cfg = pt.RenderConfig(depth=CONFIG4["depth"], spp=CONFIG4["spp"], compact=False,
                          fused_shading=True)
    return scene, cam, cfg, build_s


def sorted_rays(o, d, t_max, bvh):
    """The rays in the entry-morton order closest_hit / any_hit feed the
    traversal kernels -> (o, d, t_max, perm)."""
    from ba_pathtracing_fur_torch.ops import traverse

    perm, _ = traverse._entry_morton_perms(o, d, t_max, bvh)
    return o[perm], d[perm], t_max[perm], perm


def same_unsorted(fn, rays, perm, got, any_hit, what) -> None:
    """`fn` on the unsorted rays gives `got` (its result on the sorted rays)
    ray for ray, bit for bit: found and t, and rows on closest hits (an any
    hit's row is whichever accepted row its tile met first)."""
    t, row, found = (x[perm] for x in fn(*rays))
    torch.cuda.synchronize()
    if not (torch.equal(t, got[0]) and torch.equal(found, got[2])
            and (any_hit or torch.equal(row, got[1]))):
        raise AssertionError(f"{what}: unsorted rays give another result than sorted ones")


def compare_traverse(o, d, t_max, bvh, kind, any_hit, what) -> dict:
    """K2 against its twin on the entry-morton sorted rays the main path
    feeds it: found and t bit for bit, rows on closest hits; and K2 on the
    unsorted rays equal to K2 on the sorted ones. Returns the sorted rays
    and K2's (t, row, found) on them (`hit`, which `traverse_bound` takes)."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    so, sd, st, perm = sorted_rays(o, d, t_max, bvh)
    fn = lambda a, b, c: ctraverse.traverse(a, b, c, bvh, kind, any_hit=any_hit)  # noqa: E731
    t1, r1, f1 = fn(so, sd, st)
    t0, r0, f0 = ctraverse.traverse_ref(so, sd, st, bvh, kind, any_hit=any_hit)
    torch.cuda.synchronize()
    found_mis, t_mis = int((f0 != f1).sum()), int((t0 != t1).sum())
    row_mis = 0 if any_hit else int((r0 != r1).sum())
    log(f"traverse {kind} {'any' if any_hit else 'closest'} hit vs plain, {what} (sorted): "
        f"{o.shape[0]} rays, found {int(f0.sum())}, found/t/row mismatches {found_mis}/"
        f"{t_mis}/{row_mis}")
    if found_mis or t_mis or row_mis:
        raise AssertionError(f"traverse {kind} {what}: kernel disagrees with plain")
    same_unsorted(fn, (o, d, t_max), perm, (t1, r1, f1), any_hit, f"traverse {kind} {what}")
    return dict(found_mismatches=found_mis, t_mismatches=t_mis, row_mismatches=row_mis,
                max_abs_err=float((t0 - t1).abs().max()), sorted=(so, sd, st),
                hit=(t1, r1, f1))


def traverse_bound(o, d, t_max, bvh, kind, any_hit, hit=None) -> dict:
    """The traversal's bound on these rays: the tests `work_ref` counts;
    the rays and boxes read once, the leaves those tests enter read once,
    (t, row, found) written once. `hit`: these rays' closest (t, row, found)
    where already known (work_ref's brute force is skipped)."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    w = ctraverse.work_ref(o, d, t_max, bvh, kind, any_hit=any_hit, hit=hit)
    n_bytes = nbytes(o, d, t_max, bvh.bmin, bvh.bmax) + w["leaf_bytes"] + o.shape[0] * 9
    res = bound(w["flops"], n_bytes)
    log(f"traverse {kind} {'any' if any_hit else 'closest'} work: {w['rays']} rays, "
        f"{w['box_tests']} box tests, {w['leaf_row_tests']} leaf-row tests, "
        f"{w['leaves_entered']} of {bvh.n_leaves} leaves entered -> {w['flops']:.4e} flops, "
        f"{n_bytes:.4e} bytes, bound {res['bound_ms']:.4f} ms by {res['bound_by']}")
    return res


def shade_bound(kw, got, what) -> dict:
    """The shade kernel's bound on these inputs (`cshade.work_ref`): the
    FP32 operations of the branches these rays take, counted on
    shade_core.cuh, the integer operations of the draws those branches
    read at the INT32 rate, the inputs these rays need (the hit's fields,
    key and material id only where the branch reads them) and the tables
    read once and the outputs written once. Beside it, the byte bound of
    every per-ray input of every ray, and of the interface before the
    kernel drew and gathered itself."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    w = cshade.work_ref(kw, got)
    res = bound(w["flops"], w["bytes"], w["int_ops"])
    r = kw["origin"].shape[0]
    old_ms, all_ms = (w[k] / PEAK_BYTES * 1e3 for k in ("old_bytes", "all_bytes"))
    log(f"shade work, {what}: {r} rays by branch {w['classes']}; {w['flops']:.4e} flops "
        f"({w['flops'] / r:.1f} a ray), {w['threefry']} threefry calls and {w['draws']} "
        f"draws = {w['int_ops']:.4e} integer ops, {w['fetches']} texture fetches "
        f"({w['tex_bytes']:.4e} bytes with the uvs), {w['bytes']:.4e} bytes -> bound "
        f"{res['bound_ms']:.4f} ms by {res['bound_by']}; every input of every ray: "
        f"{w['all_bytes']:.4e} bytes = {all_ms:.4f} ms; the drawn-and-gathered interface "
        f"before: {w['old_bytes']:.4e} bytes = {old_ms:.4f} ms")
    return dict(res, all_bytes_ms=all_ms, old_bound_ms=old_ms, classes=w["classes"],
                fetches=w["fetches"])


def check_draws(keys, bounce, what) -> None:
    """The shade kernel's draws from every ray's key equal the torch
    threefry's bit for bit (tags 0-4)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    got = cshade.kernel_draws(keys, bounce, 5)
    want = rng.bounce_uniforms(keys, bounce, 5, 2)
    torch.cuda.synchronize()
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    log(f"shade draws, {what}: {keys.shape[0]} rays x 5 tags x 2, {bad} differ from "
        f"rng.bounce_uniforms")
    if bad:
        raise AssertionError(f"shade draws {what}: the kernel's threefry differs")


def compare_shade(got, want, what, k1) -> None:
    """K1 against its plain version on the same inputs under the per-field
    gate (shadow rays where they are traced); worst values into `k1`."""
    live = want["shadow_tmax"] > 0
    for f in SHADE_FIELDS + ("shadow_o", "shadow_d"):
        a, b = want[f], got[f]
        if f in ("shadow_o", "shadow_d"):
            a, b = a[live], b[live]
        frac, mx, rel = row_mismatch(a, b, rel=True)
        k1["worst_frac"], k1["max_abs_err"] = max(k1["worst_frac"], frac), \
            max(k1["max_abs_err"], mx)
        k1["max_rel_err"] = max(k1["max_rel_err"], rel)
        if frac >= FIELD_MAX_FRAC:
            raise AssertionError(f"shade {what} {f}: {frac:.4f} of rows mismatched (max "
                                 f"|diff| {mx:.3e})")


def shade_times(kw, what) -> dict:
    """K1's time on these inputs, its plain version's, and the time of the
    draws and the material gather that fed K1 before it made them itself
    (`rng.bounce_uniforms` of 4 or 5 tags and the gather, as the plain
    version runs them)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import bsdf
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    n_tags = 5 if kw["cfg"].rr else 4

    def glue():
        rng.bounce_uniforms(kw["keys"], kw["bounce"], n_tags, 2)
        bsdf.gather_rows(kw["mats_table"], kw["mat_id"])

    out = dict(ms=timed(lambda: cshade.shade_bounce(**kw), 50),
               plain_ms=timed(lambda: cshade.shade_bounce_ref(**kw), 3),
               glue_ms=timed(glue, 10))
    log(f"shade times, {what} ({kw['origin'].shape[0]} rays): " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    return out


def phase_fur_kernels(scene, cam, cfg, dev) -> dict:
    """Bounces 0-3 of config 4: K2 (cone closest and shadow any-hit) and K1
    against their plain versions on the same CUDA inputs, with the times of
    both kernels beside their plain versions at the bounce-0 and bounce-1
    shapes; there also K1's draws held to the torch threefry bit for bit,
    K1 against its plain version with hair_p_random, and K1's bound."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, traverse as ctraverse

    bvh = scene.cone_bvh
    tables = pt.BounceTables.of(scene)
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    k2, k1 = [], dict(worst_frac=0.0, max_abs_err=0.0, max_rel_err=0.0)
    out = {}
    for bounce in range(cfg.depth):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        t_cap = torch.where(alive, traverse.INF, 0.0)
        o, d = state.origin, state.direction
        what = "camera wavefront" if bounce == 0 else f"bounce-{bounce} wavefront"
        if bounce < 2:
            k2.append(compare_traverse(o, d, t_cap, bvh, "cone", False, what))
            os_, ds_, ts_ = k2[-1]["sorted"]
        hit = traverse.closest_hit(o, d, scene, t_max=t_cap)
        kw = pt.shade_inputs(state, scene, keys, bounce, cfg, hit, tables)
        got = cshade.shade_bounce(**kw)
        want = cshade.shade_bounce_ref(**kw)
        torch.cuda.synchronize()
        compare_shade(got, want, f"config4 bounce {bounce}", k1)
        live = want["shadow_tmax"] > 0
        log(f"shade vs plain, config4 bounce {bounce}: ok, {int(alive.sum())} rays alive, "
            f"{int((hit.prim_type == 1).sum())} cone hits, {int(live.sum())} shadow rays")
        so, sd, st_max = want["shadow_o"], want["shadow_d"], want["shadow_tmax"]
        if bounce < 2:
            k2.append(compare_traverse(so, sd, st_max, bvh, "cone", True,
                                       f"bounce-{bounce} shadow rays"))
            sso, ssd, sst = k2[-1]["sorted"]
            reps = 20
            times = dict(
                closest_ms=timed(lambda: ctraverse.traverse(os_, ds_, ts_, bvh, "cone"), reps),
                closest_unsorted_ms=timed(lambda: ctraverse.traverse(o, d, t_cap, bvh, "cone"),
                                          reps),
                closest_plain_ms=timed(lambda: ctraverse.traverse_ref(os_, ds_, ts_, bvh,
                                                                      "cone"), 1),
                any_ms=timed(lambda: ctraverse.traverse(sso, ssd, sst, bvh, "cone",
                                                        any_hit=True), reps),
                any_unsorted_ms=timed(lambda: ctraverse.traverse(so, sd, st_max, bvh, "cone",
                                                                 any_hit=True), reps),
                any_plain_ms=timed(lambda: ctraverse.traverse_ref(sso, ssd, sst, bvh, "cone",
                                                                  any_hit=True), 1),
                sort_ms=timed(lambda: sorted_rays(o, d, t_cap, bvh), reps))
            log(f"config4 bounce {bounce} times ({o.shape[0]} rays): " + ", ".join(
                f"{k} {v:.4f}" for k, v in times.items()))
            what = f"config4 bounce {bounce}"
            check_draws(keys, bounce, what)
            kw_p = pt.shade_inputs(state, scene, keys, bounce,
                                   dataclasses.replace(cfg, hair_p_random=True), hit, tables)
            compare_shade(cshade.shade_bounce(**kw_p), cshade.shade_bounce_ref(**kw_p),
                          f"{what} hair_p_random", k1)
            out[bounce] = dict(times=times,
                               closest_bound=traverse_bound(os_, ds_, ts_, bvh, "cone", False,
                                                            hit=k2[-2]["hit"]),
                               any_bound=traverse_bound(sso, ssd, sst, bvh, "cone", True,
                                                        hit=k2[-1]["hit"]),
                               shade=shade_times(kw, what),
                               shade_bound=shade_bound(kw, got, what))
        blocked = traverse.any_hit(so, sd, scene, st_max)
        color = want["color"] + torch.where(blocked[:, None], 0.0, want["direct_rgb"])
        state = pt.RayState(origin=want["origin"], direction=want["direction"],
                            radiance=want["radiance"], color=color, flags=want["flags"],
                            theta_i=want["theta_i"], prev_pdf=want["prev_pdf"])
    log(f"shade vs plain, config4: worst mismatched-row fraction {k1['worst_frac']:.5f} "
        f"(gate: below {FIELD_MAX_FRAC}), max |diff| {k1['max_abs_err']:.3e} (the sun's "
        f"shadow t_max is ~1e16, where an ulp is ~1e9), max |diff| / max(|plain|, 1) "
        f"{k1['max_rel_err']:.3e}")
    for x in k2:
        del x["sorted"]
    out.update(k2=k2, k1=k1)
    return out


def phase_fur_main_path(scene, cam, cfg, dev) -> dict:
    """render_image of config 4 through the kernels: launch counts, the
    image, rays/s; the spp-8 image against the render with K1's plain
    version (K2, exact against its twin, stays the kernel: its twin's brute
    force takes 3.7 s a call at this size), and the spp-1 image against the
    render with every plain version."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.utils import film

    key = rng.key(0, dev)
    reset_counts()
    img = render(scene, cam, key, cfg)
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"config4: launches {counts} (expected traverse {2 * want} = spp x depth x "
        f"(closest + shadow), shade and hit {want}, no plain calls)")
    check_counts(counts, "config4", shade=want, traverse=2 * want, hit=want)
    w, h = cam.resolution
    a = check_image(img, (h, w, 3), "config4")
    OUT_DIR.mkdir(exist_ok=True)
    film.write_png(OUT_DIR / "smoke_fur_patch.png", a)
    times = phase_timing(scene, cam, key, cfg, name="config4", with_plain=False)
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    fn = cshade.shade_bounce
    cshade.shade_bounce = cshade.shade_bounce_ref
    try:
        p = check_image(render(scene, cam, key, cfg), (h, w, 3), "config4 K1 plain")
    finally:
        cshade.shade_bounce = fn
    gate_full = image_gate(p, a, f"config4 spp-{cfg.spp} image against the render with K1's "
                           f"plain version")
    one = dataclasses.replace(cfg, spp=1)
    a1 = check_image(render(scene, cam, key, one), (h, w, 3), "config4 spp 1")
    with plain_bounces():
        t0 = time.perf_counter()
        b1 = check_image(render(scene, cam, key, one), (h, w, 3), "config4 spp 1 plain")
        plain_s = time.perf_counter() - t0
    log(f"config4 spp-1 render via plain: {plain_s:.3f} s")
    gate = image_gate(b1, a1, "config4 spp-1 kernel vs plain image")
    return dict(counts=counts, times=times, gate=gate, gate_full=gate_full)


def mesh_launches(shards_by_row, calls: int, n_rays: int, shade: int) -> dict:
    """The kernel launches a sharded render must make: per dp row and geo
    shard, `traversal_launches` of its shard scene over its row's rays
    (each shard's BVHs and K5-sized packs, as the unsharded render counts
    them) and a K6 launch for each of its closest hits (half the `calls`),
    and `shade` K1 launches a row."""
    want: dict = {}
    for shards in shards_by_row:
        for s in shards:
            for k, v in (traversal_launches(s, calls, n_rays) | {"hit": calls // 2}).items():
                want[k] = want.get(k, 0) + v
        if shade:
            want["shade"] = want.get("shade", 0) + shade
    return want


def timed_render(fn) -> tuple:
    """(image, wall seconds, peak device GiB) of one render after a warm-up
    render, the counts reset before the timed one."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img = fn()
    torch.cuda.synchronize()
    return img, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def phase_parallel(dev, card) -> dict:
    """The multi-device layer (`parallel/`) on config 4 at full width (the
    fur patch: 512^2, 45,000 cones, depth 4, fused) with a mesh of the one
    card repeated: (1) dp 4 on the replicated median BVH, spp 8; (2) geo 4
    on per-shard median BVHs (`shard_scene_bvh`), spp 8; (3) geo 2 without
    a BVH (K5 on 22,500 cones a shard), spp 1; (4) two `train_step`s at geo
    2 on per-shard BVHs, spp 1, unfused. Each image against `render_image`
    of the same scene on the card (rtol 2e-5, atol 2e-6, the JAX package's
    test tolerance); part 2's merged camera-wavefront Hit against the
    unsharded BVH's (t bit for bit; a prim_id that differs has the same t,
    an exact tie); each part's launches per kernel those of its shards and
    rows (`mesh_launches`); the loss falls. Wall seconds, rays/s against
    the unsharded render's, peak memory; then `measure_scaling` over the
    card's devices (one row here)."""
    from ba_pathtracing_fur_torch import parallel as par
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.parallel import render as prender
    from ba_pathtracing_fur_torch.scene import builtins

    t_phase = time.perf_counter()
    c = PARALLEL
    raw, cam = builtins.fur_patch(resolution=CONFIG4["res"],
                                  fibers_per_face=CONFIG4["fibers_per_face"], device=dev)
    w, h = cam.resolution
    key = rng.key(0, dev)
    fused = pt.RenderConfig(depth=CONFIG4["depth"], spp=c["spp"], compact=False,
                            fused_shading=True)
    bvh_scene = traverse.attach_bvh(raw, method="median")
    out = {}

    def part(name, scene, ref_scene, cfg, n, geo):
        mesh = par.make_mesh(devices=[dev] * n, geo=geo)
        dp = mesh.shape["dp"]
        rows = [prender.geo_shards(prender.pad_scene_geo(scene, geo), geo)] * dp
        want = mesh_launches(rows, 2 * cfg.spp * cfg.depth, w * h // dp, cfg.spp * cfg.depth)
        ref, ref_s, _ = timed_render(lambda: pt.render_image(ref_scene, cam, key, cfg))
        single = read_counts()
        img, wall, peak = timed_render(
            lambda: par.render_image_sharded(scene, cam, key, cfg, mesh))
        counts = read_counts()
        check_counts(counts, f"parallel {name}", **want)
        a, b = check_image(img, (h, w, 3), f"parallel {name}"), ref.cpu().numpy()
        err = float(np.abs(a - b).max())
        ok = np.allclose(a, b, rtol=2e-5, atol=2e-6)
        rays = w * h * cfg.spp * cfg.depth
        log(f"parallel {name} ({mesh.shape}, spp {cfg.spp}): max |diff| against render_image "
            f"{err:.3e} (rtol 2e-5, atol 2e-6: {'ok' if ok else 'FAILED'}); wall {wall:.4f} s "
            f"= {rays / wall:.4e} rays/s against {ref_s:.4f} s = {rays / ref_s:.4e} rays/s "
            f"unsharded; launches {counts} (unsharded {single}); peak {peak:.2f} GiB; on {card}")
        if not ok:
            raise AssertionError(f"parallel {name}: the sharded image differs from render_image")
        return dict(mesh=mesh.shape, max_abs_err=err, wall=wall, ref_wall=ref_s,
                    rays_per_s=rays / wall, ref_rays_per_s=rays / ref_s, peak_gib=peak,
                    counts=counts, single_counts=single)

    out["dp4"] = part("dp 4, replicated median BVH", bvh_scene, bvh_scene, fused, 4, 1)

    sharded = prender.shard_scene_bvh(raw, 4, method="median")
    state, _ = pt.camera_wavefront(cam, torch.arange(w * h, device=dev), key, [0], fused)
    o, d = state.origin, state.direction
    with plain_hit_assembly():  # the unsharded Hit by the torch assembly, the shards' by K6
        want_hit = traverse.closest_hit(o, d, bvh_scene)
    got_hit = prender.geo_closest_fn(prender.geo_shards(sharded, 4))(o, d, sharded)
    torch.cuda.synchronize()
    t_bad = int((got_hit.t.view(torch.int32) != want_hit.t.view(torch.int32)).sum())
    ties = got_hit.prim_id != want_hit.prim_id
    fields = {f: int((getattr(got_hit, f) != getattr(want_hit, f)).sum())
              for f in ("valid", "prim_type")}
    fields["mat_id"] = int((got_hit.mat_id != want_hit.mat_id)[~ties].sum())
    log(f"parallel geo 4 merged camera Hit ({w * h} rays, {int(want_hit.valid.sum())} hits): "
        f"t differs on {t_bad} rays; prim_id differs on {int(ties.sum())} rays (exact ties: "
        f"t is equal on every ray); valid/prim_type differ on {fields['valid']}/"
        f"{fields['prim_type']} rays, mat_id on {fields['mat_id']} of the untied")
    if t_bad or any(fields.values()):
        raise AssertionError("parallel geo 4: the merged Hit differs from the unsharded one")
    out["geo4"] = part("geo 4, a median BVH a shard", sharded, bvh_scene, fused, 4, 4)
    out["geo4"].update(hit_t_mismatches=t_bad, prim_id_ties=int(ties.sum()))

    one = dataclasses.replace(fused, spp=1)
    out["geo2_bvh_less"] = part("geo 2 without a BVH (K5)", raw, raw, one, 2, 2)
    # padded primitives never hit: K5 on the cone pack padded to a multiple
    # of 7 (3 inert cones) equals K5 on the pack itself, and the cull's
    # margin holds over the padded pack's boxes
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect
    padded = prender.pad_scene_geo(raw, 7).cones
    t_cap = torch.full((w * h,), traverse.INF, device=dev)
    tp, ip = cisect.closest(o, d, t_cap, cisect.tables_of(padded, "cone"), "cone")
    tu, iu = cisect.closest(o, d, t_cap, cisect.tables_of(raw.cones, "cone"), "cone")
    margin = cisect.cull_margin(o, d, t_cap, padded, "cone")
    same = torch.equal(tp, tu) and torch.equal(ip, iu)
    log(f"parallel padded cone pack ({raw.cones.count} + {padded.count - raw.cones.count} "
        f"inert cones): K5 equal to the unpadded pack's {same}, largest index hit "
        f"{int(ip.max())}; cull margin {margin}")
    if not same or margin["missed"] or margin["entry_ratio"] > cisect.PRUNE_SLACK:
        raise AssertionError("parallel: a padded cone hit, or the cull's margin failed")
    out["padded_margin"] = margin

    cfg_t = pt.RenderConfig(depth=CONFIG4["depth"], spp=1)
    mesh = par.make_mesh(devices=[dev] * 2, geo=2)
    sharded2 = prender.shard_scene_bvh(raw, 2, method="median")
    target = torch.zeros((h, w, 3), device=dev)
    st = par.TrainState(materials=sharded2.materials,
                        step=torch.tensor(0, dtype=torch.int32, device=dev))
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for _ in range(c["train_steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, loss = par.train_step(st, sharded2, cam, key, target, cfg_t, mesh, lr=c["lr"])
        losses.append(float(loss))
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = mesh_launches([prender.geo_shards(sharded2, 2)], 2 * cfg_t.depth * c["train_steps"],
                         w * h, 0)
    check_counts(counts, "parallel train_step", **want)
    log(f"parallel train_step x{c['train_steps']} (geo 2, median BVH a shard, spp 1, "
        f"unfused): losses {losses}, seconds {walls}, launches {counts}, peak {peak:.2f} GiB; "
        f"on {card}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("parallel train_step: the loss did not fall")
    out["train"] = dict(losses=losses, walls=walls, counts=counts, peak_gib=peak)

    rows = par.measure_scaling(bvh_scene, cam, dataclasses.replace(fused, spp=c["scaling_spp"]),
                               repeats=2, devices=[dev] * torch.cuda.device_count())
    log(f"parallel measure_scaling over the {torch.cuda.device_count()} visible device(s), "
        f"config 4 at spp {c['scaling_spp']}: {rows}; on {card}")
    out["scaling"] = rows
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel phase: {out['phase_s']:.1f} s on {card}")
    return out


def camera_and_shadow_rays(scene, cam, cfg, dev):
    """Bounce 0 of `scene`: the camera wavefront (o, d, t_max) and the NEE
    shadow rays (o, d, t_max) the plain shade stage emits for its hits."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
    t_cap = torch.where(alive, traverse.INF, 0.0)
    hit = traverse.closest_hit(state.origin, state.direction, scene, t_max=t_cap)
    kw = pt.shade_inputs(state, scene, keys, 0, cfg, hit, pt.BounceTables.of(scene))
    sh = cshade.shade_bounce_ref(**kw)
    return ((state.origin, state.direction, t_cap),
            (sh["shadow_o"], sh["shadow_d"], sh["shadow_tmax"]))


def phase_tri_bvh(dev) -> dict:
    """K2's triangle leaves. On the main path: a Cornell box with a
    triangle BVH, its camera wavefront (closest hit) and shadow rays (any
    hit) held against the plain version, timed and bounded there, then
    rendered through the traversal and shade kernels and held against the
    full-bounce render of the same box. Off it: a soup of random triangles
    against the plain version, reported under its own name."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse
    from ba_pathtracing_fur_torch.scene import builtins, types

    c = TRI_BVH
    scene, cam = builtins.cornell_box(resolution=c["res"], variant=c["variant"], device=dev)
    cfg = render_cfg(c, c["spp"])
    with_bvh = traverse.attach_bvh(scene, leaf_size=8, min_prims=1)
    bvh = with_bvh.tri_bvh
    (o, d, t_cap), (so, sd, st_max) = camera_and_shadow_rays(with_bvh, cam, cfg, dev)
    checks = [compare_traverse(o, d, t_cap, bvh, "tri", False, "cornell camera wavefront"),
              compare_traverse(so, sd, st_max, bvh, "tri", True, "cornell shadow rays")]
    (o1, d1, t1), (o2, d2, t2) = checks[0].pop("sorted"), checks[1].pop("sorted")
    times = dict(ms=timed(lambda: ctraverse.traverse(o1, d1, t1, bvh, "tri"), 20),
                 unsorted_ms=timed(lambda: ctraverse.traverse(o, d, t_cap, bvh, "tri"), 20),
                 plain_ms=timed(lambda: ctraverse.traverse_ref(o1, d1, t1, bvh, "tri"), 3),
                 any_ms=timed(lambda: ctraverse.traverse(o2, d2, t2, bvh, "tri",
                                                         any_hit=True), 20),
                 any_plain_ms=timed(lambda: ctraverse.traverse_ref(o2, d2, t2, bvh, "tri",
                                                                   any_hit=True), 3))
    log(f"traverse tri, cornell bounce 0 ({o.shape[0]} rays, BVH {bvh.n_leaves} leaves x "
        f"{bvh.leaf_size}): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    b = traverse_bound(o, d, t_cap, bvh, "tri", False)
    traverse_bound(so, sd, st_max, bvh, "tri", True)

    key = rng.key(0, dev)
    reset_counts()
    img = render(with_bvh, cam, key, cfg)
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"cornell with a triangle BVH ({bvh.n_leaves} leaves x {bvh.leaf_size}): "
        f"launches {counts}")
    check_counts(counts, "cornell tri BVH", shade=want, traverse=2 * want, hit=want)
    w, h = c["res"]
    a = check_image(img, (h, w, 3), "cornell tri BVH")
    ref = check_image(render(scene, cam, key, cfg), (h, w, 3), "cornell full bounce")
    image_gate(ref, a, "cornell: triangle-BVH path vs full-bounce path image")

    g = np.random.default_rng(0)
    v0 = g.uniform(-1, 1, (TRI_SOUP, 3)).astype(np.float32)
    v1, v2 = (v0 + g.normal(0, 0.04, (TRI_SOUP, 3)).astype(np.float32) for _ in range(2))
    soup = traverse.attach_bvh(dataclasses.replace(
        scene, tris=types._to(types.make_triangle_pack(v0, v1, v2), dev)), min_prims=1).tri_bvh
    so_ = torch.from_numpy(g.uniform(-1.5, 1.5, (SOUP_RAYS, 3)).astype(np.float32)).to(dev)
    sd_ = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(SOUP_RAYS, 3)).astype(np.float32)), dim=-1).to(dev)
    t_inf = torch.full((SOUP_RAYS,), 3.4e38, device=dev)
    t_one = torch.full((SOUP_RAYS,), 1.0, device=dev)
    log(f"triangle soup: {TRI_SOUP} triangles, BVH {soup.n_leaves} leaves x {soup.leaf_size}")
    soup_checks = [compare_traverse(so_, sd_, t_inf, soup, "tri", False, "soup"),
                   compare_traverse(so_, sd_, t_one, soup, "tri", True, "soup, t_max 1")]
    (o3, d3, t3), _ = (x.pop("sorted") for x in soup_checks)
    soup_hit = soup_checks[0].pop("hit")
    soup_res = dict(ms=timed(lambda: ctraverse.traverse(o3, d3, t3, soup, "tri"), 20),
                    unsorted_ms=timed(lambda: ctraverse.traverse(so_, sd_, t_inf, soup, "tri"),
                                      20),
                    plain_ms=timed(lambda: ctraverse.traverse_ref(o3, d3, t3, soup, "tri"), 1))
    log(f"traverse tri closest, soup ({SOUP_RAYS} rays): kernel {soup_res['ms']:.4f} ms "
        f"sorted, {soup_res['unsorted_ms']:.4f} ms unsorted, plain {soup_res['plain_ms']:.3f} ms")
    sb = traverse_bound(o3, d3, t3, soup, "tri", False, hit=soup_hit)
    soup_res.update(bound_ms=sb["bound_ms"], bound_by=sb["bound_by"], rays=SOUP_RAYS,
                    triangles=TRI_SOUP,
                    max_abs_err=max(x["max_abs_err"] for x in soup_checks))
    return dict(launches=counts["traverse"], max_abs_err=max(x["max_abs_err"] for x in checks),
                ms=times["ms"], unsorted_ms=times["unsorted_ms"], any_ms=times["any_ms"],
                plain_ms=times["plain_ms"], bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], soup=soup_res)


def hair_ball_scene(dev):
    """Config 5 through the entry points: the 1M fibers generated on the
    card and the device median build of their cone BVH (the 768 scalp
    triangles stay BVH-less: K5 takes them)."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    c = CONFIG5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene, cam = builtins.hair_ball(resolution=c["res"], n_fibers=c["n_fibers"],
                                    on_device=True, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n_cones = scene.cones.count
    raw = scene
    t0 = time.perf_counter()
    scene = traverse.attach_bvh(raw, method="median")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b, stats = scene.cone_bvh, dict(traverse.LAST_BUILD_STATS["cone"])
    # the same build again: its split comes from the perm cache (9M cones,
    # past PERM_CACHE_MIN; BAPT_BVH_CACHE_DIR is this run's temporary
    # directory), bit-equal to the fresh one
    t0 = time.perf_counter()
    again = traverse.attach_bvh(raw, method="median")
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    cst = traverse.LAST_BUILD_STATS["cone"]
    log(f"config5: the cached rebuild in {cached_s:.3f} s (split {cst['split']:.3f} s, "
        f"perm_cached {cst['perm_cached']}) against {build_s:.3f} s (split "
        f"{stats['split']:.3f} s, perm_cached {stats['perm_cached']})")
    if not (cst["perm_cached"] and not stats["perm_cached"]
            and torch.equal(again.cone_bvh.perm, b.perm)
            and torch.equal(again.cone_bvh.packed, b.packed)):
        raise AssertionError("config5: the perm cache missed or changed the BVH")
    del again, raw
    log(f"config5: {n_cones} cones generated on the card in {gen_s:.3f} s; cone "
        f"BVH {b.n_leaves} leaves x {b.leaf_size}, fanout {b.fanout}, built on the "
        f"card in {build_s:.3f} s (aabb {stats['aabb']:.3f}, split "
        f"{stats['split']:.3f}, reorder + pack {stats['reorder_pack']:.3f}, layouts "
        f"{stats['layouts']:.3f} s); {scene.tris.count} scalp triangles without a BVH; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if (n_cones, (b.n_leaves, b.leaf_size, b.fanout)) != (9 * c["n_fibers"], c["bvh"]) \
            or scene.tri_bvh is not None or b.perm.device != scene.cones.base.device:
        raise AssertionError("config5: unexpected scene or BVH")
    cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], compact=False, fused_shading=True)
    return scene, cam, cfg, dict(gen_s=gen_s, build_s=build_s, stages=stats,
                                 cached_build_s=cached_s, cached_stages=dict(cst))


def spread(n: int, k: int, dev) -> torch.Tensor:
    """k ray indices spread evenly over a wavefront of n."""
    return torch.arange(k, device=dev) * (n // k)


def compare_stream(o, d, t_max, bvh, any_hit, what) -> dict:
    """On the entry-morton sorted wavefront the main path feeds it: K3
    against its brute-force twin on TWIN_RAYS rays spread over it (found and
    t bit for bit, and closest-hit rows) and against K2 on the same BVH over
    the whole wavefront (found and t bit for bit, closest-hit rows: both
    return the lexicographic minimum (t, row)); K3 and K2 on the unsorted
    wavefront equal to themselves on the sorted one."""
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse

    kind = "cone"
    flat = dataclasses.replace(bvh, fanout=0)
    so, sd, st, perm = sorted_rays(o, d, t_max, bvh)
    k3 = lambda a, b, c: cstream.traverse_stream(a, b, c, bvh, kind, any_hit=any_hit)  # noqa
    k2 = lambda a, b, c: ctraverse.traverse(a, b, c, flat, kind, any_hit=any_hit)  # noqa
    t3, r3, f3 = k3(so, sd, st)
    t2, r2, f2 = k2(so, sd, st)
    sub = spread(o.shape[0], TWIN_RAYS, o.device)
    t0, r0, f0 = cstream.traverse_stream_ref(so[sub], sd[sub], st[sub], bvh, kind,
                                             any_hit=any_hit)
    torch.cuda.synchronize()
    twin = dict(found=int((f0 != f3[sub]).sum()), t=int((t0 != t3[sub]).sum()))
    vs_k2 = dict(found=int((f2 != f3).sum()), t=int((t2 != t3).sum()))
    if not any_hit:  # an any hit's row is whichever accepted row came first
        twin["rows"] = int((r0 != r3[sub]).sum())
        vs_k2["rows"] = int((r2 != r3).sum())
    err = float((t0 - t3[sub]).abs().max())
    log(f"traverse_stream cone {'any' if any_hit else 'closest'} hit, {what} (sorted): "
        f"{o.shape[0]} rays, found {int(f3.sum())}; vs twin on {TWIN_RAYS} rays (found "
        f"{int(f0.sum())}): found/t/row mismatches {twin}; vs traverse (K2) on all rays: "
        f"{vs_k2}")
    if any(twin.values()) or any(vs_k2.values()):
        raise AssertionError(f"traverse_stream {what}: kernel disagrees")
    same_unsorted(k3, (o, d, t_max), perm, (t3, r3, f3), any_hit, f"traverse_stream {what}")
    same_unsorted(k2, (o, d, t_max), perm, (t2, r2, f2), any_hit, f"traverse (K2) {what}")
    return dict(max_abs_err=err, t=t3, row=r3, found=f3, sorted=(so, sd, st))


def compare_hit(args, what) -> dict:
    """K6 against the torch assembly (`hit.hit_of_rows_ref`) on one call's
    winner rows as closest_hit hands them over (`hit_calls`): every field of
    the Hit bit for bit (floats by their int32 views, so NaN and the sign
    of 0 count), both timed, and K6's bound by bytes (`hit.work_ref`)."""
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit

    got, want = chit.hit_of_rows(*args), chit.hit_of_rows_ref(*args)
    torch.cuda.synchronize()
    bad = {}
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad[f.name] = int((a != b).reshape(a.shape[0], -1).any(-1).sum())
    work = chit.work_ref(got, args[4])
    r = got.t.shape[0]
    res = dict(rays=r, valid=int(got.valid.sum()), mismatched=bad,
               max_abs_err=0.0 if not any(bad.values()) else None,
               ms=timed(lambda: chit.hit_of_rows(*args), 20),
               plain_ms=timed(lambda: chit.hit_of_rows_ref(*args), 5),
               bound_ms=work["bytes"] / PEAK_BYTES * 1e3, bound_by="bytes",
               bytes=work["bytes"], rows_read=work["rows"])
    log(f"K6 vs the torch assembly, {what} ({r} rays, {res['valid']} hits, kinds "
        f"{sorted(args[4])}): rays with a differing field {bad}; K6 {res['ms']:.4f} ms (back to "
        f"back), torch assembly {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"({work['bytes']} bytes, {work['rows']} winner rows read)")
    if any(bad.values()):
        raise AssertionError(f"{what}: K6 differs from the torch assembly")
    return res


def compare_camera(cam, ids, key, samples, cfg, what) -> dict:
    """The camera kernel (K7) against its torch chain (`camera.
    camera_rays_ref`) on one wavefront as `pt.camera_wavefront` makes it:
    the keys and every initial RayState field bit for bit (floats by their
    int32 views), one launch a sample and no chain call (the counters),
    both timed back to back and as device time (`device_ms`; the chain's
    launches and device time from a trace), and the kernel's bound
    (`camera.work_ref`: bytes, and the threefry's integer work)."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import camera as ccamera

    launches, refs = ccamera.CAMERA_LAUNCHES, ccamera.CAMERA_REF_CALLS
    state, keys = pt.camera_wavefront(cam, ids, key, samples, cfg)
    torch.cuda.synchronize()
    n_launch, n_ref = ccamera.CAMERA_LAUNCHES - launches, ccamera.CAMERA_REF_CALLS - refs
    if (n_launch, n_ref) != (len(samples), 0):
        raise AssertionError(f"camera {what}: {n_launch} kernel launches and {n_ref} torch "
                             f"chain calls, expected {len(samples)} and 0")
    want_keys, want = ccamera.camera_rays_ref(cam, ids, key, samples, cfg.qmc, cfg.spp)
    bad = {"keys": int((keys != want_keys).any(-1).sum())}
    for name, b in zip(FIELDS, want):
        a = getattr(state, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad[name] = int((a != b).reshape(a.shape[0], -1).any(-1).sum())
    n = keys.shape[0]
    work = ccamera.work_ref(n, cfg.qmc, cam.use_dof)
    lim = bound(0.0, work["bytes"], work["int_ops"])
    run = lambda: pt.camera_wavefront(cam, ids, key, samples, cfg)  # noqa: E731
    chain = lambda: ccamera.camera_rays_ref(cam, ids, key, samples, cfg.qmc, cfg.spp)  # noqa
    chain_prof = profile_call(lambda: (chain(), torch.cuda.synchronize()),
                              f"camera torch chain {what}", ())
    res = dict(rays=n, samples=list(samples), mismatched=bad,
               max_abs_err=0.0 if not any(bad.values()) else None,
               ms=timed(run, 20), plain_ms=timed(chain, 5),
               device_ms=device_ms(run), plain_device_ms=chain_prof["busy"] * 1e3, plain_launches=chain_prof["launches"],
               bound_ms=lim["bound_ms"], bound_by=lim["bound_by"], bytes=work["bytes"],
               int_ops=work["int_ops"])
    log(f"K7 vs the torch chain, {what} ({n} rays, samples {list(samples)}): rays with a "
        f"differing field {bad}; K7 {res['ms']:.4f} ms back to back, {res['device_ms']:.4f} "
        f"ms on the device; torch chain {res['plain_ms']:.4f} "
        f"ms back to back, {res['plain_device_ms']:.4f} ms on the device in "
        f"{res['plain_launches']} launches; bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']} ({work['bytes']} bytes, {work['int_ops']:.4e} integer ops)")
    if any(bad.values()):
        raise AssertionError(f"camera {what}: K7 differs from its torch chain")
    return res


def phase_camera(cam, cfg, dev) -> dict:
    """K7 on the hair ball's 1024^2 camera: the main path's wavefront (one
    sample, what a hairball.progressive pass makes) and a wavefront of three
    samples (0, 7, 2^20) from a large seed, each held to its torch chain bit
    for bit, timed and bounded (`compare_camera`)."""
    from ba_pathtracing_fur_torch.core import rng

    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    return dict(main=compare_camera(cam, ids, rng.key(0, dev), [0], cfg, "config5 pass"),
                samples3=compare_camera(cam, ids, rng.key((1 << 33) + 977, dev),
                                        [0, 7, 1 << 20], cfg, "config5, three samples"))


def stream_bound(o, d, t_max, bvh, any_hit, t, row, found, is_any=None) -> dict:
    """K3's bound on this wavefront: the tests `work_ref` counts on WORK_RAYS
    rays spread over it (from K3's own hits, held to the twin above),
    scaled to the whole wavefront; the rays, boxes and tables read once,
    the distinct leaves the sampled rays enter read once (a lower count of
    the whole wavefront's), (t, row, found) written once. `is_any`: a mixed
    launch's flags over its interleaved pairs (read once too); the sample is
    then WORK_RAYS / 2 whole pairs."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    r = o.shape[0]
    sub = spread(r, WORK_RAYS, o.device)
    if is_any is not None:
        sub = (2 * spread(r // 2, WORK_RAYS // 2, o.device)[:, None]
               + torch.arange(2, device=o.device)).reshape(-1)
    w = ctraverse.work_ref(o[sub], d[sub], t_max[sub], bvh, "cone", any_hit=any_hit,
                           hit=(t[sub], row[sub], found[sub]),
                           is_any=None if is_any is None else is_any[sub])
    scale = r / WORK_RAYS
    n_bytes = nbytes(o, d, t_max, bvh.bmin, bvh.bmax, bvh.sboxes, bvh.cboxes) \
        + w["leaf_bytes"] + r * 9 + (0 if is_any is None else nbytes(is_any))
    res = bound(w["flops"] * scale, n_bytes)
    mode = "mixed" if is_any is not None else "any" if any_hit else "closest"
    log(f"traverse_stream cone {mode} work on {WORK_RAYS} of {r} "
        f"rays: {w['box_tests']} box tests, {w['leaf_row_tests']} leaf-row tests "
        f"({w['leaf_row_tests'] / WORK_RAYS:.1f} a ray), {w['leaves_entered']} of "
        f"{bvh.n_leaves} leaves entered ({w['leaf_bytes']:.4e} bytes) -> x{scale:.1f} = "
        f"{res['flops']:.4e} flops, {n_bytes:.4e} bytes, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']}")
    return dict(res, row_tests_per_ray=w["leaf_row_tests"] / WORK_RAYS,
                leaves_entered=w["leaves_entered"])


def brute_bound(o, d, t_max, tables, kind, t, idx, max_tiles=0) -> dict:
    """K5's bound on these rays (`cisect.work_ref`): an exact test per pair
    whose padded box the ray enters by its final t, each input read once
    and each output written once. Beside it, the cull's own tests and the
    tiles' L2 re-reads (diagnostics, not in the bound), and the TPU
    kernel's work (every live ray against every primitive) and its bound."""
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect

    t_fin = torch.where(idx >= 0, t, t_max)
    w = cisect.work_ref(o, d, t_max, tables, kind, t_fin, max_tiles=max_tiles)
    res = bound(w["flops"], w["bytes"])
    old = bound(w["all_pairs_flops"], w["all_pairs_bytes"])
    log(f"bruteforce {kind} work ({w['counted_tiles']} of {w['tiles']} tiles counted): "
        f"{w['exact_tests']:.4e} exact tests = {w['exact_per_ray']:.3f} a live ray -> "
        f"{w['flops']:.4e} flops, {w['bytes']:.4e} bytes, bound {res['bound_ms']:.4f} ms by "
        f"{res['bound_by']}; the cull's own work: {w['live_tiles']:.0f} live tiles, "
        f"{w['survivors_per_tile']:.2f} survivors a tile of {tables.cm.shape[1]}, "
        f"{w['bundle_tests']:.4e} bundle and {w['slab_tests']:.4e} slab tests = "
        f"{w['cull_flops']:.4e} flops, {w['reread_bytes']:.4e} bytes re-read from L2; the "
        f"TPU kernel's work: {w['all_pairs']} pairs x {cisect.PAIR_FLOPS[kind]} flops, bound "
        f"{old['bound_ms']:.4f} ms by {old['bound_by']}")
    return dict(res, survivors_per_tile=w["survivors_per_tile"],
                exact_per_ray=w["exact_per_ray"], cull_flops=w["cull_flops"],
                reread_bytes=w["reread_bytes"], all_pairs_bound_ms=old["bound_ms"])


def k5_wavefront(o, d, t_max, pack, kind, bvh, what, max_tiles=0, plain=False) -> dict:
    """K5 on one wavefront as the main path feeds it: on the entry-morton
    sorted rays when the scene has a BVH (`bvh`), else as they come. Held
    against its twin on every ray (t and index bit for bit), the unsorted
    rays' result equal to the sorted rays' ray for ray; the cull's margin
    (`cisect.cull_margin`) over every accepted pair; timed sorted and
    unsorted; bounded by `brute_bound`."""
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect

    tables = cisect.tables_of(pack, kind)
    rays = (o, d, t_max)
    if bvh is not None:
        *rays, perm = sorted_rays(o, d, t_max, bvh)
    so, sd, st = rays
    t1, i1 = cisect.closest(so, sd, st, tables, kind)
    t0, i0 = cisect.closest_ref(so, sd, st, tables, kind)
    torch.cuda.synchronize()
    bad_t, bad_i = int((t0 != t1).sum()), int((i0 != i1).sum())
    log(f"bruteforce {kind} vs plain, {what}{' (sorted)' if bvh is not None else ''}: "
        f"{o.shape[0]} rays x {tables.cm.shape[1]} primitives, hits {int((i1 >= 0).sum())}; "
        f"t mismatches {bad_t}, index mismatches {bad_i}")
    if bad_t or bad_i:
        raise AssertionError(f"bruteforce {kind} {what}: kernel disagrees with plain")
    margin = cisect.cull_margin(so, sd, st, pack, kind)
    log(f"bruteforce {kind} cull margin, {what}: {margin['pairs']} accepted pairs, largest "
        f"entry into the padded box / t {margin['entry_ratio']:.7f} (pruned beyond "
        f"{cisect.PRUNE_SLACK}), boxes missed {margin['missed']}, furthest hit point outside "
        f"its unpadded box {margin['pad_needed']:.3e} of the pack's extent (padded by "
        f"{cisect.BOX_PAD_EXT} of it + {cisect.BOX_PAD_REL} of each coordinate)")
    if margin["missed"] or margin["entry_ratio"] > cisect.PRUNE_SLACK:
        raise AssertionError(f"bruteforce {kind} {what}: the cull could drop an accepted pair")
    reps = 20 if kind == "tri" else 3
    res = dict(max_abs_err=float((t0 - t1).abs().max()), margin=margin,
               ms=timed(lambda: cisect.closest(so, sd, st, tables, kind), reps))
    if bvh is not None:
        tu, iu = cisect.closest(o, d, t_max, tables, kind)
        torch.cuda.synchronize()
        if not (torch.equal(tu[perm], t1) and torch.equal(iu[perm], i1)):
            raise AssertionError(f"bruteforce {kind} {what}: unsorted rays give another result")
        res["unsorted_ms"] = timed(lambda: cisect.closest(o, d, t_max, tables, kind), reps)
    if plain:
        res["plain_ms"] = timed(lambda: cisect.closest_ref(so, sd, st, tables, kind), 1)
    res["bound"] = brute_bound(so, sd, st, tables, kind, t1, i1, max_tiles)
    log(f"bruteforce {kind}, {what}: kernel {res['ms']:.4f} ms"
        + (f" sorted, {res['unsorted_ms']:.4f} ms unsorted" if "unsorted_ms" in res else "")
        + (f"; plain {res['plain_ms']:.3f} ms" if plain else ""))
    return res


def phase_hairball_kernels(scene, cam, cfg, dev) -> dict:
    """Bounces 0-1 of config 5 through the kernels: K3 (closest hit on the
    wavefront, any hit on its shadow rays) against its twin and K2, timed
    beside K2 and bounded; K6 against the torch assembly on each wavefront's
    Hit (every field bit for bit), timed and bounded; K5 on the scalp (the
    camera and bounce-1 wavefronts and the bounce-0 shadow rays, sorted as
    the main path feeds it and unsorted) against its twin, timed and
    bounded; K1 against its plain version on every ray (per-field gate), its
    draws held to the torch threefry bit for bit, timed and bounded."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade, stream as cstream, \
        traverse as ctraverse

    bvh = scene.cone_bvh
    flat = dataclasses.replace(bvh, fanout=0)
    tables = pt.BounceTables.of(scene)
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    out = dict(k1=dict(worst_frac=0.0, max_abs_err=0.0, max_rel_err=0.0))
    for bounce in range(2):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        t_cap = torch.where(alive, traverse.INF, 0.0)
        o, d = state.origin, state.direction
        what = "camera wavefront" if bounce == 0 else "bounce-1 wavefront"
        closest = compare_stream(o, d, t_cap, bvh, False, what)
        seen = []
        with hit_calls(seen):
            hit = traverse.closest_hit(o, d, scene, t_max=t_cap)
        out[f"k6_{bounce}"] = compare_hit(seen[0], f"config5 {what}")
        kw = pt.shade_inputs(state, scene, keys, bounce, cfg, hit, tables)
        sh = cshade.shade_bounce(**kw)
        compare_shade(sh, cshade.shade_bounce_ref(**kw), f"config5 bounce {bounce}", out["k1"])
        log(f"shade vs plain, config5 bounce {bounce}: ok, {o.shape[0]} rays")
        check_draws(keys, bounce, f"config5 bounce {bounce}")
        shade = dict(shade_times(kw, f"config5 bounce {bounce}"),
                     bound=shade_bound(kw, sh, f"config5 bounce {bounce}"))
        so, sd, st_max = sh["shadow_o"], sh["shadow_d"], sh["shadow_tmax"]
        shadow = compare_stream(so, sd, st_max, bvh, True, f"bounce-{bounce} shadow rays")
        sub = spread(o.shape[0], TWIN_RAYS, dev)
        (o1, d1, t1), (o2, d2, t2) = closest.pop("sorted"), shadow.pop("sorted")
        times = dict(
            closest_ms=timed(lambda: cstream.traverse_stream(o1, d1, t1, bvh, "cone"), 3),
            closest_k2_ms=timed(lambda: ctraverse.traverse(o1, d1, t1, flat, "cone"), 3),
            any_ms=timed(lambda: cstream.traverse_stream(o2, d2, t2, bvh, "cone",
                                                         any_hit=True), 3),
            any_k2_ms=timed(lambda: ctraverse.traverse(o2, d2, t2, flat, "cone",
                                                       any_hit=True), 3),
            sort_ms=timed(lambda: sorted_rays(o, d, t_cap, bvh), 3))
        if bounce == 0:
            times.update(
                closest_unsorted_ms=timed(lambda: cstream.traverse_stream(o, d, t_cap, bvh,
                                                                          "cone"), 3),
                closest_k2_unsorted_ms=timed(lambda: ctraverse.traverse(o, d, t_cap, flat,
                                                                        "cone"), 3),
                any_unsorted_ms=timed(lambda: cstream.traverse_stream(
                    so, sd, st_max, bvh, "cone", any_hit=True), 3),
                any_k2_unsorted_ms=timed(lambda: ctraverse.traverse(
                    so, sd, st_max, flat, "cone", any_hit=True), 3),
                closest_plain_ms=timed(lambda: cstream.traverse_stream_ref(
                    o1[sub], d1[sub], t1[sub], bvh, "cone"), 1))
        log(f"config5 bounce {bounce} K3 and K2 times ({o.shape[0]} rays, entry-morton "
            f"sorted unless named unsorted; plain on {TWIN_RAYS}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
        out[bounce] = dict(
            times=times, closest=closest, shadow=shadow, alive=int(alive.sum()), shade=shade,
            closest_bound=stream_bound(o1, d1, t1, bvh, False, closest["t"], closest["row"],
                                       closest["found"]),
            any_bound=stream_bound(o2, d2, t2, bvh, True, shadow["t"], shadow["row"],
                                   shadow["found"]),
            sorted=dict(closest=(o1, d1, t1), shadow=(o2, d2, t2)))
        out[f"k5_tri_{bounce}"] = k5_wavefront(o, d, t_cap, scene.tris, "tri", bvh,
                                               f"config5 {what}", plain=bounce == 0)
        if bounce == 0:
            out["k5_tri_shadow"] = k5_wavefront(so, sd, st_max, scene.tris, "tri", bvh,
                                                "config5 bounce-0 shadow rays")
        blocked = traverse.any_hit(so, sd, scene, st_max)
        color = sh["color"] + torch.where(blocked[:, None], 0.0, sh["direct_rgb"])
        state = pt.RayState(origin=sh["origin"], direction=sh["direction"],
                            radiance=sh["radiance"], color=color, flags=sh["flags"],
                            theta_i=sh["theta_i"], prev_pdf=sh["prev_pdf"])
    return out


def phase_hairball_main_path(scene, cam, cfg, dev) -> dict:
    """render_image of config 5 through the kernels: launch counts, the
    image, rays/s (median of TIMED_REPS), peak device memory."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.utils import film

    from ba_pathtracing_fur_torch.ops.cuda import camera as ccamera

    key = rng.key(0, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    img = render(scene, cam, key, cfg)
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"config5: launches {counts}, camera {ccamera.CAMERA_LAUNCHES} (expected stream and "
        f"bruteforce_tri {2 * want} = spp x depth x (closest + shadow), shade and hit {want}, "
        f"camera spp = {cfg.spp}, no plain calls)")
    check_counts(counts, "config5", shade=want, stream=2 * want, bruteforce_tri=2 * want,
                 hit=want)
    if ccamera.CAMERA_LAUNCHES != cfg.spp:
        raise AssertionError(f"config5: {ccamera.CAMERA_LAUNCHES} camera launches, expected "
                             f"one a sample ({cfg.spp})")
    counts["camera_launches"] = ccamera.CAMERA_LAUNCHES
    w, h = cam.resolution
    a = check_image(img, (h, w, 3), "config5")
    log(f"config5 image: finite, max {a.max():.4f}, mean {a.mean():.5f}, std {a.std():.5f}; "
        f"peak device memory of the render {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    OUT_DIR.mkdir(exist_ok=True)
    film.write_png(OUT_DIR / "smoke_hair_ball.png", a)
    times = phase_timing(scene, cam, key, cfg, name="config5", with_plain=False)
    return dict(counts=counts, times=times, img=img)


def bounce1_pairs(scene, cam, cfg, dev) -> tuple:
    """Bounce 0 of `scene` as the joint path traces it
    (`trace_bounce_fused_joint`) -> the bounce-1 rays and the bounce-0
    shadow rays, (o, d, t_max) each, which `traverse.joint_wavefront` pairs."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    w, h = cam.resolution
    state, keys = pt.camera_wavefront(cam, torch.arange(w * h, device=dev), rng.key(0, dev),
                                      [0], cfg)
    state, pend = pt.trace_bounce_fused_joint(state, pt.init_pending(w * h, dev), scene, keys, 0,
                                              cfg, pt.BounceTables.of(scene))
    return (state.origin, state.direction, pt._trace_cap(state), pend["o"], pend["d"],
            pend["tmax"])


def phase_joint(scene, cam, cfg, dev, separate) -> dict:
    """The joint closest + shadow path (`RenderConfig.joint_shadows`) on
    config 5, against the separate fused render `separate` of the same
    scene and config. K3's mixed mode on the real bounce-1 pairs (bounce 0
    run as the joint path runs it; the continuation rays and the bounce-0
    shadow rays, pair-sorted by `traverse.joint_wavefront`): against K3's
    closest and any launches on the same pairs on every ray (closest rays'
    found, t and rows, shadow rays' found and t bit for bit) and against
    the mixed plain version on TWIN_RAYS pairs; the mixed launch timed
    beside the two launches it replaces (on the pair order and on each
    set's own sort) and bounded (`stream_bound` with the flags). The joint
    render: launches (the mixed kernel a bounce, no plain call), bit for bit
    equal to `separate`, rays/s beside the separate render (median of
    TIMED_REPS, in turns), one traced sample of each; then the compacted
    joint sample against the uncompacted one (`phase_compaction`)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    bvh, key = scene.cone_bvh, rng.key(0, dev)
    w, h = cam.resolution
    pairs = bounce1_pairs(scene, cam, cfg, dev)
    o2, d2, t2, is_any, _ = traverse.joint_wavefront(*pairs, bvh)
    t, row, found = cstream.traverse_stream(o2, d2, t2, bvh, "cone", is_any=is_any)
    sets = {"closest": (o2[0::2].contiguous(), d2[0::2].contiguous(), t2[0::2].contiguous()),
            "any": (o2[1::2].contiguous(), d2[1::2].contiguous(), t2[1::2].contiguous())}
    tc, rc, fc = cstream.traverse_stream(*sets["closest"], bvh, "cone")
    ta, _, fa = cstream.traverse_stream(*sets["any"], bvh, "cone", any_hit=True)
    sub = (2 * spread(w * h, TWIN_RAYS, dev)[:, None] + torch.arange(2, device=dev)).reshape(-1)
    t0, r0, f0 = cstream.traverse_stream_ref(o2[sub], d2[sub], t2[sub], bvh, "cone",
                                             is_any=is_any[sub])
    torch.cuda.synchronize()
    vs_launches = dict(found=int((fc != found[0::2]).sum() + (fa != found[1::2]).sum()),
                       t=int((tc != t[0::2]).sum() + (ta != t[1::2]).sum()),
                       rows=int((rc != row[0::2]).sum()))
    vs_twin = dict(found=int((f0 != found[sub]).sum()), t=int((t0 != t[sub]).sum()),
                   rows=int((r0[0::2] != row[sub][0::2]).sum()))
    err = float((t0 - t[sub]).abs().max())
    log(f"traverse_stream cone mixed, config5 bounce-1 pairs (pair-sorted): {w * h} pairs, "
        f"closest found {int(found[0::2].sum())}, shadow rays live "
        f"{int((t2[1::2] > 0).sum())}, blocked {int(found[1::2].sum())}; vs the closest and "
        f"any launches on every ray: found/t/row mismatches {vs_launches}; vs the mixed plain "
        f"version on {TWIN_RAYS} pairs: {vs_twin}, max |t diff| {err}")
    if any(vs_launches.values()) or any(vs_twin.values()) \
            or not (t[1::2][found[1::2]] == 0.0).all():
        raise AssertionError("traverse_stream mixed: kernel disagrees")
    own = {k: sorted_rays(*v, bvh)[:3] for k, v in sets.items()}
    times = dict(
        mixed_ms=timed(lambda: cstream.traverse_stream(o2, d2, t2, bvh, "cone",
                                                       is_any=is_any), 3),
        closest_ms=timed(lambda: cstream.traverse_stream(*sets["closest"], bvh, "cone"), 3),
        any_ms=timed(lambda: cstream.traverse_stream(*sets["any"], bvh, "cone",
                                                     any_hit=True), 3),
        closest_own_sort_ms=timed(lambda: cstream.traverse_stream(*own["closest"], bvh,
                                                                  "cone"), 3),
        any_own_sort_ms=timed(lambda: cstream.traverse_stream(*own["any"], bvh, "cone",
                                                              any_hit=True), 3),
        pair_sort_ms=timed(lambda: traverse.joint_wavefront(*pairs, bvh), 3),
        two_sorts_ms=timed(lambda: [sorted_rays(*v, bvh) for v in
                                    (pairs[:3], pairs[3:])], 3),
        plain_ms=timed(lambda: cstream.traverse_stream_ref(o2[sub], d2[sub], t2[sub], bvh,
                                                           "cone", is_any=is_any[sub]), 1))
    log(f"config5 bounce-1 pairs, K3 times ({2 * w * h} rays; plain on {2 * TWIN_RAYS}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    res = dict(times=times, max_abs_err=err, vs_launches=vs_launches, vs_twin=vs_twin,
               bound=stream_bound(o2, d2, t2, bvh, False, t, row, found, is_any=is_any),
               pairs=(o2, d2, t2, is_any, (t, row, found)))
    del pairs, o2, d2, t2, is_any, t, row, found, sets, own

    joint = dataclasses.replace(cfg, joint_shadows=True)
    n = cfg.spp * cfg.depth
    reset_counts()
    img = render(scene, cam, key, joint)
    res["counts"] = read_counts()
    log(f"config5 joint: launches {res['counts']} (expected stream_mixed {n} = spp x depth, "
        f"stream {cfg.spp} (the last bounce's shadow rays), bruteforce_tri "
        f"{cfg.spp * (2 * cfg.depth + 1)}, shade and hit {n}, no plain calls)")
    check_counts(res["counts"], "config5 joint", stream_mixed=n, stream=cfg.spp,
                 bruteforce_tri=cfg.spp * (2 * cfg.depth + 1), shade=n, hit=n)
    if not torch.equal(img, separate):
        d = (img - separate).abs()
        raise AssertionError(f"config5 joint: the image differs from the separate fused one "
                             f"(max {d.max().item():.3e} over {(d > 0).any(-1).sum().item()} px)")
    log("config5 joint image: bit for bit equal to the separate fused image")
    rays = w * h * cfg.spp * cfg.depth
    walls = {"joint": [], "separate": []}
    for rep in range(TIMED_REPS):
        for name in (("joint", "separate") if rep % 2 == 0 else ("separate", "joint")):
            torch.cuda.synchronize()
            start = time.perf_counter()
            render(scene, cam, key, joint if name == "joint" else cfg)
            walls[name].append(time.perf_counter() - start)
    marks = ("stream_kernel", "brute_kernel", "shade_kernel")
    for name, c in (("joint", joint), ("separate", cfg)):
        med = float(np.median(walls[name]))
        res[name] = dict(wall=med, reps=walls[name], rays_per_s=rays / med,
                         profile=phase_profile(scene, cam, key, c, name=f"config-5 {name}",
                                               marks=marks))
        log(f"config5 {name} render: median {med:.4f} s of {walls[name]} -> "
            f"{rays / med:.4e} rays/s")
    res["compaction"] = phase_compaction(scene, cam, joint, "config5 joint",
                                         stream_mixed=cfg.depth, stream=1,
                                         bruteforce_tri=2 * cfg.depth + 1, shade=cfg.depth,
                                         hit=cfg.depth)
    return res


K3_CONTROLS = {}  # name -> [library path, nvcc process, loaded stream_launch or None]


def start_k3_controls() -> None:
    """Start nvcc of K3's controls, each traverse_stream.cu in a directory of
    its own under the kernels' build directory: the MXU_MUTANTS (a copy of
    csrc with the mutation applied, the port's flags) and "fmad" (the
    port's csrc with FMA contraction on). They build beside the port's own
    kernels; `k3_build` waits for one and loads it."""
    from ba_pathtracing_fur_torch import kernels

    root = kernels.BUILD_DIR / "k3_controls"
    for name in ("fmad", *MXU_MUTANTS):
        out = root / name
        shutil.rmtree(out, ignore_errors=True)
        flags = kernels.SOURCE_FLAGS["traverse_stream.cu"]
        src = kernels.SRC_DIR
        if name == "fmad":
            flags = tuple(f for f in flags if f != "-fmad=false")
        else:
            src = out / "csrc"
            shutil.copytree(kernels.SRC_DIR, src)
            file, old, new = MXU_MUTANTS[name]
            text = (src / file).read_text()
            if text.count(old) != 1:
                raise AssertionError(f"K3 control {name}: its lines are not in {file} once")
            (src / file).write_text(text.replace(old, new))
        out.mkdir(parents=True, exist_ok=True)
        lib = out / "libtraverse_stream.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *flags, "-I", str(src), "-o", str(lib),
               str(src / "traverse_stream.cu")]
        K3_CONTROLS[name] = [lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), None]


def stop_k3_controls() -> None:
    """End any control build still running."""
    for _, proc, _ in K3_CONTROLS.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


@contextlib.contextmanager
def k3_build(name: str):
    """traverse_stream launches the K3 control `name` (`start_k3_controls`)
    in place of the port's build."""
    import ctypes
    import types
    from ba_pathtracing_fur_torch import kernels

    entry = K3_CONTROLS[name]
    if entry[2] is None:
        out = entry[1].communicate()[0]
        if entry[1].returncode != 0:
            raise RuntimeError(f"nvcc failed for the K3 control {name}:\n{out}")
        fn = ctypes.CDLL(str(entry[0])).stream_launch
        fn.argtypes, fn.restype = kernels.SIGNATURES["stream_launch"][1], ctypes.c_int
        entry[2] = fn
    base = kernels.load_library()
    kernels._lib = types.SimpleNamespace(**{**vars(base), "stream_launch": entry[2]})
    try:
        yield
    finally:
        kernels._lib = base


def variant_hooks(variant: str, calls: list | None = None, b16=None):
    """`closest_fn(o, d, scene)` and `occlude_fn(o, d, scene, t_max)` for
    `render_sample_ids` that trace the scene's two-level cone BVH with one
    of K3's variants ("f32", "mxu": traverse_stream(mxu=True), "bf16": the
    BVH's pack_prim_hbm bf16 pack, `b16` or made once), as a user of the API
    writes them: `traverse.closest_hit` and `traverse.any_hit` on the scene
    with the traced BVH (the bf16 pack's for "bf16", so the sort keys on its
    refitted root box and the Hit reads its rounded `aos_rows`), with
    `cstream.traverse_stream` wrapped for the duration of the call to launch
    the variant on the cones, so that a variant moves the image only
    through the rows it picks. Each variant call appends its mode to
    `calls`."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    packs = {}

    def traced(scene):
        bvh = scene.cone_bvh
        if variant != "bf16":
            return scene
        if b16 is not None:
            return dataclasses.replace(scene, cone_bvh=b16)
        if id(bvh) not in packs:
            packs[id(bvh)] = (bvh, cstream.pack_prim_hbm(bvh, "cone", torch.bfloat16))
        return dataclasses.replace(scene, cone_bvh=packs[id(bvh)][1])

    @contextlib.contextmanager
    def launching():
        launch = cstream.traverse_stream

        def variant_launch(o, d, t_max, bvh, kind, any_hit=False, **k):
            if kind == "cone":
                if calls is not None:
                    calls.append("any" if any_hit else "closest")
                k["mxu"] = variant == "mxu"
            return launch(o, d, t_max, bvh, kind, any_hit=any_hit, **k)

        cstream.traverse_stream = variant_launch
        try:
            yield
        finally:
            cstream.traverse_stream = launch

    def closest_fn(o, d, scene):
        with launching():
            return traverse.closest_hit(o, d, traced(scene))

    def occlude_fn(o, d, scene, t_max):
        with launching():
            return traverse.any_hit(o, d, traced(scene), t_max)

    return closest_fn, occlude_fn


def hook_render(scene, cam, key, cfg, variant: str, calls: list | None = None,
                b16=None) -> torch.Tensor:
    """render_image's running mean over cfg.spp samples, each sample through
    `render_sample_ids` with `variant_hooks(variant, calls, b16)` (neither
    package's render_image takes the hooks) -> [H, W, 3]."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import tonemap

    closest_fn, occlude_fn = variant_hooks(variant, calls, b16)
    w, h = cam.resolution
    ids = torch.arange(w * h, device=scene.device)
    tables = pt.BounceTables.of(scene) if cfg.fused_shading else None
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
    for i in range(cfg.spp):
        c = pt.render_sample_ids(scene, cam, ids, key, i, cfg, tables, closest_fn=closest_fn,
                                 occlude_fn=occlude_fn)
        acc = acc + (c - acc) / (i + 1.0)
    img = acc.reshape(h, w, 3)
    return tonemap.tonemap(img) if cfg.tonemap else img


def brute_f64(o, d, t_max, bvh):
    """(row, found) of closest hits by the cone test in f64 over every row of
    the (upcast) pack: the exact arithmetic's answer, which both f32 tests
    approximate."""
    from ba_pathtracing_fur_torch.ops import bvh as bvh_mod
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    comp = [c.double() for c in ctraverse._rows_cm(bvh)]
    step = max(1, (1 << 25) // comp[0].shape[1])
    rows, founds = [], []
    for s in range(0, o.shape[0], step):
        t = bvh_mod._cone_core(o[s:s + step].double(), d[s:s + step].double(), comp, 1e-4,
                               t_max[s:s + step].double())
        row = t.argmin(-1)
        found = t.gather(-1, row[:, None])[:, 0] < 3.4e38
        rows.append(torch.where(found, row, -1).to(torch.int32))
        founds.append(found)
    return torch.cat(rows), torch.cat(founds)


def cone_margins(o, d, g, t_min: float = 1e-4) -> dict:
    """How near the f32 cone test's decisions are to flipping, for rays o, d
    [N, 3] each against one row g [N, 16], evaluated in f64, each as its
    distance over the size of its f32 error, so that two f32 evaluations of
    the test can disagree on a decision only where its margin is a few
    times 6e-8 (f32's unit roundoff) or less: `disc` the discriminant over
    b^2 + |ac| + 2 |d|^2 |p| P (its terms' rounding, and p's rounding at
    P = |o| + |b|: the mxu test's p = o.u - b.u rounds there, however near
    the cone), `axis` each root's axis coordinate's distance to the nearer
    end over |o.v| + |t d.v| + |d.v| P, `t_min` each root's distance to
    1e-4 and t_min over `t_err`, the roots' error scale (|b| + |d| P +
    that disc scale / 2 sqrt(disc)) / |a| (both inf where the f64
    discriminant is negative: no roots to decide on), and `t` the accepted
    root (inf where the f64 test misses). A far ray (|p| ~ 2 from fibers of
    r ~ 0.002 at the hair ball's camera) puts every decision of the
    quadratic within ~1e-6 of its scale; a ray from a fiber's surface loses
    its precision to the mxu test's rounding of p."""
    o, d = o.double(), d.double()
    b, u, v, w = g[:, 0:3], g[:, 3:6], g[:, 6:9], g[:, 9:12]
    slope, r_base, min_d, max_d = g[:, 12], g[:, 13], g[:, 14], g[:, 15]
    r = o - b
    px, py, pz = (r * u).sum(-1), (r * v).sum(-1), (r * w).sum(-1)
    dx, dy, dz = (d * u).sum(-1), (d * v).sum(-1), (d * w).sum(-1)
    a = dx * dx + dz * dz - slope * slope * dy * dy
    bq = px * dx + pz * dz + r_base * slope * dy - slope * slope * py * dy
    c_lin = r_base - slope * py
    c = px * px + pz * pz - c_lin * c_lin
    disc = bq * bq - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a.abs() < 1e-12, 1e-12, a)
    ra, rb = (-bq - sq) / a_safe, (-bq + sq) / a_safe
    roots = torch.stack([torch.minimum(ra, rb), torch.maximum(ra, rb)])
    ov = (o * v).sum(-1)
    ax = ov + roots * dy
    ok = (disc >= 0.0) & (roots >= 1e-4) & (roots > t_min) & (ax >= min_d) & (ax <= max_d)
    t = torch.where(ok[0], roots[0], torch.where(ok[1], roots[1], float("inf")))
    big_p = o.norm(dim=-1) + b.norm(dim=-1)
    dn = d.norm(dim=-1)
    disc_scale = bq * bq + (a * c).abs() + 2 * dn * dn * r.norm(dim=-1) * big_p
    t_err = (bq.abs() + dn * big_p + disc_scale / (2 * sq).clamp(min=1e-300)) / a_safe.abs()
    no_roots = (disc < 0.0)[None]  # the roots' decisions only count where there are roots
    return dict(disc=disc.abs() / disc_scale,
                axis=torch.where(no_roots, float("inf"),
                                 torch.minimum((ax - min_d).abs(), (ax - max_d).abs())
                                 / (ov.abs() + (roots * dy).abs() + dy.abs() * big_p)),
                t_min=torch.where(no_roots, float("inf"),
                                  torch.minimum((roots - 1e-4).abs(), (roots - t_min).abs())
                                  / t_err),
                t=t, t_err=t_err)


def near_ties(o, d, bvh, a: tuple, b: tuple, tol: float = TIE_REL,
              t_min: float = 1e-4) -> dict:
    """Do two closest-hit results a = (row, found) and b = (row, found) [R]
    over one cone pack (rows of `bvh.packed`, upcast) differ only by near
    ties? Each row a side found is evaluated in f64 (`cone_margins`): it is
    marginal when a decision of its test (the discriminant, an axis end or
    t_min) lies within `tol` of flipping, and plausible when the f64 test
    hits it or it is marginal. A ray where one side found nothing is a near
    tie when the other side's row is marginal; a ray where the two found
    different rows is one when both rows are plausible and one of them is
    marginal or the two lie within `tol` of each other in t (over the sum of
    their `t_err`). Returns `agree` [R] (the same found and, where found,
    the same row), `tie` [R] (agreeing or a near tie), `margin` [R] (the smallest
    relative distance of the ray's rows' decisions; 0 where they agree) and
    `t_gap` [R] (|t_a - t_b| over the sum of their t_err, in f64, where both
    sides found a row the f64 test hits, else nan)."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    (row_a, found_a), (row_b, found_b) = a, b
    agree = (found_a == found_b) & (~found_a | (row_a == row_b))
    margin = torch.zeros(agree.shape, dtype=torch.float64, device=agree.device)
    t_gap = torch.full(agree.shape, float("nan"), dtype=torch.float64, device=agree.device)
    tie = agree.clone()
    idx = (~agree).nonzero()[:, 0]
    if idx.numel():
        flat = torch.stack(ctraverse._rows_cm(bvh))[:, 0].double()  # [W, C*K]
        marg, hit, ts, errs = [], [], [], []
        for row in (row_a[idx], row_b[idx]):
            m = cone_margins(o[idx], d[idx], flat[:, row.long().clamp(min=0)].T, t_min)
            marg.append(torch.minimum(m["disc"], torch.minimum(m["axis"].amin(0),
                                                               m["t_min"].amin(0))))
            hit.append(torch.isfinite(m["t"]))
            ts.append(m["t"])
            errs.append(m["t_err"])
        fa, fb = found_a[idx], found_b[idx]
        marginal = [x <= tol for x in marg]
        plausible = [h | mg for h, mg in zip(hit, marginal)]
        gap = (ts[0] - ts[1]).abs() / (errs[0] + errs[1])
        t_tie = gap <= tol
        t_gap[idx] = torch.where(torch.isfinite(gap), gap, float("nan"))
        tie[idx] = torch.where(fa & fb, plausible[0] & plausible[1]
                               & (marginal[0] | marginal[1] | t_tie),
                               torch.where(fa, marginal[0], marginal[1]))
        inf = torch.full_like(marg[0], float("inf"))
        margin[idx] = torch.minimum(torch.where(fa, marg[0], inf), torch.where(fb, marg[1], inf))
    return dict(agree=agree, tie=tie, margin=margin, t_gap=t_gap)


def agreement(o, d, bvh, a: tuple, b: tuple, closest) -> dict:
    """How two results (row, found) of the same rays over one pack agree:
    found agreement, winner-row agreement on the both-found closest rays
    (an any hit's row is whichever accepted row came first), and over the
    rays where they differ (`near_ties` at TIE_REL): how many are no near
    ties, the largest margin, how many differing row pairs are consecutive
    cones of one fiber (original ids one apart) and the median t gap (over
    the two rows' t_err) of the pairs both hit in f64."""
    (ra, fa), (rb, fb) = a, b
    both = fa & fb & closest
    rb = torch.where(~closest & fa & fb, ra, rb)
    ties = near_ties(o, d, bvh, (ra, fa), (rb, fb))
    diff = ~ties["agree"]
    pair = diff & fa & fb
    ids = (bvh.perm[ra[pair].long()].long() - bvh.perm[rb[pair].long()].long()).abs()
    gaps = ties["t_gap"][pair]
    gaps = gaps[~gaps.isnan()]
    n_both = int(both.sum())  # no closest ray found on both sides: rows agree
    return dict(rays=int(fa.numel()), found=float((fa == fb).double().mean()),
                rows=float((both & (ra == rb)).sum()) / n_both if n_both else 1.0,
                rows_compared=n_both, differ=int(diff.sum()),
                not_ties=int((~ties["tie"]).sum()),
                max_margin=float(ties["margin"][diff].max()) if diff.any() else 0.0,
                consecutive_cones=int((ids == 1).sum()), row_pairs=int(pair.sum()),
                median_t_gap=float(gaps.median()) if gaps.numel() else 0.0)


def mxu_gate(a: dict, wave: str) -> list:
    """What an `agreement` of the mxu test on wavefront `wave` fails of the
    row gate: found under MXU_FOUND_FLOOR, rows under MXU_ROWS_FLOOR[wave],
    differing rays that are no near ties."""
    fails = []
    if a["found"] < MXU_FOUND_FLOOR:
        fails.append(f"found {a['found']:.6f} < {MXU_FOUND_FLOOR}")
    if a["rows"] < MXU_ROWS_FLOOR[wave]:
        fails.append(f"rows {a['rows']:.6f} < {MXU_ROWS_FLOOR[wave]}")
    if a["not_ties"]:
        fails.append(f"{a['not_ties']} differing rays no near ties")
    return fails


def drift(a: tuple, b: tuple, closest) -> dict:
    """Found and winner-row agreement of two results (row, found) of the same
    rays over two packs (the f32 and the bf16 one)."""
    (ra, fa), (rb, fb) = a, b
    both = fa & fb & closest
    n_both = int(both.sum())
    return dict(found=float((fa == fb).double().mean()),
                rows=float((both & (ra == rb)).sum()) / n_both if n_both else 1.0,
                found_f32=int(fa.sum()), found_bf16=int(fb.sum()))


def image_diff(a: np.ndarray, b: np.ndarray) -> dict:
    """Two renders' difference: the image gate's per-pixel numbers (mean
    |diff|, the share of pixels off by more than IMG_FLIP, and whether
    both are within IMG_MEAN and IMG_FLIP_FRAC), the mean |diff| of
    IMG_TILE x IMG_TILE-pixel tile means, and the relative difference of the
    images' means, (a - b) / b, signed."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    d = np.abs(a - b)
    mean, flips = float(d.mean()), float(np.mean(d.max(-1) > IMG_FLIP))
    h, w = a.shape[0] // IMG_TILE * IMG_TILE, a.shape[1] // IMG_TILE * IMG_TILE
    tiles = (a - b)[:h, :w].reshape(h // IMG_TILE, IMG_TILE, w // IMG_TILE, IMG_TILE, -1)
    return dict(mean=mean, flips=flips, pixel_gate_held=mean < IMG_MEAN and flips <= IMG_FLIP_FRAC,
                tile_mean=float(np.abs(tiles.mean((1, 3))).mean()),
                image_mean_rel=float((a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)))


def tile_spread(n: int, k: int, dev) -> torch.Tensor:
    """About k ray indices of a wavefront of n as whole kernel ray tiles
    (ctraverse.TILE_RAYS consecutive rays; whole pairs on a pair-sorted
    wavefront) spread evenly over it."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    tile = ctraverse.TILE_RAYS
    first = spread(n // tile, max(1, min(k // tile, n // tile)), dev) * tile
    return (first[:, None] + torch.arange(tile, device=dev)).reshape(-1)


def variant_bound(o, d, t_max, bvh, any_hit, hit, is_any, mxu) -> dict:
    """A K3 variant's bound on one wavefront: `work_ref` (with `mxu`) on
    VARIANT_WORK_RAYS rays of it, as whole ray tiles spread over it
    (`tile_spread`), from the variant's own hits, scaled; the FP32
    operations over the FP32 peak plus the TF32 products (ctraverse.
    MXU_TERMS a projection) over the tensor cores' TF32 peak, against the
    bytes (rays, boxes and tables, the entered leaves of the pack, 2 bytes a
    value for bf16, the outputs) over the memory rate. With `mxu`, the
    fewest unit-major mma tiles those tiles of rays need (`mma_tiles`,
    scaled), their fill (rays a tile over ctraverse.UNIT_RAYS) and the
    mma.sync a frame vector (ctraverse.MXU_PASSES)."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    r, dev = o.shape[0], o.device
    sub = tile_spread(r, VARIANT_WORK_RAYS, dev)
    w = ctraverse.work_ref(o[sub], d[sub], t_max[sub], bvh, "cone", any_hit=any_hit,
                           hit=tuple(x[sub] for x in hit),
                           is_any=None if is_any is None else is_any[sub], mxu=mxu)
    scale = r / sub.numel()
    n_bytes = nbytes(o, d, t_max, bvh.bmin, bvh.bmax, bvh.sboxes, bvh.cboxes) \
        + w["leaf_bytes"] + r * 9 + (0 if is_any is None else nbytes(is_any))
    t_ops = (w["flops"] / PEAK_FP32_FLOPS + w["tf32_flops"] / PEAK_TF32_FLOPS) * scale * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    res = dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
               else "bytes", flops=w["flops"] * scale, tf32_flops=w["tf32_flops"] * scale,
               bytes=n_bytes, row_tests_per_ray=w["leaf_row_tests"] / sub.numel())
    if mxu:
        res.update(mma_tiles=w["mma_tiles"] * scale, mma_rays=w["mma_rays"] * scale,
                   mma_fill=w["mma_rays"] / max(1, ctraverse.UNIT_RAYS * w["mma_tiles"]),
                   mma_passes=ctraverse.MXU_PASSES[bvh.packed.element_size()])
    return res


def hold_variant(wf: tuple, bvh, mxu: bool, ref, what: str, wave: str) -> dict:
    """One K3 variant (`mxu`, on `bvh`'s f32 or bf16 pack) on one sorted
    wavefront wf = (o, d, t_max, is_any, any_hit), named `wave`: against its
    plain version on VARIANT_PLAIN_RAYS rays spread over it (bf16: found, t
    and closest rows bit for bit; mxu: `mxu_gate`) and against `ref` = (t,
    row, found), the f32 test's kernel on the same pack, on every ray (mxu:
    `mxu_gate`); timed (median of TIMED_REPS) and bounded."""
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    o, d, t_max, is_any, any_hit = wf
    r, dev = o.shape[0], o.device
    kw = dict(any_hit=any_hit, is_any=is_any, mxu=mxu)
    t, row, found = cstream.traverse_stream(o, d, t_max, bvh, "cone", **kw)
    closest = torch.full((r,), not any_hit, device=dev) if is_any is None else ~is_any
    sub = spread(r, VARIANT_PLAIN_RAYS, dev)
    if is_any is not None:
        sub = (2 * spread(r // 2, VARIANT_PLAIN_RAYS // 2, dev)[:, None]
               + torch.arange(2, device=dev)).reshape(-1)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    t0, r0, f0 = cstream.traverse_stream_ref(o[sub], d[sub], t_max[sub], bvh, "cone",
                                             any_hit=any_hit,
                                             is_any=None if is_any is None else is_any[sub],
                                             mxu=mxu)
    e1.record()
    torch.cuda.synchronize()
    res = dict(rays=r, found=int(found.sum()), plain_ms=e0.elapsed_time(e1),
               plain_rays=int(sub.numel()))
    same = f0 & found[sub] & ((r0 == row[sub]) | ~closest[sub])
    res["max_abs_err"] = float((t0 - t[sub])[same].abs().max()) if same.any() else 0.0
    if not mxu:
        res["vs_plain"] = dict(found=int((f0 != found[sub]).sum()),
                               t=int((t0 != t[sub]).sum()),
                               rows=int(((r0 != row[sub]) & closest[sub]).sum()))
        if any(res["vs_plain"].values()):
            raise AssertionError(f"{what}: the bf16 kernel disagrees with its plain version: "
                                 f"{res['vs_plain']}")
    else:
        res["vs_plain"] = agreement(o[sub], d[sub], bvh, (r0, f0), (row[sub], found[sub]),
                                    closest[sub])
        res["vs_f32_test"] = agreement(o, d, bvh, (ref[1], ref[2]), (row, found), closest)
        for k in ("vs_plain", "vs_f32_test"):
            fails = mxu_gate(res[k], wave)
            if fails:
                raise AssertionError(f"{what}: the mxu kernel fails the row gate {k}: {fails}; "
                                     f"{res[k]}")
    res["ms"] = timed_median(lambda: cstream.traverse_stream(o, d, t_max, bvh, "cone", **kw))
    res["bound"] = variant_bound(o, d, t_max, bvh, any_hit, (t, row, found), is_any, mxu)
    res["result"] = (t, row, found)
    log(f"{what}: {r} rays, found {res['found']}; vs plain on {res['plain_rays']} rays "
        f"({res['plain_ms']:.1f} ms): {res['vs_plain']}"
        + (f"; vs the f32 test on every ray: {res['vs_f32_test']}" if mxu else "")
        + f"; {res['ms']:.4f} ms, bound {res['bound']['bound_ms']:.4f} ms by "
        f"{res['bound']['bound_by']} ({res['bound']['row_tests_per_ray']:.1f} row tests a ray"
        + (f"; at least {res['bound']['mma_tiles']:.4e} mma tiles of "
           f"{res['bound']['mma_rays']:.4e} (ray, unit) entries, fill "
           f"{res['bound']['mma_fill']:.4f}" if mxu else "") + ")")
    return res


def hold_k3_controls(wf: tuple, bvh, ref, wave: str, mutants: bool) -> dict:
    """K3's controls (`k3_build`) on wavefront wf = (o, d, t_max, is_any,
    any_hit), named `wave`, against `ref` = (t, row, found), the f32 test's
    kernel: each one's `agreement` and what it fails of `mxu_gate`. "fmad"
    (the f32 test of the FMA build, the image gate's control) is reported;
    each MXU_MUTANTS kernel (with `mutants`) must fail the gate."""
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    o, d, t_max, is_any, any_hit = wf
    closest = torch.full((o.shape[0],), not any_hit, device=o.device) if is_any is None \
        else ~is_any
    out = {}
    for name in ("fmad", *(MXU_MUTANTS if mutants else ())):
        with k3_build(name):
            _, row, found = cstream.traverse_stream(o, d, t_max, bvh, "cone", any_hit=any_hit,
                                                    is_any=is_any, mxu=name != "fmad")
        a = agreement(o, d, bvh, (ref[1], ref[2]), (row, found), closest)
        a["fails"] = mxu_gate(a, wave)
        log(f"K3 control {name!r}, {wave}: vs the f32 test on every ray {a}")
        if name != "fmad" and not a["fails"]:
            raise AssertionError(f"{wave}: the row gate passes the mxu control {name!r}: {a}")
        out[name] = a
    return out


def terrain_stream(dev) -> tuple:
    """Config 3's terrain (TRI_STREAM) on a two-level median BVH -> (scene,
    camera)."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    c = TRI_STREAM
    scene, cam = builtins.tri_terrain(resolution=c["res"], n_tris=c["n_tris"], device=dev)
    scene = traverse.attach_bvh(scene, method="median", fanout=c["fanout"])
    b = scene.tri_bvh
    if not 0 < b.fanout < b.n_leaves:
        raise AssertionError(f"terrain: not a two-level BVH: {b.n_leaves} leaves, fanout "
                             f"{b.fanout}")
    return scene, cam


def k3_occupancy(packs: dict, kind: str, what: str) -> dict:
    """Each K3 instance a launch on these packs ({"f32": bvh, "bf16": its
    bf16 pack}) takes (closest, any and mixed; cones also mxu): its dynamic
    shared memory a block and the blocks an SM holds (`cstream.occupancy`),
    printed; fails the run where one holds fewer than K3_MIN_BLOCKS, the
    blocks its 64-register cap is built for. Nothing on the CPU."""
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    out, leaf_k = {}, packs["f32"].leaf_size
    if packs["f32"].packed.device.type != "cuda":
        return out
    for pack, bvh in packs.items():
        for mxu in ((False, True) if kind == "cone" else (False,)):
            for mode in ("closest", "any", "mixed"):
                name = f"K3 {kind} {mode}{' mxu' if mxu else ''} {pack}"
                out[name] = cstream.occupancy(bvh, kind, mode, mxu)
    log(f"K3 occupancy, {what} ({leaf_k}-row leaves): "
        + ", ".join(f"{k} {v['bytes']} B a block, {v['blocks_per_sm']} a SM"
                    for k, v in out.items()))
    low = {k: v for k, v in out.items() if v["blocks_per_sm"] < K3_MIN_BLOCKS}
    if low:
        raise AssertionError(f"{what}: K3 instances under {K3_MIN_BLOCKS} blocks an SM: {low}")
    return out


def phase_stream_tri(dev) -> dict:
    """K3's triangle instances, f32 and bf16 (closest and any hit): config
    3's terrain on a two-level median BVH (fanout 64), its camera wavefront
    and shadow rays, entry-morton sorted: each against its plain version
    (found, t and closest rows bit for bit on TWIN_RAYS rays spread over
    it), timed (the median of single calls, each between its own events,
    and the mean of 10 calls back to back) and bounded, the bf16 drift
    against f32 reported."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream, traverse as ctraverse

    scene, cam = terrain_stream(dev)
    b = scene.tri_bvh
    t0 = time.perf_counter()
    b16 = cstream.pack_prim_hbm(b, "tri", torch.bfloat16)
    torch.cuda.synchronize()
    out = dict(bvh=(b.n_leaves, b.leaf_size, b.fanout), triangles=scene.tris.count,
               pack_s=time.perf_counter() - t0,
               occupancy=k3_occupancy({"f32": b, "bf16": b16}, "tri", "terrain"))
    cfg = pt.RenderConfig(depth=4, spp=1, compact=False, fused_shading=True)
    waves = camera_and_shadow_rays(scene, cam, cfg, dev)
    for name, (o, d, t_max), any_hit in (("camera", waves[0], False),
                                         ("shadow", waves[1], True)):
        o, d, t_max, _ = sorted_rays(o, d, t_max, b)
        sub = spread(o.shape[0], TWIN_RAYS, dev)
        res = {}
        for pack, bvh in (("f32", b), ("bf16", b16)):
            run = lambda: cstream.traverse_stream(o, d, t_max, bvh, "tri", any_hit=any_hit)  # noqa
            t, row, found = run()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            tp, rp, fp = cstream.traverse_stream_ref(o[sub], d[sub], t_max[sub], bvh, "tri",
                                                     any_hit=any_hit)
            e1.record()
            torch.cuda.synchronize()
            bad = dict(found=int((fp != found[sub]).sum()), t=int((tp != t[sub]).sum()),
                       rows=0 if any_hit else int((rp != row[sub]).sum()))
            if any(bad.values()):
                raise AssertionError(f"traverse_stream tri {pack} {name}: kernel disagrees "
                                     f"with plain: {bad}")
            ws = spread(o.shape[0], min(WORK_RAYS, o.shape[0]), dev)
            w = ctraverse.work_ref(o[ws], d[ws], t_max[ws], bvh, "tri", any_hit=any_hit,
                                   hit=(t[ws], row[ws], found[ws]))
            n_bytes = nbytes(o, d, t_max, bvh.bmin, bvh.bmax, bvh.sboxes, bvh.cboxes) \
                + w["leaf_bytes"] + o.shape[0] * 9
            res[pack] = dict(found=int(found.sum()), vs_plain=bad, plain_ms=e0.elapsed_time(e1),
                             max_abs_err=float((tp - t[sub]).abs().max()),
                             ms=timed_median(run), ms_back_to_back=timed(run, 10),
                             bound=bound(w["flops"] * o.shape[0] / ws.numel(), n_bytes),
                             hit=(row, found))
        closest = torch.full((o.shape[0],), not any_hit, device=dev)
        res["drift"] = drift(res["f32"].pop("hit"), res["bf16"].pop("hit"), closest)
        log(f"traverse_stream tri, terrain {name} ({o.shape[0]} rays, {b.n_leaves} leaves x "
            f"{b.leaf_size}, fanout {b.fanout}; plain on {TWIN_RAYS}): "
            + "; ".join(f"{p} found {r['found']}, vs plain {r['vs_plain']}, {r['ms']:.4f} ms "
                        f"a call ({r['ms_back_to_back']:.4f} ms a call of 10 back to back; "
                        f"plain {r['plain_ms']:.1f} ms), bound {r['bound']['bound_ms']:.4f} "
                        f"ms by {r['bound']['bound_by']}" for p, r in res.items()
                        if p != "drift")
            + f"; bf16 against f32: {res['drift']}")
        out[name] = res
    return out


def phase_stream_variants(scene, cam, cfg, dev, hb, joint, separate, card) -> dict:
    """K3's last two variants on config 5: the mxu test (f32 and bf16 packs)
    and the bf16 pack (f32 test), each in closest, any and mixed mode, on
    the sorted wavefronts of `phase_hairball_kernels` (`hb`: the camera and
    bounce-1 wavefronts, the bounce-0 shadow rays) and the bounce-1 pairs
    of `phase_joint` (`joint`), by `hold_variant`; K3's controls
    (`hold_k3_controls`: the FMA build on each wavefront, the MXU_MUTANTS on
    the camera and bounce-1 ones, where the row gate must fail them); the
    f32 test and the mxu test against an f64 brute force on the plain rays
    of the closest wavefronts; the bf16 drift against the f32 test; the
    triangle instances on the terrain (`phase_stream_tri`). Then config 5
    rendered through `render_sample_ids`' hooks (`hook_render`; with the f32
    test bit for bit `separate`, the render_image image) with the mxu test,
    with the bf16 pack, with the f32 test of the FMA build (the image
    gate's control) and with each MXU_MUTANTS kernel: each variant's
    launches (a closest and a shadow launch a bounce, no plain call), each
    image's difference from `separate` (`image_diff`; the mxu image's held
    to IMG_CONTROL_RATIO times the control's, which the mutants' must
    exceed; the bf16 image's reported), rays/s beside the f32 render
    (median of TIMED_REPS, in turns) and a traced sample of each. The
    phase's seconds against VARIANT_BUDGET_S."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.ops.cuda import stream as cstream

    start = time.perf_counter()
    bvh = scene.cone_bvh
    t0 = time.perf_counter()
    b16 = cstream.pack_prim_hbm(bvh, "cone", torch.bfloat16)
    torch.cuda.synchronize()
    out = dict(pack_s=time.perf_counter() - t0, pack_bytes=nbytes(b16.packed),
               f32_pack_bytes=nbytes(bvh.packed),
               occupancy=k3_occupancy({"f32": bvh, "bf16": b16}, "cone", "config5"))
    log(f"config5 bf16 pack: {out['pack_bytes']:.4e} bytes (f32 {out['f32_pack_bytes']:.4e}), "
        f"made with its refitted boxes in {out['pack_s']:.3f} s")
    o2, d2, t2, is_any, mixed = joint.pop("pairs")
    waves = {"camera": ((*hb[0]["sorted"]["closest"], None, False), hb[0]["closest"]),
             "bounce1": ((*hb[1]["sorted"]["closest"], None, False), hb[1]["closest"]),
             "shadow": ((*hb[0]["sorted"]["shadow"], None, True), hb[0]["shadow"]),
             "pairs": ((o2, d2, t2, is_any, False),
                       dict(t=mixed[0], row=mixed[1], found=mixed[2]))}
    for x in (0, 1):
        hb[x].pop("sorted")
    for name, (wf, f32) in waves.items():
        o, d, t_max, flags, any_hit = wf
        ref = (f32["t"], f32["row"], f32["found"])
        closest = torch.full((o.shape[0],), not any_hit, device=dev) if flags is None \
            else ~flags
        f32_ms = timed_median(lambda: cstream.traverse_stream(o, d, t_max, bvh, "cone",
                                                              any_hit=any_hit, is_any=flags))
        res = dict(f32_ms=f32_ms)
        res["bf16"] = hold_variant(wf, b16, False, None, f"traverse_stream cone bf16, {name}",
                                   name)
        bf = res["bf16"].pop("result")
        res["bf16"]["drift"] = drift((ref[1], ref[2]), (bf[1], bf[2]), closest)
        res["mxu"] = hold_variant(wf, bvh, True, ref, f"traverse_stream cone mxu, {name}", name)
        res["mxu_bf16"] = hold_variant(wf, b16, True, bf, f"traverse_stream cone mxu bf16, {name}",
                                       name)
        mx = res["mxu"].pop("result")
        res["mxu_bf16"].pop("result")
        # the FMA build everywhere; wrong kernels, which the row gate must fail
        res["controls"] = hold_k3_controls(wf, bvh, ref, name, name in ("camera", "bounce1"))
        if name in ("camera", "bounce1"):  # both f32 tests against the exact arithmetic
            sub = spread(o.shape[0], VARIANT_PLAIN_RAYS, dev)
            exact = brute_f64(o[sub], d[sub], t_max[sub], bvh)
            res["vs_f64"] = {k: agreement(o[sub], d[sub], bvh, exact, (x[1][sub], x[2][sub]),
                                          closest[sub]) for k, x in (("f32", ref), ("mxu", mx))}
        log(f"config5 {name}, K3 variants against the f32 test ({f32_ms:.4f} ms): bf16 "
            f"{res['bf16']['ms']:.4f} ms, drift {res['bf16']['drift']}; mxu "
            f"{res['mxu']['ms']:.4f} ms; mxu bf16 {res['mxu_bf16']['ms']:.4f} ms"
            + (f"; against an f64 brute force on {VARIANT_PLAIN_RAYS} rays: f32 test "
               f"{res['vs_f64']['f32']}, mxu test {res['vs_f64']['mxu']}"
               if "vs_f64" in res else ""))
        out[name] = res
    del waves, o2, d2, t2, is_any, mixed
    out["tri"] = phase_stream_tri(dev)

    key = rng.key(0, dev)
    n = cfg.spp * cfg.depth
    w, h = cam.resolution
    # the hooks themselves: with the f32 test they give render_image's image
    if not torch.equal(hook_render(scene, cam, key, cfg, "f32"), separate):
        raise AssertionError("config5: the f32 hook render differs from render_image")
    log("config5 f32 hook render: bit for bit render_image's image")
    imgs = {}
    for variant, counter in (("mxu", "stream_mxu"), ("bf16", "stream_bf16")):
        reset_counts()
        img = hook_render(scene, cam, key, cfg, variant, b16=b16)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"config5 {variant} hook render: launches {counts} (expected {counter} {2 * n} = spp "
            f"x depth x (closest + shadow), bruteforce_tri {2 * n}, shade and hit {n})")
        check_counts(counts, f"config5 {variant} hook render", **{counter: 2 * n},
                     bruteforce_tri=2 * n, shade=n, hit=n)
        imgs[variant] = check_image(img, (h, w, 3), f"config5 {variant} hook render")
        out[f"render_{variant}"] = dict(counts=counts)
    with k3_build("fmad"):  # the control: the f32 test rounded another way
        imgs["fmad"] = check_image(hook_render(scene, cam, key, cfg, "f32"), (h, w, 3),
                                   "config5 f32 (FMA build) hook render")
    for name in MXU_MUTANTS:  # wrong kernels, which the image gate must fail
        with k3_build(name):
            imgs[name] = check_image(hook_render(scene, cam, key, cfg, "mxu"), (h, w, 3),
                                     f"config5 mxu ({name} mutant) hook render")
    want = separate.cpu().numpy()
    for variant in ("fmad", "mxu", "bf16", *MXU_MUTANTS):
        out.setdefault(f"render_{variant}", {})["diff"] = image_diff(imgs[variant], want)
        log(f"config5 {variant} hook render vs the f32 render: {out[f'render_{variant}']['diff']}")
    ctl = out["render_fmad"]["diff"]
    limit = dict(mean=IMG_CONTROL_RATIO * ctl["mean"], flips=IMG_CONTROL_RATIO * ctl["flips"])
    held = {v: out[f"render_{v}"]["diff"]["mean"] <= limit["mean"]
            and out[f"render_{v}"]["diff"]["flips"] <= limit["flips"]
            for v in ("mxu", *MXU_MUTANTS)}
    out["render_mxu"]["gate"] = gate = dict(mean_limit=limit["mean"],
                                            flips_limit=limit["flips"], held=held["mxu"],
                                            mutants_held={k: held[k] for k in MXU_MUTANTS})
    log(f"config5 hook renders, image gate against the FMA-build control (x "
        f"{IMG_CONTROL_RATIO}: mean |diff| <= {limit['mean']:.4e}, flipped pixels <= "
        f"{limit['flips']:.4f}): "
        + ", ".join(f"{v} {out[f'render_{v}']['diff']['mean']:.4e}, "
                    f"{out[f'render_{v}']['diff']['flips']:.4f}: "
                    f"{'held' if held[v] else 'failed'}" for v in held))
    rays = w * h * cfg.spp * cfg.depth
    runs = {"f32": lambda c: render(scene, cam, key, c),
            "mxu": lambda c: hook_render(scene, cam, key, c, "mxu"),
            "bf16": lambda c: hook_render(scene, cam, key, c, "bf16", b16=b16)}
    walls = {k: [] for k in runs}
    for rep in range(TIMED_REPS):
        for name in (list(runs) if rep % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name](cfg)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    marks = ("stream_kernel", "brute_kernel", "shade_kernel")
    one = dataclasses.replace(cfg, spp=1)
    for name, fn in runs.items():
        med = float(np.median(walls[name]))
        prof = profile_call(lambda: (fn(one), torch.cuda.synchronize()),
                            f"config-5 {name} hook sample" if name != "f32"
                            else "config-5 f32 sample", marks)
        out.setdefault(f"render_{name}", {}).update(
            wall=med, reps=walls[name], rays_per_s=rays / med, traced_launches=prof["launches"],
            traced_busy_ms=prof["busy"] * 1e3,
            idle_share=max(0.0, 1 - prof["busy"] / prof["wall"]),
            stream_ms=prof["kernel_ms"]["stream_kernel"])
        log(f"config5 {name} render: median {med:.4f} s of {walls[name]} -> {rays / med:.4e} "
            f"rays/s; a traced sample: {prof['launches']} launches, idle share "
            f"{out[f'render_{name}']['idle_share']:.3f}, K3 "
            f"{prof['kernel_ms']['stream_kernel']:.3f} ms, on {card}")
    out["seconds"] = time.perf_counter() - start
    log(f"phase_stream_variants: {out['seconds']:.1f} s (budget {VARIANT_BUDGET_S:.0f} s: "
        f"{'held' if out['seconds'] <= VARIANT_BUDGET_S else 'missed'})")
    if not gate["held"] or any(gate["mutants_held"].values()):
        raise AssertionError(f"config5: the image gate against the FMA-build control fails "
                             f"the mxu hook render or passes a mutant's: {gate}")
    return out


VARIANT_WAVES = ("camera", "bounce1", "shadow", "pairs")


def variant_entries(sv: dict, ptx: dict, main_counts: dict) -> tuple:
    """The `kernels` line's entries of K3's two variants from
    `phase_stream_variants`' results `sv`, the build's `ptxas_report` and
    the counts of config 5's main-path render (`main_counts`): launches in
    each variant's hook render and on the main path, its numbers on the
    camera wavefront, every wavefront's beside the f32 test's, the renders
    and the ptxas of its instances."""

    def entry(name, key, counter, ptx_keep):
        cam_v = sv["camera"][key]
        per = {w: dict(ms=sv[w][key]["ms"], f32_ms=sv[w]["f32_ms"],
                       plain_ms=sv[w][key]["plain_ms"], plain_rays=sv[w][key]["plain_rays"],
                       bound_ms=sv[w][key]["bound"]["bound_ms"],
                       bound_by=sv[w][key]["bound"]["bound_by"],
                       **{k: sv[w][key]["bound"][k] for k in ("mma_tiles", "mma_rays",
                                                              "mma_fill")
                          if k in sv[w][key]["bound"]},
                       **{k: sv[w][key][k] for k in ("vs_plain", "vs_f32_test", "drift")
                          if k in sv[w][key]}) for w in VARIANT_WAVES}
        render = {x: {k: sv[f"render_{k}"][x] for k in ("f32", key)}
                  for x in ("rays_per_s", "idle_share", "traced_launches", "stream_ms")}
        render["image"] = dict(sv[f"render_{key}"]["diff"],
                               **{k: v for k, v in sv[f"render_{key}"].items() if k == "gate"})
        return dict(name=name, route="cuda",
                    source="ba_pathtracing_fur_torch/csrc/traverse_stream.cu",
                    replaces="ba_pathtracing_fur_tpu/ops/pallas/stream.py:464",
                    launches=sv[f"render_{key}"]["counts"][counter],
                    main_path_launches=main_counts[counter],
                    max_abs_err=max(sv[w][key]["max_abs_err"] for w in VARIANT_WAVES),
                    ms=cam_v["ms"], plain_ms=cam_v["plain_ms"], plain_rays=cam_v["plain_rays"],
                    bound_ms=cam_v["bound"]["bound_ms"], bound_by=cam_v["bound"]["bound_by"],
                    library_ms=None, f32_ms=sv["camera"]["f32_ms"], wavefronts=per,
                    render=render, ptxas={k: v for k, v in ptx.items() if ptx_keep(k)},
                    occupancy={k: v for k, v in {**sv["occupancy"], **sv["tri"]["occupancy"]}
                               .items() if ptx_keep(k)},
                    phase_seconds=sv["seconds"])

    mxu = entry("traverse_stream_mxu", "mxu", "stream_mxu",
                lambda k: k.startswith("K3") and " mxu" in k)
    mxu.update(bf16={w: dict(ms=sv[w]["mxu_bf16"]["ms"],
                             bound_ms=sv[w]["mxu_bf16"]["bound"]["bound_ms"],
                             mma_fill=sv[w]["mxu_bf16"]["bound"]["mma_fill"],
                             vs_plain=sv[w]["mxu_bf16"]["vs_plain"],
                             vs_bf16_f32_test=sv[w]["mxu_bf16"]["vs_f32_test"])
                     for w in VARIANT_WAVES},
               vs_f64={w: sv[w]["vs_f64"] for w in ("camera", "bounce1")},
               controls={w: sv[w]["controls"] for w in VARIANT_WAVES},
               fmad_image=sv["render_fmad"]["diff"],
               mutant_images={k: sv[f"render_{k}"]["diff"] for k in MXU_MUTANTS})
    bf16 = entry("traverse_stream_bf16", "bf16", "stream_bf16",
                 lambda k: k.startswith("K3") and k.endswith(" bf16") and " mxu" not in k)
    bf16.update(pack_bytes=sv["pack_bytes"], f32_pack_bytes=sv["f32_pack_bytes"],
                pack_s=sv["pack_s"], tri=sv["tri"])
    return mxu, bf16


def phase_bruteforce_cone(dev) -> dict:
    """K5's cone variant on a user path: config 4's fur patch without a BVH
    (262,144 rays x 45,000 cones a call; no BVH, so no ray sort). On its
    camera and bounce-1 wavefronts: held against its twin on every ray,
    timed and bounded (the cull's work counted on K5_CONE_TILES tiles);
    then rendered through the kernels at spp 1 and
    gated against the render of the same patch with a cone BVH (K2)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene import builtins

    scene, cam = builtins.fur_patch(resolution=CONFIG4["res"],
                                    fibers_per_face=CONFIG4["fibers_per_face"], device=dev)
    cfg = pt.RenderConfig(depth=CONFIG4["depth"], spp=1, compact=False, fused_shading=True)
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    res = {}
    for bounce in range(2):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        t_cap = torch.where(alive, traverse.INF, 0.0)
        o, d = state.origin, state.direction
        what = "camera wavefront" if bounce == 0 else "bounce-1 wavefront"
        res[bounce] = k5_wavefront(o, d, t_cap, scene.cones, "cone", None,
                                   f"fur patch {what}", max_tiles=K5_CONE_TILES,
                                   plain=bounce == 0)
        hit = traverse.closest_hit(o, d, scene, t_max=t_cap)
        sh = cshade.shade_bounce(**pt.shade_inputs(state, scene, keys, bounce, cfg, hit,
                                                   pt.BounceTables.of(scene)))
        state = pt.RayState(origin=sh["origin"], direction=sh["direction"],
                            radiance=sh["radiance"], color=sh["color"], flags=sh["flags"],
                            theta_i=sh["theta_i"], prev_pdf=sh["prev_pdf"])
    key = rng.key(0, dev)
    shape = (cam.resolution[1], cam.resolution[0], 3)
    reset_counts()
    a = check_image(render(scene, cam, key, cfg), shape, "fur patch without a BVH")
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"fur patch without a BVH: launches {counts}")
    check_counts(counts, "fur patch without a BVH", shade=want, bruteforce_cone=2 * want,
                 hit=want)
    b = check_image(render(traverse.attach_bvh(scene), cam, key, cfg), shape,
                    "fur patch with a BVH")
    res["gate"] = image_gate(b, a, "fur patch spp 1: BVH-less (K5) vs BVH (K2) image")
    res["launches"] = counts["bruteforce_cone"]
    return res


def phase_mid_hairball(dev) -> dict:
    """A mid-size hair ball with a two-level cone BVH (so K3 runs) through
    the kernels and through their plain versions, under the image gate."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    c = MID_HAIRBALL
    scene, cam = builtins.hair_ball(resolution=c["res"], n_fibers=c["n_fibers"],
                                    on_device=True, device=dev)
    scene = traverse.attach_bvh(scene, method="median", fanout=64)
    b = scene.cone_bvh
    if not 0 < b.fanout < b.n_leaves:
        raise AssertionError(f"mid hair ball: the BVH of {b.n_leaves} leaves is not two-level")
    cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], compact=False, fused_shading=True)
    key = rng.key(0, dev)
    w, h = c["res"]
    reset_counts()
    a = check_image(render(scene, cam, key, cfg), (h, w, 3), "mid hair ball")
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"mid hair ball ({scene.cones.count} cones, BVH {b.n_leaves} leaves x {b.leaf_size}, "
        f"fanout {b.fanout}, {w}x{h}): launches {counts}")
    check_counts(counts, "mid hair ball", shade=want, stream=2 * want, bruteforce_tri=2 * want,
                 hit=want)
    t0 = time.perf_counter()
    with plain_bounces():
        p = check_image(render(scene, cam, key, cfg), (h, w, 3), "mid hair ball plain")
    log(f"mid hair ball render via plain: {time.perf_counter() - t0:.2f} s")
    return image_gate(p, a, "mid hair ball spp 1: kernels vs plain image")

def terrain_scene(dev, c):
    """Config 3 (or the terrain of config `c`) through the entry points: the
    textured terrain on the card and its SAH BVH (the split on the host in
    numpy, the boxes, reorder and kernel layouts on the card)."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene, cam = builtins.tri_terrain(resolution=c["res"], n_tris=c["n_tris"], device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n_tris = scene.tris.count
    t0 = time.perf_counter()
    scene = traverse.attach_bvh(scene, method="sah")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b, st = scene.tri_bvh, traverse.LAST_BUILD_STATS["tri"]
    log(f"terrain: {n_tris} triangles, atlas {tuple(scene.textures.images.shape)}, "
        f"slots {scene.tex_slots}, made in {gen_s:.3f} s; SAH BVH {b.n_leaves} leaves x "
        f"{b.leaf_size}, fanout {b.fanout}, built in {build_s:.3f} s (aabb {st['aabb']:.3f}, "
        f"SAH split on the host {st['split']:.3f}, reorder + pack {st['reorder_pack']:.3f}, "
        f"layouts {st['layouts']:.3f} s)")
    if b.perm.device != scene.tris.v0.device:
        raise AssertionError("terrain: the BVH is not on the card")
    return scene, cam, dict(gen_s=gen_s, build_s=build_s, stages=st)


@contextlib.contextmanager
def captured_shadow_rays(out: list):
    """Record the (o, d, t_max) of every `traverse.any_hit` call (the NEE
    shadow rays of the unfused bounce) into `out`."""
    from ba_pathtracing_fur_torch.ops import traverse

    fn = traverse.any_hit

    def spy(o, d, scene, t_max, *a, **k):
        out.append((o, d, t_max))
        return fn(o, d, scene, t_max, *a, **k)

    traverse.any_hit = spy
    try:
        yield
    finally:
        traverse.any_hit = fn


def compare_k2_subset(o, d, t_max, bvh, any_hit, what) -> dict:
    """K2 on a triangle BVH too big for its twin on a whole wavefront: on
    the entry-morton sorted rays the main path feeds it, against the twin on
    TWIN_RAYS rays spread over them (found, t bit for bit, rows on closest
    hits), and on the unsorted wavefront equal to itself on the sorted one.
    Times K2 sorted and unsorted, and the twin on the subset."""
    from ba_pathtracing_fur_torch.ops.cuda import traverse as ctraverse

    so, sd, st, perm = sorted_rays(o, d, t_max, bvh)
    fn = lambda a, b, c: ctraverse.traverse(a, b, c, bvh, "tri", any_hit=any_hit)  # noqa: E731
    t1, r1, f1 = fn(so, sd, st)
    sub = spread(o.shape[0], TWIN_RAYS, o.device)
    t0, r0, f0 = ctraverse.traverse_ref(so[sub], sd[sub], st[sub], bvh, "tri", any_hit=any_hit)
    torch.cuda.synchronize()
    mis = dict(found=int((f0 != f1[sub]).sum()), t=int((t0 != t1[sub]).sum()))
    if not any_hit:
        mis["rows"] = int((r0 != r1[sub]).sum())
    log(f"traverse tri {'any' if any_hit else 'closest'} hit, {what} (sorted): {o.shape[0]} "
        f"rays, found {int(f1.sum())}; vs twin on {TWIN_RAYS} spread rays (found "
        f"{int(f0.sum())}): mismatches {mis}")
    if any(mis.values()):
        raise AssertionError(f"traverse tri {what}: kernel disagrees with plain")
    same_unsorted(fn, (o, d, t_max), perm, (t1, r1, f1), any_hit, f"traverse tri {what}")
    res = dict(max_abs_err=float((t0 - t1[sub]).abs().max()),
               ms=timed(lambda: fn(so, sd, st), 20), unsorted_ms=timed(lambda: fn(o, d, t_max), 20),
               plain_ms=timed(lambda: ctraverse.traverse_ref(so[sub], sd[sub], st[sub], bvh, "tri",
                                                             any_hit=any_hit), 3),
               plain_rays=TWIN_RAYS, found=int(f1.sum()))
    # the bound counts the walk these rays need: their closest hits (for a
    # shadow ray, whether one lies below t_max, and its row)
    hit = (t1, r1, f1) if not any_hit else ctraverse.traverse(so, sd, st, bvh, "tri")
    res.update(traverse_bound(so, sd, st, bvh, "tri", any_hit, hit=hit))
    log(f"traverse tri, {what}: kernel {res['ms']:.4f} ms sorted, {res['unsorted_ms']:.4f} ms "
        f"unsorted, plain {res['plain_ms']:.3f} ms on {TWIN_RAYS} rays, bound "
        f"{res['bound_ms']:.4f} ms by {res['bound_by']}")
    return res


def phase_terrain_kernels(scene, cam, cfg, dev) -> dict:
    """K2's triangle leaves on config 3's wavefronts: the camera wavefront,
    the bounce-0 NEE shadow rays and the bounce-1 wavefront of the unfused
    bounce, each held to the twin and timed (`compare_k2_subset`)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse

    bvh = scene.tri_bvh
    ids = torch.arange(cam.resolution[0] * cam.resolution[1], device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    out = {}
    for bounce in range(2):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        t_cap = torch.where(alive, traverse.INF, 0.0)
        what = "config-3 camera wavefront" if bounce == 0 else "config-3 bounce-1 wavefront"
        out[bounce] = compare_k2_subset(state.origin, state.direction, t_cap, bvh, False, what)
        shadow = []
        with captured_shadow_rays(shadow):
            nxt = pt.trace_bounce(state, scene, keys, bounce, cfg)
        if bounce == 0:
            (so, sd, st), = shadow
            out["shadow"] = compare_k2_subset(so, sd, st, bvh, True,
                                              "config-3 bounce-0 shadow rays")
        state = nxt
    return out


def phase_terrain_main_path(scene, cam, cfg, dev) -> dict:
    """render_image of config 3 through the unfused bounce: the launch
    counts (K2 alone, twice a bounce), the image, TIMED_REPS timed renders
    and a traced sample."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.utils import film

    key = rng.key(0, dev)
    reset_counts()
    img = render(scene, cam, key, cfg)  # also the warm-up of the timed reps
    counts = read_counts()
    want = cfg.spp * cfg.depth
    log(f"config3: launches {counts} (expected traverse {2 * want} = spp x depth x "
        f"(closest + shadow), hit {want}, no plain calls)")
    check_counts(counts, "config3", traverse=2 * want, hit=want)
    w, h = cam.resolution
    a = check_image(img, (h, w, 3), "config3")
    OUT_DIR.mkdir(exist_ok=True)
    film.write_png(OUT_DIR / "smoke_config3.png", a)
    times = phase_timing(scene, cam, key, cfg, name="config3", with_plain=False)
    rays = w * h * cfg.spp * cfg.depth
    rates = sorted(rays / t for t in times["kernel_reps"])
    prof = phase_profile(scene, cam, key, cfg, name="config-3", marks=("traverse_kernel",))
    log(f"config3 end to end: {rays / times['kernel']:.4e} rays/s (median of {TIMED_REPS}; "
        f"reps {', '.join(f'{r:.4e}' for r in rates)}); traced sample: device busy "
        f"{prof['busy'] * 1e3:.2f} ms, idle share {max(0.0, 1 - prof['busy'] / prof['wall']):.3f}, "
        f"{prof['launches']} launches, K2 {prof['kernel_ms']['traverse_kernel']:.3f} ms = "
        f"{prof['kernel_ms']['traverse_kernel'] / 1e3 / max(prof['busy'], 1e-12):.4f} of device "
        f"time ({prof['kernel_launches']['traverse_kernel']} launches)")
    return dict(counts=counts, times=times, rays_per_s=rays / times["kernel"], rates=rates,
                profile=prof)


def phase_terrain_gate(dev) -> dict:
    """A small terrain (SAH BVH) through the kernels and through the plain
    versions on the card, under the image gate."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt

    c = SMALL_TERRAIN
    scene, cam, _ = terrain_scene(dev, c)
    cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], compact=False)
    key = rng.key(0, dev)
    w, h = c["res"]
    reset_counts()
    a = check_image(render(scene, cam, key, cfg), (h, w, 3), "small terrain")
    counts = read_counts()
    check_counts(counts, "small terrain", traverse=2 * cfg.spp * cfg.depth,
                 hit=cfg.spp * cfg.depth)
    with plain_bounces():
        b = check_image(render(scene, cam, key, cfg), (h, w, 3), "small terrain plain")
    return image_gate(b, a, f"terrain {c['n_tris']} triangles {w}x{h} spp {cfg.spp}: kernels "
                            "vs plain image")


def phase_compaction(scene, cam, cfg, name, **want) -> dict:
    """One sample of `scene` through the kernels with compact=True and with
    compact=False: the images bit for bit (each ray's result does not
    depend on its position), both sample times (events, TIMED_REPS), and
    the live share n_alive / R after each bounce. `want`: the kernel
    launches of one sample."""
    from ba_pathtracing_fur_torch.core import rng

    key = rng.key(0, scene.device)
    one = dataclasses.replace(cfg, spp=1, spp_batch=1)
    cfgs = {c: dataclasses.replace(one, compact=c) for c in (True, False)}
    imgs, alive = {}, []
    for c, cf in cfgs.items():
        reset_counts()
        with alive_counts(alive) if c else contextlib.nullcontext():
            imgs[c] = render(scene, cam, key, cf)
        check_counts(read_counts(), f"{name} compact={c}", **want)
    if not torch.equal(imgs[True], imgs[False]):
        d = (imgs[True] - imgs[False]).abs()
        raise AssertionError(f"{name}: compacted image differs from the uncompacted one "
                             f"(max {d.max().item():.3e} over {(d > 0).any(-1).sum().item()} px)")
    share = [int(n) / r for n, r in alive]
    ms = {c: timed(lambda cf=cf: render(scene, cam, key, cf), TIMED_REPS)
          for c, cf in cfgs.items()}
    log(f"{name} compaction: images bit-identical; n_alive / R after bounces 0-"
        f"{len(share) - 1}: {', '.join(f'{x:.4f}' for x in share)} (R = {alive[0][1]}); one "
        f"sample {ms[True]:.3f} ms compacted, {ms[False]:.3f} ms not")
    return dict(alive=share, ms=ms[True], uncompacted_ms=ms[False])


def phase_gradient(scene, cam, dev) -> dict:
    """diff.fit on config 4's fur patch at full width (GRAD): the unfused
    bounce under autograd with compaction on. Times a recorded forward, a
    forward plus backward and a fit step; the peak device memory with remat
    off and on; K2 and K6 launched on every bounce of every full-width
    step, in the forward and in remat's recompute, and no plain version
    (K6's backward recomputes the torch assembly: counted apart); every
    gradient finite, the hair parameters' not all 0; the finite-difference
    check on the fur's diffuse red; and the gradients with the kernels
    against those with the twins on the card at GRAD_TWIN_RES."""
    from ba_pathtracing_fur_torch import diff
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import hit as chit
    from ba_pathtracing_fur_torch.scene import builtins
    from ba_pathtracing_fur_torch.scene.types import SHADER_MARSCHNER_HAIR

    cfg = pt.RenderConfig(**GRAD)
    key = rng.key(0, dev)
    w, h = cam.resolution
    with torch.no_grad():
        target = render(scene, cam, key, cfg)
    mats = scene.materials
    hair = int(torch.nonzero(mats.shader_id == SHADER_MARSCHNER_HAIR)[0, 0])
    beta = mats.hair_beta.clone()
    beta[hair] += HAIR_BETA_SHIFT
    start = dataclasses.replace(scene, materials=dataclasses.replace(mats, hair_beta=beta))

    def material_grads(sc, cm, tg):
        params = diff.make_params(sc)
        diff.render_loss(params, sc, cm, key, tg, cfg).backward()
        return {k: v.grad for k, v in params["materials"].items() if v.grad is not None}

    out = {}
    for remat in (False, True):
        cf = dataclasses.replace(cfg, remat=remat)
        diff.render_loss(diff.make_params(start), start, cam, key, target, cf).backward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = diff.make_params(start)
        t0 = time.perf_counter()
        loss = diff.render_loss(params, start, cam, key, target, cf)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[f"remat_{remat}"] = dict(forward_s=t1 - t0, forward_backward_s=t2 - t0,
                                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"gradient, config-4 fur patch {w}x{h} depth {cfg.depth} spp 1, remat={remat}: "
            f"recorded forward {t1 - t0:.4f} s, forward + backward {t2 - t0:.4f} s, peak device "
            f"memory {out[f'remat_{remat}']['peak_gib']:.3f} GiB")
    grads = {k: v.grad for k, v in params["materials"].items() if v.grad is not None}
    bad = [k for k, g in grads.items() if not torch.isfinite(g).all()]
    hair_g = torch.cat([grads["hair_alpha"], grads["hair_beta"]]).abs().max().item()
    log(f"gradient: {len(grads)} material fields reached, max |g| "
        + ", ".join(f"{k} {g.abs().max().item():.3e}" for k, g in grads.items()))
    if bad or not hair_g > 0.0:
        raise AssertionError(f"gradient: non-finite fields {bad}, hair max |g| {hair_g}")

    fit_cfg = dataclasses.replace(cfg, remat=True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = diff.fit(start, cam, target, fit_cfg, steps=FIT_STEPS, key=key)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / FIT_STEPS
    counts = read_counts()
    want = FIT_STEPS * 2 * 2 * cfg.depth
    log(f"fit: {FIT_STEPS} Adam steps (remat), {step_s:.4f} s a step, losses "
        f"{', '.join(f'{x:.6e}' for x in res.losses)}, hair_beta {beta[hair].item():.4f} -> "
        f"{res.params['materials']['hair_beta'][hair].item():.4f} (true "
        f"{mats.hair_beta[hair].item():.4f}); launches {counts} (expected traverse {want} = "
        f"steps x depth x (closest + shadow) x (forward + recompute), hit {want // 2}, no "
        f"plain calls); the torch assembly recomputed by K6's backward "
        f"{chit.HIT_GRAD_CALLS} times")
    check_counts(counts, "fit", traverse=want, hit=want // 2)
    fit_hit_grad = chit.HIT_GRAD_CALLS
    if not fit_hit_grad <= want // 2:
        raise AssertionError("fit: more backward recomputes of the Hit than K6 launches")
    if not np.all(np.isfinite(res.losses)):
        raise AssertionError("fit: non-finite loss")

    # against a black target, as tests/test_diff.py checks it: the loss
    # then moves with the fur's red at every fur pixel
    analytic, numeric = diff.finite_diff_check(
        diff.make_params(start), start, cam, key, torch.zeros_like(target), cfg,
        path=("materials", "diffuse"), index=(hair, 0), eps=FD_EPS)
    gate = abs(analytic - numeric) / max(abs(numeric), 1e-3)  # tests/test_diff.py's
    rel = abs(analytic - numeric) / max(abs(numeric), 1e-30)
    log(f"finite difference, fur diffuse red, eps {FD_EPS}, black target: autograd "
        f"{analytic:.6e}, central difference {numeric:.6e}, relative error {rel:.3e} "
        f"(|diff| / max(|numeric|, 1e-3) {gate:.3e} < {FD_REL})")
    if not (np.isfinite(analytic) and abs(numeric) > 1e-3 and gate < FD_REL):
        raise AssertionError("gradient: finite-difference check failed")

    small, scam = builtins.fur_patch(resolution=GRAD_TWIN_RES,
                                     fibers_per_face=CONFIG4["fibers_per_face"], device=dev)
    small = traverse.attach_bvh(small)
    with torch.no_grad():
        small_target = render(small, scam, key, cfg)
    small = dataclasses.replace(small, materials=start.materials)
    reset_counts()
    got = material_grads(small, scam, small_target)
    check_counts(read_counts(), "gradient, kernels", traverse=2 * cfg.depth, hit=cfg.depth)
    twin_hit_grad = chit.HIT_GRAD_CALLS
    log(f"gradient at {GRAD_TWIN_RES[0]}x{GRAD_TWIN_RES[1]}: {cfg.depth} K6 launches, the torch "
        f"assembly recomputed by K6's backward {twin_hit_grad} times (the twins below assemble "
        f"every Hit in torch)")
    if not twin_hit_grad <= cfg.depth:
        raise AssertionError("gradient: more backward recomputes of the Hit than K6 launches")
    with plain_bounces():
        want_g = material_grads(small, scam, small_target)
    worst = max((got[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for k, g in want_g.items())
    log(f"gradient at {GRAD_TWIN_RES[0]}x{GRAD_TWIN_RES[1]}, kernels vs twins on the card: "
        f"largest |diff| / max |g| over the fields {worst:.3e} (<= {GRAD_TWIN_TOL})")
    if set(got) != set(want_g) or not worst <= GRAD_TWIN_TOL:
        raise AssertionError("gradient: kernels and twins disagree")
    return dict(out, fit_step_s=step_s, step_launches=want // FIT_STEPS, fd_rel=rel,
                twin_rel=worst, fit_hit_grad_calls=fit_hit_grad, twin_hit_grad_calls=twin_hit_grad)


def phase_unfused_vs_fused(dev) -> dict:
    """The unfused bounce against the fused one on the card, both through
    the kernels, the same streams: the triangle-BVH Cornell (K2 on triangle
    leaves, K1 on the fused side) and the fur patch with its cone BVH (K2
    cones, K1 with the hair walk), under the image gate of
    tests/test_fused_shade.py::_compare."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    c = UNFUSED_VS_FUSED
    cornell, ccam = builtins.cornell_box(resolution=c["res"], device=dev)
    fur, fcam = builtins.fur_patch(resolution=c["res"],
                                   fibers_per_face=CONFIG4["fibers_per_face"], device=dev)
    out = {}
    for name, scene, cam in (("cornell tri BVH", traverse.attach_bvh(cornell, leaf_size=8,
                                                                     min_prims=1), ccam),
                             ("fur patch", traverse.attach_bvh(fur), fcam)):
        imgs = {}
        for fused in (False, True):
            cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], compact=False,
                                  fused_shading=fused)
            reset_counts()
            imgs[fused] = check_image(render(scene, cam, rng.key(0, dev), cfg),
                                      (c["res"][1], c["res"][0], 3), f"{name} fused={fused}")
            want = cfg.spp * cfg.depth
            check_counts(read_counts(), f"{name} fused={fused}", traverse=2 * want,
                         shade=want if fused else 0, hit=want)
        out[name] = image_gate(imgs[True], imgs[False], f"{name}: unfused vs fused image")
    return out


@contextlib.contextmanager
def traffic(rec: dict, keep: int = 0):
    """Count every `traverse.closest_hit` / `any_hit` call into `rec`: its
    calls (rec["closest"] the closest hits among them), and its traced rays
    (t_max > 0) as a device tensor; keep the ("closest" | "any", o, d,
    t_max) of the first `keep` calls in rec["kept"]."""
    from ba_pathtracing_fur_torch.ops import traverse

    closest_fn, any_fn = traverse.closest_hit, traverse.any_hit
    rec.update(calls=0, closest=0, rays=0, kept=[])

    def note(kind, o, d, t_max):
        t_max = traverse._t_max_of(t_max, o.shape[0], o)
        rec["calls"] += 1
        rec["closest"] += kind == "closest"
        rec["rays"] = rec["rays"] + (t_max > 0).sum()
        if len(rec["kept"]) < keep:
            rec["kept"].append((kind, o.detach(), d.detach(), t_max.detach()))
        return t_max

    def closest(o, d, scene, *a, **k):
        k["t_max"] = note("closest", o, d, k.get("t_max", traverse.INF))
        return closest_fn(o, d, scene, *a, **k)

    def any_(o, d, scene, t_max, *a, **k):
        return any_fn(o, d, scene, note("any", o, d, t_max), *a, **k)

    traverse.closest_hit, traverse.any_hit = closest, any_
    try:
        yield rec
    finally:
        traverse.closest_hit, traverse.any_hit = closest_fn, any_fn


def live_subset(t_max: torch.Tensor, k: int, n_dead: int = 64) -> torch.Tensor:
    """Up to k indices spread over the live rays (t_max > 0) and up to
    n_dead over the dead ones."""
    out = []
    for idx, m in ((torch.nonzero(t_max > 0)[:, 0], k), (torch.nonzero(t_max <= 0)[:, 0],
                                                         n_dead)):
        m = min(m, idx.numel())
        if m:
            out.append(idx[spread(idx.numel(), m, t_max.device)])
    return torch.cat(out)


def hold_traffic(kind, o, d, t_max, scene, what) -> dict:
    """The traversal kernels of `scene` on one captured wavefront of the
    Whitted or BDPT engines, as `closest_hit` / `any_hit` feed them (sorted
    by the entry-morton key of the cone BVH): K2 (flat BVH) or K3 (two-level)
    against its twin on TRAFFIC_TWIN_RAYS live rays and 64 dead ones spread
    over the wavefront (found and t bit for bit, rows on closest hits), K3
    also against K2 on the whole wavefront; K5 on a BVH-less triangle pack
    big enough for it against its twin on every ray; and each kernel on the
    unsorted rays equal to itself on the sorted ones. Times the kernels on
    the sorted rays."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, stream as cstream, \
        traverse as ctraverse

    any_hit = kind == "any"
    bvh = scene.cone_bvh
    so, sd, st, perm = sorted_rays(o, d, t_max, bvh)
    sub = live_subset(st, TRAFFIC_TWIN_RAYS)
    two_level = traverse.route(scene.cones, bvh, o.shape[0]) == "k3"
    fn = lambda a, b, c: (cstream.traverse_stream if two_level else ctraverse.traverse)(  # noqa
        a, b, c, bvh, "cone", any_hit=any_hit)
    ref = cstream.traverse_stream_ref if two_level else ctraverse.traverse_ref
    t1, r1, f1 = fn(so, sd, st)
    t0, r0, f0 = ref(so[sub], sd[sub], st[sub], bvh, "cone", any_hit=any_hit)
    torch.cuda.synchronize()
    mis = dict(found=int((f0 != f1[sub]).sum()), t=int((t0 != t1[sub]).sum()))
    if not any_hit:
        mis["rows"] = int((r0 != r1[sub]).sum())
    if two_level:
        t2, r2, f2 = ctraverse.traverse(so, sd, st, dataclasses.replace(bvh, fanout=0), "cone",
                                        any_hit=any_hit)
        torch.cuda.synchronize()
        mis.update(k2_found=int((f2 != f1).sum()), k2_t=int((t2 != t1).sum()))
        if not any_hit:
            mis["k2_rows"] = int((r2 != r1).sum())
    name = "traverse_stream" if two_level else "traverse"
    live = int((t_max > 0).sum())
    res = dict(rays=o.shape[0], live=live, found=int(f1.sum()), twin_rays=int(sub.numel()),
               mismatches=mis, max_abs_err=float((t0 - t1[sub]).abs().max()) if sub.numel()
               else 0.0, ms=timed(lambda: fn(so, sd, st), 3))
    nonfinite = int((~torch.isfinite(o).all(-1) | ~torch.isfinite(d).all(-1)).sum())
    log(f"{name} cone {kind} hit, {what} (sorted): {o.shape[0]} rays, {live} with t_max > 0, "
        f"{nonfinite} with a non-finite origin or direction, |d| up to "
        f"{float(torch.nan_to_num(d.norm(dim=-1), nan=0.0, posinf=3.4e38).max()):.3e}; found "
        f"{res['found']}; vs twin on {res['twin_rays']} rays: mismatches {mis}; "
        f"{res['ms']:.4f} ms")
    if any(mis.values()):
        raise AssertionError(f"{name} {what}: kernel disagrees with plain")
    same_unsorted(fn, (o, d, t_max), perm, (t1, r1, f1), any_hit, f"{name} {what}")
    tris = scene.tris
    if traverse.route(tris, scene.tri_bvh, o.shape[0]) == "k5":
        tables = cisect.tables_of(tris, "tri")
        tk, ik = cisect.closest(so, sd, st, tables, "tri")
        tp, ip = cisect.closest_ref(so, sd, st, tables, "tri")
        tu, iu = cisect.closest(o, d, t_max, tables, "tri")
        torch.cuda.synchronize()
        bad = dict(t=int((tk != tp).sum()), index=int((ik != ip).sum()),
                   unsorted=int((tu[perm] != tk).sum() + (iu[perm] != ik).sum()))
        res["k5"] = dict(hits=int((ik >= 0).sum()), mismatches=bad,
                         max_abs_err=float(torch.nan_to_num((tk - tp).abs()).max()),
                         ms=timed(lambda: cisect.closest(so, sd, st, tables, "tri"), 3))
        log(f"bruteforce tri, {what} (sorted): {o.shape[0]} rays x {tris.count} triangles, "
            f"hits {res['k5']['hits']}; mismatches {bad}; {res['k5']['ms']:.4f} ms")
        if any(bad.values()):
            raise AssertionError(f"bruteforce tri {what}: kernel disagrees with plain")
    return res


def traffic_names(scene, lobes: str) -> list:
    """The traversal calls of one Whitted iteration, in order: the nodes'
    closest hit, a shadow any-hit a light, then (hair_lobes "all") the TT
    and TRT closest hits."""
    kinds = {0: "point", 1: "quad", 2: "spot", 3: "sun"}
    names = ["node"] + [f"{kinds[int(k)]} shadow" for k in scene.lights.kind.tolist()]
    return names + (["TT", "TRT"] if lobes == "all" else [])


def timed_wall(fn, reps: int = TIMED_REPS) -> list:
    """Wall seconds of `reps` calls of `fn` (each ending in a sync)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def counted_run(fn, keep: int = 0) -> dict:
    """One run of `fn` (a render on the card, its counts reset, under
    `traffic`) -> its image, wall seconds, kernel launches, traversal calls,
    traced rays, the first `keep` calls' rays, and peak device memory."""
    rec = {}
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with traffic(rec, keep=keep):
        img = fn()
        torch.cuda.synchronize()
    return dict(img=img, first_s=time.perf_counter() - t0, counts=read_counts(),
                calls=rec["calls"], closest=rec["closest"], traced_rays=int(rec["rays"]),
                kept=rec["kept"],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def phase_whitted(name, scene, cam, card, kernels, profile=False, lobes=("all", "r")) -> dict:
    """render_whitted on a full-size scene (W4, W5) through the kernels:
    WhittedConfig(hair_lobes="all") (the reference's default depth 8, hard
    shadows, all three lobes traced) and the default hair_lobes="r". For
    each: the image, the DFS's iterations and live lanes, the launches (each
    of `kernels` once a traversal call, no plain version), wall seconds
    (median of TIMED_REPS), traced rays/s and pixels/s, peak device
    memory; for "all", the kernels held to their twins on the first
    iteration's traffic (the nodes' camera rays, each light's shadow rays
    with their dead lanes, the TT and TRT rays from inside the fibers) and,
    with `profile`, a traced render."""
    from ba_pathtracing_fur_torch.models import whitted
    from ba_pathtracing_fur_torch.utils import film

    w, h = cam.resolution
    out = {}
    for lb in lobes:
        cfg = whitted.WhittedConfig(hair_lobes=lb)
        names = traffic_names(scene, lb)
        fn = lambda: whitted.render_whitted(scene, cam, cfg)  # noqa: E731
        run = counted_run(fn, keep=len(names) if lb == "all" else 0)
        live = [list(x) for x in whitted.LAST_QUEUE_LIVE]
        iters = sum(len(x) for x in live)
        if run["calls"] != iters * len(names):
            raise AssertionError(f"{name} {lb}: {run['calls']} traversal calls for {iters} "
                                 f"iterations of {len(names)}")
        check_counts(run["counts"], f"{name} {lb}", **{k: run["calls"] for k in kernels},
                     hit=run["closest"])
        a = check_image(run.pop("img"), (h, w, 3), f"{name} {lb}")
        walls = timed_wall(fn)
        med, rays = float(np.median(walls)), run["traced_rays"]
        log(f"{name} whitted hair_lobes={lb!r} ({w}x{h}, depth {cfg.depth}): {iters} DFS "
            f"iterations, live lanes {live}; {run['calls']} traversal calls, launches "
            f"{run['counts']}; traced rays {rays}; wall median {med:.4f} s of {walls} (counted "
            f"run {run['first_s']:.4f} s) -> {rays / med:.4e} traced rays/s, "
            f"{w * h / med:.4e} pixels/s; peak device memory {run['peak_gib']:.2f} GiB; image "
            f"max {a.max():.4f}, mean {a.mean():.5f}; on {card}")
        OUT_DIR.mkdir(exist_ok=True)
        film.write_png(OUT_DIR / f"smoke_whitted_{name}_{lb}.png", a)
        kept = run.pop("kept")
        res = dict(run, iterations=iters, live=live, walls=walls, wall=med,
                   rays_per_s=rays / med, pixels_per_s=w * h / med)
        if lb == "all":
            res["held"] = {n: hold_traffic(kind, o, d, t, scene, f"{name} whitted {n} rays")
                           for n, (kind, o, d, t) in zip(names, kept)}
            if profile:
                res["profile"] = profile_call(lambda: (fn(), torch.cuda.synchronize()),
                                              f"{name} whitted render", ("traverse_kernel",))
        del kept
        out[lb] = res
    return out


def phase_bdpt(scene, cam, card) -> dict:
    """B4: render_image(bdpt=True) on config 4's fur patch at full size
    through the kernels (depth 4, spp 8, every other field at the JAX
    package's default: compaction on, unfused, 8 samples a light, 3
    bounces, the splat on): K2 once a traversal call (the light-subpath
    walks, the camera and bounce closest hits, 3 connections a bounce, the
    splat's 3), no plain version; the image, wall seconds (median of
    TIMED_REPS), traced rays/s and pixels/s, peak device memory, a traced
    sample; K2 held to its twin on every traversal call of the first
    sample (the walk, the closest hits, the connection and splat rays with
    their per-ray t_max)."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.utils import film

    cfg = pt.RenderConfig(depth=B4["depth"], spp=B4["spp"], bdpt=True)
    key = rng.key(0, scene.device)
    w, h = cam.resolution
    names = [f"light-subpath walk {j}" for j in range(1, cfg.bdpt_bounces)]
    for b in range(cfg.depth):
        names += [f"bounce-{b} closest"] + [f"bounce-{b} connection {j}"
                                           for j in range(cfg.bdpt_bounces)]
    names += [f"splat {j}" for j in range(cfg.bdpt_bounces)]
    run = counted_run(lambda: render(scene, cam, key, cfg), keep=len(names))
    if run["calls"] != cfg.spp * len(names):
        raise AssertionError(f"B4: {run['calls']} traversal calls, expected "
                             f"{cfg.spp * len(names)}")
    check_counts(run["counts"], "B4", traverse=run["calls"], hit=run["closest"])
    a = check_image(run.pop("img"), (h, w, 3), "B4")
    OUT_DIR.mkdir(exist_ok=True)
    film.write_png(OUT_DIR / "smoke_bdpt_fur_patch.png", a)
    held = {n: hold_traffic(kind, o, d, t, scene, f"B4 {n} rays")
            for n, (kind, o, d, t) in zip(names, run.pop("kept"))}
    walls = timed_wall(lambda: render(scene, cam, key, cfg))
    med, rays = float(np.median(walls)), run["traced_rays"]
    prof = phase_profile(scene, cam, key, cfg, name="B4", marks=("traverse_kernel",))
    log(f"B4 bdpt ({w}x{h}, depth {cfg.depth}, spp {cfg.spp}, {cfg.bdpt_samples_per_light} "
        f"samples a light, {cfg.bdpt_bounces} bounces, splat {cfg.bdpt_splat}, compact "
        f"{cfg.compact}): {run['calls']} traversal calls, launches {run['counts']}; traced "
        f"rays {rays}; wall median {med:.4f} s of {walls} (counted run {run['first_s']:.4f} "
        f"s) -> {rays / med:.4e} traced rays/s, {w * h * cfg.spp / med:.4e} pixel samples/s; "
        f"peak device memory {run['peak_gib']:.2f} GiB; image max {a.max():.4f}, mean "
        f"{a.mean():.5f}; on {card}")
    return dict(run, walls=walls, wall=med, rays_per_s=rays / med,
                pixels_per_s=w * h * cfg.spp / med, profile=prof, held=held)


def phase_engine_gates(dev) -> dict:
    """The Whitted and BDPT engines at a small size through the kernels and
    through their plain versions on the card: the images equal bit for bit
    (every kernel on these paths is exact against its twin, and the rest is
    the same torch code). The fur patch (SMALL_FUR, a median cone BVH: K2):
    Whitted with hair_lobes "all" and BDPT (depth 4, spp 2); a hair ball
    (SMALL_HAIRBALL, a two-level cone BVH and the BVH-less scalp: K3 and
    K5): Whitted with hair_lobes "all"."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt, whitted
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.scene import builtins

    c = SMALL_FUR
    fur, fcam = builtins.fur_patch(resolution=c["res"], fibers_per_face=c["fibers_per_face"],
                                   device=dev)
    fur = traverse.attach_bvh(fur)
    c = SMALL_HAIRBALL
    ball, bcam = builtins.hair_ball(resolution=c["res"], n_fibers=c["n_fibers"],
                                    on_device=True, device=dev)
    ball = traverse.attach_bvh(ball, method="median", fanout=64)
    if traverse.route(ball.cones, ball.cone_bvh, 0) != "k3" or fur.cone_bvh is None:
        raise AssertionError("engine gates: unexpected BVHs")
    wcfg = whitted.WhittedConfig(hair_lobes="all")
    bcfg = pt.RenderConfig(depth=4, spp=2, bdpt=True)
    cases = (("whitted fur patch", lambda: whitted.render_whitted(fur, fcam, wcfg),
              ("traverse",)),
             ("bdpt fur patch", lambda: render(fur, fcam, rng.key(0, dev), bcfg), ("traverse",)),
             ("whitted hair ball", lambda: whitted.render_whitted(ball, bcam, wcfg),
              ("stream", "bruteforce_tri")))
    out = {}
    for name, fn, kernels in cases:
        reset_counts()
        a = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        if any(counts[k] == 0 for k in kernels) or any(
                v for k, v in counts.items() if k.endswith("_ref")):
            raise AssertionError(f"{name}: launches {counts}")
        t0 = time.perf_counter()
        with plain_bounces():
            b = fn()
            torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        shape = a.shape
        check_image(a, shape, name)
        equal = torch.equal(a, b)
        d = (a - b).abs()
        log(f"{name} {shape[1]}x{shape[0]}: kernels (launches {counts}) vs plain ({plain_s:.2f} "
            f"s): bit-equal {equal}, max |diff| {d.max().item():.3e} over "
            f"{int((d > 0).any(-1).sum())} pixels")
        if not equal:
            raise AssertionError(f"{name}: the kernels' image differs from the plain one")
        out[name] = dict(counts=counts, plain_s=plain_s)
    return out


def write_skin_scene(out_dir: Path, quads: int, res, device, mesh: str = "skin.obj") -> Path:
    """The CLI phase's scene under `out_dir`: `skin.obj` (a quads x quads
    patch of the plane y = 0 over [-0.5, 0.5]^2 with UVs 2x, 2z, so that
    the texture wraps and takes negative coordinates), `skin.png` (the
    port's noise_texture(256) made on `device`) and `scene.json` naming
    `mesh`, the skin material and the "Fur" section, with a camera of
    resolution `res` -> the JSON's path."""
    from ba_pathtracing_fur_torch.scene import noise
    from ba_pathtracing_fur_torch.utils import film

    out_dir.mkdir(parents=True, exist_ok=True)
    g = np.linspace(-0.5, 0.5, quads + 1, dtype=np.float32)
    xx, zz = np.meshgrid(g, g, indexing="ij")
    lines = ["# skin patch"]
    lines += [f"v {float(x)!r} 0.0 {float(z)!r}" for x, z in zip(xx.ravel(), zz.ravel())]
    lines += [f"vt {float(2 * x)!r} {float(2 * z)!r}" for x, z in zip(xx.ravel(), zz.ravel())]
    n = quads + 1
    for i in range(quads):
        for j in range(quads):  # corners in the order that faces +y
            c = [i * n + j + 1, i * n + j + 2, (i + 1) * n + j + 2, (i + 1) * n + j + 1]
            lines.append("f " + " ".join(f"{k}/{k}" for k in c))
    (out_dir / "skin.obj").write_text("\n".join(lines) + "\n")
    tex = noise.noise_texture(256, color_lo=(0.2, 0.12, 0.08), color_hi=(0.62, 0.46, 0.36),
                              device=device)
    film.write_png(str(out_dir / "skin.png"), tex.cpu().numpy())
    scene = {
        "Material": [dict(name="skin", diffuse=[0.35, 0.25, 0.18],
                          bsdf="LambertianReflectionBSDF", diffuse_map="skin.png")],
        "Mesh": [{"path": mesh}],
        "Node": [
            dict(object="mesh", object_id=0, mesh_id=0, material_id=0, name="skin"),
            dict(object="camera", object_id=1, position=[0.0, 0.45, 1.1],
                 direction=[0.0, -0.35, -1.0], up_vector=[0.0, 1.0, 0.0],
                 resolution=list(res), name="camera"),
            dict(object="light", object_id=2, kind="point", color=[10.0, 10.0, 10.0],
                 position=[0.6, 1.2, 0.8], radius=0.05, constant=1.0, name="point"),
            dict(object="light", object_id=3, kind="sun", color=[1.5, 1.4, 1.2],
                 direction=[-0.4, -1.0, -0.3], radius=0.05, name="sun")],
        "Environment": {"color": [0.05, 0.06, 0.08], "light": [0.08, 0.08, 0.08]},
        "Fur": {"fibers_per_face": 5, "fiber_verts": 10, "radius": 0.004, "seed": 0},
    }
    path = out_dir / ("scene.json" if mesh == "skin.obj" else f"scene_{Path(mesh).suffix[1:]}.json")
    path.write_text(json.dumps(scene, indent=2))
    return path


@contextlib.contextmanager
def cli_spy(rec: dict):
    """Record into `rec` what a `cli.main` render runs: the scene it built
    (with its BVHs), the image and the seconds of the render loop
    (`render_progressive`, or `render_whitted_jit`) ending in a sync."""
    from ba_pathtracing_fur_torch.models import pathtracer as pt, whitted

    prog, wjit = pt.render_progressive, whitted.render_whitted_jit

    def progressive(scene, camera, key, cfg, *a, **k):
        rec["scene"], rec["camera"] = scene, camera
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, acc in prog(scene, camera, key, cfg, *a, **k):
            rec["img"] = acc
            yield i, acc
        torch.cuda.synchronize()
        rec["render_s"] = time.perf_counter() - t0

    def whitted_jit(scene, camera, cfg):
        rec["scene"], rec["camera"] = scene, camera
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["img"] = wjit(scene, camera, cfg)
        torch.cuda.synchronize()
        rec["render_s"] = time.perf_counter() - t0
        return rec["img"]

    pt.render_progressive, whitted.render_whitted_jit = progressive, whitted_jit
    try:
        yield rec
    finally:
        pt.render_progressive, whitted.render_whitted_jit = prog, wjit


def cli_render(scene_path: Path, out: str, dev, *, accel="median", spp=None, res=None,
               depth=None, keep=0, extra=()) -> dict:
    """One `cli.main(["render", ..., "--device", dev])` in this process, its
    counts reset:
    its wall and render seconds, launches, traversal calls and traced
    rays, the first `keep` calls' rays, peak device memory, the image, the
    scene, the build's stage seconds and each BVH's debug_info."""
    from ba_pathtracing_fur_torch import cli
    from ba_pathtracing_fur_torch.ops import bvh as bvh_mod, traverse

    spp, res, depth = spp or CLI["spp"], res or CLI["res"], depth or CLI["depth"]
    argv = ["render", "-s", str(scene_path), "-r", str(spp), "-W", str(res[0]), "-H",
            str(res[1]), "-d", str(depth), "--accel", accel, "-o", str(CLI_DIR / out),
            "--device", str(dev), *extra]
    rec, spy = {}, {}
    traverse.LAST_BUILD_STATS.clear()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cli_spy(spy), traffic(rec, keep=keep):
        if cli.main(argv) != 0:
            raise AssertionError(f"cli {' '.join(argv)}: non-zero exit")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scene = spy["scene"]
    build = {k: sum(x for n, x in v.items() if n != "perm_cached")
             for k, v in traverse.LAST_BUILD_STATS.items()}
    info = {k: bvh_mod.debug_info(b) for k, b in (("tri", scene.tri_bvh),
                                                 ("cone", scene.cone_bvh)) if b is not None}
    return dict(argv=argv, wall=wall, render_s=spy["render_s"], counts=read_counts(),
                calls=rec["calls"], closest=rec["closest"], traced_rays=int(rec["rays"]),
                kept=rec["kept"],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, img=spy["img"],
                scene=scene, camera=spy["camera"], build_s=build,
                build_stages=dict(traverse.LAST_BUILD_STATS), debug_info=info)


def traversal_launches(scene, calls: int, n_rays: int) -> dict:
    """The traversal kernels' launches of `calls` closest and any hits on
    `scene` over wavefronts of `n_rays`: per pack with a BVH, K3 (two-level)
    or K2 (flat); per BVH-less pack of K5's size, K5."""
    from ba_pathtracing_fur_torch.ops import traverse

    want: dict = {}
    for kind, pack, bvh in (("tri", scene.tris, scene.tri_bvh),
                            ("cone", scene.cones, scene.cone_bvh)):
        k = {"k3": "stream", "k2": "traverse", "k5": f"bruteforce_{kind}"}.get(
            traverse.route(pack, bvh, n_rays))
        if k is not None:
            want[k] = want.get(k, 0) + calls
    return want


def hold_cli_traffic(kind, o, d, t_max, scene, what, bound=False) -> dict:
    """Every traversal kernel of the CLI scene on one captured wavefront,
    as `closest_hit` / `any_hit` feed them (sorted by the entry-morton key
    of the cone BVH, else the triangle BVH; unsorted without a BVH): per
    pack with a BVH, K2 (flat) or K3 (two-level) on the whole wavefront
    against its twin on TRAFFIC_TWIN_RAYS live rays and 64 dead ones (found
    and t bit for bit, rows on closest hits); per BVH-less pack of K5's
    size, K5 against its twin on the same rays (t and index bit for bit).
    Each kernel is timed on the whole wavefront; with `bound`, each is
    bounded on it too: K3 by `stream_bound` and K2 by `traverse_bound` on
    their own hits, K5 by `brute_bound` on K5_CONE_TILES tiles (as on
    configs 5, 3 and 4)."""
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, stream as cstream, \
        traverse as ctraverse

    any_hit = kind == "any"
    sort_bvh = scene.cone_bvh if scene.cone_bvh is not None else scene.tri_bvh
    rays = sorted_rays(o, d, t_max, sort_bvh)[:3] if sort_bvh is not None else (o, d, t_max)
    sub = live_subset(rays[2], TRAFFIC_TWIN_RAYS)
    part = tuple(x[sub] for x in rays)
    out = {}
    for pk, pack, bvh in (("tri", scene.tris, scene.tri_bvh),
                          ("cone", scene.cones, scene.cone_bvh)):
        rt = traverse.route(pack, bvh, o.shape[0])
        if rt in ("k3", "k2"):
            two = rt == "k3"
            name = "traverse_stream" if two else "traverse"
            fn = lambda *r: (cstream.traverse_stream if two else ctraverse.traverse)(  # noqa
                *r, bvh, pk, any_hit=any_hit)
            ref = cstream.traverse_stream_ref if two else ctraverse.traverse_ref
            t1, r1, f1 = fn(*rays)
            t0, r0, f0 = ref(*part, bvh, pk, any_hit=any_hit)
            torch.cuda.synchronize()
            mis = dict(found=int((f0 != f1[sub]).sum()), t=int((t0 != t1[sub]).sum()))
            if not any_hit:
                mis["rows"] = int((r0 != r1[sub]).sum())
            found, err = int(f1.sum()), float((t0 - t1[sub]).abs().max())
        elif rt == "k5":
            name = "bruteforce"
            tables = cisect.tables_of(pack, pk)
            fn = lambda *r: cisect.closest(*r, tables, pk)  # noqa: E731
            tk, ik = fn(*rays)
            tp, ip = cisect.closest_ref(*part, tables, pk)
            torch.cuda.synchronize()
            mis = dict(t=int((tk[sub] != tp).sum()), index=int((ik[sub] != ip).sum()))
            found = int((ik >= 0).sum())
            err = float(torch.nan_to_num((tk[sub] - tp).abs()).max())
        else:
            continue
        ms = timed(lambda: fn(*rays), 3)
        out[f"{name}_{pk}"] = dict(mismatches=mis, found=found, max_abs_err=err, ms=ms,
                                   twin_rays=int(sub.numel()))
        if bound:
            out[f"{name}_{pk}"]["bound"] = (
                stream_bound(*rays, bvh, any_hit, t1, r1, f1) if name == "traverse_stream"
                else traverse_bound(*rays, bvh, pk, any_hit, hit=(t1, r1, f1))
                if name == "traverse"
                else brute_bound(*rays, tables, pk, tk, ik, max_tiles=K5_CONE_TILES))
        log(f"{name} {pk} {kind} hit, {what}: {o.shape[0]} rays, "
            f"{int((t_max > 0).sum())} with t_max > 0, found {found}; vs twin on "
            f"{sub.numel()} rays: mismatches {mis}; {ms:.4f} ms")
        if any(mis.values()):
            raise AssertionError(f"{name} {pk} {what}: kernel disagrees with plain")
    return out


def cli_traffic_names(depth: int, n_lights: int) -> list:
    """The traversal calls of one sample of the unfused bounce, in order."""
    return [f"bounce-{b} {c}" for b in range(depth)
            for c in (("closest", "shadow") if n_lights else ("closest",))]


def flatten_equal(a, b, what) -> None:
    """Two flattened scenes hold the same packs, tables, lights, environment,
    atlas and texture slots, bit for bit."""
    for part in ("tris", "cones", "materials", "lights"):
        pa, pb = getattr(a, part), getattr(b, part)
        for f in dataclasses.fields(pa):
            if not torch.equal(getattr(pa, f.name), getattr(pb, f.name)):
                raise AssertionError(f"{what}: {part}.{f.name} differs")
    if not (torch.equal(a.env.color, b.env.color) and torch.equal(a.env.ambient, b.env.ambient)
            and torch.equal(a.textures.images, b.textures.images)
            and torch.equal(a.textures.sizes, b.textures.sizes)
            and a.tex_slots == b.tex_slots and a.has_hair == b.has_hair):
        raise AssertionError(f"{what}: environment, atlas or flags differ")


def phase_cli(dev, card) -> dict:
    """The CLI on the JSON skin scene (CLI), in this process through
    `cli.main`: convert OBJ -> b3df (the b3df scene flattens to the OBJ
    scene's packs bit for bit); render --engine pt with --accel median at
    the Demo's width (3 timed runs: wall and render seconds, rays/s, build
    stages, K2 tri and K3 cone launches, peak memory, the PNG); sah, morton
    and grid at spp 4 and none at spp 1 (K5 on both packs), each with its
    build seconds, debug_info, wall and launches, every kernel held to its
    twin on the first sample's traffic, the image gated against the median
    render at the same spp; --engine whitted --hair-lobes all once; --report
    with each BVH's overlay; the fused path (K1 with its texture fetch) on
    the same scene: K1's draws bit-exact and K1 against its plain version
    on bounces 0-1, timed and bounded, the image gated against the unfused
    CLI render; and the small gate (CLI_SMALL) on the card against --device
    cpu, and through the kernels against the plain versions on the card."""
    from ba_pathtracing_fur_torch import cli
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt, whitted
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade
    from ba_pathtracing_fur_torch.scene.graph import flatten
    from ba_pathtracing_fur_torch.scene.io import load_scene_json

    t_phase = time.perf_counter()
    c = CLI
    w, h = c["res"]
    path = write_skin_scene(CLI_DIR, c["quads"], c["res"], dev)
    t0 = time.perf_counter()
    cli.main(["convert", str(CLI_DIR / "skin.obj"), str(CLI_DIR / "skin.b3df")])
    convert_s = time.perf_counter() - t0
    path_b3df = write_skin_scene(CLI_DIR, c["quads"], c["res"], dev, mesh="skin.b3df")
    t0 = time.perf_counter()
    scene_obj, cam = flatten(load_scene_json(str(path)), device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    scene_b3df, _ = flatten(load_scene_json(str(path_b3df)), device=dev)
    flatten_equal(scene_obj, scene_b3df, "the b3df scene against the OBJ scene")
    n_tris, n_cones = scene_obj.tris.count, scene_obj.cones.count
    log(f"cli scene: {n_tris} triangles, {n_cones} cones, atlas "
        f"{tuple(scene_obj.textures.images.shape)}, tex_slots {scene_obj.tex_slots}; convert "
        f"OBJ -> b3df {convert_s:.3f} s; load + fur + flatten {load_s:.3f} s; the b3df scene "
        f"flattens to the OBJ scene's packs bit for bit")
    if (n_tris, n_cones) != (2 * c["quads"] ** 2, 2 * c["quads"] ** 2 * 5 * 9):
        raise AssertionError("cli: unexpected scene size")
    del scene_b3df

    names = cli_traffic_names(c["depth"], scene_obj.lights.count)
    main = cli_render(path, "cli_median.png", dev, keep=len(names))
    walls = [cli_render(path, "cli_median.png", dev)["wall"] for _ in range(TIMED_REPS)]
    rays = w * h * c["spp"] * c["depth"]
    check_counts(main["counts"], "cli median", hit=main["closest"],
                 **traversal_launches(main["scene"], 2 * c["spp"] * c["depth"], w * h))
    a_main = check_image(main["img"], (h, w, 3), "cli median")
    med = float(np.median(walls))
    log(f"cli render --accel median ({w}x{h}, depth {c['depth']}, spp {c['spp']}): wall median "
        f"{med:.4f} s of {walls} (counted run {main['wall']:.4f} s, its render loop "
        f"{main['render_s']:.4f} s) -> {rays / med:.4e} rays/s end to end, "
        f"{rays / main['render_s']:.4e} rays/s in the render loop; build stages "
        f"{main['build_stages']} (total {sum(main['build_s'].values()):.3f} s); launches "
        f"{main['counts']}; peak device memory {main['peak_gib']:.2f} GiB; debug_info "
        f"{main['debug_info']}; {CLI_DIR / 'cli_median.png'}; on {card}")
    held = {"median": {n: hold_cli_traffic(k, o, d, t, main["scene"], f"cli median {n} rays",
                                           bound=n in CLI_BOUND_TRAFFIC)
                       for n, (k, o, d, t) in zip(names, main.pop("kept"))}}
    prof = profile_call(lambda: cli_render(path, "cli_profile.png", dev, spp=1),
                        "cli median spp-1 render (scene load and build included)",
                        ("traverse_kernel", "stream_kernel"))
    res = dict(median=dict({k: v for k, v in main.items() if k not in ("img", "scene",
                                                                      "camera")},
                           walls=walls, wall_median=med, rays_per_s=rays / med,
                           render_rays_per_s=rays / main["render_s"], profile=prof))
    del main

    refs = {}
    methods = {}
    for m, spp in (("median", c["spp_methods"]), ("sah", c["spp_methods"]),
                   ("morton", c["spp_methods"]), ("grid", c["spp_methods"]),
                   ("median", c["spp_none"]), ("none", c["spp_none"])):
        run = cli_render(path, f"cli_{m}_spp{spp}.png", dev, accel=m, spp=spp,
                         keep=len(names))
        img = check_image(run["img"], (h, w, 3), f"cli {m} spp {spp}")
        check_counts(run["counts"], f"cli {m}", hit=run["closest"],
                     **traversal_launches(run["scene"], 2 * spp * c["depth"], w * h))
        held[f"{m}_spp{spp}"] = {
            nm: hold_cli_traffic(k, o, d, t, run["scene"], f"cli {m} {nm} rays",
                                 bound=m in ("morton", "none") and nm in CLI_BOUND_TRAFFIC)
            for nm, (k, o, d, t) in zip(names, run.pop("kept"))}
        if m == "median":
            refs[spp] = img
            gate = None
        else:
            gate = image_gate(refs[spp], img, f"cli --accel {m} against median, spp {spp}")
        log(f"cli --accel {m} spp {spp}: build {run['build_s']} s, debug_info "
            f"{run['debug_info']}; wall {run['wall']:.4f} s (render loop {run['render_s']:.4f} "
            f"s); launches {run['counts']}; peak {run['peak_gib']:.2f} GiB; on {card}")
        methods[f"{m}_spp{spp}"] = dict(
            {k: v for k, v in run.items() if k not in ("img", "scene", "camera")}, gate=gate)
        del run
    res["methods"] = methods

    run = cli_render(path, "cli_whitted.png", dev,
                     extra=("--engine", "whitted", "--hair-lobes", "all"))
    iters = sum(len(x) for x in whitted.LAST_QUEUE_LIVE)
    check_image(run["img"], (h, w, 3), "cli whitted")
    log(f"cli --engine whitted --hair-lobes all: wall {run['wall']:.4f} s, render "
        f"{run['render_s']:.4f} s, {iters} DFS iterations, traced rays {run['traced_rays']} -> "
        f"{run['traced_rays'] / run['render_s']:.4e} traced rays/s; launches {run['counts']}; "
        f"peak {run['peak_gib']:.2f} GiB; on {card}")
    res["whitted"] = dict(wall=run["wall"], render_s=run["render_s"], iterations=iters,
                          traced_rays=run["traced_rays"], counts=run["counts"],
                          rays_per_s=run["traced_rays"] / run["render_s"],
                          peak_gib=run["peak_gib"])
    del run

    report = CLI_DIR / "cli_report.html"
    run = cli_render(path, "cli_report.png", dev, spp=c["spp_report"],
                     extra=("--report", str(report)))
    html = report.read_text()
    if html.count("structure overlay") < 2:
        raise AssertionError("cli report: an overlay is missing")
    log(f"cli --report (spp {c['spp_report']}): wall {run['wall']:.4f} s, {report} "
        f"{report.stat().st_size} bytes, peak device memory {run['peak_gib']:.2f} GiB "
        f"(the overlays chunk the rays x leaves slab test); on {card}")
    res["report"] = dict(wall=run["wall"], peak_gib=run["peak_gib"], bytes=report.stat().st_size)
    del run

    res["fused"] = phase_cli_fused(scene_obj, cam, a_main, dev, card)
    del scene_obj
    res["small"] = phase_cli_small(dev)
    res["held"] = held
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"cli phase: {res['phase_s']:.1f} s on {card}")
    return res


def phase_cli_fused(scene, cam, unfused: np.ndarray, dev, card) -> dict:
    """render_image(RenderConfig(depth=5, spp=16, fused_shading=True)) on
    the CLI scene with its median BVHs: K1 with its texture fetch on every
    bounce (launch counts), its draws bit-exact and K1 against its plain
    version (compare_shade's gate) on bounces 0-1, timed and bounded there;
    the spp-16 images through K1 and through K1's plain version each
    against the unfused CLI render `unfused` under image_gate."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    c = CLI
    w, h = c["res"]
    scene = traverse.attach_bvh(scene, method="median")
    cfg = pt.RenderConfig(depth=c["depth"], spp=c["spp"], fused_shading=True)
    cam = dataclasses.replace(cam, resolution=c["res"])
    reset_counts()
    t0 = time.perf_counter()
    img = render(scene, cam, rng.key(0, dev), cfg)
    wall = time.perf_counter() - t0
    counts = read_counts()
    n = c["spp"] * c["depth"]
    check_counts(counts, "cli fused", shade=n, hit=n, **traversal_launches(scene, 2 * n, w * h))
    a = check_image(img, (h, w, 3), "cli fused")
    gate = image_gate(unfused, a, f"cli fused (K1 textured) spp {c['spp']} against the "
                      f"unfused CLI render")
    fn = cshade.shade_bounce
    cshade.shade_bounce = cshade.shade_bounce_ref
    try:
        p = check_image(render(scene, cam, rng.key(0, dev), cfg), (h, w, 3), "cli fused plain")
    finally:
        cshade.shade_bounce = fn
    gate_plain = image_gate(unfused, p, f"cli fused with K1's plain version spp "
                            f"{c['spp']} against the unfused CLI render")
    out = dict(wall=wall, rays_per_s=w * h * n / wall, counts=counts, gate=gate,
               gate_plain=gate_plain)
    out.update(k1_bounces(scene, cam, cfg, dev, "cli"))
    k1 = out["k1"]
    log(f"cli fused render ({w}x{h}, depth {c['depth']}, spp {c['spp']}): {wall:.4f} s = "
        f"{w * h * n / wall:.4e} rays/s, launches {counts}; K1 textured vs plain: worst "
        f"mismatched-row fraction {k1['worst_frac']:.5f}, max |diff| {k1['max_abs_err']:.3e}; "
        f"bounce 0 {out[0]['times']['ms']:.4f} ms vs bound {out[0]['bound']['bound_ms']:.4f} ms "
        f"({out[0]['bound']['bound_by']}); on {card}")
    return out


def k1_bounces(scene, cam, cfg, dev, name, n_bounces: int = 2) -> dict:
    """K1 on bounces 0..n_bounces-1 of sample 0 of `scene`'s fused path
    (the camera wavefront, then the plain version's output): held to its
    plain version under compare_shade's gate, its draws bit-exact, timed
    (shade_times) and bounded (shade_bound) on each bounce -> {bounce:
    {times, bound}, "k1": worst values}."""
    from ba_pathtracing_fur_torch.core import rng
    from ba_pathtracing_fur_torch.models import pathtracer as pt
    from ba_pathtracing_fur_torch.ops import traverse
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    w, h = cam.resolution
    tables = pt.BounceTables.of(scene)
    ids = torch.arange(w * h, device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(0, dev), [0], cfg)
    k1 = dict(worst_frac=0.0, max_abs_err=0.0, max_rel_err=0.0)
    out = dict(k1=k1)
    for bounce in range(n_bounces):
        alive = (state.radiance != 0.0).any(-1) & (state.direction != 0.0).any(-1)
        hit = traverse.closest_hit(state.origin, state.direction, scene,
                                   t_max=torch.where(alive, traverse.INF, 0.0))
        kw = pt.shade_inputs(state, scene, keys, bounce, cfg, hit, tables)
        got = cshade.shade_bounce(**kw)
        want = cshade.shade_bounce_ref(**kw)
        torch.cuda.synchronize()
        what = f"{name} textured bounce {bounce}"
        compare_shade(got, want, what, k1)
        check_draws(keys, bounce, what)
        out[bounce] = dict(times=shade_times(kw, what), bound=shade_bound(kw, got, what))
        blocked = traverse.any_hit(want["shadow_o"], want["shadow_d"], scene,
                                   want["shadow_tmax"])
        color = want["color"] + torch.where(blocked[:, None], 0.0, want["direct_rgb"])
        state = pt.RayState(origin=want["origin"], direction=want["direction"],
                            radiance=want["radiance"], color=color, flags=want["flags"],
                            theta_i=want["theta_i"], prev_pdf=want["prev_pdf"])
    log(f"K1 textured vs plain, {name}: worst mismatched-row fraction {k1['worst_frac']:.5f}, "
        f"max |diff| {k1['max_abs_err']:.3e}")
    return out


def phase_cli_small(dev) -> dict:
    """The CLI at CLI_SMALL on a small skin of the same JSON: --device cuda
    against --device cpu (image_gate), and on the card through the kernels
    against the plain versions (bit for bit: the traversal kernels are
    exact and the rest is the same torch code)."""
    c = CLI_SMALL
    w, h = c["res"]
    path = write_skin_scene(CLI_DIR / "small", c["quads"], c["res"], dev)
    kw = dict(spp=c["spp"], res=c["res"])
    card = cli_render(path, "small_cuda.png", dev, **kw)
    check_counts(card["counts"], "cli small", hit=card["closest"],
                 **traversal_launches(card["scene"], 2 * c["spp"] * CLI["depth"], w * h))
    a = check_image(card["img"], (h, w, 3), "cli small card")
    with plain_bounces():
        plain = cli_render(path, "small_plain.png", dev, **kw)
    b = plain["img"].cpu().numpy()
    cpu = cli_render(path, "small_cpu.png", "cpu", **kw)
    cpu_img = check_image(cpu["img"], (h, w, 3), "cli small cpu")
    equal = bool(np.array_equal(a, b))
    d = np.abs(a - b)
    log(f"cli small ({w}x{h}, spp {c['spp']}, {card['scene'].cones.count} cones): card "
        f"kernels vs card plain bit-equal {equal} (max |diff| {d.max():.3e}); card "
        f"vs cpu: bit-equal {bool(np.array_equal(a, cpu_img))}")
    if not equal:
        raise AssertionError("cli small: the kernels' image differs from the plain one")
    return dict(gate=image_gate(cpu_img, a, "cli small: card against --device cpu"),
                bit_equal_plain=equal, bit_equal_cpu=bool(np.array_equal(a, cpu_img)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    from ba_pathtracing_fur_torch import kernels
    nvcc_v = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc_v}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    start_k3_controls()  # their nvcc runs beside the port's
    try:
        kernels.load_library()
        log(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
        return run(dev, card, t_start)
    finally:
        stop_k3_controls()


def run(dev, card: str, t_start: float) -> int:
    """`main` after the build: every phase, then the last lines."""
    from ba_pathtracing_fur_torch import kernels

    # the BVH perm cache of this run (config 5's build uses it) lives in a
    # temporary directory, removed at the end
    cache = tempfile.mkdtemp(prefix="bvh_cache_")
    os.environ["BAPT_BVH_CACHE_DIR"] = cache
    for line in kernels.LAST_BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line or "stack frame" in line:
            log("ptxas:", line.strip())
    try:
        kernels_line = drive(dev, card)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log(f"smoke total: {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    log(card)
    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def drive(dev, card: str) -> list:
    """Every phase on `dev`, in order -> the `kernels` line's entries."""
    ptx = ptxas_report()
    for name, v in ptx.items():
        if name.startswith(("K2 ", "K3 ")):
            log(f"ptxas {name}: {v}")
    log("ptxas, the f32 test's instances (before the K3 variants: K2 56/56/59/59 registers, "
        "K3 64, 0 spills): "
        + ", ".join(f"{k} {v.get('registers')} regs {v.get('spill_stores')} B spilled"
                    for k, v in ptx.items() if k.startswith(("K2 ", "K3 "))
                    and (k.startswith("K2 ") or k.endswith(" f32") and " mxu" not in k)))
    spilled = {k: v["spill_stores"] for k, v in ptx.items()
               if k.startswith(("K2 ", "K3 ")) and v.get("spill_stores")}
    if spilled:  # every traversal instance, the tensor-core ones too, stays in registers
        raise AssertionError(f"ptxas: traversal kernel instances spill (bytes): {spilled}")
    # threefry on the card is bit-exact with the CPU
    from ba_pathtracing_fur_torch.core import rng
    ids = torch.arange(4096)
    kc = rng.bounce_uniforms(rng.keys_for_pixels(rng.key(0, "cpu"), ids, 3), 2, 5, 2)
    kg = rng.bounce_uniforms(rng.keys_for_pixels(rng.key(0, dev), ids.to(dev), 3), 2, 5, 2)
    if not torch.equal(kc, kg.cpu()):
        raise AssertionError("threefry uniforms on the card differ from the CPU")
    log("threefry: card uniforms bit-identical to CPU")

    check = phase_kernel_vs_plain(dev)
    k4 = time_bounces(dev)
    phase_small_reference(dev)
    main_res = phase_main_path(dev)
    times = phase_timing(*main_res["config0_scene"])
    phase_profile(*main_res["config0_scene"])
    log(f"config0 end to end: kernel path {times['kernel']:.4f} s, plain path "
        f"{times['plain']:.4f} s, on {card}")
    cfg0 = main_res["config0_scene"][3]
    compaction = {"config0": phase_compaction(*main_res["config0_scene"][:2], cfg0, "config0",
                                              full_bounce=cfg0.depth)}

    scene4, cam4, cfg4, build_s = fur_scene(dev)
    fur = phase_fur_kernels(scene4, cam4, cfg4, dev)
    fur_main = phase_fur_main_path(scene4, cam4, cfg4, dev)
    from ba_pathtracing_fur_torch.core import rng
    marks4 = ("traverse_kernel", "shade_kernel")
    prof4 = phase_profile(scene4, cam4, rng.key(0, dev), cfg4, name="config-4", marks=marks4)
    un4 = phase_sort_effect(scene4, cam4, rng.key(0, dev), cfg4, "config4", marks4)
    rays4 = cam4.resolution[0] * cam4.resolution[1] * cfg4.spp * cfg4.depth
    log(f"config4 end to end: kernel path {fur_main['times']['kernel']:.4f} s = "
        f"{rays4 / fur_main['times']['kernel']:.4e} rays/s sorted, "
        f"{rays4 / un4['times']['kernel']:.4e} rays/s unsorted; the sort adds "
        f"{prof4['launches'] - un4['profile']['launches']} launches a sample; BVH build "
        f"{build_s:.3f} s, on {card}")
    compaction["config4"] = phase_compaction(scene4, cam4, cfg4, "config4",
                                             traverse=2 * cfg4.depth, shade=cfg4.depth,
                                             hit=cfg4.depth)
    grad = phase_gradient(scene4, cam4, dev)
    log(f"gradient phase on {card}: {grad}")
    w4 = phase_whitted("fur_patch", scene4, cam4, card, ("traverse",), profile=True)
    b4 = phase_bdpt(scene4, cam4, card)
    del scene4
    para = phase_parallel(dev, card)
    tri = phase_tri_bvh(dev)

    from ba_pathtracing_fur_torch.models import pathtracer as pt
    scene5, cam5, cfg5, build5 = hair_ball_scene(dev)
    k7 = phase_camera(cam5, cfg5, dev)
    hb = phase_hairball_kernels(scene5, cam5, cfg5, dev)
    hb_main = phase_hairball_main_path(scene5, cam5, cfg5, dev)
    marks5 = ("stream_kernel", "brute_kernel", "shade_kernel", "hit_kernel", "camera_kernel")
    prof5 = phase_profile(scene5, cam5, rng.key(0, dev), cfg5, name="config-5", marks=marks5)
    un5 = phase_sort_effect(scene5, cam5, rng.key(0, dev), cfg5, "config5", marks5)
    rays5 = cam5.resolution[0] * cam5.resolution[1] * cfg5.spp * cfg5.depth
    log(f"config5 end to end: kernel path {hb_main['times']['kernel']:.4f} s = "
        f"{rays5 / hb_main['times']['kernel']:.4e} rays/s sorted, "
        f"{rays5 / un5['times']['kernel']:.4e} rays/s unsorted; the sort adds "
        f"{prof5['launches'] - un5['profile']['launches']} launches a sample; generation "
        f"{build5['gen_s']:.3f} s, BVH build {build5['build_s']:.3f} s, on {card}")
    compaction["config5"] = phase_compaction(scene5, cam5, cfg5, "config5",
                                             stream=2 * cfg5.depth, bruteforce_tri=2 * cfg5.depth,
                                             shade=cfg5.depth, hit=cfg5.depth)
    img5 = hb_main.pop("img")
    joint = phase_joint(scene5, cam5, cfg5, dev, img5)
    jr, sr = joint["joint"], joint["separate"]
    log(f"config5 joint vs separate on {card}: {jr['rays_per_s']:.4e} vs "
        f"{sr['rays_per_s']:.4e} rays/s; traced sample: launches {jr['profile']['launches']} "
        f"vs {sr['profile']['launches']}, device busy {jr['profile']['busy'] * 1e3:.2f} vs "
        f"{sr['profile']['busy'] * 1e3:.2f} ms, idle share "
        f"{max(0.0, 1 - jr['profile']['busy'] / jr['profile']['wall']):.3f} vs "
        f"{max(0.0, 1 - sr['profile']['busy'] / sr['profile']['wall']):.3f}; mixed pass "
        f"{joint['times']['mixed_ms']:.4f} ms vs closest + any "
        f"{joint['times']['closest_ms'] + joint['times']['any_ms']:.4f} ms, bound "
        f"{joint['bound']['bound_ms']:.4f} ms")
    sv = phase_stream_variants(scene5, cam5, cfg5, dev, hb, joint, img5, card)
    del img5
    w5 = phase_whitted("hair_ball", scene5, cam5, card, ("stream", "bruteforce_tri"),
                       lobes=("all",))
    del scene5
    k5_cone = phase_bruteforce_cone(dev)
    phase_mid_hairball(dev)

    c3 = CONFIG3
    scene3, cam3, build3 = terrain_scene(dev, c3)
    cfg3 = pt.RenderConfig(depth=c3["depth"], spp=c3["spp"], ray_chunk=c3["ray_chunk"],
                           compact=False)
    if (scene3.tri_bvh.n_leaves, scene3.tri_bvh.leaf_size, scene3.tri_bvh.fanout) != c3["bvh"]:
        raise AssertionError(f"config3: unexpected BVH, not {c3['bvh']}")
    k2t = phase_terrain_kernels(scene3, cam3, cfg3, dev)
    main3 = phase_terrain_main_path(scene3, cam3, cfg3, dev)
    log(f"config3 end to end: {main3['rays_per_s']:.4e} rays/s; SAH build "
        f"{build3['build_s']:.3f} s (split {build3['stages']['split']:.3f} s), on {card}")
    compaction["config3"] = phase_compaction(scene3, cam3, cfg3, "config3",
                                             traverse=2 * cfg3.depth, hit=cfg3.depth)
    # K1's texture fetch at full size: the terrain's textured material on
    # the fused path (the CLI skin's fur hides its skin from bounces 0-1)
    k1t = k1_bounces(scene3, cam3, dataclasses.replace(cfg3, fused_shading=True), dev,
                     "config3")
    log(f"compaction on {card}: {compaction}")
    del scene3
    phase_terrain_gate(dev)
    phase_unfused_vs_fused(dev)
    phase_engine_gates(dev)
    cli = phase_cli(dev, card)
    for name, r in (("W4", w4["all"]), ("W4 hair_lobes='r'", w4["r"]), ("W5", w5["all"]),
                    ("B4", b4)):
        prof = r.get("profile")
        log(f"{name} on {card}: wall {r['wall']:.4f} s, {r['rays_per_s']:.4e} traced rays/s, "
            f"{r['pixels_per_s']:.4e} pixels/s, iterations {r.get('iterations', '-')}, "
            f"launches {r['counts']}, peak {r['peak_gib']:.2f} GiB"
            + (f", traced: device busy {prof['busy'] * 1e3:.2f} ms, idle share "
               f"{max(0.0, 1 - prof['busy'] / prof['wall']):.3f}, {prof['launches']} launches"
               if prof else ""))

    def cli_kernel(name):
        """The CLI scene's numbers of one kernel: its launches in the median
        (or none) render, and its time on each held wavefront of each build."""
        runs = {"median": cli["median"], **cli["methods"]}
        count = {"traverse_tri": "traverse", "traverse_stream_cone": "stream"}.get(name, name)
        return dict(
            launches={m: r["counts"][count] for m, r in runs.items()},
            ms={m: {w: x[name]["ms"] for w, x in held.items() if name in x}
                for m, held in cli["held"].items()},
            bound_ms={m: {w: x[name]["bound"]["bound_ms"] for w, x in held.items()
                          if "bound" in x.get(name, {})} for m, held in cli["held"].items()},
            max_abs_err=max([x[name]["max_abs_err"] for held in cli["held"].values()
                             for x in held.values() if name in x] or [0.0]))

    def parallel_launches(count):
        """One kernel's launches in each part of the parallel phase (the
        traverse count holds K2's triangle and cone launches), beside the
        unsharded render's."""
        return {name: dict(sharded=r["counts"][count], unsharded=r["single_counts"][count])
                for name, r in para.items() if isinstance(r, dict) and "single_counts" in r} \
            | {"train": para["train"]["counts"][count]}

    cf = cli["fused"]
    mxu_entry, bf16_entry = variant_entries(sv, ptx, hb_main["counts"])
    t0, s0 = fur[0]["times"], fur[0]["shade"]
    b0 = fur[0]["closest_bound"]
    h0, k5t, k4b = hb[0], hb["k5_tri_0"], k4["config0_b0"]
    k5c = k5_cone[0]
    kernels_line = [
        dict(name="full_bounce", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/full_bounce.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/shade.py:359",
             launches=main_res["launches"], max_abs_err=check["max_abs_err"],
             mismatch_frac=check["mismatch_frac"], ms=k4b["ms"], plain_ms=k4b["plain_ms"],
             bound_ms=k4b["bound_ms"], bound_by=k4b["bound_by"], library_ms=None,
             bounces={k: dict(ms=v["ms"], bound_ms=v["bound_ms"]) for k, v in k4.items()}),
        dict(name="traverse_cone", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/traverse.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/traverse.py:247",
             launches=fur_main["counts"]["traverse"],
             max_abs_err=max(x["max_abs_err"] for x in fur["k2"]), ms=t0["closest_ms"],
             plain_ms=t0["closest_plain_ms"], bound_ms=b0["bound_ms"],
             bound_by=b0["bound_by"], library_ms=None,
             unsorted_ms=t0["closest_unsorted_ms"], any_ms=t0["any_ms"],
             any_unsorted_ms=t0["any_unsorted_ms"], any_plain_ms=t0["any_plain_ms"],
             any_bound_ms=fur[0]["any_bound"]["bound_ms"],
             any_bound_by=fur[0]["any_bound"]["bound_by"], sort_ms=t0["sort_ms"],
             grad_step_launches=grad["step_launches"],
             whitted_launches=w4["all"]["counts"]["traverse"],
             whitted_r_launches=w4["r"]["counts"]["traverse"],
             bdpt_launches=b4["counts"]["traverse"],
             whitted_traffic_ms={n: x["ms"] for n, x in w4["all"]["held"].items()},
             bdpt_traffic_ms={n: x["ms"] for n, x in b4["held"].items()},
             parallel_launches=parallel_launches("traverse")),
        dict(name="traverse_tri", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/traverse.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/traverse.py:247",
             launches=tri["launches"], max_abs_err=tri["max_abs_err"], ms=tri["ms"],
             plain_ms=tri["plain_ms"], bound_ms=tri["bound_ms"], bound_by=tri["bound_by"],
             library_ms=None, unsorted_ms=tri["unsorted_ms"], any_ms=tri["any_ms"],
             soup=tri["soup"], cli=cli_kernel("traverse_tri"),
             config3=dict(
                 launches=main3["counts"]["traverse"],
                 max_abs_err=max(k2t[k]["max_abs_err"] for k in (0, 1, "shadow")),
                 **{k: k2t[0][k] for k in ("ms", "unsorted_ms", "plain_ms", "plain_rays",
                                           "bound_ms", "bound_by")},
                 any_ms=k2t["shadow"]["ms"], any_unsorted_ms=k2t["shadow"]["unsorted_ms"],
                 any_plain_ms=k2t["shadow"]["plain_ms"],
                 any_bound_ms=k2t["shadow"]["bound_ms"], any_bound_by=k2t["shadow"]["bound_by"],
                 bounce1_ms=k2t[1]["ms"], bounce1_unsorted_ms=k2t[1]["unsorted_ms"],
                 bounce1_bound_ms=k2t[1]["bound_ms"],
                 traced_ms=main3["profile"]["kernel_ms"]["traverse_kernel"],
                 traced_launches=main3["profile"]["kernel_launches"]["traverse_kernel"],
                 leaves=c3["bvh"][0], leaf_rows=c3["bvh"][1])),
        dict(name="shade", route="cuda", source="ba_pathtracing_fur_torch/csrc/shade.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/shade.py:92",
             launches=fur_main["counts"]["shade"],
             max_abs_err=max(fur["k1"]["max_abs_err"], hb["k1"]["max_abs_err"]),
             mismatch_frac=max(fur["k1"]["worst_frac"], hb["k1"]["worst_frac"]),
             max_rel_err=max(fur["k1"]["max_rel_err"], hb["k1"]["max_rel_err"]),
             ms=s0["ms"], plain_ms=s0["plain_ms"], bound_ms=fur[0]["shade_bound"]["bound_ms"],
             bound_by=fur[0]["shade_bound"]["bound_by"], library_ms=None,
             old_bound_ms=fur[0]["shade_bound"]["old_bound_ms"],
             all_inputs_bound_ms=fur[0]["shade_bound"]["all_bytes_ms"], glue_ms=s0["glue_ms"],
             traced_ms_per_launch=per_launch(prof4, "shade_kernel"),
             bounce1_ms=fur[1]["shade"]["ms"],
             bounce1_bound_ms=fur[1]["shade_bound"]["bound_ms"],
             config5={k: dict(ms=hb[b]["shade"]["ms"],
                              plain_ms=hb[b]["shade"]["plain_ms"],
                              glue_ms=hb[b]["shade"]["glue_ms"],
                              bound_ms=hb[b]["shade"]["bound"]["bound_ms"],
                              bound_by=hb[b]["shade"]["bound"]["bound_by"])
                      for k, b in (("bounce0", 0), ("bounce1", 1))},
             config5_launches=hb_main["counts"]["shade"],
             parallel_launches=parallel_launches("shade"),
             config5_traced_ms_per_launch=per_launch(prof5, "shade_kernel"),
             textured=dict(
                 launches=cf["counts"]["shade"], max_abs_err=cf["k1"]["max_abs_err"],
                 mismatch_frac=cf["k1"]["worst_frac"],
                 **{k: cf[0]["times"][k] for k in ("ms", "plain_ms")},
                 bound_ms=cf[0]["bound"]["bound_ms"], bound_by=cf[0]["bound"]["bound_by"],
                 bounce1_ms=cf[1]["times"]["ms"], bounce1_bound_ms=cf[1]["bound"]["bound_ms"],
                 rays_per_s=cf["rays_per_s"], fetches=cf[0]["bound"]["fetches"],
                 config3=dict(
                     max_abs_err=k1t["k1"]["max_abs_err"], mismatch_frac=k1t["k1"]["worst_frac"],
                     **{k: k1t[0]["times"][k] for k in ("ms", "plain_ms")},
                     bound_ms=k1t[0]["bound"]["bound_ms"], bound_by=k1t[0]["bound"]["bound_by"],
                     fetches=k1t[0]["bound"]["fetches"], bounce1_ms=k1t[1]["times"]["ms"],
                     bounce1_bound_ms=k1t[1]["bound"]["bound_ms"]))),
        dict(name="traverse_stream_cone", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/traverse_stream.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/stream.py:464",
             launches=hb_main["counts"]["stream"],
             max_abs_err=max(hb[b][k]["max_abs_err"] for b in (0, 1)
                             for k in ("closest", "shadow")),
             ms=h0["times"]["closest_ms"], plain_ms=h0["times"]["closest_plain_ms"],
             plain_rays=TWIN_RAYS, bound_ms=h0["closest_bound"]["bound_ms"],
             bound_by=h0["closest_bound"]["bound_by"], library_ms=None,
             k2_ms=h0["times"]["closest_k2_ms"], any_ms=h0["times"]["any_ms"],
             any_k2_ms=h0["times"]["any_k2_ms"], any_bound_ms=h0["any_bound"]["bound_ms"],
             any_bound_by=h0["any_bound"]["bound_by"],
             unsorted_ms=h0["times"]["closest_unsorted_ms"],
             k2_unsorted_ms=h0["times"]["closest_k2_unsorted_ms"],
             any_unsorted_ms=h0["times"]["any_unsorted_ms"],
             any_k2_unsorted_ms=h0["times"]["any_k2_unsorted_ms"],
             sort_ms=h0["times"]["sort_ms"], bounce1_ms=hb[1]["times"]["closest_ms"],
             bounce1_bound_ms=hb[1]["closest_bound"]["bound_ms"],
             bounce1_bound_by=hb[1]["closest_bound"]["bound_by"],
             whitted_launches=w5["all"]["counts"]["stream"],
             whitted_traffic_ms={n: x["ms"] for n, x in w5["all"]["held"].items()},
             cli=cli_kernel("traverse_stream_cone"),
             joint_launches=joint["counts"]["stream"],
             ptxas={k: v for k, v in ptx.items() if k.startswith("K3") and k.endswith(" f32")
                    and " mxu" not in k},
             occupancy={k: v for k, v in {**sv["occupancy"], **sv["tri"]["occupancy"]}.items()
                        if k.endswith(" f32") and " mxu" not in k}),
        dict(name="traverse_stream_mixed", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/traverse_stream.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/stream.py:464",
             launches=joint["counts"]["stream_mixed"], max_abs_err=joint["max_abs_err"],
             ms=joint["times"]["mixed_ms"], plain_ms=joint["times"]["plain_ms"],
             plain_rays=2 * TWIN_RAYS, bound_ms=joint["bound"]["bound_ms"],
             bound_by=joint["bound"]["bound_by"], library_ms=None,
             **{k: joint["times"][k] for k in ("closest_ms", "any_ms", "closest_own_sort_ms",
                                               "any_own_sort_ms", "pair_sort_ms",
                                               "two_sorts_ms")},
             render={k: dict(rays_per_s=joint[k]["rays_per_s"], wall=joint[k]["wall"],
                             traced_launches=joint[k]["profile"]["launches"],
                             traced_busy_ms=joint[k]["profile"]["busy"] * 1e3,
                             idle_share=max(0.0, 1 - joint[k]["profile"]["busy"]
                                            / joint[k]["profile"]["wall"]))
                     for k in ("joint", "separate")}),
        mxu_entry,
        bf16_entry,
        dict(name="bruteforce_tri", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/bruteforce.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/intersect.py:220",
             launches=hb_main["counts"]["bruteforce_tri"],
             max_abs_err=max(hb[k]["max_abs_err"] for k in ("k5_tri_0", "k5_tri_1",
                                                             "k5_tri_shadow")),
             ms=k5t["ms"], plain_ms=k5t["plain_ms"], bound_ms=k5t["bound"]["bound_ms"],
             bound_by=k5t["bound"]["bound_by"], library_ms=None,
             unsorted_ms=k5t["unsorted_ms"], all_pairs_bound_ms=k5t["bound"]["all_pairs_bound_ms"],
             survivors_per_tile=k5t["bound"]["survivors_per_tile"],
             exact_per_ray=k5t["bound"]["exact_per_ray"],
             entry_ratio=max(hb[k]["margin"]["entry_ratio"] for k in ("k5_tri_0", "k5_tri_1",
                                                                       "k5_tri_shadow")),
             **{f"{w}_{k}": hb[f"k5_tri_{w}"][k] for w in ("1", "shadow")
                for k in ("ms", "unsorted_ms")},
             **{f"{w}_bound_ms": hb[f"k5_tri_{w}"]["bound"]["bound_ms"] for w in ("1", "shadow")},
             whitted_launches=w5["all"]["counts"]["bruteforce_tri"],
             whitted_traffic_ms={n: x["k5"]["ms"] for n, x in w5["all"]["held"].items()},
             cli=cli_kernel("bruteforce_tri")),
        dict(name="bruteforce_cone", route="cuda",
             source="ba_pathtracing_fur_torch/csrc/bruteforce.cu",
             replaces="ba_pathtracing_fur_tpu/ops/pallas/intersect.py:220",
             launches=k5_cone["launches"],
             max_abs_err=max(k5_cone[b]["max_abs_err"] for b in (0, 1)),
             ms=k5c["ms"], plain_ms=k5c["plain_ms"],
             bound_ms=k5c["bound"]["bound_ms"], bound_by=k5c["bound"]["bound_by"],
             library_ms=None, all_pairs_bound_ms=k5c["bound"]["all_pairs_bound_ms"],
             survivors_per_tile=k5c["bound"]["survivors_per_tile"],
             exact_per_ray=k5c["bound"]["exact_per_ray"],
             entry_ratio=max(k5_cone[b]["margin"]["entry_ratio"] for b in (0, 1)),
             bounce1_ms=k5_cone[1]["ms"],
             bounce1_bound_ms=k5_cone[1]["bound"]["bound_ms"],
             cli=cli_kernel("bruteforce_cone"),
             parallel_launches=parallel_launches("bruteforce_cone")),
        dict(name="hit", route="cuda", source="ba_pathtracing_fur_torch/csrc/hit.cu",
             replaces="ba_pathtracing_fur_tpu/ops/traverse.py:824 (_assemble_hit, plain JAX)",
             launches=hb_main["counts"]["hit"], max_abs_err=0.0,
             mismatched={b: hb[f"k6_{b}"]["mismatched"] for b in (0, 1)},
             ms=hb["k6_0"]["ms"], plain_ms=hb["k6_0"]["plain_ms"],
             bound_ms=hb["k6_0"]["bound_ms"], bound_by="bytes", library_ms=None,
             bounce1_ms=hb["k6_1"]["ms"], bounce1_plain_ms=hb["k6_1"]["plain_ms"],
             bounce1_bound_ms=hb["k6_1"]["bound_ms"],
             config5_traced_ms_per_launch=per_launch(prof5, "hit_kernel"),
             config5_traced_launches=prof5["kernel_launches"]["hit_kernel"],
             joint_launches=joint["counts"]["hit"], fit_launches=grad["step_launches"] // 2,
             parallel_launches=parallel_launches("hit")),
        dict(name="camera", route="cuda", source="ba_pathtracing_fur_torch/csrc/camera.cu",
             replaces="ba_pathtracing_fur_tpu/models/pathtracer.py (camera_wavefront, plain "
                      "JAX)",
             launches=hb_main["counts"]["camera_launches"], max_abs_err=0.0,
             mismatched={k: v["mismatched"] for k, v in k7.items()},
             ms=k7["main"]["ms"], device_ms=k7["main"]["device_ms"],
             plain_ms=k7["main"]["plain_ms"], plain_device_ms=k7["main"]["plain_device_ms"],
             plain_launches=k7["main"]["plain_launches"], bound_ms=k7["main"]["bound_ms"],
             bound_by=k7["main"]["bound_by"], library_ms=None,
             samples3_device_ms=k7["samples3"]["device_ms"],
             samples3_bound_ms=k7["samples3"]["bound_ms"],
             config5_traced_ms_per_launch=per_launch(prof5, "camera_kernel"),
             config5_traced_launches=prof5["kernel_launches"]["camera_kernel"]),
    ]
    return kernels_line


if __name__ == "__main__":
    sys.exit(main())
