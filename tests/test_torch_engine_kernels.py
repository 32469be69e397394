"""The traversal kernels on the Whitted raytracer's and BDPT's traffic, on
trees with empty tail leaves, and K1's texture fetch.

Whitted's nodes trace with t_max = inf (the JAX package's `jnp.inf`), its
shadow rays carry unnormalized directions with t_max = 1 (|d| ~ 1e16 toward
a sun, non-finite from a miss), and its TT/TRT rays start 1e-4 inside a
fiber; BDPT's connections carry a per-ray t_max. Here the twins' rules on
that traffic (a row's INF is a miss even below t_max = inf), and, on the
card (`cuda`-marked, skipped elsewhere), K2, K3 and K5 against their twins
on it and the engines' small renders through the kernels against their
plain versions bit for bit. The morton build fills the leaves in order, so
its last leaves can be wholly padding (inverted boxes): K2 and K3 are held
to their twins on such trees. K1 on a textured scene fetches its textured
slots itself: it is held to its plain version (the textured gather) on
wrapping and negative uvs, ids of -1 and a slot the scene does not texture.
No jax import, so on the card:
`python -m pytest tests/test_torch_engine_kernels.py -m cuda --noconftest -p no:cacheprovider`.
"""

import pytest
import torch

from ba_pathtracing_fur_torch.core import rng
from ba_pathtracing_fur_torch.models import pathtracer as pt, whitted
from ba_pathtracing_fur_torch.ops import traverse
from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect, stream as cstream, \
    traverse as ctraverse
from ba_pathtracing_fur_torch.scene import builtins

torch.set_num_threads(2)

INF = traverse.INF


def _scenes(dev, res=(8, 8)):
    """(scene, camera) of a fur patch on a flat cone BVH (K2) and of a hair
    ball on a two-level one (K3) with its BVH-less 768-triangle scalp (K5)."""
    fur, fcam = builtins.fur_patch(resolution=res, fibers_per_face=150, device=dev)
    ball, bcam = builtins.hair_ball(resolution=res, n_fibers=1500, on_device=True,
                                    device=dev)
    return ((traverse.attach_bvh(fur), fcam),
            (traverse.attach_bvh(ball, method="median", leaf_size=16, fanout=8), bcam))


def _traffic(n, dev, seed=0):
    """Rays toward and away from the scene: `n` finite rays from around it,
    a quarter aiming away (misses), and the Whitted shadow-ray kinds: a sun
    direction of length 1e16, a ray from infinity with a NaN direction, and
    one from a partly infinite origin back toward a light (infinite and
    finite direction components: its slab terms mix NaN and numbers)."""
    g = torch.Generator().manual_seed(seed)
    o = (torch.rand((n, 3), generator=g) * 3.0 - 1.5)
    d = torch.nn.functional.normalize(-o + 0.3 * torch.randn((n, 3), generator=g), dim=-1)
    d[::4] = -d[::4]
    d[1::16] = torch.tensor([0.4, 1.0, 0.3]) * 1e16
    o[2::16] = float("inf")
    d[2::16] = float("nan")
    o[3::16] = torch.tensor([float("inf"), 0.2, -float("inf")])
    d[3::16] = torch.tensor([0.6, 1.2, 0.8]) - o[3::16]
    return o.to(dev), d.to(dev)


def _twin(bvh, kind, o, d, t_max, any_hit):
    if bvh.fanout and bvh.fanout < bvh.n_leaves:
        return cstream.traverse_stream_ref(o, d, t_max, bvh, kind, any_hit=any_hit)
    return ctraverse.traverse_ref(o, d, t_max, bvh, kind, any_hit=any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_twins_take_inf_as_a_miss_below_an_infinite_t_max(any_hit):
    """K2's, K3's and K5's twins: t_max = inf finds what t_max = INF finds
    (the same rows and t), and a ray that misses is not found."""
    for scene, _ in _scenes("cpu"):
        o, d = _traffic(512, "cpu")
        bvh = scene.cone_bvh
        t_inf, r_inf, f_inf = _twin(bvh, "cone", o, d, torch.full((512,), float("inf")),
                                    any_hit)
        t_big, r_big, f_big = _twin(bvh, "cone", o, d, torch.full((512,), INF), any_hit)
        assert torch.equal(f_inf, f_big) and torch.equal(r_inf, r_big)
        assert torch.equal(t_inf[f_inf], t_big[f_big])
        assert 0 < int(f_inf.sum()) < 512
        assert not f_inf[2::16].any() and not f_inf[3::16].any()
        tables = cisect.tables_of(scene.tris, "tri")
        a = cisect.closest_ref(o, d, torch.full((512,), float("inf")), tables, "tri")
        b = cisect.closest_ref(o, d, torch.full((512,), INF), tables, "tri")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("t_cap", ["inf", "one", "per_ray"])
def test_kernels_match_twins_on_the_engines_traffic_on_the_card(any_hit, t_cap):
    """K2 (flat BVH), K3 (two-level) and K5 (the scalp) against their twins
    on the engines' ray kinds, sorted as closest_hit feeds them: t_max = inf
    (Whitted's nodes), 1 (its shadow rays), or a per-ray distance with dead
    lanes (BDPT's connections): found and t bit for bit, rows on closest
    hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    n = 4096
    for scene, _ in _scenes(dev):
        o, d = _traffic(n, dev, seed=1)
        t_max = {"inf": torch.full((n,), float("inf"), device=dev),
                 "one": torch.ones((n,), device=dev),
                 "per_ray": torch.rand((n,), device=dev) * 2.0}[t_cap]
        t_max[::7] = 0.0
        bvh = scene.cone_bvh
        perm, _ = traverse._entry_morton_perms(o, d, t_max, bvh)
        so, sd, st = o[perm], d[perm], t_max[perm]
        two_level = bool(bvh.fanout) and bvh.fanout < bvh.n_leaves
        fn = cstream.traverse_stream if two_level else ctraverse.traverse
        t1, r1, f1 = fn(so, sd, st, bvh, "cone", any_hit=any_hit)
        t0, r0, f0 = _twin(bvh, "cone", so, sd, st, any_hit)
        assert torch.equal(f1, f0) and torch.equal(t1, t0)
        if not any_hit:
            assert torch.equal(r1, r0)
        tables = cisect.tables_of(scene.tris, "tri")
        a = cisect.closest(so, sd, st, tables, "tri")
        b = cisect.closest_ref(so, sd, st, tables, "tri")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_engines_render_bit_equal_to_their_plain_versions_on_the_card(monkeypatch):
    """Whitted (hair_lobes "all") on both scenes and BDPT on the fur patch,
    through the kernels and through the plain versions: equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    (fur, fcam), (ball, bcam) = _scenes(dev, res=(48, 48))
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)  # K5 on the scalp
    cfg = whitted.WhittedConfig(hair_lobes="all")
    runs = [lambda s=s, c=c: whitted.render_whitted(s, c, cfg)
            for s, c in ((fur, fcam), (ball, bcam))]
    runs.append(lambda: pt.render_image(fur, fcam, rng.key(0, dev),
                                        pt.RenderConfig(depth=3, spp=2, bdpt=True)))
    for run in runs:
        got = run()
        for mod, name, ref in ((ctraverse, "traverse", ctraverse.traverse_ref),
                               (cstream, "traverse_stream", cstream.traverse_stream_ref),
                               (cisect, "closest", cisect.closest_ref)):
            monkeypatch.setattr(mod, name, ref)
        want = run()
        monkeypatch.undo()
        monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)
        assert torch.isfinite(got).all() and torch.equal(got, want)


def _textured_inputs(dev):
    """shade_bounce's inputs on a textured terrain (a SAH BVH, K2) with
    textured diffuse and transparency on material 0, an untextured
    material 1 (ids -1), a roughness id on material 1 that the scene does
    not texture (not in tex_slots: it keeps its value), and the hits' uvs
    replaced by values in [-2.5, 2.5): wrapping and negative."""
    import dataclasses

    scene, cam = builtins.tri_terrain(resolution=(64, 64), n_tris=2000, device=dev)
    m = scene.materials
    m = dataclasses.replace(m, transparency_tex=torch.tensor([0, -1], dtype=torch.int32,
                                                             device=dev),
                            roughness_tex=torch.tensor([-1, 0], dtype=torch.int32, device=dev))
    scene = dataclasses.replace(traverse.attach_bvh(scene, method="sah", min_prims=1),
                                materials=m, tex_slots=("diffuse", "transparency"))
    cfg = pt.RenderConfig(depth=2, spp=1, compact=False, fused_shading=True)
    ids = torch.arange(64 * 64, device=dev)
    state, keys = pt.camera_wavefront(cam, ids, rng.key(3, dev), [0], cfg)
    hit = traverse.closest_hit(state.origin, state.direction, scene)
    kw = pt.shade_inputs(state, scene, keys, 0, cfg, hit, pt.BounceTables.of(scene))
    g = torch.Generator().manual_seed(5)
    kw["uv"] = (torch.rand((ids.numel(), 2), generator=g) * 5.0 - 2.5).to(dev)
    kw["uv"][:8] = torch.tensor([[0.0, 0.0], [1.0, 1.0], [-1e-10, 0.5], [2.0, -2.0],
                                 [-0.3, 1.7], [0.999999, -0.999999], [-0.0, -0.0],
                                 [1.5, 0.25]])
    assert 0.2 < float(hit.valid.float().mean()) < 1.0
    return kw


def test_textured_shade_inputs_fetch_like_the_unfused_gather():
    """The plain K1's textured rows (gather_rows + fetch_textures on the
    table's ids) equal the unfused path's gather_materials bit for bit, and
    the fetch changes the textured slots only."""
    from ba_pathtracing_fur_torch.models import bsdf

    kw = _textured_inputs("cpu")
    ids = kw["tex_table"][bsdf.material_index(kw["mat_id"], kw["tex_table"].shape[0])]
    got = bsdf.fetch_textures(bsdf.gather_rows(kw["mats_table"], kw["mat_id"]),
                              dict(zip(bsdf.CONSUMED_TEX_SLOTS, ids.unbind(1))), kw["uv"],
                              kw["textures"], kw["tex_slots"])
    plain = bsdf.gather_rows(kw["mats_table"], kw["mat_id"])
    mat0 = kw["mat_id"] == 0
    assert not torch.equal(got.diffuse[mat0], plain.diffuse[mat0])
    assert not torch.equal(got.transparency[mat0], plain.transparency[mat0])
    for f in ("diffuse", "transparency", "roughness", "specular", "emission", "ior"):
        assert torch.equal(getattr(got, f)[~mat0], getattr(plain, f)[~mat0]), f
    assert torch.equal(got.roughness, plain.roughness)


@pytest.mark.cuda
def test_shade_kernel_texture_fetch_matches_plain_on_the_card():
    """K1 with its texture fetch against its plain version (the textured
    gather) on the card: wrapping and negative uvs, a texture id of -1, a
    slot the scene does not texture, colour and scalar slots. Every output
    field under the per-field gate of the other K1 tests, and the textured
    rows' direct term bit for bit where both are lit (the fetch is rounded
    as the plain version rounds)."""
    from ba_pathtracing_fur_torch.ops.cuda import shade as cshade

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    kw = _textured_inputs(torch.device("cuda"))
    launches = cshade.SHADE_LAUNCHES
    got = cshade.shade_bounce(**kw)
    want = cshade.shade_bounce_ref(**kw)
    torch.cuda.synchronize()
    assert cshade.SHADE_LAUNCHES == launches + 1
    live = want["shadow_tmax"] > 0
    for f, a in want.items():
        b = got[f]
        if f in ("shadow_o", "shadow_d"):
            a, b = a[live], b[live]
        a, b = a.double().reshape(len(a), -1), b.double().reshape(len(b), -1)
        bad = ((a - b).abs() > 1e-4 + 1e-4 * a.abs()).any(-1).double().mean().item()
        assert bad < 0.02, f"{f}: {bad:.4f} of rows mismatched"


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_traversal_kernels_on_empty_tail_leaves_on_the_card(any_hit):
    """K2 (flat) and K3 (two-level) on morton trees whose last leaves are
    wholly padding (inverted boxes), against their twins: found and t bit
    for bit, rows on closest hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    dev = torch.device("cuda")
    fur, _ = builtins.fur_patch(resolution=(8, 8), fibers_per_face=1000, device=dev)
    n = 4096
    for leaf_size, fanout in ((96, 0), (96, 16)):
        scene = traverse.attach_bvh(fur, method="morton", leaf_size=leaf_size, fanout=fanout,
                                    min_prims=1)
        bvh = scene.cone_bvh
        empty = (bvh.perm.reshape(bvh.n_leaves, -1) < 0).all(1)
        assert int(empty.sum()) >= 8 and bool(empty[-1])
        o, d = _traffic(n, dev, seed=2)
        t_max = torch.rand((n,), device=dev) * 3.0
        t_max[::5] = float("inf")
        t_max[::11] = 0.0
        perm, _ = traverse._entry_morton_perms(o, d, t_max, bvh)
        so, sd, st = o[perm], d[perm], t_max[perm]
        fn = cstream.traverse_stream if fanout else ctraverse.traverse
        t1, r1, f1 = fn(so, sd, st, bvh, "cone", any_hit=any_hit)
        t0, r0, f0 = _twin(bvh, "cone", so, sd, st, any_hit)
        assert 0 < int(f0.sum()) < n
        assert torch.equal(f1, f0) and torch.equal(t1, t0)
        if not any_hit:
            assert torch.equal(r1, r0)
