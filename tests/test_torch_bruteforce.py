"""The brute-force kernel's cull (K5, `csrc/bruteforce.cu`) in plain torch,
on the CPU.

The kernel tests a tile's ray bundle against every primitive's padded box,
then each ray's own slab test against the survivors' boxes, and runs the
exact test only where both pass (`ops/cuda/intersect.py`: `padded_boxes`,
`ray_bundles`, `bundle_hits`, `slab_entries`). It is exact only if neither
test drops a pair that the exact test accepts. Checked here with rays made
from a numpy seed, on the hair ball's scalp and the fur patch:

* every pair that `closest_ref`'s exact test accepts below its ray's t_max
  passes its tile's bundle test and its own padded slab test at its own t:
  rays aimed at triangle edges and vertices, rays grazing cone silhouettes,
  rays that start inside boxes, flat triangles (the Cornell walls),
  duplicated primitives, rays nearly parallel to cone axes (a small
  quadratic coefficient, the largest root error), and shadow rays with a
  finite t_max; `cull_margin` says how near each set comes to a drop;
* the kernel's walk, emulated in torch (survivors in index order, each
  pruned by the ray's best t so far, strict `<`), gives `closest_ref`'s t
  and index bit for bit;
* `closest_hit` hands K5 the entry-morton sorted rays when the scene has a
  BVH (the JAX package's order) and gives the same Hit as without the sort;
* the tables are made once per pack, at its first use, and not per call;
* `work_ref` counts the work the rays need and the cull's own tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ba_pathtracing_fur_torch.ops import bruteforce, intersect as isect, traverse
from ba_pathtracing_fur_torch.ops.cuda import intersect as cisect
from ba_pathtracing_fur_torch.scene import builtins, types

torch.set_num_threads(2)

CPU = "cpu"
INF = cisect.INF


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _tri_rays(tris, n, g, inside=0.0, room=False):
    """Rays aimed at triangle edges (70%) and vertices (30%) from origins at
    distance 0.6-4 around the pack (within [-0.99, 0.99]^3 with `room`); a
    share `inside` of them starts within 0.01 of its target (inside the
    triangle's box)."""
    v0, v1, v2 = (x.numpy().astype(np.float64) for x in (tris.v0, tris.v1, tris.v2))
    pick = g.integers(0, tris.count, n)
    w = g.uniform(0, 1, (n, 1))
    edge = np.where(g.uniform(size=(n, 1)) < 0.5, v0[pick] * w + v1[pick] * (1 - w),
                    v1[pick] * w + v2[pick] * (1 - w))
    tgt = np.where(g.uniform(size=(n, 1)) < 0.7, edge, v0[pick])
    center = 0.5 * (v0.min(0) + v0.max(0))
    org = center + _unit(g.normal(size=(n, 3))) * g.uniform(0.6, 4.0, (n, 1))
    if room:
        org = g.uniform(-0.99, 0.99, (n, 3))
    near = g.uniform(size=n) < inside
    org[near] = tgt[near] + g.normal(0, 0.01, (int(near.sum()), 3))
    return org, _unit(tgt - org)


def _grazing_cone_rays(cones, n, g):
    """Rays tangent to cone silhouettes (up to a small tilt along the axis),
    from 0.01-3 before the tangent point."""
    base, v, u, w, rb, slope, h = (x.numpy().astype(np.float64) for x in (
        cones.base, cones.v, cones.u, cones.w, cones.r_base, cones.slope, cones.height))
    pick = g.integers(0, cones.count, n)
    y = g.uniform(0, 1, n) * h[pick]
    ang = g.uniform(0, 2 * np.pi, n)
    radial = np.cos(ang)[:, None] * u[pick] + np.sin(ang)[:, None] * w[pick]
    pt = base[pick] + y[:, None] * v[pick] + (rb[pick] - slope[pick] * y)[:, None] * radial
    tang = _unit(np.cross(v[pick], radial) + g.normal(0, 0.05, (n, 1)) * v[pick])
    return pt - tang * g.uniform(0.01, 3.0, (n, 1)), tang


def _axial_cone_rays(cones, n, g):
    """Rays nearly parallel to cone axes (up or down the axis, tilted by
    1e-4 to 0.1), through points on the cone surfaces, from 0.01-3 before
    them."""
    base, v, u, w, rb, slope, h = (x.numpy().astype(np.float64) for x in (
        cones.base, cones.v, cones.u, cones.w, cones.r_base, cones.slope, cones.height))
    pick = g.integers(0, cones.count, n)
    y = g.uniform(0, 1, n) * h[pick]
    ang = g.uniform(0, 2 * np.pi, n)
    radial = np.cos(ang)[:, None] * u[pick] + np.sin(ang)[:, None] * w[pick]
    pt = base[pick] + y[:, None] * v[pick] + (rb[pick] - slope[pick] * y)[:, None] * radial
    sign = np.where(g.uniform(size=(n, 1)) < 0.5, -1.0, 1.0)
    tilt = 10.0 ** g.uniform(-4, -1, (n, 1)) * _unit(
        g.normal(size=(n, 1)) * radial + g.normal(size=(n, 1)) * np.cross(v[pick], radial))
    dirs = _unit(sign * v[pick] + tilt)
    return pt - dirs * g.uniform(0.01, 3.0, (n, 1)), dirs


def _case(name):
    """(pack, kind, o [R,3], d [R,3], t_max [R]) for one case; every 17th
    ray is dead."""
    g = np.random.default_rng(sum(map(ord, name)))
    t_max = None
    if name in ("scalp_edges", "scalp_inside", "scalp_shadow"):
        scene, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=10, device=CPU)
        pack, kind = scene.tris, "tri"
        o, d = _tri_rays(pack, 6000, g, inside=0.5 if name == "scalp_inside" else 0.05)
        if name == "scalp_shadow":  # t_max just past the target, or just short of it
            t_max = np.linalg.norm(o, axis=1) * g.uniform(0.8, 1.2, o.shape[0])
    elif name in ("fur_grazing", "fur_axial", "fur_duplicated"):
        scene, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=150, device=CPU)
        pack, kind = scene.cones, "cone"
        if name == "fur_duplicated":  # every cone twice: equal t, the lower index wins
            pack = types.ConePack(**{f.name: torch.cat([getattr(pack, f.name)] * 2)
                                     for f in dataclasses.fields(types.ConePack)})
        rays = _axial_cone_rays if name == "fur_axial" else _grazing_cone_rays
        o, d = rays(pack, 6000, g)
    else:  # cornell_walls: flat triangles, rays from inside the box
        scene, _ = builtins.cornell_box(resolution=(4, 4), device=CPU)
        pack, kind = scene.tris, "tri"
        o, d = _tri_rays(pack, 4000, g, inside=0.3, room=True)
    o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    t_max = torch.full((o.shape[0],), INF) if t_max is None \
        else torch.from_numpy(t_max.astype(np.float32))
    t_max[::17] = 0.0
    return pack, kind, o, d, t_max


CASES = ["scalp_edges", "scalp_inside", "scalp_shadow", "fur_grazing", "fur_axial",
         "fur_duplicated", "cornell_walls"]


@pytest.mark.parametrize("name", CASES)
def test_cull_keeps_every_pair_the_exact_test_accepts(name):
    pack, kind, o, d, t_max = _case(name)
    tables = cisect.brute_tables(pack, kind)
    t = cisect.exact_test(o, d, tables.cm, kind)
    live = t_max > 0
    ri, pi = ((t < INF) & (t < t_max[:, None]) & live[:, None]).nonzero(as_tuple=True)
    assert ri.shape[0] > 1000
    # the ray's own slab test of the padded box, pruned at the pair's own t
    boxes = tables.boxes[:, pi]
    assert bool(cisect.slab_entries(o[ri], d[ri], boxes, t[ri, pi]).all())
    if name == "fur_grazing":  # some grazing roots lie before the box: the slack is needed
        assert not bool(cisect.slab_entries(o[ri], d[ri], boxes,
                                            t[ri, pi] / cisect.PRUNE_SLACK).all())
    # how near: every accepted pair's padded box is entered ahead of its ray,
    # by PRUNE_SLACK times its t (printed: pytest -s)
    margin = cisect.cull_margin(o, d, t_max, pack, kind)
    print(f"{name}: {margin}")
    assert margin["pairs"] == ri.shape[0] and margin["missed"] == 0
    assert margin["entry_ratio"] <= cisect.PRUNE_SLACK
    # the bundle test of the ray's tile
    hits = cisect.bundle_hits(cisect.ray_bundles(o, d, t_max), tables.boxes)
    assert bool(hits[ri // cisect.TILE_RAYS, pi].all())
    # and the cull does cull somewhere (not on these scattered rays' tiles,
    # but per ray)
    entered = cisect.slab_entries(o[:, None], d[:, None], tables.boxes,
                                  torch.where(live, t_max, -INF)[:, None])
    assert float(entered.double().mean()) < 0.5


def _kernel_walk(o, d, t_max, tables, kind, t_min=1e-4):
    """The kernel in torch, vectorised over rays (one thread a ray): the
    survivors of each tile's bundle test in index order, each pruned by the
    slab test at the ray's best t so far, the exact test where it enters,
    strict `<`."""
    surv = cisect.bundle_hits(cisect.ray_bundles(o, d, t_max), tables.boxes)
    tile = torch.arange(o.shape[0]) // cisect.TILE_RAYS
    live = t_max > 0
    best = torch.where(live, torch.clamp(t_max, max=INF), -1.0)
    idx = torch.full((o.shape[0],), -1, dtype=torch.int32)
    t_all = cisect.exact_test(o, d, tables.cm, kind, t_min)
    for k in range(tables.cm.shape[1]):
        enter = surv[tile, k] & live & cisect.slab_entries(o, d, tables.boxes[:, k:k + 1],
                                                           best)
        take = enter & (t_all[:, k] < best)
        best = torch.where(take, t_all[:, k], best)
        idx = torch.where(take, k, idx)
    return torch.where(idx >= 0, best, INF), idx


@pytest.mark.parametrize("name", ["scalp_edges", "scalp_shadow", "fur_grazing", "fur_axial",
                                  "fur_duplicated", "cornell_walls"])
def test_kernel_walk_equals_the_twin(name):
    pack, kind, o, d, t_max = _case(name)
    o, d, t_max = o[:1024], d[:1024], t_max[:1024]
    tables = cisect.brute_tables(pack, kind)
    t0, i0 = cisect.closest_ref(o, d, t_max, tables, kind)
    t1, i1 = _kernel_walk(o, d, t_max, tables, kind)
    assert torch.equal(t0, t1) and torch.equal(i0, i1)
    assert (i0 >= 0).any() and (i0[::17] == -1).all()
    if name == "fur_duplicated":  # the lower copy wins every tie
        assert (i0[i0 >= 0] < pack.count // 2).all()
    if name == "scalp_shadow":  # a hit at or beyond t_max is a miss
        assert ((t0 < t_max) | (i0 == -1)).all()
        full = cisect.closest_ref(o, d, torch.where(t_max > 0, INF, 0.0), tables, kind)[0]
        assert ((full >= t_max) & (t_max > 0) & (full < INF)).any()


def test_padded_boxes_contain_the_primitives_with_volume():
    scene, _ = builtins.cornell_box(resolution=(4, 4), device=CPU)
    boxes = cisect.padded_boxes(scene.tris, "tri")
    lo, hi = isect.triangle_aabbs(scene.tris)
    assert boxes.shape == (6, scene.tris.count) and boxes.is_contiguous()
    assert bool((boxes[:3].T < lo).all()) and bool((boxes[3:].T > hi).all())
    assert float((hi - lo).amin(1).max()) == 0.0  # the walls are flat
    assert float((boxes[3:] - boxes[:3]).min()) > 1e-4  # their boxes are not
    fur, _ = builtins.fur_patch(resolution=(4, 4), fibers_per_face=10, device=CPU)
    clo, chi = isect.cone_aabbs(fur.cones)
    cb = cisect.padded_boxes(fur.cones, "cone")
    assert bool((cb[:3].T < clo).all()) and bool((cb[3:].T > chi).all())
    assert cisect.padded_boxes(types.empty_cone_pack(), "cone").shape == (6, 0)


def test_bundle_test_bounds_every_live_ray_of_its_tile():
    """A box passes a tile's bundle test whenever any of its live rays'
    slab test (at its t_max) enters it: mixed direction signs, origins
    spread and a tile of dead rays included."""
    g = np.random.default_rng(5)
    n = 4 * cisect.TILE_RAYS
    o = torch.from_numpy(g.normal(0, 0.3, (n, 3)).astype(np.float32))
    d = torch.from_numpy(_unit(g.normal(size=(n, 3)) + [0.0, 0.0, 2.0]).astype(np.float32))
    d[: cisect.TILE_RAYS, 0] = 0.0  # an axis with 1/d of one sign: 1e20
    t_max = torch.from_numpy(g.uniform(0.1, 3.0, n).astype(np.float32))
    t_max[3 * cisect.TILE_RAYS:] = 0.0  # the last tile is dead
    c = torch.from_numpy(g.uniform(-2, 2, (3000, 3)).astype(np.float32))
    size = torch.from_numpy(g.uniform(0.0, 0.2, (3000, 3)).astype(np.float32))
    boxes = torch.cat([c - size, c + size], 1).T.contiguous()
    b = cisect.ray_bundles(o, d, t_max)
    hits = cisect.bundle_hits(b, boxes)
    assert b["live"].tolist() == [True, True, True, False] and not hits[3].any()
    entered = cisect.slab_entries(o[:, None], d[:, None], boxes,
                                  torch.where(t_max > 0, t_max, -INF)[:, None])
    per_tile = entered.reshape(4, cisect.TILE_RAYS, -1).any(1)
    assert bool((hits | ~per_tile).all())
    assert hits[:3].sum(1).min() < boxes.shape[1]  # and it culls


def _forced_brute_hair_ball():
    hb, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=300, device=CPU)
    return traverse.attach_bvh(hb, leaf_size=16, fanout=8)


def test_closest_hit_feeds_k5_the_sorted_rays(monkeypatch):
    """With a cone BVH the scalp's BVH-less triangles go to K5 (threshold
    patched down) on the entry-morton sorted rays, and the Hit equals the
    Hit without the sort."""
    scene = _forced_brute_hair_ball()
    assert scene.tri_bvh is None and scene.cone_bvh is not None
    rs = np.random.default_rng(7)
    n = 700
    o = torch.from_numpy(rs.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(-o + torch.from_numpy(
        rs.normal(0, 0.3, (n, 3)).astype(np.float32)), dim=-1)
    t_max = torch.full((n,), INF)
    t_max[::9] = 0.0
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 10)
    seen = []
    closest = cisect.closest

    def recording(o_, d_, t_, tables, kind, t_min=1e-4):
        seen.append((o_, kind))
        return closest(o_, d_, t_, tables, kind, t_min)

    monkeypatch.setattr(cisect, "closest", recording)
    sorted_hit = traverse.closest_hit(o, d, scene, t_max=t_max)
    perm, _ = traverse._entry_morton_perms(o, d, t_max, scene.cone_bvh)
    assert [k for _, k in seen] == ["tri"] and torch.equal(seen[0][0], o[perm])
    assert not torch.equal(perm, torch.arange(n))
    monkeypatch.setattr(traverse, "SORT_RAYS", False)
    plain_hit = traverse.closest_hit(o, d, scene, t_max=t_max)
    assert torch.equal(seen[-1][0], o)
    assert (sorted_hit.prim_type == bruteforce.PRIM_TRI).any()
    assert (sorted_hit.prim_type == bruteforce.PRIM_CONE).any()
    for f in dataclasses.fields(sorted_hit):
        assert torch.equal(getattr(sorted_hit, f.name), getattr(plain_hit, f.name)), f.name


def test_tables_are_made_once_per_pack(monkeypatch):
    """K5's tables of a BVH-less pack are made at its first closest_hit /
    any_hit and kept for later calls while the pack lives; the scene stays
    plain data; a pack that gets a BVH needs none; a replaced pack gets
    tables of its own."""
    made = []
    build = cisect.brute_tables
    monkeypatch.setattr(cisect, "brute_tables", lambda *a: made.append(a[1]) or build(*a))
    monkeypatch.setattr(traverse, "_BRUTE_MIN", 1 << 8)
    hb, _ = builtins.hair_ball(resolution=(4, 4), n_fibers=200, device=CPU)
    o = torch.tensor([[0.0, 0.0, 2.0]]).repeat(300, 1)
    d = torch.nn.functional.normalize(torch.randn(300, 3, generator=torch.Generator()
                                                  .manual_seed(0)) * 0.2
                                      + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    first = traverse.closest_hit(o, d, hb)
    assert sorted(made) == ["cone", "tri"]
    assert torch.equal(cisect.tables_of(hb.tris, "tri").cm, cisect.pack_cm(hb.tris, "tri"))
    again = traverse.closest_hit(o, d, hb)
    traverse.any_hit(o, d, hb, 1.9)
    assert len(made) == 2 and torch.equal(first.prim_id, again.prim_id)
    with_bvh = traverse.attach_bvh(hb, leaf_size=16, fanout=4, min_prims=1000)
    hit = traverse.closest_hit(o, d, with_bvh)
    assert len(made) == 2 and (hit.prim_type == bruteforce.PRIM_TRI).any()
    other = dataclasses.replace(with_bvh, tris=types._to(types.make_triangle_pack(
        *(hb.tris.v0.numpy()[:, None] * s for s in (1.0, 1.01, 0.99))), CPU))
    traverse.closest_hit(o, d, other)
    assert sorted(made) == ["cone", "tri", "tri"]
    key = (id(other.tris), "tri")
    assert key in cisect._TABLES
    del other
    assert key not in cisect._TABLES  # dropped with its pack


def test_work_ref_counts_the_cull():
    pack, kind, o, d, t_max = _case("scalp_edges")
    tables = cisect.brute_tables(pack, kind)
    t, idx = cisect.closest_ref(o, d, t_max, tables, kind)
    t_fin = torch.where(idx >= 0, t, t_max)
    w = cisect.work_ref(o, d, t_max, tables, kind, t_fin)
    b = cisect.ray_bundles(o, d, t_max)
    hits = cisect.bundle_hits(b, tables.boxes)
    n_tiles = -(-o.shape[0] // cisect.TILE_RAYS)
    live = t_max > 0
    assert w["tiles"] == n_tiles and w["live_tiles"] == int(b["live"].sum())
    assert w["survivors"] == int(hits.sum())
    assert w["bundle_tests"] == int(b["live"].sum()) * pack.count
    assert w["all_pairs"] == int(live.sum()) * pack.count
    assert int((idx >= 0).sum()) <= w["exact_tests"] <= w["slab_tests"] <= w["all_pairs"]
    assert w["flops"] == w["exact_tests"] * cisect.PAIR_FLOPS[kind]
    assert w["cull_flops"] == (w["bundle_tests"] + w["slab_tests"]) * cisect.BOX_FLOPS
    # each input read once, each output written once; the tiles' re-reads apart
    assert w["bytes"] == 4 * (9 + 6) * pack.count + o.shape[0] * 36
    assert w["reread_bytes"] == 4 * (w["live_tiles"] * 6 * pack.count + w["survivors"] * 9)
    half = cisect.work_ref(o, d, t_max, tables, kind, t_fin, max_tiles=n_tiles // 2)
    assert half["counted_tiles"] == n_tiles // 2
    assert 0.5 * w["exact_tests"] < half["exact_tests"] < 2.0 * w["exact_tests"]
