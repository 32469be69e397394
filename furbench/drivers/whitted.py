"""Closed-loop Whitted renders: `models/whitted.render_whitted` called one
whole deterministic render after another, as a user renders a groom's
reference image again after each change of its shading.

A unit of the window is one render: `render_whitted` on the configuration's
scene with its `WhittedConfig`, the cell's checked pixels gathered from the
image, and a sync. Its work is the W x H x supersamples^2 camera rays of the
image: a fixed count a render, whatever the recursion traces, so that a
change that traces fewer rays shows as a faster render, not as less work.
The check renders the checked pixels with the plain reference
(`furbench/furref/models/whitted.py`) and holds the last render of the
window against it, pixel by pixel, and its hard shadow rays at the same
lanes (a lane is a pixel's camera ray through the DFS) call by call: each
ray the render fired where the reference fires it, alike, and its any-hit
answer the reference's search's on the render's own ray. The shadow rays
are held apart because their answers need not reach a pixel: at 1024x1024
every one of them belongs to a miss's point at o + 3.4e38 d, whose light
term is 0 before its shadow test. The renders are deterministic: the seed
draws only the checked pixels.

Traffic parameters (the cell's workload file): `warmup_renders`,
`profile_renders` (the traced stretch), `check_pixels`, `check_block`
(pixels the reference traces at once) and `limits`.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import torch

from furbench import harness, tracing

#: a checked pixel is off where its colour is off the reference's by more
#: than TOL x (1 + the reference's largest channel). The reference runs the
#: port's arithmetic in the same order on the same device, and the kernels
#: pick rows bit for bit as their plain versions do (`-fmad=false`), so a
#: pixel the search answers alike is equal; TOL leaves room for float32
#: rounding alone (a near tie in t that the search breaks otherwise moves a
#: pixel by far more, and counts as off)
TOL = 1e-4

#: the program's plain versions' call counters: (module, counter)
PLAIN_COUNTERS = (("ops.cuda.shade", "REF_CALLS"), ("ops.cuda.shade", "SHADE_REF_CALLS"),
                  ("ops.cuda.traverse", "REF_CALLS"), ("ops.cuda.stream", "REF_CALLS"),
                  ("ops.cuda.intersect", "REF_CALLS"), ("ops.cuda.hit", "HIT_REF_CALLS"))

#: the planted faults the control readings add: reference renders put in
#: the program's place, with a lobe dropped, the shadow rays skipped,
#: colours 1% off, or a wrong any-hit (`wrong_any`: every live shadow ray's
#: answer inverted)
FAULTS = {"no_tt": dict(drop_lobe="tt"), "no_shadows": dict(shadows=False),
          "altered": dict(scale=1.01), "wrong_any": dict(flip_any=True)}


def plain_calls() -> int:
    """The calls of the port's plain versions so far (its counters)."""
    import importlib

    return sum(getattr(importlib.import_module(f"{tracing.PACKAGE}.{m}"), c)
               for m, c in PLAIN_COUNTERS)


def scene_module(config: dict):
    return harness.load_module(harness.ROOT / "scenes" / f"{config['scene']}.py",
                               f"furbench_scene_{config['scene']}")


def errors(got, want):
    """Per checked pixel: the colour error and whether it is off. A NaN is
    off."""
    err = (got - want).abs().amax(-1)
    return err, ~(err <= TOL * (1.0 + want.abs().amax(-1)))


@contextlib.contextmanager
def shadow_rays(module, traverse, lanes=None, answer=None):
    """The hard shadow rays of the Whitted renders made inside: for each DFS
    walk (a `module._trace_queue` call) the list of its `traverse.any_hit`
    calls, each dict(o, d, t_max, blocked) at `lanes` (every lane where
    None). `answer(blocked, t_max)`, where given, replaces each any-hit's
    answers in the render (a planted fault). Yields the list of walks."""
    walks = []
    walk, any_hit = module._trace_queue, traverse.any_hit

    def queue(*a, **k):
        walks.append([])
        return walk(*a, **k)

    def shadow(o, d, scene, t_max, *a, **k):
        blocked = any_hit(o, d, scene, t_max, *a, **k)
        t_max = torch.as_tensor(t_max, dtype=o.dtype, device=o.device).expand(o.shape[0])
        if answer is not None:
            blocked = answer(blocked, t_max)
        rays = dict(o=o, d=d, t_max=t_max, blocked=blocked)
        walks[-1].append({n: (v if lanes is None else v.index_select(0, lanes)).detach()
                          for n, v in rays.items()})
        return blocked

    module._trace_queue, traverse.any_hit = queue, shadow
    try:
        yield walks
    finally:
        module._trace_queue, traverse.any_hit = walk, any_hit


def wrong_any(blocked, t_max):
    """The `wrong_any` fault's answers: every live shadow ray's inverted."""
    return blocked ^ (t_max > 0.0)


def _dead(n: int, dev) -> dict:
    """A call's rays where a walk made no such call: t_max = 0, unblocked."""
    return dict(o=torch.zeros((n, 3), device=dev), d=torch.zeros((n, 3), device=dev),
                t_max=torch.zeros((n,), device=dev),
                blocked=torch.zeros((n,), dtype=torch.bool, device=dev))


def _call(walks, q: int, c: int, n: int, dev) -> dict:
    return walks[q][c] if q < len(walks) and c < len(walks[q]) else _dead(n, dev)


def _shape(walks) -> list:
    """The number of any-hit calls of each walk."""
    return [len(w) for w in walks]


def _widest(*shapes) -> list:
    n = max(map(len, shapes), default=0)
    return [max((s[q] for s in shapes if q < len(s)), default=0) for q in range(n)]


def merge_blocks(blocks: list, sizes: list, dev) -> list:
    """The walks of blocks of lanes rendered apart -> the walks of all their
    lanes in order; a block that made fewer calls is dead in the others."""
    return [[{k: torch.cat([_call(b, q, c, n, dev)[k] for b, n in zip(blocks, sizes)])
              for k in ("o", "d", "t_max", "blocked")} for c in range(calls)]
            for q, calls in enumerate(_widest(*map(_shape, blocks)))]


def _close(a, b):
    ok = (a == b) | ((a - b).abs() <= TOL * (1.0 + b.abs())) | (a.isnan() & b.isnan())
    return ok.all(-1) if ok.dim() > 1 else ok


def shadow_errors(got: list, want: list, answer_of, n: int, dev):
    """The shadow rays of the checked lanes, `got` against the reference's
    `want` (walks of calls, as `shadow_rays` keeps them) -> (rays off, rays).
    A ray is a (call, lane) where either side fires one (t_max > 0); it is
    off where the other side does not fire it, or fires another (its o, d or
    t_max off by more than TOL x (1 + |want|)), or where got's answer is not
    `answer_of(o, d, t_max)`, the reference's search on got's own ray."""
    off = rays = 0
    for q, calls in enumerate(_widest(_shape(got), _shape(want))):
        for c in range(calls):
            g, w = _call(got, q, c, n, dev), _call(want, q, c, n, dev)
            lg, lw = g["t_max"] > 0.0, w["t_max"] > 0.0
            alike = (lg == lw) & (_close(g["o"], w["o"]) & _close(g["d"], w["d"])
                                  & _close(g["t_max"], w["t_max"]) | ~lw)
            right = torch.ones_like(lg)
            if lg.any():
                right[lg] = g["blocked"][lg] == answer_of(g["o"][lg], g["d"][lg],
                                                          g["t_max"][lg])
            fired = lg | lw
            off += int((fired & ~(alike & right)).sum())
            rays += int(fired.sum())
    return off, rays


class Driver:
    unit = "render"

    def __init__(self, spec: dict, seed: int, dev):
        self.config, self.traffic = spec["config"], spec["workload"]["traffic"]
        self.limits = spec["workload"]["limits"]
        self.seed, self.dev = seed, dev
        self.scenes = scene_module(self.config)
        self.workdir = Path(tempfile.mkdtemp(prefix="furbench_"))
        self.last = None  # the last render's colours at the checked pixels
        self.shadow = []  # and its shadow rays there (`shadow_rays`)
        self.ref_scene = None

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self):
        from ba_pathtracing_fur_torch.models import whitted

        params, render = self.config["params"], self.config["render"]
        self.scene, self.cam, self.build = self.scenes.program(params, self.seed, self.dev,
                                                               self.workdir)
        self.cfg = whitted.WhittedConfig(**render)
        w, h = self.cam.resolution
        self.rays_per_render = w * h * max(1, self.cfg.supersamples) ** 2
        gen = torch.Generator().manual_seed(self.seed)
        self.pix = torch.randperm(w * h, generator=gen)[:self.traffic["check_pixels"]]
        self.pix = self.pix.to(self.dev)
        for _ in range(self.traffic["warmup_renders"]):
            self.step()
        self.plain0 = plain_calls()

    def _render(self):
        from ba_pathtracing_fur_torch.models import whitted

        img = whitted.render_whitted(self.scene, self.cam, self.cfg)
        out = img.reshape(-1, 3).index_select(0, self.pix)
        self._sync()
        return out

    def step(self) -> float:
        from ba_pathtracing_fur_torch.models import whitted
        from ba_pathtracing_fur_torch.ops import traverse

        with shadow_rays(whitted, traverse, self.pix) as walks:
            self.last = self._render()
        self.shadow = walks
        return self.rays_per_render

    def end_to_end(self, record: dict) -> dict:
        from furbench import stats

        return dict(rays_per_s=stats.rate(record["work"], record["window_s"]),
                    pass_p90_ms=stats.p90(record["unit_s"]) * 1e3)

    def traced(self) -> dict:
        """A profiled stretch of `profile_renders` renders (the window's last
        render stays the checked one); the streaming traversal's calls of
        the first render kept (their rays and answers)."""
        from ba_pathtracing_fur_torch.ops.cuda import stream

        calls, first = [], [True]
        launch = stream.traverse_stream

        def kept(o, d, t_max, bvh, kind, any_hit=False, **k):
            out = launch(o, d, t_max, bvh, kind, any_hit=any_hit, **k)
            if first[0] and not k.get("mxu") and k.get("is_any") is None:
                calls.append(dict(o=o, d=d, t_max=t_max, bvh=bvh, kind=kind,
                                  any_hit=any_hit, out=out))
            return out

        def unit():
            self._render()
            first[0] = False

        stream.traverse_stream = kept
        try:
            tr = tracing.profiled(unit, self.traffic["profile_renders"], self.unit)
        finally:
            stream.traverse_stream = launch
        return dict(trace=tr, build=self.build, k3_calls=calls, unit=self.unit,
                    seed=self.seed)

    def release(self):
        """Free the program's state; keep the checked pixels' colours."""
        self.plain = plain_calls() - self.plain0
        del self.scene
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference_scene(self):
        if self.ref_scene is None:
            self.ref_scene = self.scenes.reference(self.config["params"], self.seed, self.dev,
                                                   self.workdir)
        return self.ref_scene

    def reference(self, flip_any: bool = False, **knobs):
        """The reference's colours at the checked pixels -> ([P, 3], its
        shadow rays there as `shadow_rays` keeps them), rendered in blocks of
        `check_block` pixels; `knobs` set `RefConfig`'s own fields (the
        control's precision, the planted faults), `flip_any` inverts every
        live shadow ray's answer."""
        from furbench.furref.models import whitted as ref
        from furbench.furref.ops import traverse as ref_traverse

        scene, cam = self._reference_scene()
        cfg = ref.RefConfig.of(self.config["render"], **knobs)
        answer = wrong_any if flip_any else None
        step, colours, blocks = self.traffic["check_block"], [], []
        with torch.no_grad():
            for s in range(0, self.pix.shape[0], step):
                with shadow_rays(ref, ref_traverse, answer=answer) as walks:
                    colours.append(ref.render_pixels(scene, cam, self.pix[s:s + step], cfg))
                blocks.append(walks)
        sizes = [c.shape[0] for c in colours]
        return torch.cat(colours), merge_blocks(blocks, sizes, self.dev)

    def _answer_of(self, o, d, t_max):
        from furbench.furref.ops import traverse as ref_traverse

        with torch.no_grad():
            return ref_traverse.any_hit(o, d, self._reference_scene()[0], t_max)

    def readings(self, control: bool = False) -> dict:
        """The checked pixels' readings of the program and, with `control`,
        of the control (the reference at bfloat16, `RefConfig.round_to`) and
        of the planted faults (FAULTS) put in the program's place: the
        pixels' (`off_share_pct`) and the shadow rays' (`shadow_off_share_pct`
        of `shadow_rays`, by `shadow_errors`); `s`, each side's seconds in
        the reference, its shadow answers included."""
        t = time.perf_counter()
        want, want_shadow = self.reference()
        sides = {"program": (self.last, self.shadow, time.perf_counter() - t)}
        if control:
            for side, knobs in (("control", dict(round_to=torch.bfloat16)),
                                *FAULTS.items()):
                t = time.perf_counter()
                sides[side] = (*self.reference(**knobs), time.perf_counter() - t)
        out, n = {}, self.pix.shape[0]
        for side, (got, shadow, s) in sides.items():
            t = time.perf_counter()
            err, off = errors(got, want)
            err = err.nan_to_num(float("inf"))
            s_off, s_rays = shadow_errors(shadow, want_shadow, self._answer_of, n, self.dev)
            out[side] = dict(off_share_pct=100.0 * off.sum().item() / off.numel(),
                             off=int(off.sum()), err_median=err.median().item(),
                             err_max=err.max().item(), pixels=off.numel(),
                             shadow_off_share_pct=100.0 * s_off / max(s_rays, 1),
                             shadow_off=s_off, shadow_rays=s_rays,
                             s=s + time.perf_counter() - t)
        return out

    def check(self) -> list:
        self.last_readings = self.readings()
        r = self.last_readings["program"]
        checks = [dict(name=k, value=r[k], limit=self.limits[k], ok=r[k] <= self.limits[k])
                  for k in ("off_share_pct", "shadow_off_share_pct")]
        if self.dev.type == "cuda":
            checks.append(dict(name="plain_calls", value=self.plain, limit=0,
                               ok=self.plain == 0))
        return checks

    def close(self):
        import shutil

        self.ref_scene = None
        shutil.rmtree(self.workdir, ignore_errors=True)
