"""Closed-loop progressive rendering: `models/pathtracer.render_progressive`
driven one pass (one sample a pixel) after another, as a user watching the
progressive image sees it refresh.

A unit of the window is one pass: the next running mean the generator
yields, the cell's checked pixels gathered from it, and a sync. Its work is
the pass's W x H x depth rays. The check recomputes a seeded sample of the
passes at a seeded sample of pixels with the plain reference and holds the
running mean the program yielded at those pixels against the mean the
reference's sample gives from the program's previous mean. The compared
share is of every checked sample, a miss into a constant environment or a
black path as much as one whose sample moves its mean.

Traffic parameters (the cell's workload file): `warmup_passes`,
`profile_passes` (the traced stretch), `check_pixels`, `check_passes`,
`check_chunk` (passes the reference traces at once) and `limits`.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from furbench import harness, tracing

#: a checked sample is off where its colour is off the reference's by more
#: than TOL x (1 + the reference's largest channel)
TOL = 1e-4

#: the program's plain versions' call counters: (module, counter)
PLAIN_COUNTERS = (("ops.cuda.shade", "REF_CALLS"), ("ops.cuda.shade", "SHADE_REF_CALLS"),
                  ("ops.cuda.traverse", "REF_CALLS"), ("ops.cuda.stream", "REF_CALLS"),
                  ("ops.cuda.intersect", "REF_CALLS"))


def plain_calls() -> int:
    """The calls of the port's plain versions so far (its counters)."""
    import importlib

    return sum(getattr(importlib.import_module(f"{tracing.PACKAGE}.{m}"), c)
               for m, c in PLAIN_COUNTERS)


def scene_module(config: dict):
    return harness.load_module(harness.ROOT / "scenes" / f"{config['scene']}.py",
                               f"furbench_scene_{config['scene']}")


def checked_passes(n: int, k: int, seed: int) -> list:
    """k of the passes 0 .. n-1, drawn from the seed, the first and the last
    among them."""
    rest = np.random.default_rng(seed).permutation(np.arange(1, n - 1))[:max(k - 2, 0)]
    return sorted({0, n - 1, *rest.tolist()})


def running_mean(prev, c, i: int):
    """The program's running-mean step after pass i, as it computes it."""
    return prev + (c - prev) / (i + 1.0)


def errors(got, want, c_ref, i: int):
    """Per checked pixel of pass i: the colour error (the gap between two
    running means, times i + 1) and whether it is off. A NaN is off."""
    err = (got - want).abs().amax(-1) * (i + 1.0)
    return err, ~(err <= TOL * (1.0 + c_ref.abs().amax(-1)))


def informative(prev, c_ref):
    """The checked pixels whose sample moves their mean: where a pass that
    left the mean as it was would be off (reported beside the share, not
    gated apart)."""
    return errors(prev, c_ref, c_ref, 0)[1]


class Driver:
    unit = "pass"

    def __init__(self, spec: dict, seed: int, dev):
        self.config, self.traffic = spec["config"], spec["workload"]["traffic"]
        self.limits = spec["workload"]["limits"]
        self.seed, self.dev = seed, dev
        self.scenes = scene_module(self.config)
        self.workdir = Path(tempfile.mkdtemp(prefix="furbench_"))
        self.rec = []  # the running mean at the checked pixels after each pass

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self):
        from ba_pathtracing_fur_torch.core import rng
        from ba_pathtracing_fur_torch.models import pathtracer as pt

        params, render = self.config["params"], self.config["render"]
        self.scene, cam, self.build = self.scenes.program(params, self.seed, self.dev,
                                                          self.workdir)
        w, h = cam.resolution
        self.rays_per_pass = w * h * render["depth"]
        gen = torch.Generator().manual_seed(self.seed)
        self.pix = torch.randperm(w * h, generator=gen)[:self.traffic["check_pixels"]]
        self.pix = self.pix.to(self.dev)
        cfg = pt.RenderConfig(spp=2**62, **render)
        self.passes = pt.render_progressive(self.scene, cam, rng.key(self.seed, self.dev), cfg)
        for _ in range(self.traffic["warmup_passes"]):
            self.step()
        self.plain0 = plain_calls()

    def step(self) -> float:
        _, acc = next(self.passes)
        self.rec.append(acc.reshape(-1, 3).index_select(0, self.pix))
        self._sync()
        return self.rays_per_pass

    def end_to_end(self, record: dict) -> dict:
        from furbench import stats

        return dict(rays_per_s=stats.rate(record["work"], record["window_s"]),
                    pass_p90_ms=stats.p90(record["unit_s"]) * 1e3)

    def traced(self) -> dict:
        """A profiled stretch of `profile_passes` passes; the streaming
        traversal's calls of its first pass kept (their rays and answers)."""
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
            self.step()
            first[0] = False

        stream.traverse_stream = kept
        try:
            tr = tracing.profiled(unit, self.traffic["profile_passes"], self.unit)
        finally:
            stream.traverse_stream = launch
        return dict(trace=tr, build=self.build, k3_calls=calls, unit=self.unit,
                    seed=self.seed)

    def release(self):
        """Free the program's state; keep the checked pixels' means."""
        self.plain = plain_calls() - self.plain0
        del self.scene, self.passes
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_samples(self, ids: list, round_to=None):
        """The reference's samples `ids` at the checked pixels -> [S, P, 3]."""
        from furbench.furref.core import rng
        from furbench.furref.models import pathtracer as ref

        scene, cam = self.scenes.reference(self.config["params"], self.seed, self.dev,
                                           self.workdir)
        cfg = ref.RenderConfig(spp=1, round_to=round_to, **self.config["render"])
        key = rng.key(self.seed, self.dev)
        step = self.traffic["check_chunk"]
        with torch.no_grad():
            return torch.cat([ref.render_samples(scene, cam, self.pix, key, ids[s:s + step],
                                                 cfg) for s in range(0, len(ids), step)])

    def readings(self, control: bool = False) -> dict:
        """The checked samples' readings of the program and, with `control`,
        of the control (the program with each checked sample computed by the
        reference at bfloat16, `RenderConfig.round_to`) and of three faults
        planted in the reference put in the program's place: `unchanged` (a
        pass that returns the previous mean), `half` (the pixels of odd id
        left out of each pass: their mean stays) and `altered` (each sample's
        colour 1% off where it is made)."""
        ids = checked_passes(len(self.rec), self.traffic["check_passes"], self.seed)
        zero = torch.zeros_like(self.rec[0])
        prev = [self.rec[i - 1] if i else zero for i in ids]
        c_ref = self.reference_samples(ids)
        want = [running_mean(p, c, i) for p, c, i in zip(prev, c_ref, ids)]
        sides = {"program": [self.rec[i] for i in ids]}
        if control:
            c_low = self.reference_samples(ids, round_to=torch.bfloat16)
            odd = (self.pix % 2 == 1)[:, None]
            sides.update(
                control=[running_mean(p, c, i) for p, c, i in zip(prev, c_low, ids)],
                unchanged=prev,
                half=[torch.where(odd, p, w) for p, w in zip(prev, want)],
                altered=[running_mean(p, c * 1.01, i) for p, c, i in zip(prev, c_ref, ids)])
        moves = torch.cat([informative(p, c) for p, c in zip(prev, c_ref)])
        out = {}
        for side, got in sides.items():
            errs, offs = zip(*(errors(g, w, c, i) for g, w, c, i in zip(got, want, c_ref, ids)))
            err, off = torch.cat(errs), torch.cat(offs)
            out[side] = dict(
                off_share_pct=100.0 * off.sum().item() / off.numel(),
                off=int(off.sum()), off_informative=int((off & moves).sum()),
                err_median=err.nan_to_num(float("inf")).median().item(),
                err_max=err.nan_to_num(float("inf")).max().item(), samples=off.numel(),
                informative=int(moves.sum()), passes=len(ids))
        return out

    def check(self) -> list:
        self.last_readings = self.readings()
        r = self.last_readings["program"]
        checks = [dict(name="off_share_pct", value=r["off_share_pct"],
                       limit=self.limits["off_share_pct"],
                       ok=r["off_share_pct"] <= self.limits["off_share_pct"])]
        if self.dev.type == "cuda":
            checks.append(dict(name="plain_calls", value=self.plain, limit=0,
                               ok=self.plain == 0))
        return checks

    def close(self):
        import shutil

        shutil.rmtree(self.workdir, ignore_errors=True)

