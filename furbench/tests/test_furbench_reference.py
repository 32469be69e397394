"""The check of a progressive cell on a tiny version of its configuration,
on the CPU (the port's plain versions): the reference agrees with the port,
the control (the reference at bfloat16) and each fault the cell can have
make `correct` false."""

import time

import pytest
import torch

from furbench import harness
from furbench.drivers import progressive

from conftest import tiny

CELLS = ("hairball.progressive",)
SEED = 2**31 + 11


def run(cell, seed=SEED, seconds=0.2):
    return harness.run(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                       overrides=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_port(cell):
    res, rec = run(cell)
    assert res["correct"], res["check"]
    r = rec["readings"]["program"]
    assert r["off_share_pct"] == 0.0
    assert r["err_max"] < 1e-4
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"setup_s", "rays_per_s", "pass_p90_ms"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_planted_faults_fail_the_limit(cell):
    from furbench import control

    out = control.readings(cell, SEED, 0.2, True, device="cpu", overrides=tiny(cell))
    limit = harness.load_json(harness.ROOT / "workloads" / f"{cell}.json")["limits"]
    assert out["program"]["off_share_pct"] <= limit["off_share_pct"]
    for side in ("control", "unchanged", "half", "altered"):
        assert out[side]["off_share_pct"] > limit["off_share_pct"], side


def _frozen_mean(render_progressive):
    """A pass that returns the running mean unchanged."""
    def fault(scene, camera, key, cfg, **k):
        for i, acc in render_progressive(scene, camera, key, cfg, **k):
            if i == 0:
                first = acc
            yield i, first
    return fault


def _half_left_out(render_sample):
    """Half of the pixels left out of each pass (their sample is 0)."""
    def fault(*a, **k):
        c = render_sample(*a, **k).clone()
        c[1::2] = 0.0
        return c
    return fault


def _altered(render_sample):
    """Each pass's colour altered where it is made."""
    def fault(*a, **k):
        return render_sample(*a, **k) * 1.01
    return fault


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault,attr", [(_frozen_mean, "render_progressive"),
                                        (_half_left_out, "render_sample"),
                                        (_altered, "render_sample")])
def test_a_broken_timed_path_fails_the_check(cell, fault, attr, monkeypatch):
    from ba_pathtracing_fur_torch.models import pathtracer

    monkeypatch.setattr(pathtracer, attr, fault(getattr(pathtracer, attr)))
    res, _ = run(cell)
    assert not res["correct"], res["check"]


def _off_where_still(render_progressive):
    """Each pass after the first 0.05 off on the pixels whose sample leaves
    the running mean as it was (a miss into the constant environment, a
    black path): samples that move no mean, as a spurious hit on a
    background ray would be."""
    def fault(scene, camera, key, cfg, **k):
        for i, acc in render_progressive(scene, camera, key, cfg, **k):
            if i == 0:
                f = acc.clone()
            else:
                c = a_prev + (acc - a_prev) * (i + 1.0)
                still = ~progressive.informative(f, c)
                f = progressive.running_mean(f, torch.where(still[..., None], c + 0.05, c), i)
            a_prev = acc.clone()
            yield i, f
    return fault


@pytest.mark.parametrize("cell", CELLS)
def test_samples_that_move_no_mean_are_checked(cell, monkeypatch):
    from ba_pathtracing_fur_torch.models import pathtracer

    monkeypatch.setattr(pathtracer, "render_progressive",
                        _off_where_still(pathtracer.render_progressive))
    res, rec = run(cell, seconds=0.0)  # the warm-up pass and one more: both checked
    r = rec["readings"]["program"]
    assert r["passes"] == 2 and r["off"] > 0
    assert r["off_informative"] == 0  # every sample off moves no mean
    assert not res["correct"], res["check"]


def test_checked_passes_hold_the_first_and_last():
    ids = progressive.checked_passes(100, 8, 3)
    assert len(ids) == 8 and ids[0] == 0 and ids[-1] == 99
    assert ids == progressive.checked_passes(100, 8, 3)
    assert progressive.checked_passes(2, 8, 3) == [0, 1]


def test_a_nan_sample_is_off():
    prev = torch.zeros(4, 3)
    got = torch.tensor([[0.5] * 3, [float("nan")] * 3, [0.5] * 3, [0.6] * 3])
    c = torch.full((4, 3), 0.5)
    err, off = progressive.errors(got, progressive.running_mean(prev, c, 0), c, 0)
    assert off.tolist() == [False, True, False, True]


def test_a_tiny_run_on_the_card(card):
    res, rec = harness.run("hairball.progressive", SEED, 0.5, False, time.perf_counter(),
                           device="cuda", overrides=tiny("hairball.progressive"))
    assert res["correct"], res["check"]
    assert res["check"]["plain_calls"]["value"] == 0


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown():
    res, rec = harness.run("hairball.progressive", SEED, 0.2, True, time.perf_counter(),
                           device="cpu", overrides=tiny("hairball.progressive"))
    assert res["correct"], res["check"]
    per_layer = {m["name"] for m in harness.load_json(
        harness.CHECKOUT / "BENCHMARK.json")["per_layer"]}
    assert "bvh_build_s" in res["metrics"] and set(res["metrics"]) <= per_layer
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0.0
    assert list(res)[-1] == "check"
    assert rec["trace"]["units"] == tiny("hairball.progressive")["traffic"]["profile_passes"]
