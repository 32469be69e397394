"""Run one cell of the port's benchmark once.

A cell is found by its name: its entry in `BENCHMARK.json` (configuration,
chips, which metrics it reports) and its file `furbench/workloads/<cell>.json`
(its `Driver` module and that module's traffic parameters). The configuration is
`furbench/configs/<config>.json`, the driver `furbench/drivers/<driver>.py`
and each per-layer metric's reader `furbench/metrics/<metric>.py`, each
loaded by name, so that a new cell, configuration, driver or metric is a new
file and an entry, and no file that exists changes.

A run: set-up (imports, the `Driver`'s scene, build and warm-up) timed
from the process start; the window, units of the `Driver` (a pass or a
step) one after another until `seconds` have passed, each ending in a sync;
with `trace`, a short profiled stretch after the window; the device's memory
peak; the program's state freed; `Driver.check`, which compares the
window's output with the plain reference (`furbench/furref`); the result
line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from furbench import stats, tracing

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
#: top-level module names that no benchmark run may hold (the JAX package
#: and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "ba_pathtracing_fur_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (a metric's name may
    hold dots, so not by import)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, bench: dict, root: Path = ROOT) -> dict:
    """Everything a run of cell `name` needs: its BENCHMARK.json entry, its
    workload file, its configuration, and the end-to-end and per-layer
    metrics it reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    workload = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{entry['config']}.json")

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(name=name, entry=entry, workload=workload, config=config,
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def driver_of(spec: dict, root: Path = ROOT):
    return load_module(root / "drivers" / f"{spec['workload']['driver']}.py",
                       f"furbench_driver_{spec['workload']['driver']}")


def reader_of(metric: str, root: Path = ROOT):
    return load_module(root / "metrics" / f"{metric}.py", f"furbench_metric_{metric}")


def forbidden_modules() -> list:
    """The top-level names of FORBIDDEN that sys.modules holds, compared
    whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_env() -> None:
    """Every build and kernel cache of a run inside the checkout, at fixed
    paths; the port's BVH perm cache off, so that every run builds its BVH
    as a new groom does. The port's nvcc builds go to its own
    `ba_pathtracing_fur_torch/_build/`, inside the checkout too."""
    cache = CHECKOUT / ".furbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["BAPT_NO_BVH_CACHE"] = "1"


def device_info(torch, dev, chips: int) -> dict:
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=chips,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))
    return dict(platform="cpu", kind="cpu", count=chips, memory_peak_bytes=0)


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", overrides: dict | None = None):
    """One run of `cell` -> (the result: the last line's object, the
    compared numbers last under "check"; the run's record). `overrides`
    replaces keys of the configuration's params and of the traffic (the
    tests' tiny sizes); `device` "cpu" runs the program's plain versions
    (the tests)."""
    spec, driver = prepare(cell, seed, device, overrides)
    try:
        return _run(spec, driver, seed, seconds, trace, t_start, driver.dev)
    finally:
        driver.close()


def prepare(cell: str, seed: int, device: str, overrides: dict | None = None):
    """The cell's spec, with `overrides` of its params and traffic, and its
    driver on `device` -> (spec, driver)."""
    import torch

    spec = cell_spec(cell, load_json(CHECKOUT / "BENCHMARK.json"))
    for part, key in (("config", "params"), ("workload", "traffic")):
        spec[part][key] = {**spec[part][key], **(overrides or {}).get(key, {})}
    return spec, driver_of(spec).Driver(spec, seed, torch.device(device))


def _run(spec, driver, seed, seconds, trace, t_start, dev):
    import torch

    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    times, work = [], 0.0
    t0 = t = time.perf_counter()
    while t - t0 < seconds or not times:
        work += driver.step()
        now = time.perf_counter()
        times.append(now - t)
        t = now
    window_s = t - t0

    record = dict(setup_s=setup_s, window_s=window_s, units=len(times), unit_s=times,
                  work=work, cell=spec["name"], seed=seed)
    metrics, breakdown = {}, None
    if trace:
        record.update(driver.traced())
        metrics = {m["name"]: reader_of(m["name"]).read(record) for m in spec["per_layer"]}
        tr = record["trace"]
        ops = [(s, e) for _, s, e in tr["ops"]]
        breakdown = dict(device_ops=stats.ops_by_name(tr["ops"]),
                         idle_gaps=stats.gaps_by_span(ops, tr["window"], tr["spans"]))
    else:
        e2e = dict(setup_s=setup_s, **driver.end_to_end(record))
        metrics = {m["name"]: e2e.get(m["name"]) for m in spec["end_to_end"]}
    units = {m["name"]: m["unit"] for m in spec["per_layer"] + spec["end_to_end"]}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in metrics.items() if v is not None}
    info = device_info(torch, dev, spec["entry"]["chips"])
    if trace:
        info.update(busy_s=stats.busy_time(ops, tr["window"]),
                    window_s=tr["window"][1] - tr["window"][0])
    driver.release()
    check = driver.check()
    record["readings"] = getattr(driver, "last_readings", None)
    n_off = sum(not c["ok"] for c in check)
    result = dict(correct=n_off == 0, attempted=len(times), failed=n_off, metrics=metrics,
                  device=info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in check}
    return result, record
