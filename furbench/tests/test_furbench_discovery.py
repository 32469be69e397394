"""Cells, configurations, drivers and per-layer metrics are files found by
name: a new one is added by adding files and entries, editing none."""

import json
import shutil

from furbench import harness

BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")


def test_every_cell_config_driver_and_metric_has_its_file():
    for c in BENCH["configs"]:
        assert (harness.CHECKOUT / c["file"]).is_file()
        assert c["file"] == f"furbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        spec = harness.cell_spec(w["name"], BENCH)
        assert spec["workload"]["config"] == w["config"]
        assert spec["workload"]["chips"] == w["chips"]
        assert spec["workload"]["why"] == w["why"]
        assert hasattr(harness.driver_of(spec), "Driver")
        assert (harness.ROOT / "scenes" / f"{spec['config']['scene']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert callable(harness.reader_of(m["name"]).read)


def test_a_new_cell_and_metric_are_picked_up_without_editing(tmp_path):
    root = tmp_path / "furbench"
    for d in ("configs", "drivers", "metrics", "workloads", "scenes"):
        shutil.copytree(harness.ROOT / d, root / d)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    # the new files: a configuration, a cell and a per-layer metric
    conf = harness.load_json(root / "configs" / "hair_ball_1m.json")
    conf["params"]["n_fibers"] = 2000
    (root / "configs" / "hair_ball_small.json").write_text(json.dumps(conf))
    cell = harness.load_json(root / "workloads" / "hairball.progressive.json")
    cell["config"] = "hair_ball_small"
    (root / "workloads" / "hairball.small.json").write_text(json.dumps(cell))
    (root / "metrics" / "passes_traced.py").write_text(
        "def read(rec):\n    return rec['trace']['units'] if 'trace' in rec else None\n")

    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="hair_ball_small", source="x", why="x", reduced=[],
                                 file="furbench/configs/hair_ball_small.json"))
    bench["workloads"].append(dict(name="hairball.small", config="hair_ball_small",
                                   traffic="progressive", chips=1, why="x"))
    bench["per_layer"].append(dict(name="passes_traced", unit="passes", better="higher",
                                   source="device_trace", layer="device",
                                   moves="rays_per_s", workloads=["hairball.small"]))

    spec = harness.cell_spec("hairball.small", bench, root)
    assert spec["config"]["params"]["n_fibers"] == 2000
    assert [m["name"] for m in spec["per_layer"]][-1] == "passes_traced"
    assert "k3_roofline" not in [m["name"] for m in spec["per_layer"]]
    assert harness.reader_of("passes_traced", root).read({"trace": {"units": 3}}) == 3
    assert harness.driver_of(spec, root).Driver is not None
    # the old cell still reads what it read, and no file that was there changed
    old = harness.cell_spec("hairball.progressive", bench, root)
    assert "passes_traced" not in [m["name"] for m in old["per_layer"]]
    assert all(p.read_bytes() == b for p, b in before.items())
