"""Run one cell of the port's benchmark once and print its result.

    python3 furbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository on a machine with an
NVIDIA GPU. The last line of standard output is the result (JSON: correct,
attempted, failed, metrics, device, with --trace 1 a breakdown, and last
the numbers compared with their limits); the last lines of standard error
repeat those numbers. Exits 1 without a result where CUDA has fewer devices
than the cell asks for, where the check fails to run, or where JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from furbench import harness

    bench = harness.load_json(CHECKOUT / "BENCHMARK.json")
    spec = harness.cell_spec(args.workload, bench)
    harness.cache_env()
    import torch

    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"furbench: the cell needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result, record = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                 T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"furbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 1
    print(json.dumps({k: record[k] for k in ("setup_s", "window_s", "units", "readings")
                      if k in record}), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
