"""The readings that a cell's limits are set from, on the chip.

    python3 furbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--control-seeds 1,2,3]

For each seed, in one process: the cell's set-up, a window of `seconds`
at the cell's own load, the program's state freed, and `Driver.readings`
of what the window produced against the plain reference; on the
seeds of `--control-seeds` also the control's readings (the reference at
bfloat16 put in the program's place). One JSON line a seed. The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


def readings(cell: str, seed: int, seconds: float, control: bool, device: str = "cuda",
             overrides: dict | None = None):
    """One seed's readings: `Driver.readings`, after a window of `seconds`."""
    from furbench import harness

    _, driver = harness.prepare(cell, seed, device, overrides)
    try:
        driver.setup()
        t0 = time.perf_counter()
        units = 0
        while time.perf_counter() - t0 < seconds or not units:
            driver.step()
            units += 1
        driver.release()
        out = driver.readings(control=control)
    finally:
        driver.close()
    out["units"] = units
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    from furbench import harness

    harness.cache_env()
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, seed in control)
        print(json.dumps(dict(cell=args.workload, seed=seed, s=time.perf_counter() - t, **r)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
