"""k3_roofline: the streaming traversal kernel K3 (`csrc/traverse_stream.cu`,
the trace's kernels named `stream_kernel`) against its roofline in the
first traced pass.

The bound is of the work the pass's wavefronts need, whatever walks them:
for each K3 call of the pass (its rays and answers, kept by the driver),
the frozen `work_ref` (`furbench/k3_work.py`) counts on SAMPLE live rays,
drawn from the seed, the box and row tests any near-to-far walk of the
scene's BVH must make, scaled to the call's live rays; the bytes are each
ray's inputs read once and its answer written once, and the rows and unit
boxes of the leaves the sample enters (not scaled: a lower bound). Each
call's bound is the larger of its flops at the FP32 peak and its bytes at
the memory rate (`furbench/peaks.py`); the share is the calls' bounds over
K3's device time in that pass.
"""

import torch

from furbench import k3_work, peaks

SAMPLE = 4096
#: bytes a ray: o, d, t_max in; t, row and found out
RAY_BYTES = 7 * 4 + 4 + 4 + 1


def call_bound_s(c: dict, gen: torch.Generator) -> float:
    live = (c["t_max"] > 0.0).nonzero()[:, 0]
    if live.numel() == 0:
        return 0.0
    pick = live[torch.randperm(live.numel(), generator=gen)[:SAMPLE].to(live.device)]
    t, row, found = c["out"]
    w = k3_work.work_ref(c["o"][pick], c["d"][pick], c["t_max"][pick], c["bvh"], c["kind"],
                         any_hit=c["any_hit"], hit=(t[pick], row[pick], found[pick]))
    flops = w["flops"] * live.numel() / pick.numel()
    n_bytes = c["o"].shape[0] * RAY_BYTES + w["leaf_bytes"]
    return peaks.bound_s(flops, n_bytes)


def read(rec: dict):
    tr, calls = rec.get("trace"), rec.get("k3_calls")
    if not tr or not calls:
        return None
    s0, e0 = min((s, e) for name, s, e in tr["spans"] if name == rec["unit"])
    k3_s = sum(e - s for name, s, e in tr["ops"] if "stream_kernel" in name and s0 <= s < e0)
    if k3_s <= 0.0:
        return None
    gen = torch.Generator().manual_seed(rec["seed"])
    with torch.no_grad():
        bound = sum(call_bound_s(c, gen) for c in calls)
    return 100.0 * bound / k3_s
