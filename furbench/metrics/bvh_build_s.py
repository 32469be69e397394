"""bvh_build_s: the seconds of the set-up's BVH builds, the sum of every
stage that `ops/traverse.attach_bvh` records in its counter
`LAST_BUILD_STATS` (the AABBs, the split, the reorder and pack, the kernel
layouts) over every pack it built a BVH for."""


def read(rec: dict):
    stages = [v for kind in rec.get("build", {}).values() for k, v in kind.items()
              if k != "perm_cached"]
    return sum(stages) if stages else None
