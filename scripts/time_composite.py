#!/usr/bin/env python
"""K10 `composite_mask` and `composite_finalize` on the card: each mode's
time, its plain version's, its bound and its output hashes, for one tree
of the repository or two or more in turns.

    python scripts/time_composite.py                  # this tree
    python scripts/time_composite.py --turns A B      # trees A, B, B, A

Each tree runs in a process of its own that imports that tree's
icon_rt_tpu_torch (its kernels build into the tree's own _build/).  On
chip_smoke.py's crafted inputs (`k10_inputs`, seed 1) of LANES lanes, the
1080p slab frame of `time K10`: each mode's kernel timed with CUDA events
(REPS calls in place after a warm-up, as `time_composite`) and one call
under chip_smoke.py's `profile_window` (the kernel's device ms, None
where the profiler lost its events), its plain version's (20 calls), the
bound of its bytes at 3.35 TB/s (chip_smoke.py `K10_BYTES`) and the
share of it the events' time reaches, sha256 hashes of each mode's
outputs on
fresh copies (trees that compute the same bits print the same hashes)
and whether they equal the plain version's, and the kernels' registers
and blocks an SM where the tree has `composite_occupancy`.

Each process prints a `time_composite {json}` line; --turns prints a
summary of each tree's runs after them.  Needs a CUDA card: without one
it exits non-zero.
"""
import argparse
import os
import sys

import kernel_timing as kt
from kernel_timing import events_ms

LANES = 1920 * 1080
REPS = 200
FINALIZE = ("first_hit", "mean_fin")
WHO = "time_composite"


def measure(root):
    sys.path.insert(0, os.path.abspath(root))
    import json
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{WHO}: no CUDA card")
    from icon_rt_tpu_torch.ops import composite
    if not composite.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"{WHO}: imported {composite.__file__}, not the "
                         f"package under {root}")
    cs = kt.chip_smoke()
    dev = torch.device("cuda", 0)
    aid = torch.tensor(3, dtype=torch.int32, device=dev)
    out = {"root": os.path.abspath(root), "card": kt.card(), "lanes": LANES}
    x = cs.k10_inputs(dev, LANES, seed=1)
    for mode, (kern, plain) in cs.k10_calls(x, aid).items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        out[mode] = {
            "hash": kt.digest(*got),
            "equal_plain": all(torch.equal(a, b) for a, b in zip(got, want)),
            "bound_ms": cs.bound(cs.K10_BYTES[mode] * LANES, 0)[0]}
    for mode, (kern, plain) in cs.k10_calls(x, aid, copy=False).items():
        name = ("composite_finalize_kernel" if mode in FINALIZE
                else "composite_mask_kernel")
        out[mode].update(kt.kernel_times(cs, kern, name, f"K10 {mode}",
                                         reps=REPS))
        out[mode]["plain_ms"] = events_ms(plain, reps=20)
        out[mode]["bound_share"] = out[mode]["bound_ms"] / out[mode]["ms"]
    if hasattr(composite, "composite_occupancy"):
        out["occupancy"] = {k: composite.composite_occupancy(k)
                            for k in ("mask", "finalize")}
    print(f"{WHO} " + json.dumps(out), flush=True)


def turns(trees):
    runs = kt.turns(__file__, WHO, trees, [])
    for root in trees:
        mine = runs[root]
        for mode in ("first_hit", "mean_fin", "payload", "cand", "mean"):
            print(f"{WHO} summary {root}: {mode} ms "
                  f"{[round(r[mode]['ms'], 4) for r in mine]}, profiled "
                  f"{[r[mode]['kernel_ms'] for r in mine]}, bound share "
                  f"{[round(r[mode]['bound_share'], 3) for r in mine]}, "
                  f"hash {[r[mode]['hash'] for r in mine]}, equal to plain "
                  f"{[r[mode]['equal_plain'] for r in mine]}")
        print(f"{WHO} summary {root}: occupancy "
              f"{[r.get('occupancy') for r in mine]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=kt.HERE,
                    help="the tree whose package to time")
    ap.add_argument("--turns", nargs="+", metavar="TREE",
                    help="time two or more trees in turns, forth and back "
                         "(A, B, B, A)")
    args = ap.parse_args()
    if args.turns:
        if len(args.turns) < 2:
            ap.error("--turns takes two or more trees")
        turns(args.turns)
    else:
        measure(args.root)


if __name__ == "__main__":
    main()
