#!/usr/bin/env python
"""K7-loc `locator_bins` and K7-fm `build_finemap` at R2B9 on the card:
their times, their splits by part, their peak memory and the R2B9 build
they sit in, for one tree of the repository or two in turns.

    python scripts/time_locator.py                  # this tree
    python scripts/time_locator.py --turns A B      # trees A, B, B, A
    python scripts/time_locator.py --tiles 8x32,16x32   # K7-fm's tiles too

Each tree runs in a process of its own that imports that tree's
icon_rt_tpu_torch (its kernels build into the tree's own _build/):

  1. the R2B9 scene (synth_quantized_device(11, 16), K7-scene) for its
     corners' lat/lon;
  2. `bin_locator` on them: one warm call, then REPS calls timed with CUDA
     events (mean ms), and the peak device memory of one call above what
     the scene holds;
  3. one call under chip_smoke.py's `profile_window` (after a primer
     call in the same window): every device event in the order it ran
     (start and length in ms from the first), the device time by event
     name, and the call's wall time (the part no event covers is host
     work and the host reads' waits);
  4. `finemap_slots` (factor 2) on that locator and the scene's test
     rows, the corners freed and the allocator's cache emptied first: the
     first call's wall time (its allocations included) and its peak above
     what the scene and the locator hold, then REPS warm calls timed with
     CUDA events, then one call under `profile_window` as in 3; with
     --tiles, the warm time again at each of those tiles of the kernel
     (models/finemap.py TILE; a tree without it is timed at its own);
     then `finemap_slots` warm on the subdivision-8 device scene's
     locator (the smoke's main shape), REPS calls;
  5. the scene freed, build_q_scene(11, 16) timed by phase, with its peak
     device memory after each phase.

Each process prints `time_locator {json}` lines; --turns prints a summary
of each tree's runs after them.  Needs a CUDA card: without one it exits
non-zero.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPS = 5
#: a profiled window holds the whole call: its first device work (the
#: window's extremes: one kernel, or the parent design's torch reductions)
#: and its last (the rows, or the parent design's sort)
WHOLE_CALL = ("locator_window_kernel|reduce_kernel",
              "locator_rows_kernel|locator_sort_kernel")
#: ... and one of the fine map: the one launch, or the parent design's two
FM_CALL = ("finemap_kernel|centers_c0_kernel",
           "finemap_kernel|select_slots_kernel")
R2B9_SUB, R2B9_LAYERS = 11, 16
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    """This repository's chip_smoke.py as a module (its `profile_window`),
    loaded from its file so that the tree being measured keeps the first
    place on sys.path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    spec.loader.exec_module(mod)
    sys.path[:] = path
    return mod


def profiled(call, require, tag):
    """{"profiled_wall_ms", "device_ms", "by_name", "timeline"} of one
    `call` under chip_smoke.py's `profile_window`."""
    wall, timeline = chip_smoke().profile_window(call, require, tag)
    by_name = {}
    for name, _, ms in timeline:
        by_name[name] = by_name.get(name, 0.0) + ms
    return dict(profiled_wall_ms=wall,
                device_ms=sum(ms for _, _, ms in timeline),
                by_name={k: round(v, 4) for k, v in by_name.items()},
                timeline=[(n[:60], round(s, 4), round(ms, 4))
                          for n, s, ms in timeline])


def events_ms(call):
    """Mean ms of REPS calls, CUDA events around them."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS


def measure(root, tiles=()):
    """Steps 1-5 on the package under `root`; prints the JSON lines."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_locator: no CUDA card")
    from icon_rt_tpu_torch.data import bigscene
    from icon_rt_tpu_torch.data.device_scene import synth_quantized_device
    from icon_rt_tpu_torch.models import finemap, locator
    if not locator.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"time_locator: imported {locator.__file__}, not "
                         f"the package under {root}")

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    out = {"root": os.path.abspath(root), "card": card}
    dsc = synth_quantized_device(R2B9_SUB, R2B9_LAYERS, device=dev,
                                 latlon=True)
    lat, lon = dsc.lat, dsc.lon
    loc, k_cap = locator.bin_locator(lat, lon)[:2]
    out.update(cells=lat.shape[0], dims=loc.dims.tolist(), k_cap=k_cap)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = locator.bin_locator(lat, lon)
    torch.cuda.synchronize()
    out["peak_gib_above_scene"] = (torch.cuda.max_memory_allocated()
                                   - held) / 2 ** 30
    del res
    out["ms"] = events_ms(lambda: locator.bin_locator(lat, lon))
    out.update(profiled(lambda: locator.bin_locator(lat, lon), WHOLE_CALL,
                        "time_locator"))

    test12 = dsc.cells.test12
    del dsc, lat, lon
    finemap.build_finemap_kernel()         # nvcc before the first call
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slots = finemap.finemap_slots(loc, test12)
    torch.cuda.synchronize()
    fm = {"first_ms": (time.perf_counter() - t0) * 1e3,
          "peak_gib_above_scene": (torch.cuda.max_memory_allocated()
                                   - held) / 2 ** 30,
          "fine_bins": slots.shape[0]}
    del slots
    fm["ms"] = events_ms(lambda: finemap.finemap_slots(loc, test12))
    fm.update(profiled(lambda: finemap.finemap_slots(loc, test12), FM_CALL,
                       "time_finemap"))
    if tiles and hasattr(finemap, "TILE"):
        default, fm["tiles"] = finemap.TILE, {}
        for t in tiles:
            finemap.TILE = t
            finemap.finemap_slots(loc, test12)
            fm["tiles"]["x".join(map(str, t))] = events_ms(
                lambda: finemap.finemap_slots(loc, test12))
        finemap.TILE = default
    del loc, test12
    dsc8 = synth_quantized_device(8, R2B9_LAYERS, device=dev, latlon=True)
    loc8 = locator.bin_locator(dsc8.lat, dsc8.lon)[0]
    t8 = dsc8.cells.test12
    finemap.finemap_slots(loc8, t8)
    fm["ms_subdiv8"] = events_ms(lambda: finemap.finemap_slots(loc8, t8))
    out["finemap"] = fm
    del dsc8, loc8, t8
    torch.cuda.empty_cache()
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bigscene.build_q_scene(R2B9_SUB, R2B9_LAYERS, device=dev,
                           timings=timings)
    out["build_s"] = time.perf_counter() - t0
    out["build_phases"] = {
        k: (round(v / 2 ** 30, 3) if k.endswith("bytes") else round(v, 4))
        for k, v in timings.items()}
    print("time_locator " + json.dumps(out), flush=True)


def turns(trees, tiles):
    """Each tree of `trees` (two) in turns a, b, b, a, each in a process of
    its own; prints each run's line and a summary."""
    order = [trees[0], trees[1], trees[1], trees[0]]
    runs = []
    for root in order:
        extra = ["--tiles", tiles] if tiles else []
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--root", root, *extra], capture_output=True,
                             text=True)
        sys.stdout.write(res.stdout)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            raise SystemExit(f"time_locator: {root} exited "
                             f"{res.returncode}")
        line = [x for x in res.stdout.splitlines()
                if x.startswith("time_locator ")][-1]
        runs.append(json.loads(line[len("time_locator "):]))
    for root in trees:
        mine = [r for r in runs if r["root"] == os.path.abspath(root)]
        fm = [r["finemap"] for r in mine]
        print(f"time_locator summary {root}: K7-fm ms "
              f"{[round(f['ms'], 3) for f in fm]}, at subdiv 8 "
              f"{[round(f['ms_subdiv8'], 4) for f in fm]}, device by name "
              f"{[f['by_name'] for f in fm]}, first call ms "
              f"{[round(f['first_ms'], 3) for f in fm]}, peak GiB above the "
              f"scene {[round(f['peak_gib_above_scene'], 3) for f in fm]}, "
              f"build finemap s "
              f"{[r['build_phases']['finemap'] for r in mine]}, ms by tile "
              f"{[f.get('tiles') for f in fm]}")
        print(f"time_locator summary {root}: K7-loc ms "
              f"{[round(r['ms'], 3) for r in mine]}, build locator s "
              f"{[r['build_phases']['locator'] for r in mine]}, build s "
              f"{[round(r['build_s'], 3) for r in mine]}, peak GiB above the "
              f"scene {[round(r['peak_gib_above_scene'], 3) for r in mine]}, "
              f"build peak GiB "
              f"{[max(v for k, v in r['build_phases'].items() if k.endswith('bytes')) for r in mine]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the tree whose package to time")
    ap.add_argument("--turns", nargs=2, metavar=("A", "B"),
                    help="time two trees in turns A, B, B, A")
    ap.add_argument("--tiles", default="",
                    help="K7-fm tiles to time besides the default, as "
                         "LATxLON fine bins, comma-separated")
    args = ap.parse_args()
    if args.turns:
        turns(args.turns, args.tiles)
    else:
        measure(args.root, [tuple(int(v) for v in t.split("x"))
                            for t in args.tiles.split(",") if t])


if __name__ == "__main__":
    main()
