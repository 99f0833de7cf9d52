#!/usr/bin/env python
"""K1 `track_f32`, K2 `track_q` and K9-w `track_wedge` on the card: their
times, host reads, registers and occupancy, divergence, work a lane, split
by phase and output hashes, for one tree of the repository or two or more
in turns.

    python scripts/time_track.py                      # this tree
    python scripts/time_track.py --phases             # and by phase
    python scripts/time_track.py --turns A B          # trees A, B, B, A
    python scripts/time_track.py --turns A B --others # with K3
    python scripts/time_track.py --cells k9w --phases # K9-w

Each tree runs in a process of its own that imports that tree's
icon_rt_tpu_torch (its kernels build into the tree's own _build/):

  1. r2b8_closeup: the app's main path (chip_smoke.py `main_path`: subdiv
     8 x 16, 1920x1080, closeup, 8 samples a launch, column cache kept) and
     its steady launch median (fb on the host); then K1 on the covered
     lanes as the app launches it;
  2. r2b8q_closeup: the same on the --quantized path (fine map on), K2;
  3. r2b9q_closeup: build_q_scene(11, 16) and main r2b9q's 1080p closeup
     (fine map on, 8 samples a launch): the steady launch median of 7
     (launch and fb to the host), then K2 on the covered lanes;
  4. k9w_r2b8: K9-w `track_wedge` (-mode 2 on the fast raygen) on the
     r2b8 scene's wedge tables (ops/fast.py `pack_cells_wedge`, the wedge
     bands), the lanes and camera of 1 (8 samples a launch, column cache
     kept), as the numbers of 1 without the raw mode (K9-w has none).

--cells picks some of them (default k1,k2,k2r2b9; k9w adds 4).

For each kernel: 20 launches timed with CUDA events (mean ms); one launch
and the fb's copy to the host under chip_smoke.py's `profile_window`
(wall, device busy, idle share, device ms by kernel; a process whose
profiler loses the kernel's events in every window records None); the
host reads of
one steady call (torch.cuda.set_sync_debug_mode("warn"), one warning a
read); the warp divergence factor of the per-lane cost output in pixel
order (the sum over warps of 32 x their largest cost over the sum of the
costs); sha256 hashes of accum, fb and cost after a launch of accum_id 0
with the cost output, and of raw mode's wrote, colour and t (one sample,
rng_salt 3): trees that compute the same bits print the same hashes; the
ptxas lines, and from a copy of the kernel's source with a query appended
(written at run time into the tree's _build/, not kept) its registers,
local bytes and resident blocks an SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor at 128 threads).

With --phases an instrumented copy of the tree's csrc/track_common.cuh
(built the same way, not kept; run after every other measurement of the
process, whose profiled windows it could spoil) adds clock64() counters
around the lane
setup, the cached containment tests, the locate, the layer lookup and
alpha, the band advance and the shade, summed over the lanes beside each
lane's whole run ("other": the draws, the loop and waiting in the warp),
and counts Woodcock evaluations, locates and, per cache slot, evaluations
whose layer (the full count over the column's ceilings) differs from the
slot's previous evaluation's ("changed") or that are the slot's first
since its fill ("first").

With --others also K3-f32 and K3-q on the r2b8 tables (one pass; K3-q
without the fine map, as the app) and K3-q on the R2B9 scene (fine map
on): events and profiled kernel ms.

Each process prints `time_track {json}` lines; --turns prints a summary of
each tree's runs after them.  Needs a CUDA card: without one it exits
non-zero.
"""
import argparse
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import kernel_timing as kt

W, H, SPL = 1920, 1080, 8
R2B9_SUB, R2B9_LAYERS = 11, 16
KERNELS = {"track_f32": "track_f32_kernel", "track_q": "track_q_kernel",
           "track_wedge": "track_wedge_kernel"}
#: the cells that run each kernel
CELL_KERNEL = {"k1": "track_f32", "k2": "track_q", "k2r2b9": "track_q",
               "k9w": "track_wedge"}
WHO = "time_track"
SLOTS = 16                        # the phase probe's counters a block slot


# ---------------------------------------------------------------------------
# Probe builds: a copy of the tree's csrc with a query appended, and with
# --phases an instrumented track_common.cuh; written into _build/, not kept
# ---------------------------------------------------------------------------

_QUERY = r"""
extern "C" int probe_occupancy(int* out) {
  cudaFuncAttributes a;
  int err = static_cast<int>(cudaFuncGetAttributes(&a, %(kernel)s));
  if (err) return err;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, %(kernel)s, 128, 0));
}
"""

_PROBE_HOST = r"""
extern "C" int probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe,
                                               sizeof(g_probe)));
}
extern "C" int probe_zero() {
  static unsigned long long z[64 * 16];
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, z, sizeof(z)));
}
"""

#: the full layer count of a column, per tier: the probe's reference for
#: "changed", from the tables' fields that every tree has (the f32 and
#: wedge tiers' prof rows, in the coordinate c: r, or the wedge tier's s)
_LAYER_F32 = r"""
template <class Tier>
__device__ __forceinline__ int probe_layer(const Tier& T, int cid, float r) {
  const float* h = T.p.prof + static_cast<size_t>(cid) * 64;
  int l = 0;
  for (int k = 0; k < 32; ++k) l += (r > __ldg(h + k)) ? 1 : 0;
  return l;
}
"""
_LAYER_Q = r"""
__device__ __forceinline__ int probe_layer(const QTier& T, int cid,
                                           float r) {
  const float* row = T.p.test12 + static_cast<size_t>(cid) * 12;
  const float h_bot = __ldg(row + 9), h_top = __ldg(row + 10);
  const int nl = static_cast<int>(__ldg(row + 11));
  const float s = (h_top - h_bot) * static_cast<float>(1.0 / 65535.0);
  const float* hf = T.p.hfrac + static_cast<size_t>(cid) * T.p.hf_stride;
  int l = 0;
  for (int k = 0; k < T.p.lm; ++k)
    l += (r > ((k + 1 <= nl) ? h_bot + __ldg(hf + k) * s
                             : __int_as_float(0x7f800000))) ? 1 : 0;
  return l;
}
"""

#: (slot, regex of the statement) of each timed phase of track_lane
_PHASES = [
    (0, "init", r"const (?:track::)?Lane L = init_lane\([^;]*;"),
    (1, "contain", r"const bool in0 =.*?const bool in1 =[^;]*;"),
    (2, "locate", r"const int c = T\.locate\([^;]*;"),
    (3, "layer_alpha", r"const float a =[^;]*;"),
    (4, "advance", r"float t_adv = seg_end;.*?"
                   r"if \(at_seg_end && !to_seg1\) done = true;"),
    (5, "shade", r"T\.shade\([^;]*;"),
]
#: counters: 8 evaluations, 9 first of a slot, 10 changed, 11 locates,
#: 12 lanes, 13 steps


def instrument(common):
    """track_common.cuh with the probe's counters in track_lane; raises
    if a phase's statement is not found exactly once."""
    a, b = kt.function_body(
        common, "__device__ __forceinline__ void track_lane(", WHO)
    lane = common[a + 1:b]
    for k, name, pat in _PHASES:
        ms = list(re.finditer(pat, lane, flags=re.S))
        if len(ms) != 1:
            raise SystemExit(f"time_track --phases: {len(ms)} {name} "
                             f"statements in track_lane")
        m = ms[0]
        extra = ""
        if name == "layer_alpha":
            extra = ("{ const int _c = mru ? cid1 : cid0;"
                     " const int _l = probe_layer(T, _c, T.coord(mru ?"
                     " col1 : col0, px, py, pz, r));"
                     " const int _q = mru ? _pl1 : _pl0; ++_pr[8];"
                     " if (_q < 0) ++_pr[9]; else if (_q != _l) ++_pr[10];"
                     " if (mru) _pl1 = _l; else _pl0 = _l; }")
        if name == "locate":
            extra = "++_pr[11];"
        lane = (lane[:m.start()] + f"long long _t{k} = clock64(); "
                + m.group(0) + f" _pr[{k}] += clock64() - _t{k}; " + extra
                + lane[m.end():])
    for pat, rep in (("cid0 = c;", "cid0 = c; _pl0 = -1;"),
                     ("cid1 = c;", "cid1 = c; _pl1 = -1;"),
                     ("valid0 = valid1 = false;",
                      "valid0 = valid1 = false; _pl0 = _pl1 = -1;")):
        if lane.count(pat) != 1:
            raise SystemExit(f"time_track --phases: {pat!r} not found once")
        lane = lane.replace(pat, rep)
    lane = ("\n  unsigned long long _pr[16] = {};"
            "\n  int _pl0 = -1, _pl1 = -1;"
            "\n  const long long _t_lane = clock64();" + lane
            + "\n  _pr[6] = clock64() - _t_lane; _pr[12] = 1;"
              " _pr[13] = steps;"
              "\n  unsigned long long* _g = g_probe + (blockIdx.x % 64) * 16;"
              "\n  for (int k = 0; k < 16; ++k) atomicAdd(_g + k, _pr[k]);\n")
    decl = "__device__ unsigned long long g_probe[64 * 16];\n"
    head = common[:a + 1].replace("namespace track {",
                                  decl + "namespace track {", 1)
    if decl not in head:
        raise SystemExit("time_track --phases: no namespace track")
    return head + lane + common[b:]


def probe_build(name, phases):
    """Build a copy of csrc/<name>.cu with the occupancy query appended
    (and with `phases` the instrumented track_common.cuh); returns (the
    ctypes library, its ptxas log)."""
    def edit(f, src):
        if phases and f == "track_common.cuh":
            src = instrument(src)
        if phases and f == "tier_f32.cuh":
            src += _LAYER_F32
        if phases and f == "tier_q.cuh":
            src += _LAYER_Q
        if f == f"{name}.cu":
            src += _QUERY % {"kernel": KERNELS[name]}
            if phases:
                src += _PROBE_HOST
        return src
    return kt.probe_build(name, edit, WHO)


def occupancy(lib):
    import ctypes
    out = (ctypes.c_int * 3)()
    err = lib.probe_occupancy(out)
    if err:
        raise SystemExit(f"time_track: occupancy query failed ({err})")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}


def run_probe(name, lib, call):
    """One `call` of the kernel through the instrumented library: the
    phases' shares of the lanes' cycles and the counts a lane."""
    s = kt.probe_sums(name, lib, call, SLOTS)
    lane = max(s[6], 1)
    out = {nm: round(s[k] / lane, 4) for k, nm, _ in _PHASES}
    out["other"] = round(1.0 - sum(s[k] for k in range(6)) / lane, 4)
    n = max(s[12], 1)
    out.update(lanes=s[12], evals_per_lane=s[8] / n,
               locates_per_lane=s[11] / n, steps_per_lane=s[13] / n,
               first_share=s[9] / max(s[8], 1),
               changed_share=s[10] / max(s[8], 1),
               changed_of_repeat=s[10] / max(s[8] - s[9], 1),
               lane_cycles=s[6])
    return out


# ---------------------------------------------------------------------------
# One tree
# ---------------------------------------------------------------------------

def tracker_numbers(cs, name, render, track, perm, n, tag, probes):
    """The numbers of one tracker on one frame: render(k, acc, fb, cost)
    launches lanes perm[:n] with accum_id k (cost None or a (W*H,) int32
    tensor), track(pix, out) runs one raw sample (None: no raw mode)."""
    import torch
    from icon_rt_tpu_torch.ops.fast import alloc_raw
    from icon_rt_tpu_torch.ops.render import alloc_frame
    dev = perm.device
    acc, fb = alloc_frame(W, H, device=dev)
    out = {"ms": kt.events_ms(lambda: render(1, acc, fb, None), reps=20)}
    try:
        out.update(kt.profiled(cs, lambda: (render(4, acc, fb, None),
                                            fb.cpu()),
                               (KERNELS[name],), tag))
        out["kernel_ms"] = out["by_name"].get(KERNELS[name])
    except AssertionError as e:   # the profiler lost the kernel's events
        print(f"time_track {tag}: {e}", flush=True)
        out.update(kernel_ms=None, idle_share=None)
    out["host_reads"], out["wrapper_wall_ms"] = kt.host_reads(
        lambda: render(5, acc, fb, None))
    acc, fb = alloc_frame(W, H, device=dev)
    cost = torch.zeros(W * H, dtype=torch.int32, device=dev)
    render(0, acc, fb, cost)
    out["hash"] = {"accum": kt.digest(acc), "fb": kt.digest(fb),
                   "cost": kt.digest(cost)}
    out["divergence"] = cs.divergence(cost, perm, n)
    out["cost_mean"] = float(cost[perm[:n].long()].double().mean())
    out["cost_max"] = int(cost.max())
    if track is not None:
        raw = alloc_raw(n, dev)
        track(perm[:n].contiguous(), raw)
        out["hash"]["raw"] = kt.digest(raw.wrote, raw.ca, raw.t)
    q_lib, q_log = probes[name]["query"]
    out["occupancy"] = occupancy(q_lib)
    out["ptxas"] = cs.ptxas_lines(q_log)
    if "phases" in probes[name]:      # run last (`measure`)
        probes.setdefault("later", []).append(
            (out, name, lambda: render(1, acc, fb, None)))
    return out


def measure(root, phases, others, cells):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_track: no CUDA card")
    from icon_rt_tpu_torch.data import bigscene
    from icon_rt_tpu_torch.ops import fast, fastq, march
    if not fast.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"time_track: imported {fast.__file__}, not the "
                         f"package under {root}")
    cs = kt.chip_smoke()
    dev = torch.device("cuda", 0)
    res = {"root": os.path.abspath(root), "card": kt.card()}
    bigscene.CACHE_DIR = tempfile.mkdtemp(prefix="time_track_")

    # the probe builds, started together
    names = sorted({CELL_KERNEL[c] for c in cells})
    jobs = [(k, kind) for k in names
            for kind in (("query", "phases") if phases else ("query",))]
    builds = {"track_f32": fast.build_track_f32,
              "track_q": fastq.build_track_q,
              "track_wedge": lambda: fast.build_track_f32("track_wedge")}
    with ThreadPoolExecutor(len(jobs) + 3) as ex:
        futs = {job: ex.submit(probe_build, job[0], job[1] == "phases")
                for job in jobs}
        for f in [ex.submit(builds[k]) for k in names]:
            f.result()
        probes = {}
        for (k, kind), f in futs.items():
            probes.setdefault(k, {})[kind] = f.result()

    from icon_rt_tpu_torch.ops.render import alloc_frame
    # 1. r2b8_closeup, K1; 4. K9-w on its wedge tables
    if "k1" in cells or "k9w" in cells:
        pl, _, met = cs.main_path(dev)
        s, frame = pl.scene, pl.frame
        lps = [cs.with_id(cs.launch_params(pl), k) for k in range(8)]
        n, perm = frame["n_active"], frame["perm"]
        pix = perm[:n].contiguous()
        tabs = (s["get_packed"](), s["locator"], s["get_bands"]())

        # each cell's calls bind their tables now: the phase probes call
        # them after the later cells have rebound these names
        def render(k, acc, fb, cost, tabs=tabs, lps=lps, pix=pix, n=n):
            fast.track_f32(*tabs, lps[k], pix, acc[:n], fb[:n], width=W,
                           height=H, samples=SPL, preserve_cache=True,
                           cost=cost)

        def raw(p, out, tabs=tabs, lps=lps):
            fast.track_f32(*tabs, lps[0], p, None, None, width=W, height=H,
                           rng_salt=3, out=out)
        if "k1" in cells:
            r = tracker_numbers(cs, "track_f32", render, raw, perm, n,
                                "K1 r2b8", probes)
            r["steady_launch_ms"] = float(np.median(met["launch_ms"][1:]))
            res["k1_r2b8"] = r
            print("time_track k1_r2b8 " + json.dumps(r), flush=True)
        if others:
            acc, fb = (x[:n] for x in alloc_frame(W, H, device=dev))
            res["k3f_r2b8"] = kt.kernel_times(cs, lambda: march.march_f32(
                *tabs, lps[1], pix, acc, fb, width=W, height=H),
                "march_f32_kernel", "K3-f32 r2b8")
            print("time_track others k3f_r2b8 "
                  + json.dumps(res["k3f_r2b8"]), flush=True)
            del acc, fb
        if "k9w" in cells:
            tabs_w = (s["get_packed_wedge"](), s["locator"],
                      s["get_bands_wedge"]())

            def render_w(k, acc, fb, cost, tabs_w=tabs_w, lps=lps, pix=pix,
                         n=n):
                fast.track_wedge(*tabs_w, lps[k], pix, acc[:n], fb[:n],
                                 width=W, height=H, samples=SPL,
                                 preserve_cache=True, cost=cost)
            r = tracker_numbers(cs, "track_wedge", render_w, None, perm, n,
                                "K9-w r2b8", probes)
            res["k9w_r2b8"] = r
            print("time_track k9w_r2b8 " + json.dumps(r), flush=True)

    # 2. r2b8q_closeup, K2 with the fine map
    if "k2" in cells:
        pl, _, met = cs.main_path(dev, quantized=True)
        s, frame = pl.scene, pl.frame
        lps = [cs.with_id(cs.launch_params(pl), k) for k in range(8)]
        q, loc_q, _ = s["get_q"]()
        fm, tf = s["fm"](), s["tf"]()
        n, perm = frame["n_active"], frame["perm"]
        pix = perm[:n].contiguous()
        qtabs = (q, loc_q, s["get_bands"](), tf)

        def render_q(k, acc, fb, cost, qtabs=qtabs, lps=lps, pix=pix, n=n,
                     fm=fm):
            fastq.track_q(*qtabs, lps[k], pix, acc[:n], fb[:n], width=W,
                          height=H, samples=SPL, preserve_cache=True,
                          finemap=fm, cost=cost)

        def raw_q(p, out, qtabs=qtabs, lps=lps, fm=fm):
            fastq.track_q(*qtabs, lps[0], p, None, None, width=W, height=H,
                          finemap=fm, rng_salt=3, out=out)
        r = tracker_numbers(cs, "track_q", render_q, raw_q, perm, n,
                            "K2 r2b8", probes)
        r["steady_launch_ms"] = float(np.median(met["launch_ms"][1:]))
        res["k2_r2b8"] = r
        print("time_track k2_r2b8 " + json.dumps(r), flush=True)
        if others:
            acc, fb = (x[:n] for x in alloc_frame(W, H, device=dev))
            res["k3q_r2b8"] = kt.kernel_times(cs, lambda: march.march_q(
                *qtabs, lps[1], pix, acc, fb, width=W, height=H),
                "march_q_kernel", "K3-q r2b8")
            del acc, fb

    # 3. r2b9q_closeup, K2 with the fine map
    if "k2r2b9" in cells:
        q, loc, _, bands, tf, stats, fm, _, _ = cs.r2b9_scene(dev,
                                                               "time_track")
        lp9, perm, n = cs.r2b9_frame(stats, W, H, dev)
        lps9 = [cs.with_id(lp9, k) for k in range(8)]
        pix = perm[:n].contiguous()
        qtabs = (q, loc, bands, tf)

        def render_9(k, acc, fb, cost):
            fastq.track_q(*qtabs, lps9[k], pix, acc[:n], fb[:n], width=W,
                          height=H, samples=SPL, preserve_cache=True,
                          finemap=fm, cost=cost)

        def raw_9(p, out):
            fastq.track_q(*qtabs, lps9[0], p, None, None, width=W, height=H,
                          finemap=fm, rng_salt=3, out=out)
        acc, fb = alloc_frame(W, H, device=dev)
        walls = []
        for k in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_9(k, acc, fb, None)
            fb.cpu()
            walls.append((time.perf_counter() - t0) * 1e3)
        r = tracker_numbers(cs, "track_q", render_9, raw_9, perm, n,
                            "K2 r2b9", probes)
        r["steady_launch_ms"] = float(np.median(walls[1:]))
        r["n_active"] = n
        res["k2_r2b9"] = r
        print("time_track k2_r2b9 " + json.dumps(r), flush=True)
        if others:
            res["k3q_r2b9"] = kt.kernel_times(cs, lambda: march.march_q(
                *qtabs, lps9[1], pix, acc[:n], fb[:n], width=W, height=H,
                finemap=fm), "march_q_kernel", "K3-q r2b9")
            print("time_track others k3q_r2b9 "
                  + json.dumps(res["k3q_r2b9"]), flush=True)
    # the phase probes last: a profiled window after one may lose the
    # tracker's device events
    for out, name, call in probes.get("later", []):
        out["phases"] = run_probe(name, probes[name]["phases"][0], call)
        print(f"time_track phases {name} " + json.dumps(out["phases"]),
              flush=True)
    print("time_track " + json.dumps(res), flush=True)


def turns(trees, phases, others, cells):
    """Each tree of `trees` in turns, forth and back, each run in a
    process of its own; prints each run's line and a summary."""
    runs = kt.turns(__file__, "time_track", trees,
                    (["--phases"] if phases else [])
                    + (["--others"] if others else []) + ["--cells", cells])
    for root in trees:
        mine = runs[root]
        pick = lambda f: [f(r) for r in mine]
        rnd = lambda f: pick(lambda r: None if f(r) is None
                             else round(f(r), 4))
        for k in [k for k in ("k1_r2b8", "k2_r2b8", "k2_r2b9", "k9w_r2b8")
                  if k in mine[0]]:
            print(f"time_track summary {root}: {k} kernel "
                  f"{rnd(lambda r: r[k]['kernel_ms'])}, events "
                  f"{rnd(lambda r: r[k]['ms'])}, steady launch "
                  f"{rnd(lambda r: r[k].get('steady_launch_ms'))}, idle "
                  f"{rnd(lambda r: r[k]['idle_share'])}, host reads "
                  f"{pick(lambda r: r[k]['host_reads'])}, occupancy "
                  f"{pick(lambda r: r[k]['occupancy'])}, hashes "
                  f"{pick(lambda r: r[k]['hash'])}")
        if others:
            for k in [k for k in ("k3f_r2b8", "k3q_r2b8", "k3q_r2b9")
                      if k in mine[0]]:
                print(f"time_track summary {root}: {k} kernel "
                      f"{rnd(lambda r: r[k]['kernel_ms'])}, events "
                      f"{rnd(lambda r: r[k]['ms'])}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=kt.HERE,
                    help="the tree whose package to time")
    ap.add_argument("--turns", nargs="+", metavar="TREE",
                    help="time two or more trees in turns, forth and back "
                         "(A, B, B, A)")
    ap.add_argument("--phases", action="store_true",
                    help="K1's and K2's split by phase and work counts "
                         "through an instrumented copy of "
                         "csrc/track_common.cuh")
    ap.add_argument("--others", action="store_true",
                    help="also K3-f32 and K3-q")
    ap.add_argument("--cells", default="k1,k2,k2r2b9",
                    help="comma-separated cells to run: k1 (r2b8_closeup), "
                         "k2 (r2b8q_closeup), k2r2b9 (r2b9q_closeup), k9w "
                         "(K9-w on the r2b8 wedge tables)")
    args = ap.parse_args()
    if args.turns:
        if len(args.turns) < 2:
            ap.error("--turns takes two or more trees")
        turns(args.turns, args.phases, args.others, args.cells)
    else:
        measure(args.root, args.phases, args.others, args.cells.split(","))


if __name__ == "__main__":
    main()
