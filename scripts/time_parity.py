#!/usr/bin/env python
"""K8 `parity_track` on the card: its times, host reads, registers and
occupancy, divergence, split by phase and output hashes, for one tree of
the repository or two or more in turns.

    python scripts/time_parity.py                     # this tree
    python scripts/time_parity.py --phases            # and by phase
    python scripts/time_parity.py --turns A B         # trees A, B, B, A
    python scripts/time_parity.py --cells ae_loc,ae_brute --turns A B C

Each tree runs in a process of its own that imports that tree's
icon_rt_tpu_torch (its kernels build into the tree's own _build/).  The
cells are chip_smoke.py's:

  ae_loc      `main ae`: the app with --raygen ae and the locator sampler
              at subdiv 8 x 16, 1920x1080, the closeup camera, the app's
              unit distance, one sample a launch;
  ae_brute    `check parity`'s AE x brute: subdiv 3 x 8 (1280 cells),
              128x128, the same camera and unit distance, every pixel;
  sphere_loc  `main accel sphere`: as ae_loc on the spherical-shell accel
              (its host build takes ~30 s);
  check       every other K8 combination at check parity's scene and
              camera: sphere and grid x locator and brute and AE x
              locator at 128x128, raw mode of sphere x locator, and the
              wedge sampler (K9-p) x ae, sphere, grid at 64x64: events and
              profiled kernel ms and output hashes only;
  ae_w        `main ae w` (BASELINE configs[2]): the app with --raygen ae
              and -mode 2 (the wedge sampler, K9-p) at subdiv 7 x 16,
              1024x1024, the closeup camera, one sample a launch;
  grid_w      `main grid w`: the same on the grid accel;
  sphere_w    `main accel w`: the same on the spherical-shell accel.

For each: the wrapper's launch timed with CUDA events (mean ms of REPS
launches of accum_id 1); one launch and the fb's copy to the host under
chip_smoke.py's `profile_window` (wall, device busy, idle share, device ms
by kernel); the app's steady launch (ae_loc, sphere_loc: `pl.launch` and
the fb on the host, median of launches 2..8) or, for ae_brute, the wrapper
and the fb; the host reads of one steady wrapper call
(torch.cuda.set_sync_debug_mode("warn"), one warning a read); the warp
divergence factor of the debug output's iterations (the sum over warps of
32 consecutive lanes of 32 x their largest count, over the sum of the
counts) and the iterations' mean and max; sha256 hashes of accum, fb and
the debug output after a launch of accum_id 0, and of raw mode's wrote and
colour (accum_id 1): trees that compute the same bits print the same
hashes; the ptxas lines, and from a copy of the kernel's source with a
query appended (written at run time into the tree's _build/, not kept)
the kernel's registers, local bytes and resident blocks an SM (the
tree's `parity_occupancy`, where it has one).  The wedge cells' hashes
also cover raw mode (accum_id 1), and their lines give the wedge shell
(`Wedges.shell`, where the tree has one).

With --phases an instrumented copy of the tree's csrc/parity.cu (built
the same way, not kept, run after every other measurement of the
process) adds clock64() counters around AE's free-path draw, the sample's
radius, its locate (asin, atan2, the locator row), its candidate scan,
the classification with the acceptance draw, and the finalize, summed
over the lanes beside each lane's whole run ("other": the loop, the
traversal and waiting in the warp), and counts samples and the samples
whose radius lies outside the cells' shell [min h_bot, max h_top]; with
the wedge sampler also the time of each candidate column's find_layer
and of its Newton inversions (inside the scan), and the samples outside
the wedge shell (a tree with `Wedges.shell`).

Each process prints `time_parity {json}` lines; --turns prints a summary
of each tree's runs after them.  Needs a CUDA card: without one it exits
non-zero.
"""
import argparse
import json
import os
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import kernel_timing as kt

MAIN_SUB, MAIN_LAYERS, W, H = 8, 16, 1920, 1080
BRUTE_SUB, BRUTE_LAYERS, BRUTE_W = 3, 8, 128
W7_SUB, W7_LAYERS, W7 = 7, 16, 1024      # chip_smoke.py's main ... w scene
STEADY = 8                        # the app's launches; the first is cold
REPS = {"ae_loc": 5, "ae_brute": 2, "sphere_loc": 20, "ae_w": 2,
        "grid_w": 5, "sphere_w": 20}
CELLS = ("ae_loc", "ae_brute", "sphere_loc", "check", "ae_w", "grid_w",
         "sphere_w")
#: (raygen, sampler) of each cell
MODES = {"ae_loc": ("ae", "locator"), "ae_brute": ("ae", "brute"),
         "sphere_loc": ("sphere", "locator"), "ae_w": ("ae", "wedge"),
         "grid_w": ("grid", "wedge"), "sphere_w": ("sphere", "wedge")}
KERNEL = "parity_kernel"
WHO = "time_parity"
SLOTS = 16                        # the phase probe's counters a block slot


# ---------------------------------------------------------------------------
# Probe builds: a copy of the tree's csrc with a query appended, and with
# --phases an instrumented parity.cu; written into _build/, not kept
# ---------------------------------------------------------------------------

_QUERY = r"""
extern "C" int probe_occupancy(int raygen, int sampler, int block,
                               int* out) {
  if (raygen == 0 && sampler == 0)
    return track::occupancy(parity_kernel<kAE, kLocator, false>, block, out);
  if (raygen == 0 && sampler == 1)
    return track::occupancy(parity_kernel<kAE, kBrute, false>, block, out);
  return track::occupancy(parity_kernel<kSphere, kLocator, false>, block,
                          out);
}
"""

#: per-thread counters in shared memory (blocks of at most 128 threads):
#: 0 draw, 1 radius, 2 locate, 3 scan, 4 classify and accept, 5 finalize,
#: 6 lane, 7 samples outside the wedge shell, 8 samples, 9 samples outside
#: the cells' shell, 10 iterations, 11 lanes, 12 the wedge sampler's
#: find_layer, 13 its Newton inversions
_PRELUDE = r"""
__device__ unsigned long long g_probe[64 * 16];
__device__ float g_probe_shell[4];
__shared__ unsigned long long s_pr[128 * 16];
#define PROBE(k) s_pr[threadIdx.x * 16 + (k)]
struct ProbeTimer {
  int k;
  long long t0;
  __device__ explicit ProbeTimer(int k_) {
    k = k_;
    t0 = clock64();
  }
  __device__ ~ProbeTimer() { PROBE(k) += clock64() - t0; }
};
struct ProbeLane {
  long long t0;
  __device__ ProbeLane() {
    for (int k = 0; k < 16; ++k) PROBE(k) = 0;
    t0 = clock64();
  }
  __device__ ~ProbeLane() {
    PROBE(6) = clock64() - t0;
    PROBE(11) = 1;
    unsigned long long* g = g_probe + (blockIdx.x % 64) * 16;
    for (int k = 0; k < 16; ++k) atomicAdd(g + k, PROBE(k));
  }
};
"""

_PROBE_HOST = r"""
extern "C" int probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe,
                                               sizeof(g_probe)));
}
extern "C" int probe_zero(float lo, float hi, float wlo, float whi) {
  static unsigned long long z[64 * 16];
  const float s[4] = {lo, hi, wlo, whi};
  const int err = static_cast<int>(cudaMemcpyToSymbol(g_probe, z, sizeof(z)));
  return err ? err : static_cast<int>(cudaMemcpyToSymbol(g_probe_shell, s,
                                                         sizeof(s)));
}
"""

#: (counter, name, regex of the statements timed inline) in parity.cu;
#: each alternative matches one tree's design
_INLINE = [
    (0, "draw", r"const float xi = track::lcg_next\(R\.rng\);\s*"
                r"t = t - logf\(1\.0f - xi\) / rate;"),
    (1, "radius", r"const float r = sqrtf\(px \* px \+ py \* py \+ "
                  r"pz \* pz\);"
                  r"|const float s = px \* px \+ py \* py \+ pz \* pz;"),
    (2, "locate", r"const float lat = asinf\(pz / r\);.*?"
                  r"const int32_t\* row = [^;]*;"),
    (4, "classify", r"classify\(p, value, rgba\);\s*"
                    r"const float u = track::lcg_next\(R\.rng\);"),
]
#: (counter, name, regex of a statement's head) of the blocks timed whole
_BLOCKS = [
    (3, "scan", r"for \(int c = 0; c < p\.n_cells; \+\+c\) \{"),
    (3, "scan", r"for \(; c \+ kGroup <= p\.n_cells; c \+= kGroup\) \{"),
    (3, "scan", r"for \(; c < p\.n_cells; \+\+c\) \{"),
    (3, "scan", r"for \(int s = 0; s < p\.k_cap; \+\+s\) \{"),
    (5, "finalize", r"if \(!RAW(?: && wrote)?\) \{"),
]
PHASES = ("draw", "radius", "locate", "scan", "classify", "finalize")
#: the wedge sampler's parts of the scan: (counter, name, regex) in
#: wedge_column
_WEDGE = [(12, "find_layer", r"const int base =[^;]*;"),
          (13, "newton",
           r"if \(uelems::newton<6>\(([^;]*)\)\)\s*return true;")]


def instrument(src):
    """parity.cu with the probe's counters; raises if a statement is not
    found where the design has it."""
    out = src
    # inline statements: AE's in track_ae, the sampler's in sample
    for k, name, pat in _INLINE:
        fn = ("__device__ void track_ae(" if k in (0, 4)
              else "__device__ bool sample(")
        a, b = kt.function_body(out, fn, WHO)
        body = out[a:b]
        ms = list(re.finditer(pat, body, flags=re.S))
        if not ms:
            raise SystemExit(f"time_parity --phases: no {name} statement")
        extra = ""
        if name == "radius":
            extra = (" ++PROBE(8); { const float _r = sqrtf(px * px + "
                     "py * py + pz * pz); if (!(_r >= g_probe_shell[0] && "
                     "_r <= g_probe_shell[1])) ++PROBE(9); if (!(_r >= "
                     "g_probe_shell[2] && _r <= g_probe_shell[3])) "
                     "++PROBE(7); }")
        for m in reversed(ms):
            body = (body[:m.start()] + f"long long _t{k} = clock64(); "
                    + m.group(0) + f" PROBE({k}) += clock64() - _t{k};"
                    + extra + body[m.end():])
        out = out[:a] + body + out[b:]
    found = set()
    for k, name, pat in _BLOCKS:
        m = re.search(pat, out)
        if m is None:
            continue
        found.add(name)
        end = kt.matching_brace(out, m.end() - 1, WHO)
        out = (out[:m.start()] + f"{{ ProbeTimer _pt{k}({k}); "
               + out[m.start():end + 1] + " }" + out[end + 1:])
    if found != {"scan", "finalize"}:
        raise SystemExit(f"time_parity --phases: only {found} blocks")
    a, b = kt.function_body(out, "__device__ __forceinline__ bool "
                                 "wedge_column(", WHO)
    body = out[a:b]
    for k, name, pat in _WEDGE:
        m = re.search(pat, body, flags=re.S)
        if m is None:
            raise SystemExit(f"time_parity --phases: no {name} statement")
        if name == "newton":
            timed = (f"bool _h{k}; {{ ProbeTimer _pt{k}({k}); _h{k} = "
                     f"uelems::newton<6>({m.group(1)}); }} "
                     f"if (_h{k}) return true;")
        else:                        # base stays in the function's scope
            expr = m.group(0)[len("const int base ="):-1]
            timed = (f"int base; {{ ProbeTimer _pt{k}({k}); base = {expr}; "
                     f"}}")
        body = body[:m.start()] + timed + body[m.end():]
    out = out[:a] + body + out[b:]
    a, b = kt.function_body(out, "parity_kernel(const ParityParams p)",
                            WHO)
    body = out[a:b]
    head = "if (lane >= p.n_lanes) return;"
    if body.count(head) != 1 or body.count("  if (p.dbg) {") != 1:
        raise SystemExit("time_parity --phases: the kernel's head or tail "
                         "is not found once")
    body = body.replace(head, head + " ProbeLane _plane;")
    body = body.replace("  if (p.dbg) {",
                        "  PROBE(10) = R.it;\n  if (p.dbg) {")
    out = out[:a] + body + out[b:]
    inc = '#include "uelems.cuh"\n'
    if inc not in out:
        raise SystemExit("time_parity --phases: no uelems.cuh include")
    return out.replace(inc, inc + _PRELUDE, 1)


def probe_build(phases):
    """Build a copy of csrc/parity.cu with the occupancy query appended
    where the tree has none of its own (and with `phases` instrumented);
    returns (the ctypes library, its ptxas log)."""
    def edit(f, src):
        if f != "parity.cu":
            return src
        if phases:
            src = instrument(src) + _PROBE_HOST
        if "parity_occupancy" not in src:
            src += _QUERY
        return src
    return kt.probe_build("parity", edit, WHO)


def occupancy(lib, cell):
    """The probe query's {blocks_per_sm, registers, local_bytes} of a
    cell's finalizing kernel at 128 threads (a tree without
    `parity_occupancy`)."""
    import ctypes
    out = (ctypes.c_int * 3)()
    rg, sp = MODES[cell]
    err = lib.probe_occupancy({"ae": 0, "sphere": 1}[rg],
                              {"locator": 0, "brute": 1}[sp], 128, out)
    if err:
        raise SystemExit(f"time_parity: occupancy query failed ({err})")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}


def run_probe(lib, call, shell):
    """One `call` of K8 through the instrumented library: the phases'
    shares of the lanes' cycles and the counts."""
    import ctypes
    lib.probe_zero.argtypes = [ctypes.c_float] * 4
    wshell = shell[2:] if len(shell) > 2 else (float("nan"),) * 2
    s = kt.probe_sums("parity", lib, call, SLOTS,
                      zero=lambda: lib.probe_zero(*shell[:2], *wshell))
    lane = max(s[6], 1)
    out = {nm: round(s[k] / lane, 4) for k, nm in enumerate(PHASES)}
    out["other"] = round(1.0 - sum(s[k] for k in range(6)) / lane, 4)
    for k, nm, _ in _WEDGE:          # inside the scan
        out[nm] = round(s[k] / lane, 4)
    out.update(lanes=s[11], samples=s[8], outside_shell=s[9],
               outside_share=s[9] / max(s[8], 1), iterations=s[10],
               lane_cycles=s[6],
               cycles_per_iteration=s[6] / max(s[10], 1))
    if len(shell) > 2:
        out.update(outside_wedge_shell=s[7],
                   outside_wedge_share=s[7] / max(s[8], 1))
    return out


# ---------------------------------------------------------------------------
# One tree
# ---------------------------------------------------------------------------

def cell_tables(cs, cell, dev):
    """(cells, locator, tf, accel or None, lp, width, height, the app's
    pipeline or None) of a cell."""
    import torch
    from icon_rt_tpu_torch import app
    if cell == "ae_brute":
        from icon_rt_tpu_torch.data import synthetic
        from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
        from icon_rt_tpu_torch.models.transfunc import make_transfunc
        ds = synthetic.icosphere(BRUTE_SUB, BRUTE_LAYERS)
        stats = compute_stats(ds)
        tf = make_transfunc(value_range=tuple(stats.data_range), device=dev)
        lp = cs.parity_lp(stats, BRUTE_W, BRUTE_W, dev)
        return (build_cells(ds, device=dev), None, tf, None, lp, BRUTE_W,
                BRUTE_W, None)
    raygen, sampler = MODES[cell]
    if sampler == "wedge":
        sub, layers, w, h = W7_SUB, W7_LAYERS, W7, W7
    else:
        sub, layers, w, h = MAIN_SUB, MAIN_LAYERS, W, H
    pl = app.build(cs.parity_argv(raygen, raygen, sampler, sub, layers, w,
                                  h, STEADY, f"time_parity_{cell}"))
    s = pl.scene
    cells, loc = s["get_f32"]()
    accel = s["get_accel"](raygen) if raygen != "ae" else None
    torch.cuda.synchronize()
    return (cells, loc, s["tf"](), accel, cs.launch_params_wh(pl, w, h), w,
            h, pl)


def cell_numbers(cs, cell, dev, probes, later):
    import numpy as np
    import torch
    from icon_rt_tpu_torch.ops import render
    from icon_rt_tpu_torch.ops.fast import alloc_raw
    t0 = time.perf_counter()
    cells, loc, tf, accel, lp, w, h, pl = cell_tables(cs, cell, dev)
    raygen, sampler = MODES[cell]
    out = {"build_s": time.perf_counter() - t0}
    pl_wedges = pl.scene["get_wedges"]() if sampler == "wedge" else None
    if pl is not None:
        walls = []
        cs.run_loop(pl, walls)
        out["steady_launch_ms"] = float(np.median(walls[1:]))
        out["app_launch_ms"] = [round(x, 3) for x in walls]
        del pl
    acc, fb = render.alloc_frame(w, h, device=dev)
    kw = dict(width=w, height=h, raygen=raygen, sampler=sampler,
              locator=loc, accel=accel)
    if sampler == "wedge":
        kw["wedges"] = wedges = pl_wedges
        if hasattr(wedges, "shell"):
            out["wedge_shell"] = [float(x) for x in wedges.shell[:2]]

    lps = {k: cs.with_id(lp, k) for k in range(6)}

    def steady(k=1):
        render.parity_track(cells, tf, lps[k], acc, fb, **kw)
    out["ms"] = kt.events_ms(steady, reps=REPS[cell])
    try:
        out.update(kt.profiled(cs, lambda: (steady(4), fb.cpu()),
                               (KERNEL,), f"K8 {cell}"))
        out["kernel_ms"] = out["by_name"].get(KERNEL)
    except AssertionError as e:   # the profiler lost the kernel's events
        print(f"time_parity {cell}: {e}", flush=True)
        out.update(kernel_ms=None, idle_share=None)
    if cell == "ae_brute":
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steady(5)
            fb.cpu()
            walls.append((time.perf_counter() - t1) * 1e3)
        out["steady_launch_ms"] = float(np.median(walls))
    out["host_reads"], out["wrapper_wall_ms"] = kt.host_reads(
        lambda: steady(5))
    a0, f0 = render.alloc_frame(w, h, device=dev)
    dbg = torch.zeros(w * h, 2, dtype=torch.int32, device=dev)
    render.parity_track(cells, tf, lps[0], a0, f0, debug=dbg, **kw)
    raw = alloc_raw(w * h, dev)
    render.parity_track(cells, tf, lps[1], None, None, out=raw, **kw)
    out["hash"] = {"accum": kt.digest(a0), "fb": kt.digest(f0),
                   "dbg": kt.digest(dbg), "raw": kt.digest(raw.wrote, raw.ca)}
    it = dbg[:, 1]
    lanes = torch.arange(w * h, device=dev)
    out.update(divergence=cs.divergence(it, lanes, w * h),
               it_mean=float(it.double().mean()), it_max=int(it.max()),
               covered=float((f0 != 0).double().mean()))
    q_lib, q_log = probes["query"]
    out["occupancy"] = (render.parity_occupancy(raygen, sampler)
                        if hasattr(render, "parity_occupancy")
                        else occupancy(q_lib, cell))
    out["ptxas"] = cs.ptxas_lines(q_log, cs.parity_instance(raygen, sampler))
    if "phases" in probes:            # run last (`measure`)
        shell = (float(cells.h_bot.min()), float(cells.h_top.max()))
        if "wedge_shell" in out:
            shell += tuple(out["wedge_shell"])
        later.append((out, cell, lambda: steady(1), shell, dict(
            cells=cells, loc=loc, tf=tf, accel=accel, lps=lps, acc=acc,
            fb=fb)))
    return out


def check_numbers(cs, dev):
    """{combination: {ms, kernel_ms, hash}} of the `check` cell."""
    import torch
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.wedges import build_wedges
    from icon_rt_tpu_torch.ops import render
    from icon_rt_tpu_torch.ops.fast import alloc_raw
    tabs, stats, _ = cs.parity_tables(BRUTE_SUB, BRUTE_LAYERS, dev)
    wedges = build_wedges(synthetic.icosphere(BRUTE_SUB, BRUTE_LAYERS),
                          device=dev)
    out = {}
    combos = [(g, s) for g in ("ae", "sphere", "grid")
              for s in ("locator", "brute", "wedge", "raw")
              if (g, s) != ("ae", "brute") and (s != "raw" or g == "sphere")]
    for raygen, sampler in combos:
        n = 64 if sampler == "wedge" else BRUTE_W
        lp = cs.parity_lp(stats, n, n, dev, k=1)
        acc, fb = render.alloc_frame(n, n, device=dev)
        raw = alloc_raw(n * n, dev) if sampler == "raw" else None
        kw = dict(width=n, height=n, raygen=raygen,
                  sampler="locator" if sampler == "raw" else sampler,
                  locator=tabs["loc"], accel=tabs["accel"].get(raygen),
                  wedges=wedges if sampler == "wedge" else None)
        call = (lambda kw=kw, lp=lp, acc=acc, fb=fb, raw=raw:
                render.parity_track(tabs["cells"], tabs["tf"], lp,
                                    None if raw else acc,
                                    None if raw else fb, out=raw, **kw))
        r = kt.kernel_times(cs, call, KERNEL,
                            f"time_parity check K8 {raygen} {sampler}", reps=5)
        dbg = torch.zeros(n * n, 2, dtype=torch.int32, device=dev)
        a0, f0 = render.alloc_frame(n, n, device=dev)
        r0 = alloc_raw(n * n, dev) if raw is not None else None
        render.parity_track(tabs["cells"], tabs["tf"], cs.with_id(lp, 0),
                            None if raw else a0, None if raw else f0,
                            out=r0, debug=dbg, **kw)
        r["hash"] = kt.digest(dbg, *((r0.wrote, r0.ca) if raw is not None
                                     else (a0, f0)))
        out[f"{raygen}_{sampler}"] = r
    return out


def measure(root, phases, cells):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_parity: no CUDA card")
    from icon_rt_tpu_torch.models.accel import build_majorant_kernel
    from icon_rt_tpu_torch.ops import render
    if not render.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"time_parity: imported {render.__file__}, not "
                         f"the package under {root}")
    cs = kt.chip_smoke()
    dev = torch.device("cuda", 0)
    res = {"root": os.path.abspath(root), "card": kt.card()}
    kinds = ("query", "phases") if phases else ("query",)
    with ThreadPoolExecutor(len(kinds) + 2) as ex:
        futs = {k: ex.submit(probe_build, k == "phases") for k in kinds}
        # K8 itself, and the K5b majorants of the sphere accel
        for f in [ex.submit(render.build_parity),
                  ex.submit(build_majorant_kernel)]:
            f.result()
        probes = {k: f.result() for k, f in futs.items()}
    later = []
    for cell in cells:
        if cell == "check":
            res[cell] = check_numbers(cs, dev)
            print("time_parity check " + json.dumps(res[cell]), flush=True)
            continue
        r = cell_numbers(cs, cell, dev, probes, later)
        res[cell] = r
        print(f"time_parity {cell} " + json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    # the phase probes last: a profiled window after one may lose the
    # kernel's device events
    for out, cell, call, shell, keep in later:
        out["phases"] = run_probe(probes["phases"][0], call, shell)
        print(f"time_parity phases {cell} " + json.dumps(out["phases"]),
              flush=True)
        del keep
    print("time_parity " + json.dumps(res), flush=True)


def turns(trees, phases, cells):
    """Each tree of `trees` in turns, forth and back, each run in a
    process of its own; prints each run's line and a summary."""
    runs = kt.turns(__file__, "time_parity", trees,
                    ["--cells", ",".join(cells)]
                    + (["--phases"] if phases else []))
    for root in trees:
        mine = runs[root]
        pick = lambda f: [f(r) for r in mine]
        rnd = lambda f: pick(lambda r: None if f(r) is None
                             else round(f(r), 4))
        if "check" in cells:
            for k in mine[0]["check"]:
                print(f"time_parity summary {root}: check {k} kernel "
                      f"{rnd(lambda r: r['check'][k]['kernel_ms'])}, events "
                      f"{rnd(lambda r: r['check'][k]['ms'])}, hashes "
                      f"{pick(lambda r: r['check'][k]['hash'])}", flush=True)
        for k in [c for c in cells if c != "check"]:
            print(f"time_parity summary {root}: {k} kernel "
                  f"{rnd(lambda r: r[k]['kernel_ms'])}, events "
                  f"{rnd(lambda r: r[k]['ms'])}, steady launch "
                  f"{rnd(lambda r: r[k]['steady_launch_ms'])}, idle "
                  f"{rnd(lambda r: r[k]['idle_share'])}, host reads "
                  f"{pick(lambda r: r[k]['host_reads'])}, occupancy "
                  f"{pick(lambda r: r[k]['occupancy'])}, divergence "
                  f"{rnd(lambda r: r[k]['divergence'])}, hashes "
                  f"{pick(lambda r: r[k]['hash'])}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=kt.HERE,
                    help="the tree whose package to time")
    ap.add_argument("--turns", nargs="+", metavar="TREE",
                    help="time two or more trees in turns, forth and back "
                         "(A, B, B, A)")
    ap.add_argument("--phases", action="store_true",
                    help="K8's split by phase and its samples outside the "
                         "shell through an instrumented copy of "
                         "csrc/parity.cu")
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells to run: " + ", ".join(CELLS))
    args = ap.parse_args()
    cells = args.cells.split(",")
    if any(c not in CELLS for c in cells):
        ap.error(f"--cells takes some of {', '.join(CELLS)}")
    if args.turns:
        if len(args.turns) < 2:
            ap.error("--turns takes two or more trees")
        turns(args.turns, args.phases, cells)
    else:
        measure(args.root, args.phases, cells)


if __name__ == "__main__":
    main()
