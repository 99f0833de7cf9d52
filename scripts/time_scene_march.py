#!/usr/bin/env python
"""K7-scene `synth_scene` and K3 `march_q` / `march_f32` on the card: their
times, their splits, their host reads and the builds and passes they sit
in, for one tree of the repository or two in turns.

    python scripts/time_scene_march.py                  # this tree
    python scripts/time_scene_march.py --turns A B      # trees A, B, B, A
    python scripts/time_scene_march.py --turns A B C    # A, B, C, C, B, A
    python scripts/time_scene_march.py --phases         # K3 by phase too

Each tree runs in a process of its own that imports that tree's
icon_rt_tpu_torch (its kernels build into the tree's own _build/):

  1. K7-scene at R2B9 (synth_quantized_device(11, 16), corners' lat/lon
     kept, as build_q_scene asks): one call, then REPS calls timed with
     CUDA events (mean ms of the whole build: every pass and the one host
     read of the value range), the peak device memory of a call above what
     is held before it, one call under chip_smoke.py's `profile_window`
     (device ms by kernel: each pass apart) and the ptxas lines of
     csrc/scene.cu; then the same for the subdivision-8 mip tier of level
     3 (r2b9q_viewall's);
  2. the app's main m and main mq paths (chip_smoke.py `main_path`:
     subdiv 8 x 16, 1920x1080, closeup; steady launch median with the fb
     on the host), then K3-f32 and K3-q (fine map off, as the app) 20
     launches timed with CUDA events, one launch under `profile_window`,
     the host reads of a steady call, each kernel's registers, local
     bytes and resident blocks an SM (a copy of csrc/march.cu with an
     occupancy query appended, cudaOccupancyMaxActiveBlocksPerMultiprocessor
     at 128 threads) and its ptxas spill stores, sha256 hashes of accum
     and fb after a launch of accum_id 1 into a zeroed frame and of its
     cost output (trees that compute the same bits print the same
     hashes) and, for K3-q, the divergence factor as in 4;
  3. build_q_scene(11, 16) by phase, with the device's peak after each;
  4. K3-q on that scene at main r2b9m's 1920x1080 closeup (fine map on):
     20 launches timed with CUDA events; the converged pass (launch and
     fb to the host) median of 3; one pass under `profile_window` (wall,
     device busy, idle share, device ms by event); the host reads of one
     steady call (torch.cuda.set_sync_debug_mode("warn"), one warning a
     read) and its wrapper's host wall; the warp divergence factor of the
     per-lane cost output in pixel_perm order (the sum over warps of 32 x
     their largest cost over the sum of the costs); its bound, counted by
     chip_smoke.py's `CountingTier` on CHECK_LANES strided covered lanes
     with `scale`, and the plain version's ms on those lanes (last: the
     profiler's windows lose their device events after a plain loop).

With --phases, step 2's K3-f32 and K3-q and step 4's K3-q also run two
instrumented copies of the tree's csrc/ (march.cu and the tier headers),
written at run time into the tree's _build/ and not kept: one with
clock64() counters around the locate, the column exit, the integral, the
gap skip and the band lookup of each iteration and around the lane's
setup and epilogue, summed over the lanes, beside each lane's whole
march ("other": the rest of the loop); one with counts (warp-aggregated
atomics): column crossings integrated, those whose descending piece
[t0, tm] or ascending piece [tm, t1] is empty, the layers the integral's
two loops visit and those of them with a length > 0, locates, the
candidate test rows the locates read and those the gap skips read.

Each process prints `time_scene_march {json}` lines; --turns prints a
summary of each tree's runs after them.  Needs a CUDA card: without one it
exits non-zero.
"""
import argparse
import json
import os
import re
import sys
import tempfile
import time

import kernel_timing as kt
from kernel_timing import events_ms, host_reads, profiled

REPS = 5
R2B9_SUB, R2B9_LAYERS, LOD_SUB, LOD = 11, 16, 8, 3
W, H = 1920, 1080
#: a profiled window of a scene build holds both passes
SCENE_CALL = ("scene_pass1_kernel", "scene_pass2_kernel")
WHO = "time_scene_march"
SLOTS = 8                         # the phase probe's counters a block slot


def ptxas(cs, name):
    from icon_rt_tpu_torch.utils import cuda_build
    return cs.ptxas_lines(cuda_build.info(name)["log"])


# ---------------------------------------------------------------------------
# K3's phase probe: an instrumented copy of csrc/march.cu, not kept
# ---------------------------------------------------------------------------

_PROBE_TAIL = r"""
__device__ unsigned long long g_phase[64 * 8];
extern "C" int probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase,
                                               sizeof(g_phase)));
}
extern "C" int probe_zero() {
  static unsigned long long z[64 * 8];
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, z, sizeof(z)));
}
"""


def _instrument(src):
    """The march.cu source with clock64() counters around the four phases
    of march_lane's loop and its whole body; raises if a phase's statement
    is not found."""
    body = src.index("__device__ __forceinline__ void march_lane(")
    head, lane = src[:body], src[body:]
    end = lane.index("\n}\n") + 2
    lane, tail = lane[:end], lane[end:]
    marks = [
        ("locate", r"(\n[ \t]*)(const int c = T\.locate\([^;]*;)"),
        ("exit", r"(\n[ \t]*)(const float t_exit =[^;]*;)"),
        ("integral", r"(\n[ \t]*)(integrate[<\w, >]*\([^;]*;)"),
        ("gap", r"(\n[ \t]*)(float skip = bin_exit\(.*?"
                r"t = fmaxf\(fminf\(skip, seg_end\), tl\);)"),
    ]
    marks.append(("band", r"(\n[ \t]*)(const float r = track::r_of\(tl, "
                          r"od, oo\);.*?const float seg_end =[^;]*;)"))
    for k, (name, pat) in zip((0, 1, 2, 3, 7), marks):
        m = re.search(pat, lane, flags=re.S)
        if m is None:
            raise SystemExit(f"time_scene_march --phases: no {name} "
                             f"statement in march_lane")
        ind = m.group(1)
        lane = (lane[:m.start()] + f"{ind}long long _ph_t{k} = clock64();"
                + ind + m.group(2)
                + f"{ind}_ph[{k}] += clock64() - _ph_t{k};"
                + lane[m.end():])
    # the lane's setup ends where its march state starts; its epilogue
    # starts at the colour's ambient terms
    for k, (pat, at_end) in ((5, ("float t = L.t", False)),
                             (6, ("float cr = 0.0f, cg = 0.0f", True))):
        i = lane.index(pat)
        i = lane.rindex("\n", 0, i) + 1
        ins = (f"  const long long _ph_t{k} = clock64();\n" if at_end else
               f"  _ph[{k}] += clock64() - _ph_lane;\n")
        lane = lane[:i] + ins + lane[i:]
    open_brace = lane.index("{") + 1
    lane = (lane[:open_brace]
            + "\n  long long _ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};"
            + "\n  const long long _ph_lane = clock64();"
            + lane[open_brace:])
    close = lane.rindex("\n}")
    lane = (lane[:close]
            + "\n  _ph[6] += clock64() - _ph_t6;"
            + "\n  _ph[4] = clock64() - _ph_lane;"
            + "\n  {\n    unsigned long long* g = g_phase + "
              "(blockIdx.x % 64) * 8;"
            + "\n    for (int k = 0; k < 8; ++k) atomicAdd(g + k, "
              "static_cast<unsigned long long>(_ph[k]));\n  }"
            + lane[close:])
    decl = "__device__ unsigned long long g_phase[64 * 8];\n"
    return head.replace("namespace {", decl + "namespace {", 1) + lane \
        + tail + _PROBE_TAIL.replace(decl, "", 1)


def phase_probe(cs, call):
    """K3's time by phase in one `call` of the march, through the
    instrumented copy: {phase: share of the lanes' cycles, "lane_cycles":
    the sum over lanes}.  The build's ptxas lines are printed."""
    lib, log = probe_lib("phases")
    print("\n".join(f"{WHO} phase probe ptxas: {line}"
                    for line in cs.ptxas_lines(log)), flush=True)
    sums = kt.probe_sums("march", lib, call, SLOTS)
    lane = max(sums[4], 1)
    out = {name: round(sums[k] / lane, 4) for k, name in
           ((0, "locate"), (1, "exit"), (2, "integral"), (3, "gap"),
            (5, "setup"), (6, "epilogue"), (7, "band"))}
    out["other"] = round(1.0 - sum(sums[k] for k in (0, 1, 2, 3, 5, 6, 7))
                         / lane, 4)
    out["lane_cycles"] = sums[4]
    return out


#: the count probe's helpers, ahead of march.cu's includes: a
#: warp-aggregated add to counter k of the block's slot, and the integral's
#: per-crossing counts, added when it returns
_COUNT_HEAD = r"""
__device__ unsigned long long g_phase[64 * 8];
__device__ __forceinline__ void _probe_count(int k, unsigned v) {
  const unsigned m = __activemask();
  const unsigned s = __reduce_add_sync(m, v);
  if ((threadIdx.x & 31) == __ffs(m) - 1)
    atomicAdd(g_phase + (blockIdx.x % 64) * 8 + k,
              static_cast<unsigned long long>(s));
}
struct _ProbeLayers {
  unsigned d, a, v = 0, p = 0;
  __device__ _ProbeLayers(bool d_, bool a_) : d(d_), a(a_) {}
  __device__ void visit(float len) { ++v; p += len > 0.0f ? 1u : 0u; }
  __device__ ~_ProbeLayers() {
    _probe_count(0, 1u);
    _probe_count(1, d);
    _probe_count(2, a);
    _probe_count(3, v);
    _probe_count(4, p);
  }
};
"""

#: the count probe's slots
COUNTS = ("crossings", "desc_empty", "asc_empty", "layers_visited",
          "layers_positive", "locates", "locate_rows", "gap_rows")


def _sub(src, pat, rep, what, count=0):
    """re.sub that raises where `pat` is not found."""
    out, n = re.subn(pat, rep, src, count=count, flags=re.S)
    if n == 0:
        raise SystemExit(f"time_scene_march --phases: no {what}")
    return out


def _count(f, src):
    """The count probe's edit of csrc file `f`."""
    if f in ("tier_f32.cuh", "tier_q.cuh"):
        # the candidate rows a locate reads
        return _sub(src, r"(\n[ \t]*)(load\(c, col\);)",
                    r"\1_probe_count(6, 1u);\1\2", f"locate read in {f}")
    if f != "march.cu":
        return src
    i, j = kt.function_body(src, "__device__ __forceinline__ void integrate(",
                            WHO)
    body = _sub(src[i:j], r"(\n[ \t]*)(const float tm = [^;]*;)",
                r"\1\2\1_ProbeLayers _pl(!(tm > t0), !(t1 > tm));",
                "tm in integrate", count=1)
    body = _sub(body, r"(\n[ \t]*)(const float (len[12]) = [^;]*;)",
                r"\1\2\1_pl.visit(\3);", "len1/len2 in integrate")
    src = src[:i] + body + src[j:]
    src = _sub(src, r"(\n[ \t]*)(const int c = T\.locate\()",
               r"\1_probe_count(5, 1u);\1\2", "locate in march_lane")
    src = _sub(src, r"(\n[ \t]*)(T\.load\(cc, col\);)",
               r"\1_probe_count(7, 1u);\1\2", "gap read in march_lane")
    inc = '#include "tier_f32.cuh"'
    if inc not in src:
        raise SystemExit("time_scene_march --phases: no tier include")
    return src.replace(inc, _COUNT_HEAD + inc, 1) + _PROBE_TAIL.replace(
        "__device__ unsigned long long g_phase[64 * 8];\n", "", 1)


_PROBES = {}


def probe_lib(kind):
    """The tree's probe build of csrc/march.cu of `kind` ("phases",
    "counts" or "occupancy"), built once a process: (the ctypes library,
    its ptxas log)."""
    if kind not in _PROBES:
        edit = {"phases": lambda f, src: (_instrument(src)
                                          if f == "march.cu" else src),
                "counts": _count,
                "occupancy": lambda f, src: (src + _QUERY
                                             if f == "march.cu" else src)}
        _PROBES[kind] = kt.probe_build("march", edit[kind], WHO)
    return _PROBES[kind]


def layer_counts(call):
    """K3's counts (COUNTS) in one `call` of the march through the count
    probe, with the means a crossing and the shares of crossings with an
    empty piece."""
    lib, _ = probe_lib("counts")
    sums = dict(zip(COUNTS, kt.probe_sums("march", lib, call, SLOTS)))
    n = max(sums["crossings"], 1)
    sums.update(
        desc_empty_share=round(sums["desc_empty"] / n, 4),
        asc_empty_share=round(sums["asc_empty"] / n, 4),
        visited_a_crossing=round(sums["layers_visited"] / n, 3),
        positive_a_crossing=round(sums["layers_positive"] / n, 3),
        rows_a_locate=round(sums["locate_rows"] / max(sums["locates"], 1),
                            3))
    return sums


_QUERY = r"""
extern "C" int probe_occupancy(int tier, int* out) {
  return tier == 0 ? track::occupancy(march_f32_kernel, 128, out)
                   : track::occupancy(march_q_kernel, 128, out);
}
"""


def occupancy(tier):
    """{blocks_per_sm, registers, local_bytes, spill_store_bytes} of K3's
    kernel of `tier` ("f32" or "q") from the occupancy probe's query and
    its ptxas report (the same source and flags as the tree's build)."""
    import ctypes
    lib, log = probe_lib("occupancy")
    out = (ctypes.c_int * 3)()
    err = lib.probe_occupancy(0 if tier == "f32" else 1, out)
    if err:
        raise SystemExit(f"{WHO}: occupancy query failed ({err})")
    cs = kt.chip_smoke()
    spill = cs.spill_stores(cs.ptxas_lines(log, f"march_{tier}_kernel"))
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2], "spill_store_bytes": spill}


def march_hashes(run, n, dev):
    """{"frame", "cost"}: hashes of accum and fb after run(acc, fb, cost)
    of accum_id 1 into a zeroed frame on the first n lanes, and of the
    cost output of the same launch."""
    import torch
    from icon_rt_tpu_torch.ops.render import alloc_frame
    acc, fb = alloc_frame(W, H, device=dev)
    run(acc[:n], fb[:n], None)
    a2, f2 = alloc_frame(W, H, device=dev)
    cost = torch.zeros(W * H, dtype=torch.int32, device=dev)
    run(a2[:n], f2[:n], cost)
    torch.cuda.synchronize()
    return {"frame": kt.digest(acc, fb), "cost": kt.digest(cost),
            "frame_with_cost": kt.digest(a2, f2)}


# ---------------------------------------------------------------------------
# One tree
# ---------------------------------------------------------------------------

def scene_times(cs, dev, sub, lod, tag):
    """Step 1 for one scene: {"ms", "first_ms", "peak_gib_above_held",
    profiled split, "ptxas"}."""
    import torch
    from icon_rt_tpu_torch.data.device_scene import synth_quantized_device

    def call():
        return synth_quantized_device(sub, R2B9_LAYERS, device=dev,
                                      latlon=True, field_lod=lod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    out = {"first_ms": (time.perf_counter() - t0) * 1e3}
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = call()
    torch.cuda.synchronize()
    out["peak_gib_above_held"] = (torch.cuda.max_memory_allocated()
                                  - held) / 2 ** 30
    del res
    out["ms"] = events_ms(call)
    out.update(profiled(cs, call, SCENE_CALL, tag))
    out["ptxas"] = ptxas(cs, "scene")
    return out


def march_q_times(cs, q, loc, bands, tf, lp, perm, n_active, fm, phases,
                  tag, plain=False):
    """Step 3 / 4's K3-q numbers on one scene and frame."""
    import torch
    from icon_rt_tpu_torch.ops import march
    from icon_rt_tpu_torch.ops.fastq import _QTier
    from icon_rt_tpu_torch.ops.render import alloc_frame
    kw = dict(width=W, height=H, pixel_perm=perm, n_active=n_active,
              finemap=fm)
    acc, fb = alloc_frame(W, H, device=perm.device)
    lps = [cs.with_id(lp, k) for k in range(8)]

    def launch(k=1):
        march.render_frame_march_q(q, loc, bands, tf, lps[k], acc, fb, **kw)
    out = {"ms": events_ms(launch, reps=20)}
    passes = []
    for k in range(1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launch(k)
        fb.cpu()
        passes.append((time.perf_counter() - t0) * 1e3)
    out["pass_ms"] = passes
    out["pass_median_ms"] = sorted(passes)[1]
    out.update(profiled(cs, lambda: (launch(4), fb.cpu()),
                        ("march_q_kernel",), tag))
    out["host_reads"], out["wrapper_wall_ms"] = host_reads(
        lambda: launch(5))
    pix = perm[:n_active].contiguous()
    cost = torch.zeros(W * H, dtype=torch.int32, device=perm.device)
    march.march_q(q, loc, bands, tf, lps[1], pix, acc[:n_active],
                  fb[:n_active], width=W, height=H, finemap=fm, cost=cost)
    out["divergence"] = cs.divergence(cost, perm, n_active)
    out["cost_mean"] = float(cost[pix.long()].double().mean())
    out["cost_max"] = int(cost.max())
    if plain:
        lanes = cs.strided_lanes(perm, n_active)
        tier = cs.CountingTier(_QTier(q, loc, tf, fm))
        a2, f2 = alloc_frame(W, H, device=perm.device)
        n = lanes.shape[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        march._march_frame_torch(tier, bands, lps[1], lanes, a2[:n], f2[:n],
                                 W, H)
        torch.cuda.synchronize()
        out["plain_ms_sampled"] = (time.perf_counter() - t0) * 1e3
        out["sampled_lanes"] = n
        out["bound_ms"], out["bound_by"] = tier.bound(
            "march_q", n_active, lambda c: q.test12[c, 11],
            scale=n_active / n)
    out["hashes"] = march_hashes(
        lambda a, f, c: march.march_q(q, loc, bands, tf, lps[1], pix, a, f,
                                      width=W, height=H, finemap=fm, cost=c),
        n_active, perm.device)
    out["occupancy"] = occupancy("q")
    if phases:
        out["phases"] = phase_probe(cs, launch)
        out["counts"] = layer_counts(launch)
    return out


def measure(root, phases):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_scene_march: no CUDA card")
    from icon_rt_tpu_torch.data import bigscene
    from icon_rt_tpu_torch.ops import march
    if not march.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"time_scene_march: imported {march.__file__}, not "
                         f"the package under {root}")
    cs = kt.chip_smoke()
    dev = torch.device("cuda", 0)
    out = {"root": os.path.abspath(root), "card": kt.card()}
    bigscene.CACHE_DIR = tempfile.mkdtemp(prefix="time_scene_march_")

    # 1. K7-scene
    out["scene_r2b9"] = scene_times(cs, dev, R2B9_SUB, 0, "scene R2B9")
    out["scene_lod3"] = scene_times(cs, dev, LOD_SUB, LOD, "scene lod 3")
    print("time_scene_march scene " + json.dumps(
        {k: out[k] for k in ("scene_r2b9", "scene_lod3")}), flush=True)
    torch.cuda.empty_cache()

    # 2. R2B8 1080p, the app's march paths (before any plain loop: the
    # profiler's windows lose their device events after one)
    res = {}
    for quantized in (False, True):
        pl, _, met = cs.main_path(dev, quantized=quantized, marching=True)
        steady = sorted(met["launch_ms"][1:cs.MARCH_LIMIT])
        name = "march_q" if quantized else "march_f32"
        r = {"steady_launch_median_ms": steady[len(steady) // 2]}
        s, frame = pl.scene, pl.frame
        lp = cs.launch_params(pl)
        n = frame["n_active"]
        pix = frame["perm"][:n].contiguous()
        acc, fb = frame["accum"][:n], frame["fb"][:n]
        if quantized:
            q, loc_q, _ = s["get_q"]()
            tabs = (q, loc_q, s["get_bands"](), s["tf"]())
            r.update(march_q_times(cs, *tabs, lp, frame["perm"], n, None,
                                   phases, "march_q R2B8"))
            r["ms_render"] = r.pop("ms")

            def launch():
                march.march_q(*tabs, lp, pix, acc, fb, width=W, height=H)
        else:
            tabs = (s["get_packed"](), s["locator"], s["get_bands"]())

            def launch():
                march.march_f32(*tabs, lp, pix, acc, fb, width=W, height=H)
            r.update(profiled(cs, lambda: (launch(), fb.cpu()),
                              ("march_f32_kernel",), "march_f32 R2B8"))
            r["host_reads"], r["wrapper_wall_ms"] = host_reads(launch)
            r["hashes"] = march_hashes(
                lambda a, f, c: march.march_f32(
                    *tabs, cs.with_id(lp, 1), pix, a, f, width=W, height=H,
                    cost=c), n, dev)
            r["occupancy"] = occupancy("f32")
            if phases:
                r["phases"] = phase_probe(cs, launch)
                r["counts"] = layer_counts(launch)
        r["ms"] = events_ms(launch, reps=20)
        res[name] = r
        del pl
        torch.cuda.empty_cache()
    out["r2b8"] = res
    # 3. the R2B9 build
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    q, loc, _, bands, tf, stats, fm, _, _ = bigscene.build_q_scene(
        R2B9_SUB, R2B9_LAYERS, device=dev, timings=timings)
    out["build_s"] = time.perf_counter() - t0
    out["build_held_gib"] = held / 2 ** 30
    out["build_phases"] = {
        k: (round(v / 2 ** 30, 3) if k.endswith("bytes") else round(v, 4))
        for k, v in timings.items()}

    # 4. K3-q at R2B9, its plain version last
    lp, perm, n_active = cs.r2b9_frame(stats, W, H, dev)
    out["march_q_r2b9"] = march_q_times(cs, q, loc, bands, tf, lp, perm,
                                        n_active, fm, phases,
                                        "march_q R2B9", plain=True)
    out["march_q_r2b9"]["n_active"] = n_active
    print("time_scene_march march_q_r2b9 " + json.dumps(
        out["march_q_r2b9"]), flush=True)
    del q, loc, bands, tf, fm, lp, perm
    torch.cuda.empty_cache()

    out["ptxas_march"] = ptxas(cs, "march")
    print("time_scene_march " + json.dumps(out), flush=True)


def turns(trees, phases):
    """Each tree of `trees` in turns, forth and back, each run in a
    process of its own; prints each run's line and a summary."""
    runs = kt.turns(__file__, WHO, trees, ["--phases"] if phases else [])
    for root in trees:
        mine = runs[root]
        pick = lambda f: [f(r) for r in mine]
        r2 = lambda f: pick(lambda r: round(f(r), 4))
        print(f"time_scene_march summary {root}: K7-scene R2B9 ms "
              f"{r2(lambda r: r['scene_r2b9']['ms'])}, by kernel "
              f"{pick(lambda r: r['scene_r2b9']['by_name'])}, peak GiB "
              f"{r2(lambda r: r['scene_r2b9']['peak_gib_above_held'])}; "
              f"lod 3 ms {r2(lambda r: r['scene_lod3']['ms'])}, by kernel "
              f"{pick(lambda r: r['scene_lod3']['by_name'])}; build "
              f"{pick(lambda r: r['build_phases'])}")
        print(f"time_scene_march summary {root}: K3-q R2B9 ms "
              f"{r2(lambda r: r['march_q_r2b9']['ms'])}, pass median "
              f"{r2(lambda r: r['march_q_r2b9']['pass_median_ms'])}, kernel "
              f"{pick(lambda r: r['march_q_r2b9']['by_name'].get('march_q_kernel'))}"
              f", idle {r2(lambda r: r['march_q_r2b9']['idle_share'])}, "
              f"host reads {pick(lambda r: r['march_q_r2b9']['host_reads'])}"
              f", occupancy "
              f"{pick(lambda r: r['march_q_r2b9']['occupancy'])}, hashes "
              f"{pick(lambda r: r['march_q_r2b9']['hashes'])}")
        for k in ("march_q", "march_f32"):
            print(f"time_scene_march summary {root}: {k} R2B8 ms "
                  f"{r2(lambda r: r['r2b8'][k]['ms'])}, steady launch "
                  f"{r2(lambda r: r['r2b8'][k]['steady_launch_median_ms'])}"
                  f", kernel "
                  f"{pick(lambda r: r['r2b8'][k]['by_name'].get(k + '_kernel'))}"
                  f", idle {r2(lambda r: r['r2b8'][k]['idle_share'])}"
                  f", host reads {pick(lambda r: r['r2b8'][k]['host_reads'])}"
                  f", occupancy {pick(lambda r: r['r2b8'][k]['occupancy'])}"
                  f", hashes {pick(lambda r: r['r2b8'][k]['hashes'])}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=kt.HERE,
                    help="the tree whose package to time")
    ap.add_argument("--turns", nargs="+", metavar="TREE",
                    help="time two or more trees in turns, forth and back "
                         "(A, B, B, A)")
    ap.add_argument("--phases", action="store_true",
                    help="K3's split by phase and its layer and row "
                         "counts through instrumented copies of csrc/")
    args = ap.parse_args()
    if args.turns:
        if len(args.turns) < 2:
            ap.error("--turns takes two or more trees")
        turns(args.turns, args.phases)
    else:
        measure(args.root, args.phases)


if __name__ == "__main__":
    main()
