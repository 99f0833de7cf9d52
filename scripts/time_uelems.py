#!/usr/bin/env python
"""K9-n `uelems_points`, the Newton intersectors of unstructured elements,
on the card: events and device times, registers and blocks an SM, Newton
iterations, bounds and output hashes, for one tree of the repository or
two or more in turns; with --variants, probe builds of other designs.

    python scripts/time_uelems.py                  # this tree
    python scripts/time_uelems.py --turns A B      # trees A, B, B, A
    python scripts/time_uelems.py --variants       # + probe builds

Each tree runs in a process of its own that imports that tree's
icon_rt_tpu_torch (its kernels build into the tree's own _build/).  For
nv 5 (pyramid), 6 (wedge) and 8 (hexahedron), on chip_smoke.py's seeded
points on jittered unit elements (`uelems_inputs`, seed nv) at two sizes,
65,536 points (chip_smoke.py's `check w`) and 2,073,600 (one a lane of a
1080p frame, enough to fill the card):

  1. the wrapper timed with CUDA events (`ms`: the mean of REPS calls back
     to back after a warm one, its host work and allocations included),
     and with `out=` where the tree's wrapper takes it (`out_ms`);
  2. WINDOW calls under chip_smoke.py's `profile_window`: `kernel_ms`, the
     device time of the intersector kernel a call, and `device_ms`, of
     every device event a call (a tree whose wrapper casts the flags to
     bool runs a second kernel); None where the profiler lost them;
  3. the inside share and the plain `newton`'s iterations (mean, sum),
     the bound (chip_smoke.py `uelems_bound`: bytes 12 + 12 nv + 5 a point
     and 4 nv a point inside at 3.35 TB/s, against NEWTON_OPS for the
     counted iterations at 67 TFLOP/s; the larger and which) and the share
     of it the kernel reaches;
  4. sha256 hashes of the flags and values (trees that compute the same
     bits print the same hashes) and whether they equal the plain
     version's;
  5. each kernel's registers, local bytes and resident blocks an SM (the
     tree's `uelems_occupancy`, or a query appended to a copy of its
     source) and the ptxas lines of a build of that copy (written at run
     time into the tree's _build/, not kept).

With --variants (this tree only), probe builds of csrc/uelems.cu with
blocks of 64, 256 or 512 threads (the built kernel: 128), each timed as
in 2 at both sizes and its hashes held to the built kernel's
(`VARIANTS`).

Each process prints a `time_uelems {json}` line; --turns prints a summary
of each tree's runs after them.  Needs a CUDA card: without one it exits
non-zero.
"""
import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import kernel_timing as kt
from kernel_timing import events_ms

SIZES = (65536, 1920 * 1080)
NVS = (5, 6, 8)
REPS = {65536: 200, 1920 * 1080: 50}
WINDOW = {65536: 20, 1920 * 1080: 10}    # calls in a profiled window
KERNEL = "uelems_kernel"
WHO = "time_uelems"

#: the query appended to a copy of a tree's csrc/uelems.cu that has no
#: `uelems_occupancy` (blocks of 128 threads, as such trees launch)
_QUERY = r"""
template <class K>
static int probe_occ(K kernel, int* out) {
  cudaFuncAttributes a;
  int err = static_cast<int>(cudaFuncGetAttributes(&a, kernel));
  if (err) return err;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = 128;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, 128, 0));
}
extern "C" int uelems_occupancy(int nv, int* out) {
  return nv == 5 ? probe_occ(uelems_kernel<5>, out)
       : nv == 6 ? probe_occ(uelems_kernel<6>, out)
                 : probe_occ(uelems_kernel<8>, out);
}
"""

BLOCK = "constexpr int kBlock = 128;"

#: variant -> [(old, new)] edits of csrc/uelems.cu
VARIANTS = {f"block{n}": [(BLOCK, f"constexpr int kBlock = {n};")]
            for n in (64, 256, 512)}


def probe(changes, append=""):
    """Build a copy of the tree's csrc/uelems.cu with `changes` made and
    `append` appended; returns (the ctypes library, its ptxas log)."""
    def edit(fname, text):
        if fname != "uelems.cu":
            return text
        for old, new in changes:
            if text.count(old) != 1:
                raise SystemExit(f"{WHO}: {old!r} is not in uelems.cu once")
            text = text.replace(old, new)
        return text + append
    return kt.probe_build("uelems", edit, WHO)


class using:
    """The wrapper launches through the probe library `lib` in place of
    the built one inside this context."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from icon_rt_tpu_torch.utils import cuda_build
        self.saved = cuda_build._BUILT.pop("uelems", None)
        cuda_build._BUILT["uelems"] = {"lib": self.lib, "seconds": 0.0,
                                       "log": ""}

    def __exit__(self, *exc):
        from icon_rt_tpu_torch.utils import cuda_build
        cuda_build._BUILT.pop("uelems")
        if self.saved is not None:
            cuda_build._BUILT["uelems"] = self.saved


def occupancy(lib, nv):
    """{blocks_per_sm, registers, local_bytes, block} of the library's
    kernel of nv vertices."""
    import ctypes
    out = (ctypes.c_int * 4)()
    fn = lib.uelems_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(nv, out)
    if err:
        raise SystemExit(f"{WHO}: occupancy query failed ({err})")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2], "block": out[3]}


def device_times(cs, call, m, tag):
    """{kernel_ms, device_ms} a call, from WINDOW[m] calls in one profiled
    window (None where the profiler lost them)."""
    n = WINDOW[m]
    try:
        prof = kt.profiled(cs, lambda: [call() for _ in range(n)],
                           (KERNEL,), tag)
    except AssertionError as e:
        print(f"{WHO} {tag}: {e}", flush=True)
        return {"kernel_ms": None, "device_ms": None}
    return {"kernel_ms": prof["by_name"].get(KERNEL, 0.0) / n,
            "device_ms": prof["device_ms"] / n,
            "device_kernels": sorted(prof["by_name"])}


def measure(root, variants):
    sys.path.insert(0, os.path.abspath(root))
    import inspect
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{WHO}: no CUDA card")
    from icon_rt_tpu_torch.ops import uelems
    if not uelems.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"{WHO}: imported {uelems.__file__}, not the "
                         f"package under {root}")
    cs = kt.chip_smoke()
    dev = torch.device("cuda", 0)
    has_out = "out" in inspect.signature(uelems.uelems_points).parameters
    has_occ = hasattr(uelems, "uelems_occupancy")
    with ThreadPoolExecutor(2 + (len(VARIANTS) if variants else 0)) as ex:
        built = ex.submit(uelems.build_uelems)
        query = ex.submit(probe, [], "" if has_occ else _QUERY)
        vfuts = {k: ex.submit(probe, ch) for k, ch in VARIANTS.items()} \
            if variants else {}
        built.result()
        q_lib, q_log = query.result()
        vlibs, failed = {}, {}
        for k, f in vfuts.items():
            try:
                vlibs[k] = f.result()
            except SystemExit as e:       # a variant that does not build
                failed[k] = {"error": str(e)[-2000:]}
    out = {"root": os.path.abspath(root), "card": kt.card(),
           "out_param": has_out, "ptxas": cs.ptxas_lines(q_log, KERNEL),
           "occupancy": {nv: occupancy(q_lib, nv) for nv in NVS}}
    if variants:
        out["variants"] = {k: {"ptxas": cs.ptxas_lines(log, KERNEL),
                               "occupancy": {nv: occupancy(lib, nv)
                                             for nv in NVS}}
                           for k, (lib, log) in vlibs.items()}
        out["variants"].update(failed)
    for m in SIZES:
        for nv in NVS:
            key = f"nv{nv}_{m}"
            P, V, S = cs.uelems_inputs(nv, m, dev, nv)
            call = lambda: uelems.uelems_points(P, V, S)
            hk, vk = call()
            hp, vp, it = uelems.newton(P, V, S, return_iters=True)
            n_in = int(hp.sum())
            bnd = cs.uelems_bound(nv, m, n_in, int(it.sum()))
            r = {"points": m, "nv": nv, "hash": kt.digest(hk, vk),
                 "equal_plain": bool(torch.equal(hk, hp)
                                     and torch.equal(vk, vp)),
                 "dtype": str(hk.dtype), "inside_share": n_in / m,
                 "iters_mean": float(it.double().mean()),
                 "iters_sum": int(it.sum()), "bound_ms": bnd[0],
                 "bound_by": bnd[1], "bound_bytes_ms": cs.uelems_bound(
                     nv, m, n_in, 0)[0],
                 "ms": events_ms(call, reps=REPS[m])}
            del hp, vp, it
            if has_out:
                o = (torch.empty(m, dtype=torch.bool, device=dev),
                     torch.empty(m, dtype=torch.float32, device=dev))
                r["out_ms"] = events_ms(
                    lambda: uelems.uelems_points(P, V, S, out=o),
                    reps=REPS[m])
            r.update(device_times(cs, call, m, f"K9-n {key}"))
            if r["kernel_ms"]:
                r["bound_share"] = bnd[0] / r["kernel_ms"]
            for name, (lib, _) in vlibs.items():
                with using(lib):
                    h2, v2 = call()
                    vr = {"hash": kt.digest(h2, v2),
                          "equal_built": bool(torch.equal(h2, hk)
                                              and torch.equal(v2, vk))}
                    vr.update(device_times(cs, call, m,
                                           f"K9-n {name} {key}"))
                out["variants"][name][key] = vr
            out[key] = r
            print(f"{WHO} {key} " + json.dumps(r), flush=True)
            del P, V, S, hk, vk
            torch.cuda.empty_cache()
    print(f"{WHO} " + json.dumps(out), flush=True)


def turns(trees):
    runs = kt.turns(__file__, WHO, trees, [])
    rnd = lambda x: None if x is None else round(x, 5)
    for root in trees:
        mine = runs[root]
        for m in SIZES:
            for nv in NVS:
                k = f"nv{nv}_{m}"
                print(f"{WHO} summary {root}: {k} events "
                      f"{[rnd(r[k]['ms']) for r in mine]}, out= "
                      f"{[rnd(r[k].get('out_ms')) for r in mine]}, kernel "
                      f"{[rnd(r[k]['kernel_ms']) for r in mine]}, device "
                      f"{[rnd(r[k]['device_ms']) for r in mine]}, bound "
                      f"{rnd(mine[0][k]['bound_ms'])} "
                      f"({mine[0][k]['bound_by']}), hash "
                      f"{[r[k]['hash'] for r in mine]}, equal to plain "
                      f"{[r[k]['equal_plain'] for r in mine]}", flush=True)
        print(f"{WHO} summary {root}: occupancy "
              f"{mine[0]['occupancy']}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=kt.HERE,
                    help="the tree whose package to time")
    ap.add_argument("--turns", nargs="+", metavar="TREE",
                    help="time two or more trees in turns, forth and back "
                         "(A, B, B, A)")
    ap.add_argument("--variants", action="store_true",
                    help="probe builds of other designs (this tree only)")
    args = ap.parse_args()
    if args.turns:
        if len(args.turns) < 2:
            ap.error("--turns takes two or more trees")
        turns(args.turns)
    else:
        measure(args.root, args.variants)


if __name__ == "__main__":
    main()
