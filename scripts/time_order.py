#!/usr/bin/env python
"""K6 `chord_keys` and `pixel_order`, and K6b `refine_perm` and
`refine_order_device`, on the card at 1920x1080: each one's time, its
device time, its bound and its output hashes, for one tree of the
repository or two or more in turns.

    python scripts/time_order.py                  # this tree
    python scripts/time_order.py --turns A B      # trees A, B, B, A

Each tree runs in a process of its own that imports that tree's
icon_rt_tpu_torch (its kernels build into the tree's own _build/).  At
the bench's closeup (`frame_camera(stats, "closeup", ...)`) of two
scenes: R2B8, chip_smoke.py's `Scene(8, 16, ...)` (1,310,720 columns),
and R2B9, the stats of `synth_quantized_device(11, 16)` (83,886,080
columns, the scene main r2b9q renders):

  1. K6 as the tree's `chord_keys` runs it on the launch params' camera
     (a tree whose K6 returns the keys alone counts nothing in it):
     CUDA events around REPS calls after a warm one (`ms`: the kernel
     with the wrapper's host work), and a profiled window of PROF_CALLS
     calls under chip_smoke.py's `profile_window` (`kernel_ms`: the
     kernel's device time a call; `device_ms`: every device event's, the
     count's memset included); its bound (chip_smoke.py's K6 row: the
     keys and the count written, the camera read, at 3.35 TB/s);
  2. `pixel_order` as a whole, from the camera to n_covered on the host:
     the host's clock over REPS calls (each call ends in its read), the
     device syncs of one call and the device events a call runs;
  3. on R2B8 only, K6b on the covered prefix (1,193,007 lanes) re-sorted
     by the cost of one SPL-sample f32 launch (render_frame_fast's
     return_cost; the same K1 in every tree): `refine_perm` with the
     sort's indices as the tree's `refine_order_device` hands them over
     (int64 where the tree takes them, else int32), and with int32 where
     the tree takes int64 too; `refine_order_device` as a whole; and
     `torch.cat([head.index_select(0, order), tail])`, the library's
     refine_perm, in the same process; each timed as in 1 (`kernel_ms`
     of refine_perm's kernel, of the library's gather) beside its bound
     (bytes: the order read a covered lane, perm read and the permutation
     written a lane; refine_order_device's adds refine_keys' 12 bytes a
     covered lane and leaves the sort out); and the other two K6b
     kernels, as every tree runs them: `refine_keys` (bound 12 bytes a
     covered lane) and `repermute_device` of an 8-sample frame's accum
     and fb into the re-sorted order (48 bytes a lane).

Every output is hashed (sha256 of its bytes: trees that compute the same
bits print the same hashes).  Each process prints a `time_order {json}`
line; --turns prints a summary of each tree's runs after them.  Needs a
CUDA card: without one it exits non-zero.
"""
import argparse
import os
import sys
import time

import kernel_timing as kt

W, H = 1920, 1080
REPS = 200
PROF_CALLS = 10
SPL = 8
HBM = 3.35e12
WHO = "time_order"


def bound_ms(nbytes):
    return nbytes / HBM * 1e3


def profiled_call(cs, call, kernel, tag):
    """(the device ms of `kernel`, of every device event) a call, from one
    profiled window of PROF_CALLS calls; (None, None) where the profiler
    lost the kernel in every window."""
    try:
        prof = kt.profiled(cs, lambda: [call() for _ in range(PROF_CALLS)],
                           (kernel,), tag)
    except AssertionError as e:
        print(f"{tag}: {e}", flush=True)
        return None, None
    k = sum(ms for name, ms in prof["by_name"].items() if kernel in name)
    return k / PROF_CALLS, prof["device_ms"] / PROF_CALLS


def timed(cs, call, kernel, tag, nbytes):
    """{"ms", "kernel_ms", "device_ms", "bound_ms", "hash"} of `call`."""
    import torch
    out = call()
    out = out if isinstance(out, tuple) else (out,)
    r = {"ms": kt.events_ms(call, reps=REPS), "bound_ms": bound_ms(nbytes),
         "hash": kt.digest(*out)}
    r["kernel_ms"], r["device_ms"] = profiled_call(cs, call, kernel, tag)
    torch.cuda.synchronize()
    return r


def host_call(call):
    """{"ms": host ms a call over REPS calls after a warm one, "host_reads":
    the device syncs of one call}."""
    import torch
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / REPS * 1e3
    reads, _ = kt.host_reads(call)
    return {"ms": ms, "host_reads": reads}


def keys_call(order, lp, r_in, r_out):
    """K6 as the tree runs it: () -> (keys, count) where its kernel takes
    the count, else () -> keys."""
    if hasattr(order, "_camera"):
        cam = order._camera(lp)
        return lambda: order.chord_keys(cam, r_in, r_out, W, H)
    cam = order._camera_vector(lp)
    return lambda: order.chord_keys(cam, r_in, r_out, W, H)


def measure_camera(cs, order, lp, stats, tag):
    import torch
    r_in, r_out = stats.spherical_bounds_lo[0], stats.spherical_bounds_hi[0]
    call = keys_call(order, lp, r_in, r_out)
    got = call()
    keys = got[0] if isinstance(got, tuple) else got
    n_cov = int(torch.isfinite(keys).sum())
    k6 = timed(cs, call, "chord_keys_kernel", f"{WHO} {tag} K6",
               W * H * 4 + 4 + 48)
    k6["hash"] = kt.digest(keys)          # the keys alone in every tree
    po = lambda: order.pixel_order(lp, r_in, r_out, W, H)
    perm, n = po()
    whole = host_call(po)
    try:
        _, timeline = cs.profile_window(po, ("chord_keys_kernel",),
                                        f"{WHO} {tag} pixel_order")
        whole["device_events"] = [cs.short_name(e[0]) for e in timeline]
        whole["device_ms"] = sum(e[2] for e in timeline)
    except AssertionError as e:
        print(f"{WHO} {tag} pixel_order: {e}", flush=True)
    whole["hash"] = kt.digest(perm)
    whole["n_covered"] = n
    if n != n_cov:
        raise SystemExit(f"{WHO} {tag}: pixel_order's n_covered {n} is not "
                         f"the count of finite keys {n_cov}")
    return {"n_covered": n, "k6": k6, "pixel_order": whole}


def measure_refine(cs, order, sc, dev):
    import torch
    from icon_rt_tpu_torch.ops import fast
    from icon_rt_tpu_torch.ops.render import alloc_frame
    perm, n = sc.perm, sc.n_cov
    acc, fb = alloc_frame(W, H, device=dev)
    _, _, cost = fast.render_frame_fast(
        sc.cells, sc.packed, sc.loc, sc.bands, sc.lp, acc, fb, width=W,
        height=H, pixel_perm=perm, n_active=n, samples=SPL, return_cost=True)
    keys = order.refine_keys(perm, n, cost)
    srt = torch.sort(keys, stable=True).indices
    takes_64 = hasattr(order, "_camera")    # the CUDA C++ K6b refine_perm
    srt32 = srt.to(torch.int32)
    head, tail = perm[:n], perm[n:]
    lanes = perm.shape[0]
    out = {"n_active": n, "lanes": lanes, "cost_hash": kt.digest(cost),
           "order_dtype": "int64" if takes_64 else "int32"}
    out["refine_perm"] = timed(
        cs, lambda: order.refine_perm(perm, n, srt if takes_64 else srt32),
        "refine_perm_kernel", f"{WHO} refine_perm",
        (8 if takes_64 else 4) * n + 8 * lanes)
    if takes_64:
        out["refine_perm_int32"] = timed(
            cs, lambda: order.refine_perm(perm, n, srt32),
            "refine_perm_kernel", f"{WHO} refine_perm int32",
            4 * n + 8 * lanes)
    out["refine_order_device"] = timed(
        cs, lambda: order.refine_order_device(perm, n, cost),
        "refine_perm_kernel", f"{WHO} refine_order_device",
        12 * n + 8 * n + 8 * lanes)
    out["index_select_cat"] = timed(
        cs, lambda: torch.cat([head.index_select(0, srt), tail]),
        "scatter_gather", f"{WHO} index_select + cat", 8 * n + 8 * lanes)
    out["refine_keys"] = timed(
        cs, lambda: order.refine_keys(perm, n, cost), "refine_keys_kernel",
        f"{WHO} refine_keys", 12 * n)
    new = order.refine_order_device(perm, n, cost)
    inv = order.inverse_order(perm)
    out["repermute"] = timed(
        cs, lambda: order.repermute_device(acc, fb, new, inv),
        "repermute_kernel", f"{WHO} repermute", 48 * lanes)
    del acc, fb
    want = torch.from_numpy(order.refine_order(
        perm.cpu().numpy(), n, cost.cpu().numpy())).to(dev)
    out["equal_refine_order"] = all(
        torch.equal(f(), want) for f in (
            lambda: order.refine_perm(perm, n, srt if takes_64 else srt32),
            lambda: order.refine_order_device(perm, n, cost),
            lambda: torch.cat([head.index_select(0, srt), tail])))
    return out


def measure(root):
    sys.path.insert(0, os.path.abspath(root))
    import json
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{WHO}: no CUDA card")
    from icon_rt_tpu_torch.ops import order
    if not order.__file__.startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"{WHO}: imported {order.__file__}, not the "
                         f"package under {root}")
    from icon_rt_tpu_torch.data.device_scene import synth_quantized_device
    cs = kt.chip_smoke()
    dev = torch.device("cuda", 0)
    out = {"root": os.path.abspath(root), "card": kt.card()}
    sc = cs.Scene(8, 16, W, H, dev)
    out["r2b8"] = measure_camera(cs, order, sc.lp, sc.stats, "r2b8")
    out["refine"] = measure_refine(cs, order, sc, dev)
    del sc
    torch.cuda.empty_cache()
    stats9 = synth_quantized_device(11, 16, device=dev).stats
    torch.cuda.empty_cache()
    lp9, _, _ = cs.r2b9_frame(stats9, W, H, dev)
    out["r2b9"] = measure_camera(cs, order, lp9, stats9, "r2b9")
    print(f"{WHO} " + json.dumps(out), flush=True)


def turns(trees):
    runs = kt.turns(__file__, WHO, trees, [])
    for root in trees:
        mine = runs[root]
        for cam in ("r2b8", "r2b9"):
            for part in ("k6", "pixel_order"):
                rs = [r[cam][part] for r in mine]
                print(f"{WHO} summary {root}: {cam} {part} ms "
                      f"{[round(r['ms'], 4) for r in rs]}, kernel "
                      f"{[r.get('kernel_ms') for r in rs]}, device "
                      f"{[r.get('device_ms') for r in rs]}, host reads "
                      f"{[r.get('host_reads') for r in rs]}, device events "
                      f"{[r.get('device_events') for r in rs]}, hash "
                      f"{[r['hash'] for r in rs]}, n_covered "
                      f"{[r[cam]['n_covered'] for r in mine]}")
        for part in ("refine_perm", "refine_perm_int32",
                     "refine_order_device", "index_select_cat",
                     "refine_keys", "repermute"):
            rs = [r["refine"].get(part) for r in mine]
            if None in rs:
                continue
            print(f"{WHO} summary {root}: {part} ms "
                  f"{[round(r['ms'], 4) for r in rs]}, kernel "
                  f"{[r['kernel_ms'] for r in rs]}, device "
                  f"{[r['device_ms'] for r in rs]}, bound "
                  f"{round(rs[0]['bound_ms'], 4)}, hash "
                  f"{[r['hash'] for r in rs]}")
        print(f"{WHO} summary {root}: refine equal to refine_order "
              f"{[r['refine']['equal_refine_order'] for r in mine]}, cost "
              f"hash {[r['refine']['cost_hash'] for r in mine]}")


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
