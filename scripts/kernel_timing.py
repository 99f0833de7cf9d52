"""What scripts/time_track.py, time_scene_march.py and time_parity.py share:
this repository's chip_smoke.py loaded beside the tree being measured,
CUDA-event and profiled timings, the host reads of a call, output hashes,
probe builds (a copy of the tree's csrc/ with a query or clock64()
counters added, built into the tree's _build/ and not kept) and runs of
two or more trees in turns.

Nothing here imports the port at load time: a script puts the tree it
measures first on sys.path, then calls these.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_file(name, path):
    """A module of this repository loaded from its file, so that the tree
    being measured keeps the first place on sys.path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    keep = list(sys.path)
    spec.loader.exec_module(mod)
    sys.path[:] = keep
    return mod


def chip_smoke():
    """This repository's chip_smoke.py as a module (`profile_window`,
    `main_path`, `divergence`, `ptxas_lines`, ...)."""
    return load_file("chip_smoke", os.path.join(HERE, "chip_smoke.py"))


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]


def digest(*tensors):
    """A short sha256 of the tensors' bytes: trees that compute the same
    bits print the same hash."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def events_ms(call, reps=5):
    """Mean ms of `reps` calls, CUDA events around them (one warm call
    first)."""
    import torch
    call()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profiled(cs, call, require, tag):
    """{"profiled_wall_ms", "device_ms", "busy_ms", "idle_share",
    "by_name"} of one `call` under chip_smoke.py's `profile_window`."""
    wall, timeline = cs.profile_window(call, require, tag)
    by_name = {}
    for name, _, ms in timeline:
        k = cs.short_name(name)
        by_name[k] = by_name.get(k, 0.0) + ms
    busy, end = 0.0, -float("inf")
    for _, a, ms in sorted(timeline, key=lambda x: x[1]):
        if a + ms > end:
            busy += a + ms - max(a, end)
            end = a + ms
    return dict(profiled_wall_ms=wall,
                device_ms=sum(ms for _, _, ms in timeline), busy_ms=busy,
                idle_share=1.0 - busy / wall,
                by_name={k: round(v, 4) for k, v in by_name.items()})


def kernel_times(cs, call, kernel, tag, reps=10):
    """{"ms": events ms, "kernel_ms": profiled kernel ms} of `call`; the
    kernel's ms is None where the profiler lost its events in every
    window."""
    ms = events_ms(call, reps=reps)
    try:
        prof = profiled(cs, call, (kernel,), tag)
    except AssertionError as e:
        print(f"{tag}: {e}", flush=True)
        return {"ms": ms, "kernel_ms": None}
    return {"ms": ms, "kernel_ms": prof["by_name"].get(kernel)}


def host_reads(call):
    """(device syncs of one `call` under set_sync_debug_mode("warn"), the
    call's host wall ms up to its return)."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            call()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's own notice, once a process, that it is a prototype is not
    # a read
    return sum("synchroniz" in str(w.message)
               and "prototype" not in str(w.message) for w in got), wall


# ---------------------------------------------------------------------------
# Probe builds
# ---------------------------------------------------------------------------

def matching_brace(src, i, who):
    """The index of the brace that closes the one at src[i]."""
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return j
    raise SystemExit(f"{who}: unbalanced braces")


def function_body(src, head, who):
    """(i, j): src[i] is the brace that opens the body of the first
    function whose text starts with `head`, src[j] the one that closes
    it."""
    i = src.index("{", src.index(head))
    return i, matching_brace(src, i, who)


def probe_build(name, edit, who):
    """Build csrc/<name>.cu of the imported tree from a copy of its csrc/
    in which each .cu and .cuh source went through edit(file name, text)
    -> text, with build's flags; returns (the ctypes library, its ptxas
    log)."""
    import ctypes
    from icon_rt_tpu_torch.utils import cuda_build
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cuda_build.BUILD_DIR, prefix=f"probe_{name}_")
    for f in os.listdir(cuda_build.CSRC):
        if f.endswith((".cuh", ".cu")):
            with open(os.path.join(cuda_build.CSRC, f)) as src:
                text = edit(f, src.read())
            with open(os.path.join(tmp, f), "w") as out:
                out.write(text)
    so = os.path.join(tmp, f"lib{name}.so")
    res = subprocess.run(
        [cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
         "-Xcompiler", "-fPIC", "-I", tmp, "-o", so,
         os.path.join(tmp, f"{name}.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"{who}: the probe build of {name}.cu failed:\n"
                         f"{res.stderr[-3000:]}")
    return ctypes.CDLL(so), res.stderr


#: the probe libraries' counters: `slots` unsigned 64-bit sums for each
#: of 64 block slots (blockIdx.x % 64), read by probe_read(out) and zeroed
#: by probe_zero()
PROBE_BLOCKS = 64


def probe_sums(name, lib, call, slots, zero=None):
    """One `call` of the kernel of csrc/<name>.cu through the probe
    library `lib` in place of the built one, after one call that binds its
    entry points: each counter summed over the block slots.  `zero()`
    zeroes the counters (lib.probe_zero() where None)."""
    import ctypes
    import torch
    from icon_rt_tpu_torch.utils import cuda_build
    saved = cuda_build._BUILT.pop(name, None)
    cuda_build._BUILT[name] = {"lib": lib, "seconds": 0.0, "log": ""}
    try:
        call()
        torch.cuda.synchronize()
        (zero or lib.probe_zero)()
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (PROBE_BLOCKS * slots))()
        lib.probe_read(buf)
    finally:
        cuda_build._BUILT.pop(name)
        if saved is not None:
            cuda_build._BUILT[name] = saved
    return [sum(buf[b * slots + k] for b in range(PROBE_BLOCKS))
            for k in range(slots)]


# ---------------------------------------------------------------------------
# Trees in turns
# ---------------------------------------------------------------------------

def turns(script, prefix, trees, args):
    """`script --root TREE *args` for each tree of `trees` in turns, forth
    and back (A, B, B, A for two), each in a process of its own; echoes
    each run's output and returns {tree: the JSON of the last `prefix
    {...}` line of each of its runs}."""
    runs = []
    for root in list(trees) + list(reversed(trees)):
        res = subprocess.run([sys.executable, os.path.abspath(script),
                              "--root", root] + list(args),
                             capture_output=True, text=True)
        sys.stdout.write(res.stdout)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            raise SystemExit(f"{prefix}: {root} exited {res.returncode}")
        line = [x for x in res.stdout.splitlines()
                if x.startswith(prefix + " {")][-1]
        runs.append(json.loads(line[len(prefix) + 1:]))
    return {root: [r for r in runs if r["root"] == os.path.abspath(root)]
            for root in trees}
