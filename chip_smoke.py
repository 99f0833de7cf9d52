#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (icon_rt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints lines starting with its tag; any failure raises and the
script exits non-zero without printing a result):

  env     the card's name and power limit; there is no CPU fallback
  build   the nvcc build of K1 (csrc/track_f32.cu) and the first Triton
          compile of K5a, K5b and K6, with their seconds
  check   every kernel against its plain PyTorch version on the card, at
          subdiv 5 x 16 layers, 256x256, closeup camera:
            K1  samples=4, both preserve_cache settings: fb identical on
                >= 99.9% of pixels, accum max-abs-diff <= 1e-6
            K5a <= 1 ULP    K5b exact    K6 keys <= 1 ULP, same n_covered
  main    the app's main path (icon_rt_tpu_torch.app.build, then the
          launch / is_running / present loop of apps/icon_rt.py) at subdiv
          8 x 16 layers, 1920x1080, 16 samples (8 per launch), closeup
          camera of bench.py; the launch counters of all four kernels are
          zeroed before and read after, the image must cover >= 0.5 of the
          frame; then the same loop runs on to 128 samples, and the median
          and spread of the steady launches' wall time (fb copied to the
          host) give the end-to-end rate
  time    each kernel against its plain version at the main path's shapes
          and launch arguments (same tolerances as `check`), both timed
          with CUDA events
  profile one steady launch under torch.profiler: device time by kernel
          and the device's idle share of the launch's wall time

The last lines are the card's `nvidia-smi` name and power limit, one JSON
line {"kernels": [...]}, and {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SMOKE_SUB, SMOKE_LAYERS, SMOKE_W = 5, 16, 256
MAIN_SUB, MAIN_LAYERS, MAIN_W, MAIN_H = 8, 16, 1920, 1080
MAIN_LIMIT, MAIN_SPL = 16, 8
STEADY_LIMIT = 128          # the main path continued to 16 launches in all
ACCUM_TOL = 1e-6            # K1 accum max-abs-diff against its plain version
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


def closeup_camera(stats, width, height):
    """bench.py's closeup pose (bench.py:205-222): the globe slightly
    overfills the frame vertically."""
    from icon_rt_tpu_torch.ops.camera import Camera
    cam = Camera()
    cam.set_aspect(width / height)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r_out = float(stats.spherical_bounds_hi[0])
    theta = np.arctan(1.15 * np.tan(0.5 * cam.fovy))
    d = r_out / np.sin(theta)
    direction = np.array([2.2, 0.4, 0.9], np.float32)
    direction /= np.linalg.norm(direction)
    cam.set_orientation(center + direction * d, center,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    return cam


def ulp_diff(a, b):
    """Max distance in units in the last place between two f32 tensors
    (inf == inf counts as 0)."""
    import torch
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def time_cuda(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over `reps` calls, CUDA events around the run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


class Scene:
    """Tables of one synthetic scene on one device, built through the
    port's public builders (so the kernels run where dev is CUDA)."""

    def __init__(self, sub, layers, width, height, dev):
        from icon_rt_tpu_torch.data import synthetic
        from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
        from icon_rt_tpu_torch.models.locator import build_locator
        from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                                     update_band_majorants)
        from icon_rt_tpu_torch.models.transfunc import make_transfunc
        from icon_rt_tpu_torch.ops.fast import pack_cells
        from icon_rt_tpu_torch.ops.order import pixel_order
        from icon_rt_tpu_torch.ops.render import make_launch_params
        ds = synthetic.icosphere(sub, layers)
        self.stats = stats = compute_stats(ds)
        self.cells = build_cells(ds, device=dev)
        self.loc = build_locator(ds, device=dev)
        self.tf = make_transfunc(value_range=tuple(stats.data_range),
                                 device=dev)
        self.bands = update_band_majorants(
            build_radial_bands(ds, 64, device=dev), self.tf.values,
            self.tf.value_range)
        self.packed = pack_cells(self.cells, self.tf)
        cam = closeup_camera(stats, width, height)
        ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
        self.lp = make_launch_params(cam.basis(width, height),
                                     stats.world_bounds_lo,
                                     stats.world_bounds_hi, unit_distance=ud,
                                     device=dev)
        self.perm, self.n_cov = pixel_order(
            self.lp, stats.spherical_bounds_lo[0],
            stats.spherical_bounds_hi[0], width, height)
        self.width, self.height = width, height


def check_kernels(dev, sub=SMOKE_SUB, layers=SMOKE_LAYERS, size=SMOKE_W):
    """Each kernel against its plain version on the same inputs.
    Returns {kernel name: max_abs_err}."""
    import torch
    from icon_rt_tpu_torch.models.accel import compute_max_opacities_torch
    from icon_rt_tpu_torch.ops import fast
    from icon_rt_tpu_torch.ops.order import _camera_vector, _chord_keys_torch
    from icon_rt_tpu_torch.ops.render import alloc_frame

    sc = Scene(sub, layers, size, size, dev)
    errs = {}
    prof_p, rgb_p = fast._profile_rows_torch(
        sc.cells.height, sc.cells.value, sc.cells.num_layers, sc.tf)
    u = max(ulp_diff(sc.packed.prof, prof_p), ulp_diff(sc.packed.rgb, rgb_p))
    errs["classify_bake"] = float(max(
        (sc.packed.prof - prof_p).nan_to_num(posinf=0.0).abs().max(),
        (sc.packed.rgb - rgb_p).abs().max()))
    print(f"check K5a classify_bake: max {u} ULP, max abs err "
          f"{errs['classify_bake']:.3e}")
    if u > 1:
        raise AssertionError(f"K5a differs from its plain version by {u} ULP")

    mo_p = compute_max_opacities_torch(sc.bands.value_ranges, sc.tf.values,
                                       sc.tf.value_range)
    errs["max_opacity"] = float((sc.bands.max_opacities - mo_p).abs().max())
    print(f"check K5b max_opacity: max abs err {errs['max_opacity']:.3e}")
    if not torch.equal(sc.bands.max_opacities, mo_p):
        raise AssertionError("K5b differs from its plain version")

    st = sc.stats
    f32 = lambda v: torch.tensor(float(np.float32(v)), device=dev)
    keys_p = _chord_keys_torch(_camera_vector(sc.lp),
                               f32(st.spherical_bounds_lo[0]),
                               f32(st.spherical_bounds_hi[0]), size, size)
    from icon_rt_tpu_torch.ops.order import chord_keys
    keys_k = chord_keys(_camera_vector(sc.lp), st.spherical_bounds_lo[0],
                        st.spherical_bounds_hi[0], size, size)
    n_cov_p = int(torch.isfinite(keys_p).sum())
    fin = torch.isfinite(keys_p)
    u = ulp_diff(keys_k[fin], keys_p[fin])
    errs["chord_keys"] = float((keys_k[fin] - keys_p[fin]).abs().max())
    print(f"check K6 chord_keys: max {u} ULP, n_covered {sc.n_cov} vs "
          f"{n_cov_p}")
    if u > 1 or n_cov_p != sc.n_cov or not torch.equal(
            torch.isfinite(keys_k), fin):
        raise AssertionError("K6 differs from its plain version")

    k1 = 0.0
    for preserve in (True, False):
        outs = []
        for kernel in (True, False):
            acc, fb = alloc_frame(size, size, device=dev)
            args = (sc.packed, sc.loc, sc.bands, sc.lp,
                    sc.perm[:sc.n_cov].contiguous(), acc[:sc.n_cov],
                    fb[:sc.n_cov])
            if kernel:
                fast.track_f32(*args, width=size, height=size, samples=4,
                               preserve_cache=preserve)
            else:
                fast._render_frame_fast_torch(*args, size, size, 4, preserve)
            torch.cuda.synchronize(dev) if dev.type == "cuda" else None
            outs.append((acc, fb))
        (ak, fk), (ap, fp) = outs
        same = float((fk == fp).float().mean())
        err = float((ak - ap).abs().max())
        k1 = max(k1, err)
        print(f"check K1 track_f32 samples=4 preserve_cache={preserve}: fb "
              f"identical on {same:.6f} of {size * size} pixels, accum "
              f"max abs diff {err:.3e}")
        if same < 0.999 or not err <= ACCUM_TOL:
            raise AssertionError("K1 disagrees with its plain version")
    errs["track_f32"] = k1
    return errs


def main_path(dev):
    """Run the app's main path with zeroed launch counters; returns
    (pipeline, counts, metrics)."""
    import torch
    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models import accel
    from icon_rt_tpu_torch.models.cells import compute_stats
    from icon_rt_tpu_torch.ops import fast, order

    stats = compute_stats(synthetic.icosphere(MAIN_SUB, MAIN_LAYERS))
    cam = closeup_camera(stats, MAIN_W, MAIN_H)
    pose = [*cam.position, *cam.get_poi(), *cam.up_vector]
    os.makedirs(OUT_DIR, exist_ok=True)
    argv = ["--device", dev.type, "--synthetic",
            f"{MAIN_SUB}:{MAIN_LAYERS}", "--size", str(MAIN_W), str(MAIN_H),
            "--sample-limit", str(MAIN_LIMIT), "--samples", str(MAIN_SPL),
            "--camera", *[repr(float(v)) for v in pose],
            "-fovy", repr(float(cam.get_fovy_degrees())),
            "-o", os.path.join(OUT_DIR, "chip_smoke")]

    def run_loop(launch_ms):
        """The launch / is_running loop of apps/icon_rt.py; appends each
        launch's wall time in ms, fb copied to the host before the clock
        is read."""
        while True:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            pl.launch()
            np.asarray(pl._last_fb.cpu())          # output on the host
            e1.record()
            torch.cuda.synchronize()
            launch_ms.append(e0.elapsed_time(e1))
            if not pl.is_running():
                return

    accel.launches = 0
    order.launches = 0
    for k in fast.launches:
        fast.launches[k] = 0
    t0 = time.perf_counter()
    pl = app.build(argv)
    build_s = time.perf_counter() - t0
    launch_ms = []
    run_loop(launch_ms)
    n_launch = len(launch_ms)
    t1 = time.perf_counter()
    pl.present()
    present_s = time.perf_counter() - t1
    counts = {"track_f32": fast.launches["track_f32"],
              "classify_bake": fast.launches["classify_bake"],
              "max_opacity": accel.launches, "chord_keys": order.launches}
    print(f"main build {build_s:.3f} s (scene, locator, tables on the "
          f"card); launches {n_launch}, ms per launch "
          f"{[round(x, 3) for x in launch_ms]}; present {present_s:.3f} s")
    print(f"main launch counts {json.dumps(counts)}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"main path did not launch {name}")
    if counts["track_f32"] != n_launch:
        raise AssertionError(f"K1 launched {counts['track_f32']} times in "
                             f"{n_launch} launches")

    frame = pl.frame
    acc = frame["accum"]
    if tuple(acc.shape) != (MAIN_W * MAIN_H, 4) \
            or not bool(torch.isfinite(acc).all()):
        raise AssertionError("main path accum is not finite (W*H, 4)")
    fb = frame["fb"].cpu().numpy().view(np.uint32)
    covered = float(((fb >> 24) > 0).mean())
    n_active = frame["n_active"]
    print(f"main image covered fraction {covered:.4f} (K6 covered prefix "
          f"{n_active} of {MAIN_W * MAIN_H} lanes)")
    if covered < 0.5:
        raise AssertionError(f"image covers only {covered:.3f} of the frame")

    # the same loop on to STEADY_LIMIT samples; every launch but the first
    # (which orders the rays and bakes the tables) is a steady one
    pl.sample_limit = STEADY_LIMIT
    run_loop(launch_ms)
    steady = np.array(launch_ms[1:])
    med = float(np.median(steady))
    mray = MAIN_W * MAIN_H * MAIN_SPL / (med * 1e-3) / 1e6
    print(f"main steady launches {len(steady)} ({MAIN_SPL} samples each, "
          f"to {STEADY_LIMIT} samples): ms per launch median {med:.3f}, "
          f"min {steady.min():.3f}, max {steady.max():.3f}; all "
          f"{[round(x, 3) for x in launch_ms]}")
    print(f"main end-to-end full-frame rate {mray:.3f} Mray/s (median "
          f"launch wall time, fb copied to the host)")
    return pl, counts, {"build_s": build_s, "launch_ms": launch_ms,
                        "mray_s": mray, "covered": covered}


def time_kernels(pl, errs, counts):
    """Each kernel and its plain version at the main path's shapes."""
    import torch
    from icon_rt_tpu_torch.models.accel import (compute_max_opacities_torch,
                                                max_opacity)
    from icon_rt_tpu_torch.ops import fast
    from icon_rt_tpu_torch.ops.order import (_camera_vector,
                                             _chord_keys_torch, chord_keys)
    from icon_rt_tpu_torch.ops.render import alloc_frame, make_launch_params

    s = pl.scene
    cells, loc, stats = s["cells"], s["locator"], s["stats"]
    packed, bands, tf = s["get_packed"](), s["get_bands"](), s["tf"]()
    frame = pl.frame
    W, H = MAIN_W, MAIN_H
    dev = cells.height.device
    lp = make_launch_params(s["camera"].basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi,
                            unit_distance=s["unit_distance"](), device=dev)
    n = frame["n_active"]
    pix = frame["perm"][:n].contiguous()
    rows = []

    def row(name, route, source, replaces, ms, plain_ms, **extra):
        rows.append(dict(name=name, route=route, source=source,
                         replaces=replaces, launches=counts[name],
                         max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         **extra))
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # K1 as the app launches it: MAIN_SPL samples, column cache kept
    acc, fb = alloc_frame(W, H, device=dev)
    k8 = time_cuda(lambda: fast.track_f32(
        packed, loc, bands, lp, pix, acc[:n], fb[:n], width=W, height=H,
        samples=MAIN_SPL, preserve_cache=True), reps=3)
    acc_k, fb_k = alloc_frame(W, H, device=dev)
    fast.track_f32(packed, loc, bands, lp, pix, acc_k[:n], fb_k[:n],
                   width=W, height=H, samples=MAIN_SPL, preserve_cache=True)
    acc_p, fb_p = alloc_frame(W, H, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast._render_frame_fast_torch(packed, loc, bands, lp, pix, acc_p[:n],
                                  fb_p[:n], W, H, MAIN_SPL, True)
    torch.cuda.synchronize()
    p8 = (time.perf_counter() - t0) * 1e3
    same = float((fb_k == fb_p).float().mean())
    err = float((acc_k - acc_p).abs().max())
    errs["track_f32"] = max(errs["track_f32"], err)
    print(f"time K1 full frame, {MAIN_SPL} samples, preserve_cache=True: fb "
          f"identical on {same:.6f} of {W * H} pixels, accum max abs diff "
          f"{err:.3e}")
    if same < 0.999 or not err <= ACCUM_TOL:
        raise AssertionError("K1 disagrees with its plain version at 1080p")
    print(f"time K1 kernel rate {W * H * MAIN_SPL / (k8 * 1e-3) / 1e6:.3f} "
          f"Mray/s full frame ({MAIN_SPL} samples, {k8:.3f} ms, no host "
          f"copy)")
    row("track_f32", "cuda", "icon_rt_tpu_torch/csrc/track_f32.cu",
        "icon_rt_tpu/ops/fast.py:451", k8, p8, samples=MAIN_SPL)

    args = (cells.height, cells.value, cells.num_layers, tf)
    prof_k, rgb_k = fast.classify_bake(cells, tf)
    prof_p, rgb_p = fast._profile_rows_torch(*args)
    u = max(ulp_diff(prof_k, prof_p), ulp_diff(rgb_k, rgb_p))
    errs["classify_bake"] = max(errs["classify_bake"], float(max(
        (prof_k - prof_p).nan_to_num(posinf=0.0).abs().max(),
        (rgb_k - rgb_p).abs().max())))
    print(f"time K5a at {cells.height.shape[0]} x 32: max {u} ULP")
    if u > 1:
        raise AssertionError(f"K5a differs from its plain version by {u} ULP"
                             f" at the main shape")
    del prof_k, rgb_k, prof_p, rgb_p
    kb = time_cuda(lambda: fast.classify_bake(cells, tf), reps=10)
    pb = time_cuda(lambda: fast._profile_rows_torch(*args), reps=3)
    row("classify_bake", "triton", "icon_rt_tpu_torch/ops/fast.py",
        "icon_rt_tpu/ops/fast.py:115", kb, pb)

    mo_args = (bands.value_ranges, tf.values, tf.value_range)
    if not torch.equal(max_opacity(*mo_args),
                       compute_max_opacities_torch(*mo_args)):
        raise AssertionError("K5b differs from its plain version at the "
                             "main shape")
    km = time_cuda(lambda: max_opacity(*mo_args), reps=50)
    pm = time_cuda(lambda: compute_max_opacities_torch(*mo_args), reps=20)
    row("max_opacity", "triton", "icon_rt_tpu_torch/models/accel.py",
        "icon_rt_tpu/models/accel.py:201", km, pm)

    cam = _camera_vector(lp)
    r_in, r_out = stats.spherical_bounds_lo[0], stats.spherical_bounds_hi[0]
    f32 = lambda v: torch.tensor(float(np.float32(v)), device=dev)
    kk = time_cuda(lambda: chord_keys(cam, r_in, r_out, W, H), reps=20)
    pk = time_cuda(lambda: _chord_keys_torch(cam, f32(r_in), f32(r_out),
                                             W, H), reps=10)
    keys_k = chord_keys(cam, r_in, r_out, W, H)
    keys_p = _chord_keys_torch(cam, f32(r_in), f32(r_out), W, H)
    fin = torch.isfinite(keys_p)
    if not torch.equal(torch.isfinite(keys_k), fin) \
            or ulp_diff(keys_k[fin], keys_p[fin]) > 1:
        raise AssertionError("K6 disagrees with its plain version at 1080p")
    errs["chord_keys"] = max(errs["chord_keys"],
                             float((keys_k[fin] - keys_p[fin]).abs().max()))
    row("chord_keys", "triton", "icon_rt_tpu_torch/ops/order.py",
        "icon_rt_tpu/ops/order.py:23", kk, pk)
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
    return rows


def profile_launch(pl):
    """One steady main-path launch (K1, 8 samples, fb copied to the host)
    under torch.profiler: device time by kernel and the device's idle
    share of the launch's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from icon_rt_tpu_torch.ops.fast import render_frame_fast
    from icon_rt_tpu_torch.ops.render import make_launch_params

    s, frame = pl.scene, pl.frame
    stats = s["stats"]
    lp = make_launch_params(s["camera"].basis(MAIN_W, MAIN_H),
                            stats.world_bounds_lo, stats.world_bounds_hi,
                            unit_distance=s["unit_distance"](),
                            device=frame["accum"].device)
    tables = (s["cells"], s["get_packed"](), s["locator"], s["get_bands"]())

    def launch():
        render_frame_fast(*tables, lp, frame["accum"], frame["fb"],
                          width=MAIN_W, height=MAIN_H,
                          pixel_perm=frame["perm"],
                          n_active=frame["n_active"], samples=MAIN_SPL)
        return frame["fb"].cpu()

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        launch()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:    # kernels and copies
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    # busy: the union of the device spans, so an event reported twice
    # counts once
    busy, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    top = ", ".join(f"{k[:40]} {v:.3f} ms" for k, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
    print(f"profile steady launch: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; {top}")
    if not 0.0 < busy <= wall:
        raise AssertionError(f"device busy {busy:.3f} ms is not within the "
                             f"launch's wall time {wall:.3f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    from icon_rt_tpu_torch.ops import fast
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"env device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    fast.build_track_f32()
    info = fast.track_build_info()
    print(f"build K1 nvcc+load {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"build ptxas: {line.strip()}")
    t1 = time.perf_counter()
    errs = check_kernels(dev)   # first Triton compiles happen in here
    print(f"build+check Triton compile and checks {time.perf_counter() - t1:.2f}"
          f" s (build total {time.perf_counter() - t0:.2f} s)")

    pl, counts, _ = main_path(dev)
    rows = time_kernels(pl, errs, counts)
    profile_launch(pl)
    print(nvidia_smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
