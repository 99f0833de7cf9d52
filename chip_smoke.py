#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (icon_rt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints lines starting with its tag; any failure raises and the
script exits non-zero without printing a result):

  env     the card's name and power limit; there is no CPU fallback
  build   the nvcc builds of K1 (csrc/track_f32.cu), K2 (csrc/track_q.cu)
          and K7-fm (csrc/finemap.cu), started together, and the first
          Triton compile of K5a, K5b, K6 and K5c-q, with their seconds
  check   every kernel against its plain PyTorch version on the card, at
          subdiv 5 x 16 layers, 256x256, closeup camera:
            K1  samples=4, both preserve_cache settings: fb identical on
                >= 99.9% of pixels, accum max-abs-diff <= 1e-6
            K5a <= 1 ULP    K5b exact    K6 keys <= 1 ULP, same n_covered
  check q the quantized tier's kernels at the same shape:
            K2  samples=4, both preserve_cache settings, the fine map on
                and off: fb identical on >= 99.9%, accum <= 1e-6
            K5c-q full lookup and <= 32-level patch: u8 tables exact
            K7-fm slots exact
  main    the app's main path (icon_rt_tpu_torch.app.build, then the
          launch / is_running / present loop of apps/icon_rt.py) at subdiv
          8 x 16 layers, 1920x1080, 16 samples (8 per launch), closeup
          camera of bench.py; the launch counters of all four kernels are
          zeroed before and read after, the image must cover >= 0.5 of the
          frame; then the same loop runs on to 128 samples, and the median
          and spread of the steady launches' wall time (fb copied to the
          host) give the end-to-end rate
  main q  the app's --quantized path (fine map on, its cache emptied) at
          the same scale and camera: the counters of K2, K5c-q, K7-fm, K5b
          and K6 are zeroed before and read after, the image must cover
          >= 0.5; on to 128 samples for the steady launch; then one
          opacity-scale edit, one <= 32-level curve edit and one full
          curve edit, each timed up to the next launch's fb on the host
  time    each kernel against its plain version at the main paths' shapes
          and launch arguments (same tolerances as `check`), both timed
          with CUDA events
  profile one steady launch of each main path under torch.profiler:
          device time by kernel and the device's idle share of the
          launch's wall time

The last lines are the card's `nvidia-smi` name and power limit, one JSON
line {"kernels": [...]}, and {"ok": true, "device": {...}}.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SMOKE_SUB, SMOKE_LAYERS, SMOKE_W = 5, 16, 256
MAIN_SUB, MAIN_LAYERS, MAIN_W, MAIN_H = 8, 16, 1920, 1080
MAIN_LIMIT, MAIN_SPL = 16, 8
STEADY_LIMIT = 128          # the main path continued to 16 launches in all
ACCUM_TOL = 1e-6            # K1/K2 accum max-abs-diff against the plain version
CU_SOURCES = ("track_f32", "track_q", "finemap")   # csrc/*.cu
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
        self.ds = ds = synthetic.icosphere(sub, layers)
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
    """Each f32-tier kernel against its plain version on the same inputs.
    Returns ({kernel name: max_abs_err}, the Scene)."""
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
    return errs, sc


def compare_track_q(tabs, lp, pix, acc_n, width, height, samples,
                    preserve, fm, label):
    """K2 and its plain version on the same lanes; returns (max abs err of
    accum, the plain version's ms), raises past the tolerances (fb
    identical on >= 99.9%, accum <= ACCUM_TOL)."""
    import torch
    from icon_rt_tpu_torch.ops import fastq
    from icon_rt_tpu_torch.ops.render import alloc_frame
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(width, height, device=pix.device)
        args = (*tabs, lp, pix, acc[:acc_n], fb[:acc_n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kernel:
            fastq.track_q(*args, width=width, height=height, samples=samples,
                          preserve_cache=preserve, finemap=fm)
        else:
            fastq._render_frame_fast_q_torch(*args, width, height, samples,
                                             preserve, fm)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        outs.append((acc, fb))
    (ak, fk), (ap, fp) = outs
    same = float((fk == fp).float().mean())
    err = float((ak - ap).abs().max())
    print(f"{label} K2 track_q samples={samples} preserve_cache={preserve} "
          f"finemap={'on' if fm is not None else 'off'}: fb identical on "
          f"{same:.6f} of {width * height} pixels, accum max abs diff "
          f"{err:.3e}")
    if same < 0.999 or not err <= ACCUM_TOL:
        raise AssertionError("K2 disagrees with its plain version")
    return err, plain_ms


def bake_inputs(q, tf, dev):
    """K5c-q's arguments: the normalized (256,) u8 alpha table of `tf`, and
    a patch of 20 levels (-1 padded to 32) with their new u8 values."""
    import torch
    from icon_rt_tpu_torch.models import qcells
    a_tab = qcells._classify_alpha_table(tf, q.value_lo, q.value_hi)
    q_tab = torch.floor(a_tab / torch.clamp(a_tab.max(), min=1e-8)
                        * 255.0).to(torch.uint8)
    lev = torch.full((32,), -1, dtype=torch.int32, device=dev)
    lev[:20] = torch.arange(100, 120, dtype=torch.int32, device=dev)
    new = (torch.arange(32, device=dev) * 7 % 256).to(torch.uint8)
    return q_tab, lev, new


def check_bakes(q, tf, dev, label):
    """K5c-q full lookup and <= 32-level patch against their plain versions
    on the scene's value table; returns max abs err (0 when exact)."""
    import torch
    from icon_rt_tpu_torch.models import qcells
    q_tab, lev, new = bake_inputs(q, tf, dev)
    full_k = qcells.bake_lookup(q.value_q, q_tab)
    full_p = qcells._bake_lookup_torch(q.value_q, q_tab)
    patch_k = qcells.bake_patch(q.value_q, full_k, lev, new)
    patch_p = qcells._bake_patch_torch(q.value_q, full_p, lev, new)
    err = max(float((full_k.int() - full_p.int()).abs().max()),
              float((patch_k.int() - patch_p.int()).abs().max()))
    print(f"{label} K5c-q bake_lookup/bake_patch at {tuple(q.value_q.shape)}"
          f": exact {torch.equal(full_k, full_p)} / "
          f"{torch.equal(patch_k, patch_p)}")
    if not (torch.equal(full_k, full_p) and torch.equal(patch_k, patch_p)):
        raise AssertionError("K5c-q differs from its plain version")
    return err


def check_finemap(loc, test12, label):
    """K7-fm against its plain version; returns max abs err (0 = exact)."""
    import torch
    from icon_rt_tpu_torch.models import finemap
    k = finemap.finemap_slots(loc, test12)
    p = finemap._build_finemap_torch(loc, test12)
    err = float((k.int() - p.int()).abs().max())
    print(f"{label} K7-fm build_finemap slots {tuple(k.shape)}: exact "
          f"{torch.equal(k, p)}")
    if not torch.equal(k, p):
        raise AssertionError("K7-fm differs from its plain version")
    return err


def check_q_kernels(sc, dev):
    """The quantized tier's kernels against their plain versions on the
    check scene (built as the app's get_q builds it)."""
    from icon_rt_tpu_torch.models.finemap import build_finemap
    from icon_rt_tpu_torch.models.locator import (build_locator_csr,
                                                  densify_csr)
    from icon_rt_tpu_torch.models.qcells import (bake_alpha_q,
                                                 quantize_cells,
                                                 quantize_dataset_values)
    ds_q, lo, hi = quantize_dataset_values(sc.ds)
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi), device=dev),
                     sc.tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap, device=dev)
    errs = {"build_finemap": check_finemap(loc, q.test12, "check q"),
            "bake_alpha_q": check_bakes(q, sc.tf, dev, "check q")}
    fm = build_finemap(loc, q.test12)
    n, size = sc.n_cov, sc.width
    pix = sc.perm[:n].contiguous()
    errs["track_q"] = max(
        compare_track_q((q, loc, sc.bands, sc.tf), sc.lp, pix, n, size,
                        size, 4, preserve, f, "check q")[0]
        for preserve in (True, False) for f in (fm, None))
    return errs


def zero_counters():
    """Every kernel launch counter of the port to 0."""
    from icon_rt_tpu_torch.models import accel, finemap, qcells
    from icon_rt_tpu_torch.ops import fast, fastq, order
    accel.launches = order.launches = 0
    fastq.launches = finemap.launches = 0
    for d in (fast.launches, qcells.launches):
        for k in d:
            d[k] = 0


def read_counters(quantized):
    """{kernel name: launches} of the kernels a main path runs."""
    from icon_rt_tpu_torch.models import accel, finemap, qcells
    from icon_rt_tpu_torch.ops import fast, fastq, order
    counts = {"max_opacity": accel.launches, "chord_keys": order.launches}
    if quantized:
        counts.update(track_q=fastq.launches,
                      bake_alpha_q=sum(qcells.launches.values()),
                      build_finemap=finemap.launches)
    else:
        counts.update(track_f32=fast.launches["track_f32"],
                      classify_bake=fast.launches["classify_bake"])
    return counts


def run_loop(pl, launch_ms):
    """The launch / is_running loop of apps/icon_rt.py; appends each
    launch's wall time in ms, fb copied to the host before the clock is
    read."""
    import torch
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


def main_path(dev, quantized=False):
    """Run the app's main path (the f32 tier, or --quantized with the fine
    map built into an empty cache) with zeroed launch counters; returns
    (pipeline, counts, metrics)."""
    import torch
    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.cells import compute_stats

    tag = "main q" if quantized else "main"
    stats = compute_stats(synthetic.icosphere(MAIN_SUB, MAIN_LAYERS))
    cam = closeup_camera(stats, MAIN_W, MAIN_H)
    pose = [*cam.position, *cam.get_poi(), *cam.up_vector]
    os.makedirs(OUT_DIR, exist_ok=True)
    name = "chip_smoke_q" if quantized else "chip_smoke"
    argv = ["--device", dev.type, "--synthetic",
            f"{MAIN_SUB}:{MAIN_LAYERS}", "--size", str(MAIN_W), str(MAIN_H),
            "--sample-limit", str(MAIN_LIMIT), "--samples", str(MAIN_SPL),
            "--camera", *[repr(float(v)) for v in pose],
            "-fovy", repr(float(cam.get_fovy_degrees())),
            "-o", os.path.join(OUT_DIR, name)]
    if quantized:
        argv.append("--quantized")

    zero_counters()
    t0 = time.perf_counter()
    pl = app.build(argv)
    build_s = time.perf_counter() - t0
    launch_ms = []
    run_loop(pl, launch_ms)
    n_launch = len(launch_ms)
    t1 = time.perf_counter()
    pl.present()
    present_s = time.perf_counter() - t1
    counts = read_counters(quantized)
    tracker = "track_q" if quantized else "track_f32"
    what = ("scene; the quantized tables, CSR locator and fine map are "
            "built by the first launch" if quantized
            else "scene, locator, tables on the card")
    print(f"{tag} build {build_s:.3f} s ({what}); launches "
          f"{n_launch}, ms per launch {[round(x, 3) for x in launch_ms]} "
          f"(the first also bakes and orders the rays"
          f"{' and builds the fine map' if quantized else ''}); present "
          f"{present_s:.3f} s")
    print(f"{tag} launch counts {json.dumps(counts)}")
    for k, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{tag} path did not launch {k}")
    if counts[tracker] != n_launch:
        raise AssertionError(f"{tracker} launched {counts[tracker]} times "
                             f"in {n_launch} launches")

    frame = pl.frame
    acc = frame["accum"]
    if tuple(acc.shape) != (MAIN_W * MAIN_H, 4) \
            or not bool(torch.isfinite(acc).all()):
        raise AssertionError(f"{tag} path accum is not finite (W*H, 4)")
    fb = frame["fb"].cpu().numpy().view(np.uint32)
    covered = float(((fb >> 24) > 0).mean())
    n_active = frame["n_active"]
    print(f"{tag} image covered fraction {covered:.4f} (K6 covered prefix "
          f"{n_active} of {MAIN_W * MAIN_H} lanes)")
    if covered < 0.5:
        raise AssertionError(f"image covers only {covered:.3f} of the frame")

    # the same loop on to STEADY_LIMIT samples; every launch but the first
    # (which orders the rays and bakes the tables) is a steady one
    pl.sample_limit = STEADY_LIMIT
    run_loop(pl, launch_ms)
    steady = np.array(launch_ms[1:])
    med = float(np.median(steady))
    mray = MAIN_W * MAIN_H * MAIN_SPL / (med * 1e-3) / 1e6
    print(f"{tag} steady launches {len(steady)} ({MAIN_SPL} samples each, "
          f"to {STEADY_LIMIT} samples): ms per launch median {med:.3f}, "
          f"min {steady.min():.3f}, max {steady.max():.3f}; all "
          f"{[round(x, 3) for x in launch_ms]}")
    print(f"{tag} end-to-end full-frame rate {mray:.3f} Mray/s (median "
          f"launch wall time, fb copied to the host)")
    return pl, counts, {"build_s": build_s, "launch_ms": launch_ms,
                        "mray_s": mray, "covered": covered}


def tf_edits(pl):
    """Three TF edits on the quantized main path, each timed from the edit
    to the next launch's fb on the host: an opacity-scale edit (through the
    TF editor's dirty flags), a curve edit that changes <= 32 of the 256
    normalized alpha levels (K5c-q patch) and one that changes most of
    them (K5c-q lookup)."""
    import torch
    from icon_rt_tpu_torch.models import qcells

    def level_changes(lut):
        q, _, _ = pl.scene["get_q"]()
        tf = pl.scene["tf"]()
        a = qcells._classify_alpha_table(
            tf._replace(values=torch.from_numpy(lut).to(tf.values.device)),
            q.value_lo, q.value_hi)
        tab = torch.floor(a / torch.clamp(a.max(), min=1e-8) * 255.0)
        return int((tab.to(torch.uint8).cpu().numpy() != q.alpha_tab).sum())

    def timed(label, edit, want):
        before = dict(qcells.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        edit()
        pl.launch()
        np.asarray(pl._last_fb.cpu())
        ms = (time.perf_counter() - t0) * 1e3
        ran = {k: qcells.launches[k] - before[k] for k in before}
        print(f"main q TF edit {label}: {ms:.3f} ms to the next launch's fb "
              f"on the host; K5c-q launches {ran}")
        if want and ran[want] != 1:
            raise AssertionError(f"TF edit {label} did not run {want}")
        return ms

    def set_lut(lut):
        tf = pl.transfunc
        tf.set_lut(lut)
        pl.transfunc_update_handler(tf, pl.tf_index)
        pl.reset_accumulation()

    def set_opacity():
        pl.tfe.set_opacity_scale(0.5)
        pl.is_running()          # the loop's TF-editor harvest fires the edit

    out = {"opacity": timed("opacity scale 1.0 -> 0.5", set_opacity, None)}
    base = pl.transfunc.get_lut()
    narrow = None
    for k in range(base.shape[0] // 2, base.shape[0]):
        lut = base.copy()
        lut[k, 3] *= 0.5
        if 0 < level_changes(lut) <= qcells.PATCH_LEVELS:
            narrow = lut
            break
    if narrow is None:
        raise AssertionError("no single-entry curve edit changes <= 32 "
                             "alpha levels")
    out["curve_patch"] = timed("curve, <= 32 levels", lambda: set_lut(narrow),
                               "bake_patch")
    wide = base.copy()
    wide[: base.shape[0] // 2, 3] = 0.0
    out["curve_full"] = timed("curve, lower half transparent",
                              lambda: set_lut(wide), "bake_lookup")
    if not bool(torch.isfinite(pl.frame["accum"]).all()):
        raise AssertionError("accum not finite after the TF edits")
    return out


def kernel_row(rows, counts, errs, name, route, source, replaces, ms,
               plain_ms, **extra):
    """Append one entry of the {"kernels": [...]} line and print its
    times."""
    rows.append(dict(name=name, route=route, source=source,
                     replaces=replaces, launches=counts[name],
                     max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                     **extra))
    print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")


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
    row = lambda *a, **kw: kernel_row(rows, counts, errs, *a, **kw)

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


def time_q_kernels(pl, errs, counts):
    """The quantized tier's kernels and their plain versions at the main
    q path's shapes: K2 as the app launches it (the covered lanes, 8
    samples, cache kept) with the fine map on and off, K5c-q over the
    1,310,720 x 16 value table, K7-fm over the subdiv-8 locator."""
    from icon_rt_tpu_torch.models import finemap, qcells
    from icon_rt_tpu_torch.ops import fastq
    from icon_rt_tpu_torch.ops.render import alloc_frame, make_launch_params

    s = pl.scene
    q, loc, k_cap = s["get_q"]()
    fm, bands, tf, stats = s["fm"](), s["get_bands"](), s["tf"](), s["stats"]
    W, H = MAIN_W, MAIN_H
    dev = q.test12.device
    lp = make_launch_params(s["camera"].basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi,
                            unit_distance=s["unit_distance"](), device=dev)
    n = pl.frame["n_active"]
    pix = pl.frame["perm"][:n].contiguous()
    tabs = (q, loc, bands, tf)
    rows = []
    row = lambda *a, **kw: kernel_row(rows, counts, errs, *a, **kw)

    acc, fb = alloc_frame(W, H, device=dev)
    kms = {}
    for f in (fm, None):
        kms[f is not None] = time_cuda(lambda: fastq.track_q(
            *tabs, lp, pix, acc[:n], fb[:n], width=W, height=H,
            samples=MAIN_SPL, preserve_cache=True, finemap=f), reps=3)
    plain_ms = {}
    for f in (fm, None):
        err, plain_ms[f is not None] = compare_track_q(
            tabs, lp, pix, n, W, H, MAIN_SPL, True, f, "time 1080p")
        errs["track_q"] = max(errs["track_q"], err)
    print(f"time K2 kernel rate {W * H * MAIN_SPL / (kms[True] * 1e-3) / 1e6:.3f}"
          f" Mray/s full frame ({MAIN_SPL} samples, fine map on, "
          f"{kms[True]:.3f} ms; off {kms[False]:.3f} ms; no host copy)")
    row("track_q", "cuda", "icon_rt_tpu_torch/csrc/track_q.cu",
        "icon_rt_tpu/ops/fastq.py:80", kms[True], plain_ms[True],
        samples=MAIN_SPL, ms_no_finemap=kms[False],
        plain_ms_no_finemap=plain_ms[False])

    errs["bake_alpha_q"] = max(errs["bake_alpha_q"],
                               check_bakes(q, tf, dev, "time main shape"))
    q_tab, lev, new = bake_inputs(q, tf, dev)
    kb = time_cuda(lambda: qcells.bake_lookup(q.value_q, q_tab), reps=20)
    pb = time_cuda(lambda: qcells._bake_lookup_torch(q.value_q, q_tab),
                   reps=5)
    kp = time_cuda(lambda: qcells.bake_patch(q.value_q, q.alpha_q, lev,
                                             new), reps=20)
    pp = time_cuda(lambda: qcells._bake_patch_torch(q.value_q, q.alpha_q,
                                                    lev, new), reps=3)
    print(f"time K5c-q bake_patch: kernel {kp:.4f} ms, plain {pp:.4f} ms")
    row("bake_alpha_q", "triton", "icon_rt_tpu_torch/models/qcells.py",
        "icon_rt_tpu/models/qcells.py:266", kb, pb, patch_ms=kp,
        patch_plain_ms=pp)

    errs["build_finemap"] = max(errs["build_finemap"], check_finemap(
        loc, q.test12, "time main shape"))
    kf = time_cuda(lambda: finemap.finemap_slots(loc, q.test12), reps=5)
    pf = time_cuda(lambda: finemap._build_finemap_torch(loc, q.test12),
                   reps=1)
    row("build_finemap", "cuda", "icon_rt_tpu_torch/csrc/finemap.cu",
        "icon_rt_tpu/models/finemap.py:174", kf, pf,
        fine_bins=int(fm.slots.shape[0]), k_cap=k_cap)
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
    return rows


def profile_launch(pl, quantized=False):
    """One steady main-path launch (8 samples, fb copied to the host) under
    torch.profiler: device time by kernel and the device's idle share of
    the launch's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from icon_rt_tpu_torch.ops.fast import render_frame_fast
    from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q
    from icon_rt_tpu_torch.ops.render import make_launch_params

    s, frame = pl.scene, pl.frame
    stats = s["stats"]
    lp = make_launch_params(s["camera"].basis(MAIN_W, MAIN_H),
                            stats.world_bounds_lo, stats.world_bounds_hi,
                            unit_distance=s["unit_distance"](),
                            device=frame["accum"].device)
    kw = dict(width=MAIN_W, height=MAIN_H, pixel_perm=frame["perm"],
              n_active=frame["n_active"], samples=MAIN_SPL)
    if quantized:
        q, loc, _ = s["get_q"]()
        tables = (q, loc, s["get_bands"](), s["tf"]())

        def render():
            render_frame_fast_q(*tables, lp, frame["accum"], frame["fb"],
                                finemap=s["fm"](), **kw)
    else:
        tables = (s["cells"], s["get_packed"](), s["locator"],
                  s["get_bands"]())

        def render():
            render_frame_fast(*tables, lp, frame["accum"], frame["fb"], **kw)

    def launch():
        render()
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
    print(f"profile steady {'quantized ' if quantized else ''}launch: wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}; {top}")
    if not 0.0 < busy <= wall:
        raise AssertionError(f"device busy {busy:.3f} ms is not within the "
                             f"launch's wall time {wall:.3f} ms")


def build_all():
    """nvcc of every csrc/*.cu kernel, started together; prints seconds and
    the ptxas register/spill lines."""
    from icon_rt_tpu_torch.models.finemap import build_finemap_kernel
    from icon_rt_tpu_torch.ops.fast import build_track_f32
    from icon_rt_tpu_torch.ops.fastq import build_track_q
    from icon_rt_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CU_SOURCES)) as ex:
        for f in [ex.submit(b) for b in (build_track_f32, build_track_q,
                                          build_finemap_kernel)]:
            f.result()
    for name in CU_SOURCES:
        info = cuda_build.info(name)
        print(f"build {name}.cu nvcc+load {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                print(f"build ptxas {name}: {line.strip()}")
    print(f"build nvcc total {time.perf_counter() - t0:.2f} s (in parallel)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a GPU",
              file=sys.stderr)
        return 2
    from icon_rt_tpu_torch.data import bigscene
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"env device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    build_all()
    t1 = time.perf_counter()
    errs, sc = check_kernels(dev)   # first Triton compiles happen in here
    errs.update(check_q_kernels(sc, dev))
    del sc
    print(f"build+check Triton compiles and checks "
          f"{time.perf_counter() - t1:.2f} s")

    pl, counts, _ = main_path(dev)
    rows = time_kernels(pl, errs, counts)
    profile_launch(pl)
    del pl
    torch.cuda.empty_cache()

    # the quantized path builds its fine map into an empty cache (K7-fm)
    bigscene.CACHE_DIR = tempfile.mkdtemp(
        prefix="chip_smoke_fmap_", dir=os.path.dirname(bigscene.CACHE_DIR))
    try:
        pl_q, counts_q, _ = main_path(dev, quantized=True)
        rows += time_q_kernels(pl_q, errs, counts_q)
        profile_launch(pl_q, quantized=True)
        tf_edits(pl_q)
    finally:
        shutil.rmtree(bigscene.CACHE_DIR, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
