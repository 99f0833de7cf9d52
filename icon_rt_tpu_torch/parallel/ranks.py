"""Ranks: start a process group's ranks on one host, and the jobs they run.

`run_ranks` starts `world` processes (torch.multiprocessing, spawn), each of
which joins a process group over the backend its caller names (a file://
rendezvous: no port to collide), runs a job and sends back the job's
result.  A rank that raises, dies or outlives the time limit fails the
run: every rank is terminated and RuntimeError raised, so a hung
collective fails one call and never blocks its caller.

The jobs live here, in the package, so that a child process imports
neither a test module nor anything outside this package:

  * `animate_job` -- an animation (or, with one timestep, a frame) through
    data/animation.py on a ("tiles", "samples") mesh, f32 or quantized tier;
  * `slab_job` -- samples of the scene shard (parallel/scene_shard.py) on a
    ("slabs", "tiles") mesh, optionally with the unsharded K2 image beside;
  * `samples_job` -- the f32 tier's dealt frame on a samples axis, held
    against its sequential frame;
  * `parity_job` -- `render_frame_sharded` (the parity raygens through K8,
    the fast one through K1, row tiles) in one or more mesh layouts.

A job takes its inputs from a picklable `inputs(device)` callable: the
tables themselves (`given`, for small scenes handed over by a test), a file
of them (`saved`, for tables too slow to build on every rank and too large
for the spawn's pickles) or a function that builds them on the rank's
device (`r2b9_animation`, `synthetic_scene`).
"""
from __future__ import annotations

import os
import queue
import time
import traceback
import uuid
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


# ===========================================================================
# The launcher
# ===========================================================================

def rank_device(rank: int, device_type: str) -> torch.device:
    """The device of `rank`: card rank % cards (ranks past the card count
    share them), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, world, backend, init, device_type, job, args, results):
    try:
        dev = rank_device(rank, device_type)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=timedelta(seconds=600),
            device_id=dev if backend == "nccl" else None)
        out = job(rank, world, backend, dev, *args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(job, world: int, backend: str, args=(), *, timeout: float,
              rendezvous_dir: str, device_type: str = "cuda") -> list:
    """Run job(rank, world, backend, device, *args) on `world` new
    processes, rank r on `rank_device(r, device_type)`, inside a process
    group of `backend` ("nccl" or "gloo"; never chosen here); return the
    jobs' results in rank order.  Raises RuntimeError if a rank raises,
    exits without a result, or the run outlives `timeout` seconds; the
    ranks are terminated either way before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + os.path.join(rendezvous_dir, f"pg_{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, init, device_type, job,
                               tuple(args), results))
             for r in range(world)]
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"run_ranks: {world - len(got)} of "
                                   f"{world} ranks gave no result within "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"run_ranks: rank(s) {dead} died "
                                       f"(exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"run_ranks: ranks did not exit cleanly "
                               f"(rank, exit code): {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


# ===========================================================================
# Launch counts
# ===========================================================================

def launch_counts() -> dict:
    """{kernel: launches} of the kernels the multi-device paths run."""
    from ..data import device_scene
    from ..models import accel, finemap, locator, qcells
    from ..ops import composite, fast, fastq, order, render
    return {"track_f32": fast.launches["track_f32"],
            "classify_bake": fast.launches["classify_bake"],
            "track_q": fastq.launches,
            "bake_alpha_q": sum(qcells.launches.values()),
            "chord_keys": order.launches, "max_opacity": accel.launches,
            "locator_bins": sum(locator.launches.values()),
            "build_finemap": finemap.launches,
            "synth_scene": sum(device_scene.launches.values()),
            **composite.launches, **render.launches}


def zero_launch_counts():
    """Every counter of `launch_counts` to 0."""
    from ..data import device_scene
    from ..models import accel, finemap, locator, qcells
    from ..ops import composite, fast, fastq, order, render
    fastq.launches = order.launches = accel.launches = finemap.launches = 0
    for d in (fast.launches, qcells.launches, locator.launches,
              device_scene.launches, composite.launches, render.launches):
        for k in d:
            d[k] = 0


def _peak_gib(dev) -> float:
    if dev.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


# ===========================================================================
# Inputs
# ===========================================================================

def _to(v, device):
    """v with its tensors on `device` (a tensor, a NamedTuple of tensors, a
    dict of either; anything else as it is)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_to(x, device) for x in v))
    if isinstance(v, dict):
        return {k: _to(x, device) for k, x in v.items()}
    return v


def given(tables: dict, device) -> dict:
    """Inputs handed over as they are (tensors moved to `device`)."""
    return _to(tables, device)


def saved(path: str, device) -> dict:
    """Inputs from a file that `torch.save` wrote (the tables as `given`
    takes them), loaded onto `device`."""
    return given(torch.load(path, map_location=device, weights_only=False),
                 device)


def closeup_lp(stats, width: int, height: int, device):
    """Launch params of the bench's closeup camera (bench.py `_camera`) at
    the synthetic scenes' unit distance."""
    from ..data.lod import frame_camera
    from ..ops.render import make_launch_params
    cam = frame_camera(stats, "closeup", width, height)
    ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    return make_launch_params(cam.basis(width, height),
                              stats.world_bounds_lo, stats.world_bounds_hi,
                              unit_distance=ud, device=device)


def synthetic_scene(tier: str, sub: int, layers: int, width: int,
                    height: int, device) -> dict:
    """A synthetic icosphere scene built on `device` with the closeup camera:
    tier "f32" (cells, locator, packed tables, bands; a one-timestep
    animation), "q" (the app's quantized tier with its fine map; one
    timestep of value_q), "slab" (the dataset, TF and camera the scene
    shard builds its slabs from) or "parity" (the f32 tables and the
    accel of `parity_job`, a 1 x 64 x 64 ShellAccel built on the host:
    small scenes only)."""
    from ..data import synthetic
    from ..data.animation import Animation
    from ..models.cells import build_cells, compute_stats
    from ..models.locator import build_locator
    from ..models.shells import build_radial_bands, update_band_majorants
    from ..models.transfunc import make_transfunc
    ds = synthetic.icosphere(sub, layers)
    stats = compute_stats(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), device=device)
    out = dict(tf=tf, stats=stats, lp=closeup_lp(stats, width, height,
                                                 device))
    if tier == "slab":
        return dict(out, ds=ds)
    bands = update_band_majorants(build_radial_bands(ds, 64, device=device),
                                  tf.values, tf.value_range)
    if tier in ("f32", "parity"):
        out.update(cells=build_cells(ds, device=device),
                   loc=build_locator(ds, device=device), bands=bands)
    if tier == "f32":
        return dict(out, anim=Animation([ds]))
    if tier == "parity":
        from ..models.accel import build_shell_accel, update_majorants
        sph = build_shell_accel(ds, stats.spherical_bounds_lo,
                                stats.spherical_bounds_hi, (1, 64, 64),
                                device=device)
        return dict(out, accel={"sphere": update_majorants(
            sph, tf.values, tf.value_range)})
    from ..data.bigscene import build_locator_csr_from_scene
    from ..models.finemap import build_finemap
    from ..models.qcells import (bake_alpha_q, quantize_cells,
                                 quantize_dataset_values)
    ds_q, lo, hi = quantize_dataset_values(ds)
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi),
                                    device=device), tf)
    loc, k_cap = build_locator_csr_from_scene(ds_q)
    loc = loc._replace(**{k: getattr(loc, k).to(device)
                          for k in loc._fields})
    return dict(out, q=q, loc=loc, bands=bands, value_q=[q.value_q],
                fm=build_finemap(loc, q.test12, k_cap))


def r2b9_animation(width: int, height: int, device) -> dict:
    """BASELINE configs[4] at full size: build_q_scene(11, 16) (83,886,080
    columns) on the card with its fine map, two timesteps (the second
    value_q halved on the card, as tests/test_animation.py:142-143: u8
    x * 0.5 truncated is x >> 1), the bands' value ranges widened to the
    quantization range so their majorants bound both timesteps (K5b
    again), the closeup camera at width x height."""
    from ..data.bigscene import build_q_scene
    from ..models.shells import update_band_majorants
    q, loc, _, bands, tf, stats, fm, _, _ = build_q_scene(11, 16,
                                                          device=device)
    rng = torch.stack([q.value_lo, q.value_hi]).expand(bands.num_bands, 2)
    bands = update_band_majorants(bands._replace(
        value_ranges=rng.contiguous()), tf.values, tf.value_range)
    return dict(q=q, loc=loc, bands=bands, tf=tf, stats=stats, fm=fm,
                value_q=[q.value_q, q.value_q >> 1],
                lp=closeup_lp(stats, width, height, device))


# ===========================================================================
# Jobs
# ===========================================================================

def with_id(lp, k: int):
    """lp at sample id k."""
    return lp._replace(accum_id=torch.tensor(k, dtype=torch.int32,
                                             device=lp.accum_id.device))


def animate_job(rank, world, backend, dev, inputs, tier: str, *, width: int,
                height: int, samples_per_frame: int, tiles=None,
                samples: int = 1, chunk: int = 4096, finemap: bool = False,
                mesh: bool = True):
    """An animation of inputs(dev) (see `synthetic_scene`, `r2b9_animation`)
    through data/animation.py on a (tiles x samples) mesh over `backend`
    (mesh=False: one process, no mesh), the camera fixed, sample s of every
    timestep at accum_id s.  Returns {"frames": rank 0's natural-order
    frames, "counts": launches on the path, "timings": seconds per part,
    "seconds", "peak_gib", "build_s"}."""
    from ..data.animation import animate_fast_sharded, animate_fastq_sharded
    from .sharded import make_mesh
    t0 = time.perf_counter()
    inp = inputs(dev)
    build_s = time.perf_counter() - t0
    m = make_mesh(backend, tiles=tiles, samples=samples) if mesh else None
    lp = inp["lp"]
    lp_for = lambda t, s: with_id(lp, s)
    timings: dict = {}
    zero_launch_counts()
    t0 = time.perf_counter()
    if tier == "f32":
        it = animate_fast_sharded(inp["anim"], inp["cells"], inp["loc"],
                                  inp["bands"], inp["tf"], lp_for, m, width,
                                  height, samples_per_frame, chunk, timings)
    else:
        it = animate_fastq_sharded(
            inp["q"], inp["value_q"], inp["loc"], inp["bands"], inp["tf"],
            lp_for, m, inp["stats"], width, height, samples_per_frame,
            chunk, inp["fm"] if finemap else None, timings)
    frames = list(it)
    seconds = time.perf_counter() - t0
    return dict(frames=frames if rank == 0 else None,
                counts=launch_counts(), timings=timings, seconds=seconds,
                peak_gib=_peak_gib(dev), build_s=build_s)


def slab_job(rank, world, backend, dev, inputs, *, slabs: int, tiles=None,
             width: int, height: int, spp: int, reference: bool = False):
    """spp samples of the scene shard of inputs(dev) (a dataset `ds`, TF
    `tf` and launch params `lp`; see `synthetic_scene`) on a ("slabs",) or
    ("slabs", "tiles") mesh over `backend`: each rank builds its slab
    (build_sharded_scene) and the global 64 radial bands, then renders its
    tile.  Returns {"accum", "fb": rank 0's natural-order frame, "counts",
    "timings", "seconds", "build_s", "peak_gib"; on the card rank 0's
    "k2_raw_ms", K2's raw-mode launch timed after the path}; with
    `reference` also rank 0's unsharded K2 image of the same quantized
    field ("ref_accum", "ref_fb"; its launches come after "counts")."""
    from ..models.shells import build_radial_bands, update_band_majorants
    from .scene_shard import (build_sharded_scene, make_slab_mesh,
                              render_frame_scene_sharded)
    from .sharded import axis_index, gather_frame, tile_pixels
    t0 = time.perf_counter()
    inp = inputs(dev)
    mesh = make_slab_mesh(backend, slabs, tiles)
    tf, lp = inp["tf"], inp["lp"]
    slab = axis_index(mesh, "slabs")
    scene, _, ds_q = build_sharded_scene(inp["ds"], tf, slabs, slab,
                                         device=dev)
    bands = update_band_majorants(
        build_radial_bands(ds_q, 64, device=dev), tf.values,
        tf.value_range)
    p = tile_pixels(mesh, width, height, dev).shape[0]
    accum = torch.zeros((p, 4), dtype=torch.float32, device=dev)
    fb = torch.zeros(p, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    timings: dict = {}
    zero_launch_counts()
    t0 = time.perf_counter()
    for s in range(spp):
        render_frame_scene_sharded(mesh, scene, bands, tf, with_id(lp, s),
                                   accum, fb, width=width, height=height,
                                   timings=timings)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = dict(counts=launch_counts(), timings=timings,
               seconds=time.perf_counter() - t0, build_s=build_s)
    if slab == 0:
        out.update(accum=gather_frame(mesh, accum), fb=gather_frame(mesh, fb))
    if rank == 0 and dev.type == "cuda":
        out["k2_raw_ms"] = _time_raw_q(scene, bands, tf, lp, mesh, width,
                                       height)
    if reference and rank == 0:
        vr = (float(scene.value_lo), float(scene.value_hi))
        out.update(zip(("ref_accum", "ref_fb"),
                       unsharded_q(ds_q, vr, tf, bands, lp, width, height,
                                   spp, dev)))
    out["peak_gib"] = _peak_gib(dev)
    return out


def _time_raw_q(scene, bands, tf, lp, mesh, width: int, height: int,
                reps: int = 5) -> float:
    """ms per K2 raw-mode launch (salted, one sample) over this rank's
    tile against its slab, CUDA events around `reps` launches."""
    from ..ops.fast import alloc_raw
    from ..ops.fastq import track_q
    from .sharded import axis_index, tile_pixels
    pix = tile_pixels(mesh, width, height, lp.accum_id.device)
    raw = alloc_raw(pix.shape[0], pix.device)
    q, loc = scene.cells(), scene.locator()
    salt = axis_index(mesh, "slabs") + 1

    def launch(k):
        track_q(q, loc, bands, tf, with_id(lp, k), pix, None, None,
                width=width, height=height, out=raw, rng_salt=salt)

    launch(0)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for k in range(reps):
        launch(k)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def unsharded_q(ds_q, value_range, tf, bands, lp, width: int, height: int,
                spp: int, dev):
    """spp samples of K2 over the whole quantized field (quantized over
    the slabs' value_range, one locator) in natural pixel order: the image
    the slab composite converges to.  Returns (accum, fb) as numpy
    arrays."""
    from ..models.qcells import bake_alpha_q, quantize_cells
    from ..ops.fastq import render_frame_fast_q
    from ..ops.render import alloc_frame
    from .scene_shard import _slab_locator
    q = bake_alpha_q(quantize_cells(ds_q, value_range=value_range,
                                    device=dev), tf)
    loc, _ = _slab_locator(ds_q, dev)
    accum, fb = alloc_frame(width, height, device=dev)
    for s in range(spp):
        render_frame_fast_q(q, loc, bands, tf, with_id(lp, s), accum, fb,
                            width=width, height=height)
    return accum.cpu().numpy(), fb.cpu().numpy()


def _natural(x: np.ndarray, local_pix: np.ndarray, total: int):
    """Dealt-order rows x ((n_tiles * p_local, ...)) in natural pixel order,
    zero where nothing was dealt."""
    out = np.zeros((total,) + x.shape[1:], x.dtype)
    flat = np.asarray(local_pix).reshape(-1)
    m = flat >= 0
    out[flat[m]] = x[m]
    return out


def samples_job(rank, world, backend, dev, inputs, *, width: int,
                height: int, launches: int, samples: int,
                reference: bool = False):
    """`launches` steps of parallel/sharded.py `render_frame_fast_sharded`
    (the f32 tier of inputs(dev), see `synthetic_scene`) on a (world /
    samples) x samples mesh: step a accumulates samples a * S + s.  Returns
    {"accum", "fb": rank 0's natural-order frame, "counts", "timings",
    "seconds", "build_s", "peak_gib", "mean_equal": whether one more step's
    K10 mean composite equals the plain mean on the same reduced buffer
    (accum and fb bit for bit)}; with `reference` also rank 0's sequential
    frame of the same launches * S samples ("ref_accum", "ref_fb": K1 in raw
    mode, one sample per launch, accumulated through K10's finalize, which
    equals the finalizing launch bit for bit) and "all_wrote", the pixels
    every one of whose samples met the shell."""
    from ..ops import composite
    from ..ops.fast import alloc_raw, pack_cells, track_f32
    from ..ops.order import pixel_order
    from .sharded import (SUM, all_reduce, alloc_fast_sharded_frame,
                          axis_index, gather_frame, local_lanes, make_mesh,
                          plan_fast_sharding, render_frame_fast_sharded)
    t0 = time.perf_counter()
    inp = inputs(dev)
    mesh = make_mesh(backend, tiles=world // samples, samples=samples)
    cells, loc, bands, tf, lp = (inp[k] for k in
                                 ("cells", "loc", "bands", "tf", "lp"))
    st = inp["stats"]
    packed = pack_cells(cells, tf)
    perm, n_active = pixel_order(lp, st.spherical_bounds_lo[0],
                                 st.spherical_bounds_hi[0], width, height)
    local = plan_fast_sharding(perm.cpu().numpy(), n_active,
                               world // samples)
    pix = local_lanes(mesh, local, dev)
    accum, fb = alloc_fast_sharded_frame(mesh, local, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    timings: dict = {}
    zero_launch_counts()
    t0 = time.perf_counter()
    for a in range(launches):
        render_frame_fast_sharded(mesh, packed, loc, bands, with_id(lp, a),
                                  accum, fb, pix, width=width,
                                  height=height, timings=timings)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = dict(counts=launch_counts(), timings=timings,
               seconds=time.perf_counter() - t0, build_s=build_s)
    # one more step, its composite held against the plain mean
    n, s = pix.shape[0], axis_index(mesh, "samples")
    raw = alloc_raw(n, dev)
    track_f32(packed, loc, bands, with_id(lp, launches * samples + s), pix,
              None, None, width=width, height=height, out=raw)
    total = all_reduce(composite.mean_payload(raw.wrote, raw.ca), SUM, mesh,
                       "samples")
    acc_k, fb_k = accum[:n].clone(), fb[:n].clone()
    acc_p, fb_p = accum[:n].clone(), fb[:n].clone()
    aid = with_id(lp, launches).accum_id
    composite.finalize_mean(total, acc_k, fb_k, aid)
    composite._finalize_torch(composite.MEAN_FIN, total, acc_p, fb_p, aid)
    out["mean_equal"] = bool(torch.equal(acc_k, acc_p)
                             and torch.equal(fb_k, fb_p))
    if s == 0:
        total_px = width * height
        acc_all, fb_all = gather_frame(mesh, accum), gather_frame(mesh, fb)
        if acc_all is not None:
            out.update(accum=_natural(acc_all, local, total_px),
                       fb=_natural(fb_all, local, total_px))
    if reference and rank == 0:
        ref_acc = torch.zeros((n_active, 4), dtype=torch.float32, device=dev)
        ref_fb = torch.zeros(n_active, dtype=torch.int32, device=dev)
        wrote = torch.zeros(n_active, dtype=torch.int32, device=dev)
        lanes = perm[:n_active].contiguous()
        raw = alloc_raw(n_active, dev)
        for k in range(launches * samples):
            track_f32(packed, loc, bands, with_id(lp, k), lanes, None, None,
                      width=width, height=height, out=raw)
            wrote += raw.wrote
            composite.finalize_mean(composite.mean_payload(raw.wrote,
                                                           raw.ca),
                                    ref_acc, ref_fb, with_id(lp, k).accum_id)
        nat = lanes.long().cpu().numpy()
        total_px = width * height
        out["ref_accum"] = np.zeros((total_px, 4), np.float32)
        out["ref_accum"][nat] = ref_acc.cpu().numpy()
        out["ref_fb"] = np.zeros(total_px, np.int32)
        out["ref_fb"][nat] = ref_fb.cpu().numpy()
        out["all_wrote"] = np.zeros(total_px, bool)
        out["all_wrote"][nat] = (wrote == launches * samples).cpu().numpy()
    out["peak_gib"] = _peak_gib(dev)
    return out


def parity_job(rank, world, backend, dev, inputs, *, width: int,
               height: int, runs, mesh: bool = True):
    """Runs of parallel/sharded.py `render_frame_sharded` on the tables of
    inputs(dev): "cells", "loc", "tf", "lp", "accel" (a dict by accel mode)
    and, for the fast raygen, "bands".  Each run is a dict of "tiles",
    "samples" (a tiles x samples mesh over `backend`; mesh=False: one
    process without a mesh), "raygen" ("ae", "accel" or "fast"),
    "accel_mode", "sampler" (default "locator") and "steps": that many
    progressive steps, step a at accum_id a, after every launch counter is
    zeroed.  Returns {"build_s", "runs": per run {"accum", "fb": rank 0's
    natural-order frame (None elsewhere), "counts", "timings" (seconds by
    part: track, composite, all_reduce, gather), "seconds", "peak_gib"}}."""
    from ..ops.fast import pack_cells
    from .sharded import gather_frame, make_mesh, render_frame_sharded
    t0 = time.perf_counter()
    inp = inputs(dev)
    packed = pack_cells(inp["cells"], inp["tf"]) \
        if any(r["raygen"] == "fast" for r in runs) else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = dict(build_s=time.perf_counter() - t0, runs=[])
    for run in runs:
        m = make_mesh(backend, tiles=run["tiles"],
                      samples=run["samples"]) if mesh else None
        p_local = width * height // (run["tiles"] if mesh else 1)
        accum = torch.zeros((p_local, 4), dtype=torch.float32, device=dev)
        fb = torch.zeros(p_local, dtype=torch.int32, device=dev)
        mode = run.get("accel_mode", "grid")
        timings: dict = {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        zero_launch_counts()
        t0 = time.perf_counter()
        for a in range(run["steps"]):
            render_frame_sharded(
                m, inp["cells"], inp["tf"], inp.get("accel", {}).get(mode),
                with_id(inp["lp"], a), accum, fb, width=width, height=height,
                accel_mode=mode, sampler=run.get("sampler", "locator"),
                locator=inp["loc"], raygen=run["raygen"], packed=packed,
                bands=inp.get("bands"), timings=timings)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        t1 = time.perf_counter()
        acc_all, fb_all = gather_frame(m, accum), gather_frame(m, fb)
        timings["gather"] = time.perf_counter() - t1
        out["runs"].append(dict(
            accum=acc_all if rank == 0 else None,
            fb=fb_all if rank == 0 else None, counts=counts,
            timings=timings, seconds=seconds, peak_gib=_peak_gib(dev)))
    return out
