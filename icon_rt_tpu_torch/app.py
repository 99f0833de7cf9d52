"""icon_rt — the ICON direct-volume renderer application, PyTorch/CUDA port.

Same CLI as apps/icon_rt.py (ref: icon_rt/hostCode.cu:703-968):
  positional <file>.ic, --num-cells N, --lat-range lo:hi, --lon-range lo:hi,
  -mode M (0, 1: analytic column sampling; 2: the cuBQL mode, the wedge
  sampler), plus the common pipeline flags (--bgcolor --sample-limit --xf
  -win/--win/--size -fovy --camera), and:
  --synthetic SUBDIV[:LAYERS]  render a generated icosphere field (no .ic)
  --samples N|auto             progressive samples per launch (default 8);
                               auto: frames 0 and 1 render one sample,
                               frame 1's wall time (the card synchronized)
                               sizes every later launch to AUTO_BUDGET_S
  --preview N                  the first frame after a reset renders one
                               sample at 1/N resolution (K6, then K1 or K2)
                               and is presented upscaled (0: off)
  -o PATH                      output PNG name (default icon_rt.png)
  --device DEV                 torch device (default cuda; cpu runs the
                               kernels' plain PyTorch versions)
  --quantized                  the quantized storage tier (u8 values and
                               alpha, u16-grid heights, CSR-binned locator)
  --finemap / --no-finemap     the quantized tier's two-stage fine-map
                               locate (default on; cached per dataset)
  --march                      the deterministic transmittance march: one
                               converged pass per launch instead of
                               Woodcock samples (K3; without the fine map
                               on the quantized tier, as apps/icon_rt.py)
  --raygen {fast,accel,ae}     fast = the radial-band raygen; accel/ae =
                               the reference-parity raygens (K8, one
                               sample per launch, f32 cells)
  --accel-mode {sphere,grid}   the accel raygen's majorant grid
  --sampler {locator,brute,wedge}  the point sampler (brute: a scan of
                               every cell per sample, meant for small
                               scenes; wedge, as -mode 2: the parity
                               raygens invert the column layers' flat
                               wedges by Newton, the fast raygen renders
                               the wedge tier)

This port renders the fast radial-band raygen with the locator sampler on
the f32 tier and, with --quantized, on the quantized tier, by Woodcock
tracking (K1, K2) or, with --march, by the march (K3), the wedge sampler
(-mode 2) on the fast raygen's wedge tier (K9-w; --quantized takes
precedence over it, and --march with it renders the tracker), and the
reference-parity raygens (K8; K9-p with the wedge sampler) on the f32
cells.  An opacity-scale edit of
the f32 tier re-bakes only the alpha half (K5c-f32).  The UI parameters
"Raygen", "Accel mode", "Sampler mode" (2: the wedge sampler) and "Use
naive accel" switch the path at run time and reset accumulation; "Use
naive accel" off renders the accel raygen as AE.

Batch behavior matches the reference: renders --sample-limit progressive
frames, writes the PNG, prints FPS.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

#: --samples auto: the wall budget of one launch, the interactive launch
#: limit (PERF.md §2), since the viewer applies events only between launches
AUTO_BUDGET_S = 0.033


def _choice(flag, value, options):
    if value not in options:
        raise ValueError(f"{flag} {value}: expected one of {options}")
    return value


def parse_app_args(argv):
    cfg = {
        "filepath": None, "num_cells": -1,
        "lat_range": None, "lon_range": None,
        "synthetic": None, "out": "icon_rt", "bands": 64,
        "samples": 8, "device": "cuda", "quantized": False,
        "finemap": True, "march": False, "mode": 1, "raygen": "fast",
        "accel_mode": "sphere", "sampler": "locator", "preview": 0,
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-") and a.endswith(".ic"):
            cfg["filepath"] = a
        elif a == "--num-cells":
            cfg["num_cells"] = int(argv[i + 1]); i += 1
        elif a == "--lat-range":
            lo, hi = argv[i + 1].split(":")
            cfg["lat_range"] = (float(lo), float(hi)); i += 1
        elif a == "--lon-range":
            lo, hi = argv[i + 1].split(":")
            cfg["lon_range"] = (float(lo), float(hi)); i += 1
        elif a == "-mode":
            # reference sampler modes (ref: Params.h:29-31): 0 = user geom,
            # 1 = triangles (both: analytic column sampling), 2 = cuBQL, the
            # wedge sampler on every raygen (apps/icon_rt.py:49-61)
            cfg["mode"] = int(argv[i + 1])
            cfg["sampler"] = "wedge" if cfg["mode"] == 2 else "locator"
            i += 1
        elif a == "--synthetic":
            s = argv[i + 1].split(":")
            cfg["synthetic"] = (int(s[0]), int(s[1]) if len(s) > 1 else 8)
            i += 1
        elif a == "--raygen":
            cfg["raygen"] = _choice(a, argv[i + 1], ("fast", "accel", "ae"))
            i += 1
        elif a == "--accel-mode":
            cfg["accel_mode"] = _choice(a, argv[i + 1], ("sphere", "grid"))
            i += 1
        elif a == "--sampler":
            cfg["sampler"] = _choice(a, argv[i + 1],
                                     ("locator", "brute", "wedge"))
            cfg["sampler_explicit"] = True
            i += 1
        elif a == "-o":
            cfg["out"] = argv[i + 1].removesuffix(".png"); i += 1
        elif a == "--quantized":
            cfg["quantized"] = True
        elif a in ("--finemap", "--no-finemap"):
            cfg["finemap"] = a == "--finemap"
        elif a == "--march":
            cfg["march"] = True
        elif a == "--preview":
            cfg["preview"] = max(0, int(argv[i + 1])); i += 1
        elif a == "--samples":
            v = argv[i + 1]
            cfg["samples"] = "auto" if v == "auto" else max(1, int(v))
            i += 1
        elif a == "--device":
            cfg["device"] = argv[i + 1]; i += 1
        i += 1
    return cfg


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return 0
    pl = build(argv)
    if pl is None:
        return 1
    # render loop (ref: hostCode.cu:931-965)
    while True:
        pl.launch()
        if not pl.is_running():
            break
    pl.present()
    return 0


def _device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available here "
                           "(use --device cpu for the plain PyTorch path)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return dev


def build(argv):
    """Construct the fully wired Pipeline (render fn, TF handler) without
    running the frame loop."""
    cfg = parse_app_args(argv)
    dev = _device(cfg["device"])

    import torch

    from .data import icfile, synthetic
    from .models.accel import (build_grid_accel, build_shell_accel,
                               update_majorants)
    from .models.cells import build_cells, compute_stats
    from .models.locator import build_locator
    from .models.shells import (build_radial_bands,
                                build_radial_bands_wedge,
                                update_band_majorants)
    from .models.wedges import build_wedges
    from .models.transfunc import DEFAULT_COLORS
    from .ops.camera import Camera
    from .ops.fast import (apply_opacity_scale, pack_alpha_scale_parts,
                           pack_cells, pack_cells_wedge, render_frame_fast,
                           wedge_rows)
    from .ops.fastq import render_frame_fast_q
    from .ops.march import render_frame_march, render_frame_march_q
    from .ops.order import inverse_order, pixel_order
    from .ops.render import (alloc_frame, make_launch_params,
                             render_frame_accel, render_frame_ae)
    from .pipeline.pipeline import Pipeline, TransfuncState
    from .utils import autosize

    # -- dataset (ref: hostCode.cu:717-808) ---------------------------------
    if cfg["synthetic"] is not None:
        subdiv, layers = cfg["synthetic"]
        ds = synthetic.icosphere(subdivisions=subdiv, num_layers=layers)
    else:
        if not cfg["filepath"]:
            print("Usage: icon_rt <file.ic> | --synthetic SUBDIV[:LAYERS]",
                  file=sys.stderr)
            return None
        ds = icfile.read_ic(cfg["filepath"], cfg["num_cells"]
                            if cfg["num_cells"] >= 0 else None)
        ds = ds.crop(cfg["lat_range"], cfg["lon_range"])
    print(f"cells: {ds.num_cells}")
    stats = compute_stats(ds)

    # the f32 tier's tables (the parity raygens render from them too); the
    # quantized tier builds its own in get_q
    timings = {}
    f32_tabs = {"cells": None, "locator": None}

    def get_f32():
        """(cells, locator) of the f32 tier, built on first use."""
        if f32_tabs["cells"] is None:
            t0 = time.perf_counter()
            f32_tabs["cells"] = build_cells(ds, device=dev)
            t1 = time.perf_counter()
            f32_tabs["locator"] = build_locator(ds, device=dev)
            timings.update(cells_s=t1 - t0,
                           locator_s=time.perf_counter() - t1)
        return f32_tabs["cells"], f32_tabs["locator"]

    cells = locator = None
    if not cfg["quantized"]:
        cells, locator = get_f32()

    pl = Pipeline(argv, name=cfg["out"])
    pl.set_frame(512, 512)
    # the preview tier (off in batch mode unless --preview N; the viewer
    # turns it on): the first frame after a reset at 1/N resolution
    pl.preview_scale = cfg["preview"]

    cam = Camera()
    cam.set_aspect(pl.width / pl.height)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    pl.set_camera(cam)

    if not pl.transfunc_valid():
        vr = stats.data_range
        if not (vr[0] < vr[1]):
            vr = np.array([0.0, 1.0], np.float32)
        pl.set_transfunc(TransfuncState(DEFAULT_COLORS, tuple(vr)))

    # value histogram for the TFE overlay (ref: alpha_editor.cpp:209-234)
    if pl.tfe is not None and ds.num_cells:
        mask = (np.arange(ds.value.shape[1])[None, :]
                < ds.num_layers[:, None])
        counts, _ = np.histogram(ds.value[mask], bins=64,
                                 range=tuple(stats.data_range)
                                 if stats.data_range[0] < stats.data_range[1]
                                 else (0.0, 1.0))
        pl.tfe.set_histogram(counts)

    # unit distance slider scaled to shell magnitude (ref: hostCode.cu:838-841)
    magnitude = np.floor(np.log10(stats.spherical_bounds_lo[0]))
    scale = 10.0 ** (magnitude - 3)
    state = {"unit_distance": 1.0 * scale, "accel_active": True,
             "mode": cfg["mode"], "accel_mode": cfg["accel_mode"],
             "raygen": cfg["raygen"]}
    pl.ui_param("Unit distance", lambda: state["unit_distance"],
                lambda v: state.__setitem__("unit_distance", v),
                minf=0.01 * scale, maxf=5.0 * scale)
    pl.ui_param("Use naive accel", lambda: state["accel_active"],
                lambda v: state.__setitem__("accel_active", v))

    def setter(key, options):
        def set_(v):
            if v not in options:
                raise ValueError(f"{key} {v!r}: expected one of {options}")
            state[key] = v
        return set_

    # live mode toggles (ref: hostCode.cu:138-199 toggleRayGen/Mode/
    # AccelMode, UI at :843-857): render() reads `state` every frame, so a
    # set_ui_param swaps the path and resets accumulation.  "Sampler mode"
    # and "Accel mode" apply to the parity raygens (accel, ae).
    pl.ui_param("Raygen", lambda: state["raygen"],
                setter("raygen", ("fast", "accel", "ae")),
                options=["fast", "accel", "ae"])
    pl.ui_param("Sampler mode", lambda: state["mode"],
                setter("mode", (0, 1, 2)),
                options=["user geom mode", "triangle mode", "cuBQL mode"])
    pl.ui_param("Accel mode", lambda: state["accel_mode"],
                setter("accel_mode", ("sphere", "grid")),
                options=["sphere accel", "grid accel"])

    def set_opacity(v):
        """Live opacity-scale slider (the reference's opacityScale,
        ref: tfe.cpp:29-50), routed through the TFE dirty flags."""
        if pl.tfe is not None:
            pl.tfe.set_opacity_scale(float(v))
        elif pl.transfunc is not None:
            pl.transfunc.opacity = float(v)
            on_tf_update(pl.transfunc, pl.tf_index)

    pl.ui_param("Opacity scale", lambda: (pl.tfe.get_opacity_scale()
                                          if pl.tfe is not None else
                                          (pl.transfunc.opacity
                                           if pl.transfunc else 1.0)),
                set_opacity, minf=0.0, maxf=10.0)

    # -- radial bands and baked rows: built on first use, refreshed on every
    # TF edit (ref: hostCode.cu:878-909) -----------------------------------
    device = {}
    struct = {"bands": None, "packed": None, "q": None, "loc_q": None,
              "q_tf": None, "fm": None, "alpha_parts": None, "sphere": None,
              "grid": None, "wedges": None, "bands_w": None,
              "rows_w": None, "packed_w": None}

    def get_bands():
        if struct["bands"] is None:
            struct["bands"] = update_band_majorants(
                build_radial_bands(ds, cfg["bands"], device=dev),
                device["tf"].values, device["tf"].value_range)
        return struct["bands"]

    def get_packed():
        if struct["packed"] is None:
            struct["packed"] = pack_cells(cells, device["tf"])
        return struct["packed"]

    # the wedge sampler's tables (apps/icon_rt.py:247-276, :326-332): the
    # wedges of the parity raygens, the fast wedge tier's bands and baked
    # rows, each built on first use
    def get_wedges():
        if struct["wedges"] is None:
            t0 = time.perf_counter()
            struct["wedges"] = build_wedges(ds, device=dev)
            timings["wedges_s"] = time.perf_counter() - t0
        return struct["wedges"]

    def get_bands_wedge():
        if struct["bands_w"] is None:
            t0 = time.perf_counter()
            struct["bands_w"] = update_band_majorants(
                build_radial_bands_wedge(ds, cfg["bands"], device=dev),
                device["tf"].values, device["tf"].value_range)
            timings["bands_w_s"] = time.perf_counter() - t0
        return struct["bands_w"]

    def get_packed_wedge():
        if struct["packed_w"] is None:
            t0 = time.perf_counter()
            struct["rows_w"] = wedge_rows(get_f32()[0])
            struct["packed_w"] = pack_cells_wedge(get_f32()[0], device["tf"],
                                                  struct["rows_w"])
            timings["packed_w_s"] = time.perf_counter() - t0
        return struct["packed_w"]

    def get_q():
        """Quantized tier (--quantized): cells, the locator (K7-loc) and
        (with --finemap, not --march) the fine map, built on first use; the
        u8 alpha table re-bakes (K5c-q) only when the device TF changed.
        The bands stay those of the unquantized dataset (get_bands), as in
        the JAX app.  Returns (q, locator, k_cap)."""
        from .data.bigscene import build_finemap_cached
        from .models.locator import bin_locator
        from .models.qcells import (bake_alpha_q, quantize_cells,
                                    quantize_dataset_values)
        if struct["q"] is None:
            ds_q, lo, hi = quantize_dataset_values(ds)
            struct["q"] = quantize_cells(ds_q, value_range=(lo, hi),
                                         device=dev)
            lat, lon = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in (ds_q.lat, ds_q.lon))
            struct["loc_q"] = bin_locator(lat, lon)[:2]
            if cfg["finemap"] and not cfg["march"]:
                # the quantized march renders without the fine map
                # (apps/icon_rt.py:489-493), so it is not built for it
                if cfg["synthetic"] is not None:
                    key = "app_s%d_l%d" % cfg["synthetic"]
                else:
                    st = os.stat(cfg["filepath"])
                    key = "app_%s_%d_%d" % (
                        os.path.basename(cfg["filepath"]).removesuffix(".ic"),
                        st.st_size, int(st.st_mtime))
                struct["fm"] = build_finemap_cached(
                    struct["loc_q"][0], struct["q"].test12, factor=2,
                    cache_key=key)
        if struct["q_tf"] is not device["tf"]:
            # the old table is referenced nowhere else: donate it
            struct["q"] = bake_alpha_q(struct["q"], device["tf"],
                                       donate=True)
            struct["q_tf"] = device["tf"]
        return (struct["q"], *struct["loc_q"])

    def get_accel(mode):
        """The parity accel raygen's ShellAccel ('sphere', 1 x 1024 x 1024
        bins) or GridAccel ('grid', 256^3), built on first use (host numpy
        and the native rasterizer) with its majorants (K5b)."""
        if struct[mode] is None:
            t0 = time.perf_counter()
            if mode == "sphere":
                acc = build_shell_accel(ds, stats.spherical_bounds_lo,
                                        stats.spherical_bounds_hi, device=dev)
            else:
                acc = build_grid_accel(ds, stats.world_bounds_lo,
                                       stats.world_bounds_hi, device=dev)
            struct[mode] = update_majorants(acc, device["tf"].values,
                                            device["tf"].value_range)
            timings[f"{mode}_s"] = time.perf_counter() - t0
        return struct[mode]

    def on_tf_update(tf_state, index):
        """TF-edit handler: new device LUT, band majorants (K5b) and baked
        rows of the f32 tier.  An edit that changes only the opacity scale
        (LUT and ranges as before) re-derives the baked alpha from parts
        baked once per LUT and range (K5c-f32, apps/icon_rt.py:334-374);
        any other edit re-runs the full bake (K5a).  The quantized tier
        re-bakes its alpha table in get_q at the next launch.  The wedge
        tier's bands get their majorants again (K5b) and its rows are baked
        again in full (pack_cells_wedge: no scale-only shortcut, as
        apps/icon_rt.py:374-381) over the TF-independent test rows and bv
        kept from the first build."""
        sig = (tf_state.lut.tobytes(), tf_state.value_range.tobytes(),
               tf_state.rel_range.tobytes())
        scale_only = device.get("tf_sig") == sig
        device["tf_sig"] = sig
        device["tf"] = tf_state.to_device(device=dev)
        if struct["bands"] is not None:
            struct["bands"] = update_band_majorants(
                struct["bands"], device["tf"].values,
                device["tf"].value_range)
        for mode in ("sphere", "grid"):
            if struct[mode] is not None:
                struct[mode] = update_majorants(
                    struct[mode], device["tf"].values,
                    device["tf"].value_range)
        if not scale_only:
            struct["alpha_parts"] = None   # parts are baked per LUT + range
        if struct["packed"] is not None:
            if scale_only:
                if struct["alpha_parts"] is None:
                    struct["alpha_parts"] = pack_alpha_scale_parts(
                        cells, device["tf"])
                struct["packed"] = apply_opacity_scale(
                    struct["packed"], struct["alpha_parts"],
                    device["tf"].opacity_scale)
            else:
                struct["packed"] = pack_cells(cells, device["tf"])
        if struct["bands_w"] is not None:
            struct["bands_w"] = update_band_majorants(
                struct["bands_w"], device["tf"].values,
                device["tf"].value_range)
        if struct["packed_w"] is not None:
            struct["packed_w"] = pack_cells_wedge(get_f32()[0], device["tf"],
                                                  struct["rows_w"])

    pl.set_transfunc_update_handler(on_tf_update)
    on_tf_update(pl.transfunc, 0)

    W, H = pl.width, pl.height
    frame = {"perm": None, "inv": None, "n_active": None, "raygen": None,
             "natural": False}
    frame["accum"], frame["fb"] = alloc_frame(W, H, device=dev)
    r_in, r_out = stats.spherical_bounds_lo[0], stats.spherical_bounds_hi[0]

    def render_preview():
        """The preview tier (apps/icon_rt.py:420-457): one sample at
        (W/N, H/N) through K6 and K1 (K2 with --quantized) on exactly K6's
        covered lanes, unpermuted and upscaled on the host; returns the
        natural-order (H*W,) host fb.  samples_per_launch 0: the full-res
        sample 0 renders on the next launch."""
        pl.preview_pending = False
        pl.samples_per_launch = 0
        sc = pl.preview_scale
        Wp, Hp = W // sc, H // sc
        lp = make_launch_params(
            cam.basis(Wp, Hp), stats.world_bounds_lo, stats.world_bounds_hi,
            ambient_color=(1.0, 1.0, 1.0), ambient_radiance=1.0,
            unit_distance=state["unit_distance"], accum_id=0, device=dev)
        p, n_cov = pixel_order(lp, r_in, r_out, Wp, Hp)
        acc, fb = alloc_frame(Wp, Hp, device=dev)
        kw = dict(width=Wp, height=Hp, pixel_perm=p, n_active=n_cov,
                  samples=1)
        if cfg["quantized"]:
            q, loc_q, _ = get_q()
            render_frame_fast_q(q, loc_q, get_bands(), device["tf"], lp, acc,
                                fb, finemap=struct["fm"], **kw)
        else:
            render_frame_fast(cells, get_packed(), locator, get_bands(), lp,
                              acc, fb, **kw)
        small = fb.cpu().numpy()[inverse_order(p.cpu().numpy())]
        frame["natural"] = True
        return np.repeat(np.repeat(small.reshape(Hp, Wp), sc, axis=0),
                         sc, axis=1).ravel()

    def render(frame_id):
        raygen = state["raygen"]
        # the reference's sampler modes (ref: Params.h:29-31): 2 = cuBQL ->
        # the wedge sampler; 0/1 -> analytic column sampling (locator),
        # unless --sampler chose one (apps/icon_rt.py:392-396)
        sampler = "wedge" if state["mode"] == 2 else (
            cfg["sampler"] if cfg.get("sampler_explicit") else "locator")
        # samples per launch, clamped so batch mode honors --sample-limit;
        # the parity raygens render one sample per launch (the oracle).
        # --samples auto: frames 0 and 1 render one sample, frame 1 (the
        # probe) sizes every later launch (apps/icon_rt.py:401-414)
        auto = cfg["samples"] == "auto" and raygen == "fast"
        want = 1 if raygen != "fast" else (
            state.get("auto_spl", 1) if auto else cfg["samples"])
        spl = max(1, min(want, pl.sample_limit - frame_id
                         if not pl.interactive else want))
        pl.samples_per_launch = spl
        probe = auto and "auto_spl" not in state and frame_id >= 1
        t_probe = time.perf_counter() if probe else None
        if (pl.preview_pending and raygen == "fast"
                and (sampler != "wedge" or cfg["quantized"])
                and pl.preview_scale > 1 and W % pl.preview_scale == 0
                and H % pl.preview_scale == 0):
            return render_preview()
        frame["natural"] = False
        if frame_id == 0:
            frame["accum"], frame["fb"] = alloc_frame(W, H, device=dev)
            # mode changes reset accumulation, so the buffer's layout
            # (permuted for fast, natural otherwise) holds for a whole run
            frame["raygen"] = raygen
        lp = make_launch_params(
            cam.basis(W, H), stats.world_bounds_lo, stats.world_bounds_hi,
            ambient_color=(1.0, 1.0, 1.0), ambient_radiance=1.0,
            unit_distance=state["unit_distance"], accum_id=frame_id,
            device=dev)
        if raygen != "fast":
            c, loc = get_f32()
            kw = dict(width=W, height=H, sampler=sampler, locator=loc,
                      wedges=get_wedges() if sampler == "wedge" else None)
            if raygen == "accel" and state["accel_active"]:
                mode = state["accel_mode"]
                render_frame_accel(c, device["tf"], get_accel(mode), lp,
                                   frame["accum"], frame["fb"],
                                   accel_mode=mode, **kw)
            else:
                render_frame_ae(c, device["tf"], lp, frame["accum"],
                                frame["fb"], **kw)
            return frame["fb"]
        if frame["perm"] is None or frame_id == 0:
            # re-sort rays by expected cost on camera change (K6)
            p, n_cov = pixel_order(lp, r_in, r_out, W, H)
            frame["inv"] = inverse_order(p).cpu().numpy()
            frame["perm"] = p
            frame["n_active"] = n_cov
        if cfg["march"] and sampler != "wedge":
            # one converged pass per launch (apps/icon_rt.py:480-500); the
            # quantized march runs without the fine map, as there; with the
            # wedge sampler --march falls through to the tracker
            pl.samples_per_launch = 1
            kw = dict(width=W, height=H, pixel_perm=frame["perm"],
                      n_active=frame["n_active"])
            if cfg["quantized"]:
                q, loc_q, _ = get_q()
                render_frame_march_q(q, loc_q, get_bands(), device["tf"], lp,
                                     frame["accum"], frame["fb"], **kw)
            else:
                render_frame_march(cells, get_packed(), locator, get_bands(),
                                   lp, frame["accum"], frame["fb"], **kw)
        elif cfg["quantized"]:
            # --quantized takes precedence over the wedge sampler
            # (apps/icon_rt.py:501-509)
            q, loc_q, _ = get_q()
            render_frame_fast_q(q, loc_q, get_bands(), device["tf"], lp,
                                frame["accum"], frame["fb"], width=W,
                                height=H, pixel_perm=frame["perm"],
                                n_active=frame["n_active"], samples=spl,
                                finemap=struct["fm"])
        elif sampler == "wedge":
            # mode 2 on the fast raygen: the wedge tier (K9-w,
            # apps/icon_rt.py:510-518)
            render_frame_fast(cells, get_packed_wedge(), locator,
                              get_bands_wedge(), lp, frame["accum"],
                              frame["fb"], width=W, height=H,
                              pixel_perm=frame["perm"],
                              n_active=frame["n_active"], samples=spl,
                              sampler="wedge")
        else:
            render_frame_fast(cells, get_packed(), locator, get_bands(), lp,
                              frame["accum"], frame["fb"], width=W,
                              height=H, pixel_perm=frame["perm"],
                              n_active=frame["n_active"], samples=spl)
        if probe:
            # the probe's clock is read once the card has finished: launches
            # are asynchronous, and the enqueue alone would pick 64
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            state["auto_spl"] = autosize.auto_spp(
                time.perf_counter() - t_probe, budget_s=AUTO_BUDGET_S)
            print(f"# auto samples/launch: {state['auto_spl']}",
                  file=sys.stderr, flush=True)
        return frame["fb"]

    pl.set_render_fn(render)

    def present_fn(fb, w, h):
        # the fast path renders in ray-sorted order; unpermute on the host
        # (a preview frame arrives in natural order, upscaled)
        if frame["raygen"] == "fast" and not frame["natural"]:
            fb = fb[frame["inv"]]
        pl.write_frame(fb)
    pl.present_fn = present_fn
    # the wired state, for drivers that measure the path (chip_smoke.py)
    pl.frame = frame
    pl.scene = {"cells": cells, "locator": locator, "stats": stats,
                "camera": cam, "get_bands": get_bands,
                "get_packed": get_packed, "get_q": get_q,
                "fm": lambda: struct["fm"], "tf": lambda: device["tf"],
                "unit_distance": lambda: state["unit_distance"],
                "get_f32": get_f32, "get_accel": get_accel,
                "get_wedges": get_wedges, "get_bands_wedge": get_bands_wedge,
                "get_packed_wedge": get_packed_wedge, "timings": timings,
                "auto_spl": lambda: state.get("auto_spl")}
    return pl
