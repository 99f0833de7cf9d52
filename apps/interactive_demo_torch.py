#!/usr/bin/env python
"""Scripted interactive session on the PyTorch/CUDA port (the five steps of
apps/interactive_demo.py through icon_rt_tpu_torch): exercises the full
interactive contract — arcball orbit (CameraManip), live
transfer-function alpha edits (TFE) with majorant refresh and
accumulation resets — without a windowing system.

Equivalent user actions in the reference: LMB-drag to orbit
(ref: common/camera.h:160-179), freehand alpha painting in the TFE widget
(ref: common/alpha_editor.cpp:263-320), each resetting progressive
accumulation (ref: common/pipeline.cu:1007-1034).  Writes one PNG per
interaction step plus the TFE widget image, `session.xf` and the camera's
CLI string.  Each step renders 4 samples through K1 (`render_frame_fast`,
natural pixel order); the TF handler re-bakes the rows (K5a) and the band
majorants (K5b).  Runs on the card unless --device cpu is given.

Usage: python apps/interactive_demo_torch.py [--synthetic SUBDIV[:LAYERS]]
           [--size N] [--device cuda|cpu] [-o DIR]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    subdiv, layers = 3, 6
    out_dir = "demo_out"
    size = 256
    device = "cuda"
    i = 0
    while i < len(argv):
        if argv[i] == "--synthetic":
            parts = argv[i + 1].split(":")
            subdiv = int(parts[0])
            layers = int(parts[1]) if len(parts) > 1 else 6
            i += 1
        elif argv[i] == "-o":
            out_dir = argv[i + 1]; i += 1
        elif argv[i] == "--size":
            size = int(argv[i + 1]); i += 1
        elif argv[i] == "--device":
            device = argv[i + 1]; i += 1
        i += 1
    os.makedirs(out_dir, exist_ok=True)

    from icon_rt_tpu_torch.app import _device
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
    from icon_rt_tpu_torch.models.locator import build_locator
    from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                                 update_band_majorants)
    from icon_rt_tpu_torch.models.transfunc import DEFAULT_COLORS
    from icon_rt_tpu_torch.ops.camera import Camera, CameraManip
    from icon_rt_tpu_torch.ops.fast import pack_cells, render_frame_fast
    from icon_rt_tpu_torch.ops.render import (alloc_frame, fb_to_image,
                                              make_launch_params)
    from icon_rt_tpu_torch.pipeline.pipeline import Pipeline, TransfuncState
    from icon_rt_tpu_torch.utils.metrics import PhaseTimer
    from icon_rt_tpu_torch.utils.png import write_png

    dev = _device(device)
    W = H = size
    ds = synthetic.icosphere(subdivisions=subdiv, num_layers=layers)
    stats = compute_stats(ds)
    cells = build_cells(ds, device=dev)
    loc = build_locator(ds, device=dev)

    pl = Pipeline([], name="interactive")
    pl.interactive = True
    pl.set_frame(W, H)
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r = stats.spherical_bounds_hi[0]
    cam.set_orientation(center + np.array([2.5 * r, 0, 0], np.float32), center,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    pl.set_camera(cam)
    manip = CameraManip(cam, W, H)
    pl.set_transfunc(TransfuncState(DEFAULT_COLORS, tuple(stats.data_range)))

    state = {"bands": build_radial_bands(ds, 64, device=dev), "packed": None,
             "tf": None}

    def on_tf(tf_state, index):
        state["tf"] = tf_state.to_device(device=dev)
        state["bands"] = update_band_majorants(state["bands"],
                                               state["tf"].values,
                                               state["tf"].value_range)
        state["packed"] = pack_cells(cells, state["tf"])
    pl.set_transfunc_update_handler(on_tf)
    on_tf(pl.transfunc, 0)

    unit_distance = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    timer = PhaseTimer()
    frame = {"accum": None, "fb": None}

    def render_samples(n, tag):
        frame["accum"], frame["fb"] = alloc_frame(W, H, device=dev)
        with timer.phase("frame"):
            for s in range(n):
                lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                                        stats.world_bounds_hi,
                                        unit_distance=unit_distance, accum_id=s,
                                        device=dev)
                frame["accum"], frame["fb"] = render_frame_fast(
                    cells, state["packed"], loc, state["bands"], lp,
                    frame["accum"], frame["fb"], width=W, height=H)
            img = fb_to_image(frame["fb"], W, H)
        path = os.path.join(out_dir, f"{tag}.png")
        write_png(path, img)
        print(f"{tag}: {path} ({(img[..., 3] > 0).mean():.2%} coverage)")

    # step 0: initial view
    render_samples(4, "step0_initial")

    # step 1-2: arcball orbit drag (LMB)
    manip.handle_mouse_down(W // 2, H // 2, CameraManip.LEFT)
    manip.handle_mouse_move(W // 2 + W // 4, H // 2, CameraManip.NOMOD)
    pl.reset_accumulation()
    render_samples(4, "step1_orbit_right")
    manip.handle_mouse_move(W // 2 + W // 4, H // 2 - H // 5, CameraManip.NOMOD)
    manip.handle_mouse_up(W // 2 + W // 4, H // 2 - H // 5, CameraManip.LEFT)
    pl.reset_accumulation()
    render_samples(4, "step2_orbit_up")

    # step 3: dolly zoom (RMB)
    manip.handle_mouse_down(W // 2, H // 2, CameraManip.RIGHT)
    manip.handle_mouse_move(W // 2, H // 2 + H // 4, CameraManip.NOMOD)
    manip.handle_mouse_up(W // 2, H // 2 + H // 4, CameraManip.RIGHT)
    pl.reset_accumulation()
    render_samples(4, "step3_zoom")

    # step 4: freehand TF alpha edit (paint a low-alpha notch), then harvest
    tfe = pl.tfe
    tfe.draw_stroke([(60, 140), (90, 5), (120, 140)])
    pl._harvest_tfe()        # the dirty flags fire the TF handler (K5a, K5b)
    render_samples(4, "step4_tf_edit")
    write_png(os.path.join(out_dir, "tfe_widget.png"), tfe.rasterize(),
              flip_vertically=False)

    # state artifacts: camera CLI + .xf (Shift+C / Shift+T parity)
    print(pl.camera_cli_string())
    pl.save_transfunc(os.path.join(out_dir, "session.xf"))
    print(timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
