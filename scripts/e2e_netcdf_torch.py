#!/usr/bin/env python
"""Real-data ingest, end to end, on the PyTorch/CUDA port.

The reference renders DWD ICON NetCDF output
(ref: tools/convert_icon/convert_icon.cpp:163-452).  This script writes an
R2B7-scale (327,680-column, 16-level) NetCDF dataset in the DWD layout the
converter expects -- an icosahedral clat/clon_vertices grid in the (nv,
cell) layout of DWD grid files, HSURF terrain, one HHL file per height
level (top first), one data file per level with a 'pres' variable -- and
runs the production path on it:

  NetCDF -> convert_icon CLI -> .ic -> read_ic -> the app (tables, K6, K1
         or with --quantized K5c-q, K7-loc, K7-fm and K2) -> PNG

printing the seconds of every stage.

    python scripts/e2e_netcdf_torch.py [--subdiv 7] [--levels 16]
        [--size 1920 1080] [--sample-limit 8] [--quantized]
        [--device cuda|cpu] [--workdir DIR] [-o NAME]

Without --workdir the NetCDF and .ic files go to a temporary directory,
removed at the end.  Imports nothing of the JAX package.
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_netcdf_inputs(workdir: str, subdiv: int, levels: int):
    """DWD-layout NetCDF files of the synthetic icosahedral grid (the files
    of scripts/e2e_netcdf.py `make_netcdf_inputs`, written through
    scipy.io.netcdf_file): the grid's radian corners in the (nv, cell)
    layout of DWD grid files, smooth HSURF terrain, levels + 1
    terrain-following HHL levels top first, and `levels` 'pres' files of a
    banded wave at a pressure-like magnitude.  Returns (hgrid, hsurf,
    hhl_files, data_files)."""
    from scipy.io import netcdf_file

    from icon_rt_tpu_torch.data.synthetic import _default_field, icosphere

    ds = icosphere(subdivisions=subdiv, num_layers=1)   # geometry only
    ncell = ds.num_cells
    lat, lon = ds.lat, ds.lon
    os.makedirs(workdir, exist_ok=True)

    def write(path, dims, variables, version=2):
        f = netcdf_file(path, "w", version=version)
        for n, s in dims.items():
            f.createDimension(n, s)
        for name, (dimnames, data) in variables.items():
            v = f.createVariable(name, data.dtype.newbyteorder(">"), dimnames)
            v[:] = data
        f.close()

    hgrid = os.path.join(workdir, "icon_grid.nc")
    write(hgrid, {"nv": 3, "cell": ncell},
          {"clat_vertices": (("nv", "cell"), lat.T.astype(np.float32)),
           "clon_vertices": (("nv", "cell"), lon.T.astype(np.float32))})

    clat = lat.mean(axis=1)
    clon = np.arctan2(np.sin(lon).mean(axis=1), np.cos(lon).mean(axis=1))
    hsurf_v = (600.0 + 500.0 * np.sin(2 * clat) * np.cos(3 * clon)
               ).astype(np.float32)
    hsurf = os.path.join(workdir, "hsurf.nc")
    write(hsurf, {"cell": ncell}, {"HSURF": (("cell",), hsurf_v)})

    top = 30000.0
    hhl_files, data_files = [], []
    for k in range(levels + 1):
        frac = 1.0 - k / levels           # level k, the 30 km top first
        h = (hsurf_v + (top - hsurf_v) * frac).astype(np.float32)
        p = os.path.join(workdir, f"hhl_{k:02d}.nc")
        write(p, {"cell": ncell}, {"HHL": (("cell",), h)})
        hhl_files.append(p)
    for k in range(levels):
        depth = np.float32(1.0 - (k + 0.5) / levels)   # top first, as HHL
        v = _default_field(clat.astype(np.float32),
                           clon.astype(np.float32), depth)
        v = (50000.0 + 45000.0 * v).astype(np.float32)
        p = os.path.join(workdir, f"pres_{k:02d}.nc")
        write(p, {"cell": ncell}, {"pres": (("cell",), v)})
        data_files.append(p)
    return hgrid, hsurf, hhl_files, data_files


def convert_argv(inputs, out):
    """The convert_icon CLI's arguments for make_netcdf_inputs' files."""
    hgrid, hsurf, hhl, data = inputs
    return ["-hgrid", hgrid, "-hsurf", hsurf, "-hhl", *hhl, "-data", *data,
            "-o", out]


def camera_argv(ds, width, height):
    """--camera and -fovy of the bench's closeup framing of `ds`."""
    from icon_rt_tpu_torch.data.lod import frame_camera
    from icon_rt_tpu_torch.models.cells import compute_stats
    cam = frame_camera(compute_stats(ds), "closeup", width, height)
    pose = [*cam.position, *cam.get_poi(), *cam.up_vector]
    return ["--camera", *[repr(float(v)) for v in pose],
            "-fovy", repr(float(cam.get_fovy_degrees()))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--levels", type=int, default=16)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--size", type=int, nargs=2, default=(1920, 1080))
    ap.add_argument("--sample-limit", type=int, default=8)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-o", "--out", default="e2e_netcdf_torch")
    args = ap.parse_args(argv)

    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.data.icfile import read_ic
    from icon_rt_tpu_torch.tools import convert_icon

    workdir = args.workdir or tempfile.mkdtemp(prefix="icon_e2e_")
    try:
        t0 = time.perf_counter()
        inputs = make_netcdf_inputs(workdir, args.subdiv, args.levels)
        files = [inputs[0], inputs[1], *inputs[2], *inputs[3]]
        mb = sum(os.path.getsize(p) for p in files) / 1e6
        print(f"[1] NetCDF: {len(inputs[2])} HHL + {len(inputs[3])} data "
              f"files, {mb:.1f} MB, {time.perf_counter() - t0:.2f} s",
              flush=True)

        t0 = time.perf_counter()
        out = os.path.join(workdir, f"r2b{args.subdiv}")
        if convert_icon.main(convert_argv(inputs, out)) != 0:
            raise RuntimeError("convert_icon failed")
        ic_path = out + ".ic"
        print(f"[2] convert_icon -> .ic: {os.path.getsize(ic_path) / 1e6:.1f}"
              f" MB, {time.perf_counter() - t0:.2f} s", flush=True)

        t0 = time.perf_counter()
        ds = read_ic(ic_path)
        print(f"[3] read_ic: {ds.num_cells} columns, "
              f"{int(ds.num_layers.max())} layers, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        W, H = args.size
        argv_app = [ic_path, "--device", args.device, "--size", str(W),
                    str(H), "--sample-limit", str(args.sample_limit),
                    *camera_argv(ds, W, H), "-o", args.out]
        if args.quantized:
            argv_app.append("--quantized")
        t0 = time.perf_counter()
        pl = app.build(argv_app)
        print(f"[4] app build (read, tables): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        launch_s = []
        while True:
            t0 = time.perf_counter()
            pl.launch()
            pl.frame["fb"].cpu()           # the launch's output on the host
            launch_s.append(time.perf_counter() - t0)
            if not pl.is_running():
                break
        fb = pl.frame["fb"].cpu().numpy()
        covered = float((fb != 0).mean())
        print(f"[5] render {args.sample_limit} samples at {W}x{H}: "
              f"{len(launch_s)} launches, seconds "
              f"{[round(s, 4) for s in launch_s]} (the first orders the "
              f"rays and bakes), covered {covered:.3f}", flush=True)
        pl.present()
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
