#!/usr/bin/env python
"""The port's deterministic march (icon_rt_tpu_torch/ops/march.py) against
the JAX package's (icon_rt_tpu/ops/march.py) on the CPU: the measurements
behind PERF.md's findings on ties (ROADMAP Queue 3, F4) and on rmse_q.

  tie    the port's quantized march with and without the fine map, once with
         its column exit and once with JAX's (the `ti > t0` filter of
         icon_rt_tpu/ops/march.py `_column_exit`, ROADMAP Queue 3 F4): the
         lanes that differ beyond 1e-4 and the largest difference, at
         subdiv 5 x 16, 256x256, closeup camera, the lower half of the LUT
         transparent (--tf default: the LUT as it is)
  rmse   bench.py `_rmse_q_vs_f32` taken apart at subdiv 8 x 16, 480x270:
         the f32 and quantized marches of both packages compared pixel by
         pixel in natural order, the port's march on JAX's quantized
         tables, and the code and alpha tables of both

    JAX_PLATFORMS=cpu python scripts/torch_march_vs_jax.py tie
    JAX_PLATFORMS=cpu python scripts/torch_march_vs_jax.py rmse

`rmse` holds about 20 GB at its peak (the JAX f32 march at subdiv 8);
`tie` a few GB.  Both take a few minutes on 6 CPU threads.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from icon_rt_tpu_torch.ops import march as tm  # noqa: E402


def column_exit_jax(test16, t0, org, dx, dy, dz, od, oo, seg_hi):
    """ops/march.py `_column_exit` with JAX's filter: a side plane counts
    only where it is crossed after t0."""
    ox, oy, oz = org
    big = tm._BIG
    t_exit = torch.clamp(seg_hi, max=big)
    for i in (0, 4, 8):
        nx, ny, nz, w = (test16[:, i], test16[:, i + 1], test16[:, i + 2],
                         test16[:, i + 3])
        a = nx * ox + ny * oy + nz * oz - w
        b = nx * dx + ny * dy + nz * dz
        ti = torch.where(b > 1e-30, -a / torch.clamp(b, min=1e-30), big)
        t_exit = torch.minimum(t_exit, torch.where(ti > t0, ti, big))
    h_bot, h_top = test16[:, 12], test16[:, 13]
    disc_b = od * od - oo + h_bot * h_bot
    tb_in = -od - torch.sqrt(torch.clamp(disc_b, min=0.0))
    t_exit = torch.minimum(t_exit, torch.where((disc_b > 0.0) & (tb_in > t0),
                                               tb_in, big))
    tt_out = -od + torch.sqrt(torch.clamp(od * od - oo + h_top * h_top,
                                          min=0.0))
    return torch.minimum(t_exit, torch.where(tt_out > t0, tt_out, big))


def tie(args):
    from icon_rt_tpu_torch.models.finemap import build_finemap
    from icon_rt_tpu_torch.models.locator import (build_locator_csr,
                                                  densify_csr)
    from icon_rt_tpu_torch.models.qcells import (bake_alpha_q,
                                                 quantize_cells,
                                                 quantize_dataset_values)
    from icon_rt_tpu_torch.models.shells import update_band_majorants
    from icon_rt_tpu_torch.ops.fastq import _QTier
    dev = torch.device("cpu")
    sc = cs.Scene(args.subdiv, args.layers, args.size, args.size, dev)
    tf = sc.tf
    if args.tf == "transparent":
        lut = tf.values.clone()
        lut[: lut.shape[0] // 2, 3] = 0.0
        tf = tf._replace(values=lut)
    bands = update_band_majorants(sc.bands, tf.values, tf.value_range)
    ds_q, lo, hi = quantize_dataset_values(sc.ds)
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi)), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    fm = build_finemap(loc, q.test12)
    pix = sc.perm[:sc.n_cov].contiguous()
    port_exit = tm._column_exit
    for name, fn in (("port", port_exit), ("jax", column_exit_jax)):
        tm._column_exit = fn
        try:
            out = [tm._march_torch(_QTier(q, loc, tf, f), bands, sc.lp, pix,
                                   args.size, args.size)[1]
                   for f in (fm, None)]
        finally:
            tm._column_exit = port_exit
        d = (out[0] - out[1]).abs().amax(dim=1)
        print(f"tie column_exit={name} subdiv {args.subdiv} x {args.layers} "
              f"{args.size}x{args.size} tf={args.tf}: fine map on vs off "
              f"{int((d > 1e-4).sum())} of {pix.numel()} lanes beyond 1e-4, "
              f"max {float(d.max()):.4g}")


def rmse(args):
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    import bench
    from icon_rt_tpu.data import synthetic as jsyn
    from icon_rt_tpu.models.cells import build_cells as jcells
    from icon_rt_tpu.models.cells import compute_stats as jstats
    from icon_rt_tpu.models.locator import build_locator as jlocator
    from icon_rt_tpu.models.locator import build_locator_csr as jcsr
    from icon_rt_tpu.models.locator import densify_csr as jdensify
    from icon_rt_tpu.models.qcells import bake_alpha_q as jbake
    from icon_rt_tpu.models.qcells import quantize_cells as jquantize
    from icon_rt_tpu.models.qcells import quantize_dataset_values as jqvalues
    from icon_rt_tpu.models.shells import build_radial_bands as jbands
    from icon_rt_tpu.models.shells import update_band_majorants as jmajor
    from icon_rt_tpu.models.transfunc import make_transfunc as jmake_tf
    from icon_rt_tpu.ops import march as jm
    from icon_rt_tpu.ops.fast import pack_cells as jpack
    from icon_rt_tpu.ops.order import pixel_order as jorder
    from icon_rt_tpu.ops.render import alloc_frame as jalloc
    from icon_rt_tpu.ops.render import make_launch_params as jlp
    from icon_rt_tpu_torch import interop
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
    from icon_rt_tpu_torch.models.locator import (build_locator,
                                                  build_locator_csr,
                                                  densify_csr)
    from icon_rt_tpu_torch.models.qcells import (bake_alpha_q,
                                                 quantize_cells,
                                                 quantize_dataset_values)
    from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                                 update_band_majorants)
    from icon_rt_tpu_torch.models.transfunc import make_transfunc
    from icon_rt_tpu_torch.ops.fast import pack_cells
    from icon_rt_tpu_torch.ops.fastq import _QTier
    from icon_rt_tpu_torch.ops.order import pixel_order
    from icon_rt_tpu_torch.ops.render import alloc_frame, make_launch_params

    W, H, sub, layers = args.width, args.height, args.subdiv, args.layers

    def natural(acc, perm):
        out = np.zeros_like(acc)
        out[np.asarray(perm)] = acc
        return out

    # -- JAX: bench.py `_rmse_q_vs_f32`, keeping the accums -------------------
    t0 = time.perf_counter()
    ds_q, lo, hi = jqvalues(jsyn.icosphere(subdivisions=sub,
                                           num_layers=layers))
    st = jstats(ds_q)
    tf = jmake_tf(value_range=tuple(st.data_range))
    bands = jmajor(jbands(ds_q, 64), tf.values, tf.value_range)
    cam = bench._camera(st, "closeup")
    ud = 10.0 ** (np.floor(np.log10(st.spherical_bounds_lo[0])) - 3)
    lp = jlp(cam.basis(W, H), st.world_bounds_lo, st.world_bounds_hi,
             unit_distance=ud)._replace(accum_id=jnp.int32(0))
    perm, n_act = jorder(lp, st.spherical_bounds_lo[0],
                         st.spherical_bounds_hi[0], W, H)
    kw = dict(width=W, height=H, pixel_perm=jnp.asarray(perm),
              n_active=n_act, chunk=8192)
    cells = jcells(ds_q)
    af, _ = jm.render_frame_march(cells, jpack(cells, tf), jlocator(ds_q),
                                  bands, lp, *jalloc(W, H), **kw)
    jf = natural(np.asarray(af), perm)
    del cells, af
    jq_tab = jbake(jquantize(ds_q, value_range=(lo, hi)), tf)
    csr, k_cap = jcsr(ds_q)
    jloc = jdensify(csr, k_cap)
    aq, _ = jm.render_frame_march_q(jq_tab, jloc, k_cap, bands, tf, lp,
                                    *jalloc(W, H), **kw)
    jq = natural(np.asarray(aq), perm)
    jcode = np.asarray(jm._vq_rgb_table(jq_tab, tf)).reshape(256, 4)
    print(f"rmse JAX marches done ({time.perf_counter() - t0:.0f} s)")

    # -- the port: chip_smoke.py `rmse_q`'s scene, keeping the accums ---------
    torch.set_num_threads(args.threads)
    ds_t, lo_t, hi_t = quantize_dataset_values(synthetic.icosphere(sub,
                                                                   layers))
    st_t = compute_stats(ds_t)
    tf_t = make_transfunc(value_range=tuple(st_t.data_range))
    bands_t = update_band_majorants(build_radial_bands(ds_t, 64),
                                    tf_t.values, tf_t.value_range)
    lp_t = make_launch_params(cs.closeup_camera(st_t, W, H).basis(W, H),
                              st_t.world_bounds_lo, st_t.world_bounds_hi,
                              unit_distance=ud)
    perm_t, n_t = pixel_order(lp_t, st_t.spherical_bounds_lo[0],
                              st_t.spherical_bounds_hi[0], W, H)
    kw_t = dict(width=W, height=H, pixel_perm=perm_t, n_active=n_t)
    cells_t = build_cells(ds_t)
    af_t, _ = tm.render_frame_march(cells_t, pack_cells(cells_t, tf_t),
                                    build_locator(ds_t), bands_t, lp_t,
                                    *alloc_frame(W, H), **kw_t)
    pf = natural(af_t.numpy(), perm_t.numpy())
    del cells_t
    q_t = bake_alpha_q(quantize_cells(ds_t, value_range=(lo_t, hi_t)), tf_t)
    csr_t, kc_t = build_locator_csr(ds_t)
    loc_t = densify_csr(csr_t, kc_t)
    aq_t, _ = tm.render_frame_march_q(q_t, loc_t, bands_t, tf_t, lp_t,
                                      *alloc_frame(W, H), **kw_t)
    pq = natural(aq_t.numpy(), perm_t.numpy())
    # the port's march on JAX's quantized tables
    aq_j, _ = tm.render_frame_march_q(
        interop.quantized_cells(jq_tab, n=ds_q.num_cells),
        interop.locator_packed(jloc, k_cap), bands_t, tf_t, lp_t,
        *alloc_frame(W, H), **kw_t)
    pqj = natural(aq_j.numpy(), perm_t.numpy())
    pcode = _QTier(q_t, loc_t, tf_t, None).code_table.numpy()

    def err(a, b):
        both = (a[:, 3] > 0) & (b[:, 3] > 0)
        return float(np.sqrt(np.mean((a[both] - b[both]) ** 2)))

    print(f"rmse subdiv {sub} x {layers}, {W}x{H}, natural pixel order:")
    for name, a, b in (("port q vs port f32 (the port's rmse_q)", pq, pf),
                       ("JAX q vs JAX f32 (JAX's rmse_q)", jq, jf),
                       ("port f32 vs JAX f32", pf, jf),
                       ("port q vs JAX f32", pq, jf),
                       ("JAX q vs port f32", jq, pf),
                       ("port q vs JAX q", pq, jq),
                       ("port q on JAX's tables vs port f32", pqj, pf)):
        print(f"rmse   {name}: {err(a, b):.4g}")
    d = np.abs(jq - pq).max(axis=1)
    cov = (pq[:, 3] > 0) & (jq[:, 3] > 0)
    print(f"rmse JAX q vs port q: {int((d[cov] > 1e-3).sum())} of "
          f"{int(cov.sum())} covered pixels differ by more than 1e-3, max "
          f"{float(d.max()):.4g}")
    print(f"rmse code tables equal: {np.array_equal(jcode, pcode)}; u8 alpha "
          f"tables equal: "
          f"{np.array_equal(np.asarray(jq_tab.alpha_tab), q_t.alpha_tab)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("tie", "rmse"))
    ap.add_argument("--subdiv", type=int)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--size", type=int, default=256, help="tie: W = H")
    ap.add_argument("--width", type=int, default=cs.RMSE_W)
    ap.add_argument("--height", type=int, default=cs.RMSE_H)
    ap.add_argument("--tf", choices=("transparent", "default"),
                    default="transparent", help="tie: the LUT")
    ap.add_argument("--threads", type=int, default=6)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.what == "tie":
        args.subdiv = args.subdiv or 5
        tie(args)
    else:
        args.subdiv = args.subdiv or cs.MAIN_SUB
        rmse(args)


if __name__ == "__main__":
    main()
