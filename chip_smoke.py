#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (icon_rt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints lines starting with its tag; any failure raises and the
script exits non-zero without printing a result):

  env     the card's name and power limit; there is no CPU fallback
  build   the nvcc builds of K1 (csrc/track_f32.cu), K2 (csrc/track_q.cu),
          K7-fm (csrc/finemap.cu), K3 (csrc/march.cu), K7-scene
          (csrc/scene.cu), K7-loc (csrc/locator.cu), K8 and K9-p
          (csrc/parity.cu), K9-w (csrc/track_wedge.cu), K9-n
          (csrc/uelems.cu), K10 (csrc/composite.cu), K5b
          (csrc/majorant.cu), K5c-q (csrc/bake_q.cu), K6 and K6b
          refine_keys, refine_perm (csrc/order.cu), started together,
          and the first Triton compile of K5a and K5c-f32,
          with their seconds and the ptxas register/spill lines
  check   every kernel against its plain PyTorch version on the card, at
          subdiv 5 x 16 layers, 256x256, closeup camera:
            K1  samples=4, both preserve_cache settings: fb identical on
                >= 99.9% of pixels, accum max-abs-diff <= 1e-6
            K5a <= 1 ULP    K5b exact    K6 keys <= 1 ULP (bit-equality
                printed), the same coverage and covered count
  check q the quantized tier's kernels at the same shape:
            K2  samples=4, both preserve_cache settings, the fine map on
                and off: fb identical on >= 99.9%, accum <= 1e-6
            K5c-q full lookup and <= 32-level patch: u8 tables exact
            K7-fm slots exact
  check m the march's kernels at the same shape, accum_id 0 and 3:
            K3-f32, K3-q (fine map on and off): fb identical on >= 99.9%,
                accum <= 1e-6; K3-q fine map on against off: accum <= 1e-4
            K5c-f32 parts and apply exact; a scale-only edit's prof against
                a full K5a bake at the new scale: its ULP printed, <= 1
          check march cost: K3's cost output (each lane's iterations at its
          pixel) on both tiers (K3-q with the fine map on and off) against
          its plain version, exact, and the frame with the cost bit-equal
          to the frame without; at 1080p again in `time`
  check w the unstructured elements' kernels at the same shape: K5a over
          the per-wedge constants bv (<= 1 ULP); K9-w samples=4, both
          preserve_cache settings (fb identical on >= 99.9%, accum <=
          1e-6); K9-n on 65,536 seeded points per element shape (pyramid,
          wedge, hexahedron), and wedges at 2,073,600 points (one a 1080p
          lane) and at 1, 127, 129 and 65,537 points into out= (also
          with NaN scalars on the elements that do not contain their
          point): inside flags (bool) and values bit-equal; the wedge
          timed at both sizes (events, profiled kernel and device ms,
          registers)
  check composite  K10 (csrc/composite.cu): its three masks and two
          finalizes against their plain versions on crafted inputs (ties
          of equal t, every slab +inf, lanes without a write) of 2,073,600
          and 8,294,400 lanes, bit-equal; K1 and K2 in raw mode with
          rng_salt 0, 1, 2 against their plain versions on the check scene
          (wrote identical, colour and t identical on >= 99.9% of lanes,
          colour <= 1e-6); a raw sample through K10's finalize bit-equal to
          the finalizing launch of the same sample
  main    the app's main path (icon_rt_tpu_torch.app.build, then the
          launch / is_running / present loop of apps/icon_rt.py) at subdiv
          8 x 16 layers, 1920x1080, 16 samples (8 per launch), closeup
          camera of bench.py; the launch counters of all four kernels are
          zeroed before and read after, the image must cover >= 0.5 of the
          frame; then the same loop runs on to 128 samples, and the median
          and spread of the steady launches' wall time (fb copied to the
          host) give the end-to-end rate
  main preview  --preview 4 on the main path's pipeline after `profile`
          (and `main preview q` on main q's, before its TF edits): a camera
          move and a reset, then the preview launch (K6 and K1, or K2 with
          the fine map, one sample at 480x270 on K6's covered lanes): K1
          (K2) against its plain version on those lanes, the presented
          1920x1080 fb in constant 4x4 blocks and equal to the plain
          version's frame upscaled, frame_id 0 after is_running() (fault
          F2 of the JAX pipeline not copied), the next full-res launch
          bit-equal to one without a preview; the preview launch's ms
          (events, fb on the host), K6's and K1's (K2's) device time in a
          profiled preview launch, a full-res one-sample launch's ms
  main viewer  apps/viewer_torch.py `serve` on the same pipeline
          (127.0.0.1, port 0, preview 4, sample limit 16 in launches of
          8): the first frame, a TFE stroke, the Raygen toggle to ae and
          back, a view drag; each reset's first frame a preview (ae: its
          first launch) at X-Accum-Id 0, then frames to the sample limit;
          the drag's converged frame bit-equal to a direct render of its
          camera; per event the edit latency, the launch and PNG-encode ms,
          fps and Mray/s; the phase's launch counts
  main w  the app with -mode 2 on the fast raygen (the wedge tier, K9-w)
          at the same scale and camera: 16 samples, 8 per launch, then on
          to 128; the counters of K9-w, K5a, K5b and K6 zeroed before the
          build and read after (K1 must read 0); layer_pad, the build
          seconds of bands_w and packed_w, the steady launch's median and
          spread, Mray/s full and traced, coverage >= 0.5; an opacity-scale
          and a curve edit, each timed to the next fb on the host; a
          profiled launch; K9-w against its plain version on the first 4096
          covered lanes and on 4096 lanes strided over the covered prefix
          (whose counted work gives the bound); the K9-w row's registers,
          local bytes, spill stores, blocks an SM, host reads and
          divergence, as the K1 row's
  main q  the app's --quantized path (fine map on, its cache emptied) at
          the same scale and camera: the counters of K2, K5c-q, K7-loc,
          K7-fm, K5b and K6 are zeroed before and read after, the image
          must cover >= 0.5; on to 128 samples for the steady launch; one
          opacity-scale edit, one <= 32-level curve edit and one full
          curve edit, each timed up to the next launch's fb on the host
  main m  the app's --march path at the same scale and camera, 8 launches
          of one converged pass each, then one opacity-scale edit (K5c-f32)
          timed to the next converged frame on the host; the counters of
          K3-f32, K5a, K5c-f32, K5b and K6 are zeroed before the build and
          read after the edit (K1 must read 0); the image must cover >= 0.5
  main mq the same with --quantized (no fine map, as apps/icon_rt.py): K3-q,
          K5c-q, K5b and K6 (K2 must read 0); an opacity-scale and a curve
          edit, each timed to the next converged frame
  bench m bench.py's r2b8m_closeup call: the quantized march with a fine map
          built by K7-fm; one pass timed, held against the pass without the
          fine map (accum <= 1e-4)
  rmse_q  bench.py `_rmse_q_vs_f32` on the card: both marches through their
          kernels, subdiv 8 x 16, 480x270, value-quantized scene
  main auto  --samples auto on the main path's scene and camera (f32,
          sample limit 16): launches of 1, 1, then the pick clamped to the
          limit; the probe read with the stream idle and at least a
          one-sample K1 launch's device time; the probe's seconds, the
          pick, the sequence and the covered share
  main ic r2b7  scripts/e2e_netcdf_torch.py's DWD-layout NetCDF at
          subdiv 7 x 16 levels (327,680 columns) in a temporary directory,
          the port's convert_icon CLI, the .ic's columns and layers against
          the HHL inputs, then the app on the .ic at 1080p, f32 and
          --quantized (the fine map built, K7-loc, K7-fm): 8 samples, then
          3 launches of 8; K1 and K2 against their plain versions on 4096
          lanes strided over the covered prefix; the seconds of the write,
          the convert, the read and the build, ms per launch, peak memory
  time    each kernel against its plain version at the main paths' shapes
          and launch arguments (same tolerances as `check`), both timed
          with CUDA events; beside them the least time the card could take
          (bound) and, where one PyTorch call computes the same function,
          that call's time; the K1 and K2 rows also give the kernel's
          registers, local bytes, spill stores and resident blocks an SM
          (its library's occupancy query), the host reads of a steady call
          (0: it runs under torch.cuda.set_sync_debug_mode("error")) and
          the warp divergence factor of its step counts
  profile one steady launch of each main path under torch.profiler:
          device time by kernel and the device's idle share of the
          launch's wall time, from a window that holds the path's tracker
          or march kernel (up to 3 windows; none fails the phase)
  scene9  the R2B9 scene's kernels (subdiv 11 x 16, 83,886,080 columns),
          after every earlier table is freed:
            K7-scene against its plain version on the whole subdiv-8 x 16
                scene, on the first, the last and an ancestor-period-
                straddling 2^20-cell index window of R2B9 and on the whole
                of R2B9: pass 1's aggregates, test12, corner lat/lon and
                field stash bit-equal; value_q exact on >= 99.999% of
                entries and within 1 level, value range and per-layer u8
                ranges equal; pass 1 and both passes timed with CUDA events
            K7-loc against its plain version on the subdiv-8 scene and on
                R2B9 (rectangles, counts, k_cap and bins exact), the R2B9
                invariants (counts sum to the rectangles' area, rows
                ascending with -1 only at the tail, every cell listed), and
                the bins of the host synthesizer's lat/lon against the device
                scene's at subdiv 8 (a count, not a check); one R2B9 call
                under torch.profiler (`profile_window`): each device
                event in order, its time by part and the host's share
            K7-fm at R2B9: the first call's seconds (its allocation
                included) and the peak above what the scene holds, the
                warm time (CUDA events), one call under torch.profiler
                (its launches), and the slots exact against the plain
                version's `_finemap_bins_torch` on sampled fine bins:
                2^20 random bins, every bin of the first and last fine
                rows and of the longitude seam's two columns, and the edge
                bins of 2048 random tiles of the kernel
  main r2b9q  bench.py `_measure_row_q` at LOD 0: build_q_scene(11, 16)
          with every launch counter zeroed before and read after, the
          closeup camera at 1920x1080, 8 samples per launch to 64 samples
          (median and spread of the steady launches, fb on the host), fps1,
          tf_edit_s, tf_stroke_s, tf_preview_s; coverage >= 0.5; K2 against
          its plain version on the first 4096 covered lanes, fine map on
          and off, and with its cost output on 4096 lanes strided over the
          covered prefix (8 samples); the K2 R2B9 row: the kernel over the
          covered lanes (CUDA events; the profiled launch's kernel ms and
          idle share), the K1/K2 rows' extra keys, and the bound counted by
          the plain version on the strided lanes
  main r2b9m  bench.py `_measure_row_m`: the scene built again, the
          quantized march with the fine map, one converged pass per launch
          (median of 3), tf_edit_s; the pass with the fine map against the
          pass without (<= FINEMAP_SHARE of lanes beyond FINEMAP_TOL); K3-q
          against its plain version on the first 4096 covered lanes; the
          K3-q R2B9 row: the kernel over the covered lanes (CUDA events), a
          steady call under torch.cuda.set_sync_debug_mode("error") (no
          device-to-host read), and the plain version with its counted
          bound on 4096 lanes strided over the covered prefix
  scene9lod  K7-scene's mip tier as r2b9q_viewall builds it (subdiv 8 x
          16, each cell the mean of its 64 subdivision-11 descendants)
          against its plain version: pass 1 on the whole tier (pooled
          field bit-equal), pass 2 on the whole tier, both passes on a
          head, an ancestor-period and a tail window of 65,536 cells, under
          the K7-scene contract; both passes timed with CUDA events
  main r2b9qv  bench.py `_measure_row_q` for r2b9q_viewall: frame_lod(11,
          "viewall", 1920, 1080) must be level 3, then the main r2b9q
          phase's contract on build_q_scene(11, 16, field_lod=3) with the
          reference's viewall camera (coverage >= 0.02 of the frame: the
          globe is small in that framing); K2 and its cost output also
          against the plain version on 4096 lanes strided over the
          covered prefix
  order refine  the measured-cost re-sort K6b on the R2B8 closeup at
          1080p, f32 and quantized tiers: three 8-sample launches with
          return_cost, once with refine_order_device + repermute_device
          between launches and once without; the unpermuted fb and accum,
          and every launch's cost, identical; both runs' launch times
          printed beside each other; K1's cost against its plain version;
          K6b's kernels exact against their plain versions (refine_perm
          with the sort's int64 and with int32 order, and equal to the
          host refine_order), timed beside index_select and the
          torch.sort + index_select re-sort; refine_keys and index_select,
          refine_perm and index_select + cat also in turns, each as 20
          back-to-back calls (CUDA events: the host's launch rate) and as
          device time (profiled windows of 10 calls); K6's device time
          and pixel_order as a whole, from the keys to n_covered on the
          host (20 calls on the host's clock)
  main ae, main accel sphere, main accel grid  the reference-parity
          raygens (K8, csrc/parity.cu) through the app (--raygen ae /
          accel, --accel-mode, the locator sampler) at subdiv 8 x 16,
          1920x1080, closeup camera, after every earlier table is freed:
          K8's counters zeroed before the build and read after 8 launches
          of samples=1; build seconds (cells, locator, the accel with its
          K5b majorants), ms per launch (fb on the host) and Mray/s,
          coverage >= 0.5, the maximum loop iterations per lane over the
          frame, K5b against its plain version at the accel's bin count
          (exact), a profiled launch, tf_edit_s (a gain edit to the next
          frame's fb on the host); the K8 row's block, registers, spill
          stores and blocks an SM, the host reads of a steady launch (run
          under torch.cuda.set_sync_debug_mode("error"), so 0) and the
          warp divergence factor of its iterations
  main brute  the brute-force sampler through the app on the check scene,
          each raygen, 2 launches (its launch counts)
  main accel w, main ae w  BASELINE configs[2] (bench.py:945): the app
          with -mode 2 on --raygen accel --accel-mode sphere, then on
          --raygen ae (K9-p), at subdiv 7 x 16 (327,680 columns), 1024x1024,
          closeup camera, 4 and 2 launches of samples=1, after every
          earlier table is freed: build seconds of cells, locator, wedges
          and the shell accel, layer_pad, ms per launch (fb on the host),
          Mray/s, coverage, peak memory, K9-p's launch count, the wedge
          shell (`Wedges.shell`), and the K9-p row's registers, spill
          stores, blocks an SM, host reads and divergence, as the K8
          rows'; the share of samples that its wedge shell test rejects
          comes with its bound in `check parity`
  main grid w  the same with -mode 2 on --raygen accel --accel-mode
          grid, 4 launches of samples=1
  check parity  K8's six raygen x sampler combinations {ae, accel sphere,
          accel grid} x {locator, brute} against the plain version at
          subdiv 3 x 8, 128x128, closeup camera, the app's unit distance,
          2 samples: the first sample's final LCG state and loop
          iterations equal on every lane, fb identical on >= 99.9% of
          pixels, accum <= 1e-6; `check parity raw`: K8's raw mode (one
          sample per lane, no finalize) of each combination against its
          plain version (wrote bit-equal, colour identical on >= 99.9% and
          <= 1e-6), and the raw sample through K10's mean finalize bit-equal
          to K8's finalizing launch; then each main parity path's K8 against
          its plain version on the first 4096 lanes of pixel_order's
          covered prefix and on 4096 lanes strided over the frame.  The
          bound of each K8 row comes from the events that the plain run
          of the brute rows' 128x128 lanes, or of the strided lanes
          (scaled to the frame), counts (ops/woodcock.py `Work`; with the
          share of samples that the whole-shell test rejects); the brute
          rows get the locator rows' extra keys at 128x128.  These
          plain runs come last: after their long loops the profiler
          reports no device event for several windows.  Then K9-p (the
          wedge sampler) x {ae, accel sphere, accel grid} at subdiv 3 x 8,
          64x64, 2 samples, on 256 (ae) or 1024 lanes strided over the
          frame, under the same contract; then main accel w's, main ae
          w's and main grid w's K9-p against the plain version on 1024,
          256 and 1024 seeded lanes spread over the frame, whose counted
          work, scaled, gives their bounds
  main anim r2b9q 4k  BASELINE configs[4] at full size, after every
          earlier table is freed: build_q_scene(11, 16) (83,886,080
          columns, fine map on), the closeup camera at 3840x2160, two
          timesteps (the second value_q halved on the card), 8 samples per
          frame through data/animation.py `animate_fastq_sharded`: (a) in
          this process, (b) tiles=1 over NCCL (world size 1), (c) tiles=2
          over gloo (two ranks sharing the card, each with the whole scene).
          The frames of (a), (b) and (c) bit-equal, the timesteps different,
          coverage >= 0.5; per rank the ms per frame, K2's ms per sample
          launch, the gather's ms, Mray/s and peak GiB; the frames as
          chip_smoke_anim_t{0,1}.png in OUT_DIR
  main slabs  the scene shard (parallel/scene_shard.py) at subdiv 8 x 16,
          1080p, closeup, quantized, 16 samples: 2 slabs x 1 tile (two gloo
          ranks) beside rank 0's unsharded K2 image, then 2 x 2 (four
          ranks); the 2 x 2 accum and fb bit-equal to the 2 x 1 ones, the
          composite's coverage equal to the unsharded image's and its RMSE
          over covered pixels < 0.55 / sqrt(16); ms per sample of the
          tracking, the three collectives and K10
  main samples  the samples axis (parallel/sharded.py) on the f32 tier,
          subdiv 8 x 16, 1080p: tiles=1 x samples=2 (two gloo ranks), 4
          steps of 2 samples; K10's mean equal to the plain mean on each
          rank; pixels all of whose 8 samples wrote equal the sequential
          frame to accum 1e-6
  main mesh accel sphere, main mesh ae, main mesh fast
          parallel/sharded.py `render_frame_sharded` (ranks.py
          `parity_job`; row tiles) at subdiv 8 x 16, 1080p closeup, the
          locator sampler, on the tables main accel sphere saved (each rank
          loads them from the gitignored _build/): the ShellAccel, 8 steps,
          as one process, NCCL world 1 and gloo tiles 2 x samples 1 (fb and
          accum bit-equal to one process's render_frame_accel), and gloo
          tiles 1 x samples 2 (K8 raw mode, K10's mean; accum within 1e-6
          of the sequential frame where all 16 samples wrote, the same
          coverage, 8-bit RMSE < 2 per channel); the AE raygen, 2 steps on
          gloo 2 x 1, bit-equal to render_frame_ae; the fast raygen (K1),
          8 steps on gloo 2 x 1 (bit-equal to render_frame_fast) and on
          gloo 2 x 2 (four ranks; the samples gates).  Per rank the ms per
          step by part, the gather, Mray/s and peak GiB; K8's raw launch at
          1080p beside its finalizing launch (CUDA events) and against its
          plain version on 4096 strided lanes
  time K10  each mode of K10 and its plain version at 2,073,600 lanes
          (CUDA events) beside its bytes at 3.35 TB/s
Each multi-device phase prints its backend, world size and how many ranks
share a card, and fails if a rank raises, dies or outlives 300 s (the
ranks are then terminated).  The counts of K10, K1 and K2 on those paths
come from the ranks, zeroed before each path and read after it.

Every phase prints the device's peak memory (torch.cuda.max_memory_allocated
since the phase began).

The last lines are the card's `nvidia-smi` name and power limit, one JSON
line {"kernels": [...]}, and {"ok": true, "device": {...}}.
"""
import functools
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
MARCH_LIMIT = 8             # the march paths: 8 launches of one pass each
RMSE_W, RMSE_H = 480, 270   # bench.py `_rmse_q_vs_f32` frame
ACCUM_TOL = 1e-6            # K1/K2/K3 accum max-abs-diff, kernel vs plain
FINEMAP_TOL = 1e-4          # K3-q fine map on vs off (tests/test_march.py:366)
#: share of lanes that may differ by more than FINEMAP_TOL between the
#: quantized march with and without the fine map: the q tier's unnormalised
#: plane equations (|n| ~ 1e9) make a point just past a shared face lie in
#: both columns in f32, and the two locates may return either one first.
#: A re-located previous column costs an eps step (ops/march.py
#: `_column_exit`); with JAX's column exit it integrated on to its far face
#: (26 of 64,667 lanes at the check scene, up to 0.024).  Measured with the
#: port's exit on the CPU: 7 of 64,667 lanes, up to 3.4e-3
#: (scripts/torch_march_vs_jax.py tie --tf default).
FINEMAP_SHARE = 1e-3
CU_SOURCES = ("track_f32", "track_q", "finemap", "march", "scene",
              "locator", "parity", "track_wedge", "uelems",
              "composite", "majorant", "order", "bake_q")   # csrc/*.cu
R2B9_SUB, R2B9_LAYERS = 11, 16    # bench.py r2b9q_closeup / r2b9m_closeup
R2B9_SPL, R2B9_LIMIT = 8, 64      # r2b9q: samples per launch, in all
PREVIEW_W, PREVIEW_H = 480, 270   # bench.py's preview frame (W/4 x H/4)
WINDOW_CELLS = 1 << 20            # the R2B9 index windows of the K7-scene check
R2B9V_LOD = 3                     # r2b9q_viewall's auto-LOD level (bench.py:412)
LOD_WINDOW = 1 << 16              # the mip tier's windows of the K7-scene check
#: least covered share of the frame by framing: the closeup globe covers
#: 0.55; viewall's ~3.5 r_out camera distance leaves a disc of ~160 px
#: radius at 1080p, 0.04 of the frame
MIN_COVERED = {"closeup": 0.5, "viewall": 0.02}
CHECK_LANES = 4096                # K2 / K3-q against plain at R2B9
FM_RANDOM_BINS = 1 << 20          # K7-fm at R2B9: random fine bins checked
FM_EDGE_TILES = 2048              # ... and the edge bins of these tiles
PROFILE_WINDOWS = 20              # profiler windows tried for a kernel
LEAD_IN_SPINS = 4                 # spin kernels opening a window, a try
SPIN_CYCLES = 100_000             # device cycles of each
LEAD_IN_S = 0.02                  # host seconds after them, a try
SCENE_THICKNESS = 3.0e4           # data/device_scene.py's default
OUT_DIR = os.path.join(ROOT, "chiprun_out")
PARITY_SUB, PARITY_LAYERS, PARITY_W = 3, 8, 128   # the K8 check scene
PARITY_SAMPLES = 2          # samples of each K8 check
PARITY_LIMIT = 8            # main parity phases: 8 launches of 1 sample
PARITY_RAYGENS = ("ae", "sphere", "grid")
PARITY_SAMPLERS = ("locator", "brute")
#: the unstructured elements' phases: K9-p's check lanes, strided over the
#: frame (the plain Newton window runs ~800 tensor operations per lock-step
#: iteration, and an AE lane beside the globe walks the whole box), and
#: BASELINE configs[2] (bench.py:945, the r2b7 scene at 1024^2, one sample
#: per launch: 4 launches on the sphere accel, 2 on AE; 4 on the grid
#: accel at the same scene)
WEDGE_CHECK_LANES = {"ae": 256, "sphere": 1024, "grid": 1024}
W7_SUB, W7_LAYERS, W7_W = 7, 16, 1024
#: seeded columns of models/wedges.py `shell_probes` on which `main ... w`
#: holds the wedge shell against the search run without it
WEDGE_SHELL_COLUMNS = 256
W7_LIMIT = {"sphere": 4, "ae": 2, "grid": 4}
UELEMS_POINTS = 65536        # K9-n's check points per element shape
#: K9-n's wedge points beyond them: one a 1080p lane (the size that fills
#: the card), and ragged sizes around its blocks of 128 threads, into out=
UELEMS_FRAME = 1920 * 1080
UELEMS_RAGGED = (1, 127, 129, 65537)
#: the JAX loops each K8 raygen replaces (the samplers' too: models/
#: cells.py:170, models/locator.py:366)
PARITY_REPLACES = {"ae": "icon_rt_tpu/ops/render.py:102",
                   "sphere": "icon_rt_tpu/ops/traverse.py:212",
                   "grid": "icon_rt_tpu/ops/traverse.py:84"}

# The bound of a kernel is the larger of its bytes over the H100's memory
# rate and its f32 operations over the card's f32 rate (NVIDIA's published
# peaks of the H100 SXM: 3.35 TB/s, 67 TFLOP/s f32 outside the tensor
# cores).  For the trackers and the march
# the bytes are each lane's pix, accum and fb once, the data of the
# distinct columns the run located and the distinct locator-bin rows it
# read; the operations are per event counts of the kernels' arithmetic.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12           # NVIDIA's H100 SXM data sheet, FP64 outside
#                             the tensor cores (K7-loc's rectangles)
#: K7-scene operations, counted once whatever passes the kernel takes: per
#: subdivision step 9 adds and 3 vertex normalizations (3 mul, 2 add, sqrt,
#: 3 div); per cell the orientation, the 6 transcendentals of the corner
#: lat/lon and the 10 of the centroid field (~20 each, with the means); per
#: layer the field's scale, clip and quantization; the three side normals
#: (9 mul, 6 sub, 9 cross products); per layer of a pooled descendant its
#: scale, clip and add
SCENE_OPS = {"step": 36, "orient": 40, "latlon": 120, "field": 240,
             "layer": 12, "normals": 72, "pool": 4}
#: K5b f32 operations a bin: two differences and divisions, two multiplies
#: and conversions, the clamps, the +1, the level, the index and the two
#: table reads' maximum, the empty test
K5B_OPS = 16
#: K7-loc f64 operations per cell (edge extrema, 2 bulge points per edge,
#: the interior tests and the bin indices)
LOCATOR_OPS = 300
LANE_BYTES = 40             # pix read, accum read and written, fb written
#: per distinct located column: bytes of its test data, and bytes per layer
#: of the per-layer entries the kernel reads (K1: height + alpha; K3-f32:
#: height, alpha, RGB; the quantized tier: u8 alpha and value, the heights
#: from one shared row)
ROW_BYTES = {"track_f32": (56, 8), "track_q": (44, 2), "march_f32": (56, 20),
             "march_q": (44, 2), "track_wedge": (68, 8)}
#: f32 operations per event: a Woodcock evaluation (position, radius, three
#: plane tests, layer select, draws), a locate (asin, atan2, binning, one
#: candidate test), a layer of a march crossing (two sphere crossings, the
#: overlap, the depth, two exponentials, the colour), a crossing's column
#: exit, and per candidate of a gap skip
FLOPS = {"eval": 40, "locate": 60, "layer": 20, "cross": 60, "skip_cand": 50,
         "coord": 5}
#: K8's f32 operations per event of ops/woodcock.py `Work`, each the
#: arithmetic its code path in csrc/parity.cu runs (a transcendental counts
#: 20, a division or square root 1): a free-path draw (the LCG, the log,
#: two divisions, the compare), a DDA advance (grid: the closest crossing,
#: the stepping axes, the next segment and bin; sphere: the same with the
#: floored bin wrap), a sample (position and radius), its whole-shell test
#: (two compares; the locator and brute samplers), the locate of a sample
#: that passes it (asin, atan2, two bins), a candidate test by where it
#: stops (the radial compare 2, then 7 per plane evaluated), and a hit
#: (classification, acceptance draw, collision window) plus 2 per layer of
#: its layer select
PARITY_OPS = {"draw": 30, "advance": {"ae": 0, "grid": 18, "sphere": 27},
              "eval": 12, "shell": 2, "locate": 55, "radial": 2, "plane": 7,
              "hit": 40, "hit_layer": 2}
#: K8's bytes per lane (accum read and written, fb written) and per read:
#: a cell's radii 8 when its radial test runs, its planes 48 when a plane
#: test runs, num_layers, one value and 4 per layer ceiling when it is hit,
#: 4 per locator entry
PARITY_BYTES = {"lane": 36, "radial": 8, "planes": 48, "hit": 8,
                "layer": 4, "entry": 4, "wedge": 96}
#: K9-p's f32 operations of the wedge sampler (csrc/uelems.cuh): per
#: visited column 2 per layer of its find_layer; per Newton its set-up
#: (the bounding box 36, the tolerance 6) and its end (the value 11, the
#: box tests 8); per iteration the shape and derivative tables 17, the
#: four vertex sums 3 x (11 + 7 + 7 + 11) (the derivative columns without
#: their constant-zero terms), the four determinants 4 x 14, three
#: divisions, the update and the convergence tests 15.  K9-n's bounds
#: take the wedge's counts for every shape.
NEWTON_OPS = {"col_layer": 2, "newton": 61, "iter": 199}


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return res.stdout.strip().splitlines()[0]


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


def time_turns(fa, fb, reps: int):
    """(ms of fa, ms of fb) per call, each the mean of two `time_cuda` runs
    of `reps` calls taken in turns a, b, b, a, so that a clock or cache
    state that drifts over the four favours neither."""
    a1, b1 = time_cuda(fa, reps), time_cuda(fb, reps)
    b2, a2 = time_cuda(fb, reps), time_cuda(fa, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def bound(nbytes: float, flops: float):
    """(least ms on the card, "bytes" or "operations")."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


class CountingTier:
    """A plain tracker/march tier that records what a run's data needs, for
    the bounds: the columns it located, the coarse bins it queried and the
    number of locates, Woodcock evaluations and march crossings.  Counting
    adds no device sync to the plain run it wraps."""

    def __init__(self, tier):
        self._tier = tier
        self.cids, self.bins = [], []
        self.n = {"locate": 0, "eval": 0, "cross": 0}

    def __getattr__(self, name):
        return getattr(self._tier, name)

    def locate(self, px, py, pz, r, return_rows=False):
        import torch
        from icon_rt_tpu_torch.ops.fast import _grid_bin
        out = self._tier.locate(px, py, pz, r, return_rows)
        self.cids.append(torch.where(out[1], out[0], -1))
        loc, (n_lat, n_lon) = self._tier.loc, self._tier.dims
        lat = torch.asin(torch.clamp(pz / r, -1.0, 1.0))
        lon = torch.atan2(py, px)
        self.bins.append(_grid_bin(lat, loc.lat_lo, loc.lat_hi, n_lat) * n_lon
                         + _grid_bin(lon, loc.lon_lo, loc.lon_hi, n_lon))
        self.n["locate"] += px.shape[0]
        return out

    def alpha(self, cid, r):
        self.n["eval"] += cid.shape[0]
        return self._tier.alpha(cid, r)

    def march_prof(self, cid):
        self.n["cross"] += cid.shape[0]
        return self._tier.march_prof(cid)

    def bound(self, kernel, n_lanes, nl_of_cells, scale=1.0,
              lane_bytes=LANE_BYTES):
        """(ms, by) of `kernel` (a ROW_BYTES key) for this run's data;
        nl_of_cells maps cell ids to their layer counts.  With `scale` the
        run covered n_lanes / scale lanes of the frame: its events count
        scale times, its reads once (fewer than the frame's, so the bound
        stays a least time).  lane_bytes: each lane's own reads and
        writes."""
        import torch
        cids = torch.cat(self.cids) if self.cids else torch.zeros(0)
        cells = torch.unique(cids[cids >= 0])
        nl = int(nl_of_cells(cells).sum()) if cells.numel() else 0
        n_bins = int(torch.unique(torch.cat(self.bins)).numel()) \
            if self.bins else 0
        k_cap = self._tier.loc.bins.shape[1]
        per_cell, per_layer = ROW_BYTES[kernel]
        nbytes = (lane_bytes * n_lanes + per_cell * cells.numel()
                  + per_layer * nl + 4 * k_cap * n_bins)
        n = self.n
        if kernel.startswith("march"):
            nl_mean = nl / max(cells.numel(), 1)
            flops = (n["locate"] * FLOPS["locate"]
                     + n["cross"] * (FLOPS["cross"]
                                     + 2 * nl_mean * FLOPS["layer"])
                     + (n["locate"] - n["cross"]) * k_cap
                     * FLOPS["skip_cand"])
        else:
            flops = n["eval"] * FLOPS["eval"] + n["locate"] * FLOPS["locate"]
            if kernel == "track_wedge":    # dot(P, n') at each test
                flops += (n["eval"] + n["locate"] * k_cap) * FLOPS["coord"]
        flops *= scale
        print(f"bound {kernel}: {n_lanes} lanes, {cells.numel()} distinct "
              f"columns ({nl} layers), {n_bins} bins, events {n}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP")
        return bound(nbytes, flops)


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
        from icon_rt_tpu_torch.data.lod import frame_camera
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
        cam = frame_camera(stats, "closeup", width, height)
        ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
        self.lp = make_launch_params(cam.basis(width, height),
                                     stats.world_bounds_lo,
                                     stats.world_bounds_hi, unit_distance=ud,
                                     device=dev)
        self.perm, self.n_cov = pixel_order(
            self.lp, stats.spherical_bounds_lo[0],
            stats.spherical_bounds_hi[0], width, height)
        self.width, self.height = width, height


def check_chord_keys(keys_k, n_k, keys_p, n_p, label):
    """K6 against its plain version: the same coverage (finite keys) and
    covered count, finite keys within 1 ULP; prints whether they are
    bit-equal.  Returns the finite keys' max abs error."""
    import torch
    fin = torch.isfinite(keys_p)
    u = ulp_diff(keys_k[fin], keys_p[fin])
    err = float((keys_k[fin] - keys_p[fin]).abs().max()) if fin.any() else 0.0
    print(f"{label}: max {u} ULP, bit-equal {torch.equal(keys_k, keys_p)}, "
          f"covered count {int(n_k)} vs plain {int(n_p)} of {fin.numel()}")
    if u > 1 or not torch.equal(n_k, n_p) or int(n_p) != int(fin.sum()) \
            or not torch.equal(torch.isfinite(keys_k), fin):
        raise AssertionError(f"{label}: K6 differs from its plain version")
    return err


def check_kernels(dev, sub=SMOKE_SUB, layers=SMOKE_LAYERS, size=SMOKE_W):
    """Each f32-tier kernel against its plain version on the same inputs.
    Returns ({kernel name: max_abs_err}, the Scene)."""
    import torch
    from icon_rt_tpu_torch.models.accel import compute_max_opacities_torch
    from icon_rt_tpu_torch.ops import fast
    from icon_rt_tpu_torch.ops.order import (_camera, _chord_keys_torch,
                                             chord_keys)
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
    keys_p, n_p = _chord_keys_torch(_camera(sc.lp),
                                    f32(st.spherical_bounds_lo[0]),
                                    f32(st.spherical_bounds_hi[0]), size,
                                    size)
    keys_k, n_k = chord_keys(_camera(sc.lp), st.spherical_bounds_lo[0],
                             st.spherical_bounds_hi[0], size, size)
    errs["chord_keys"] = check_chord_keys(keys_k, n_k, keys_p, n_p,
                                          f"check K6 chord_keys {size}x{size}")
    if int(n_k) != sc.n_cov:
        raise AssertionError(f"K6's count {int(n_k)} is not pixel_order's "
                             f"n_covered {sc.n_cov}")

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
                    preserve, fm, label, cost=False, return_fb=False):
    """K2 and its plain version on the same lanes; returns (max abs err of
    accum, the plain version's ms, its CountingTier[, the plain version's
    fb with return_fb]), raises past the tolerances (fb identical on >=
    99.9%, accum <= ACCUM_TOL; with `cost` the per-pixel step counts too:
    identical on >= 99.9% of the lanes, 0 on every other pixel)."""
    import torch
    from icon_rt_tpu_torch.ops import fast, fastq
    from icon_rt_tpu_torch.ops.render import alloc_frame
    q, loc, bands, tf = tabs
    tier = CountingTier(fastq._QTier(q, loc, tf, fm))
    outs = []
    for kernel in (True, False):
        acc, fb = alloc_frame(width, height, device=pix.device)
        c = torch.zeros(width * height, dtype=torch.int32,
                        device=pix.device) if cost else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kernel:
            fastq.track_q(*tabs, lp, pix, acc[:acc_n], fb[:acc_n],
                          width=width, height=height, samples=samples,
                          preserve_cache=preserve, finemap=fm, cost=c)
        else:   # _render_frame_fast_q_torch, through the counting tier
            fast._track_torch(tier, bands, lp, pix, acc[:acc_n], fb[:acc_n],
                              width, height, samples, preserve, c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        outs.append((acc, fb, c))
    (ak, fk, ck), (ap, fp, cp) = outs
    same = float((fk == fp).float().mean())
    err = float((ak - ap).abs().max())
    print(f"{label} K2 track_q samples={samples} preserve_cache={preserve} "
          f"finemap={'on' if fm is not None else 'off'}: fb identical on "
          f"{same:.6f} of {width * height} pixels, accum max abs diff "
          f"{err:.3e}")
    if same < 0.999 or not err <= ACCUM_TOL:
        raise AssertionError("K2 disagrees with its plain version")
    if cost:
        compare_cost(ck, cp, pix, f"{label} K2 track_q")
    return (err, plain_ms, tier, fp) if return_fb else (err, plain_ms, tier)


def strided_lanes(perm, n_active):
    """CHECK_LANES lanes strided over the covered prefix of a pixel order:
    every chord length, where the prefix's head holds the shortest."""
    step = max(1, n_active // CHECK_LANES)
    return perm[:n_active][::step][:CHECK_LANES].contiguous()


def compare_cost(ck, cp, pix, label):
    """The kernel's per-pixel step counts against the plain version's:
    identical on >= 99.9% of the traced pixels (the share the fb is held
    to), 0 on every untraced one."""
    import torch
    traced = torch.zeros_like(ck, dtype=torch.bool)
    traced[pix.long()] = True
    same = float((ck[traced] == cp[traced]).float().mean())
    zero = int(ck[~traced].abs().max()) if bool((~traced).any()) else 0
    print(f"{label} cost: step counts identical on {same:.6f} of "
          f"{pix.shape[0]} traced pixels (mean "
          f"{float(ck[traced].float().mean()):.2f} steps), max on untraced "
          f"pixels {zero}")
    if same < 0.999 or zero != 0:
        raise AssertionError(f"{label}: the cost output disagrees with the "
                             f"plain version")


def bake_inputs(q, tf):
    """K5c-q's table: the normalized (256,) u8 alpha table of `tf`."""
    import torch
    from icon_rt_tpu_torch.models import qcells
    a_tab = qcells._classify_alpha_table(tf, q.value_lo, q.value_hi)
    return torch.floor(a_tab / torch.clamp(a_tab.max(), min=1e-8)
                       * 255.0).to(torch.uint8)


def check_bakes(q, tf, dev, label):
    """K5c-q's lookup, into a new table and into a given one (out=), against
    its plain version on the scene's value table; returns max abs err (0
    when exact)."""
    import torch
    from icon_rt_tpu_torch.models import qcells
    q_tab = bake_inputs(q, tf)
    want = qcells._bake_lookup_torch(q.value_q, q_tab)
    forms = {"lookup": qcells.bake_lookup(q.value_q, q_tab),
             "lookup out=": qcells.bake_lookup(
                 q.value_q, q_tab, out=torch.empty_like(q.value_q))}
    err = max(float((k.int() - want.int()).abs().max()) if k.numel() else 0.0
              for k in forms.values())
    same = {f: torch.equal(k, want) for f, k in forms.items()}
    print(f"{label} K5c-q at {tuple(q.value_q.shape)}: exact {same}")
    if not all(same.values()):
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


def bin_dataset(ds, dev):
    """The quantized tier's dense locator of a dataset on `dev`, binned as
    the app's get_q bins it (K7-loc on the card)."""
    import torch
    from icon_rt_tpu_torch.models.locator import bin_locator
    lat, lon = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (ds.lat, ds.lon))
    return bin_locator(lat, lon)[0]


def check_q_kernels(sc, dev):
    """The quantized tier's kernels against their plain versions on the
    check scene (built as the app's get_q builds it).  Returns (errs,
    (q, locator, fine map))."""
    from icon_rt_tpu_torch.models.finemap import build_finemap
    from icon_rt_tpu_torch.models.qcells import (bake_alpha_q,
                                                 quantize_cells,
                                                 quantize_dataset_values)
    ds_q, lo, hi = quantize_dataset_values(sc.ds)
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi), device=dev),
                     sc.tf)
    loc = bin_dataset(ds_q, dev)
    errs = {"build_finemap": check_finemap(loc, q.test12, "check q"),
            "bake_alpha_q": check_bakes(q, sc.tf, dev, "check q")}
    fm = build_finemap(loc, q.test12)
    n, size = sc.n_cov, sc.width
    pix = sc.perm[:n].contiguous()
    errs["track_q"] = max(
        compare_track_q((q, loc, sc.bands, sc.tf), sc.lp, pix, n, size,
                        size, 4, preserve, f, "check q")[0]
        for preserve in (True, False) for f in (fm, None))
    return errs, (q, loc, fm)


def compare_march(label, run, width, height, n, dev):
    """A K3 wrapper (run(acc, fb, kernel=True)) and its plain version
    (kernel=False) on the same lanes; returns (max abs err of accum, the
    plain version's ms, the kernel's accum), raises past the tolerances
    (fb identical on >= 99.9%, accum <= ACCUM_TOL)."""
    import torch
    from icon_rt_tpu_torch.ops.render import alloc_frame
    outs, plain_ms = [], 0.0
    for kernel in (True, False):
        acc, fb = alloc_frame(width, height, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(acc[:n], fb[:n], kernel)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        outs.append((acc, fb))
    (ak, fk), (ap, fp) = outs
    same = float((fk == fp).float().mean())
    err = float((ak - ap).abs().max())
    print(f"{label}: fb identical on {same:.6f} of {width * height} pixels, "
          f"accum max abs diff {err:.3e}")
    if same < 0.999 or not err <= ACCUM_TOL:
        raise AssertionError(f"{label}: the kernel disagrees with its plain "
                             f"version")
    return err, plain_ms, ak


def march_runs(packed, loc, bands, lp, pix, width, height, qtabs=None,
               fm=None, counter=None):
    """run(acc, fb, kernel, cost=None) of K3 on the f32 tier (qtabs None)
    or the quantized tier (qtabs = (q, loc_q, tf)), with the cost output
    when `cost` is given; the plain version goes through `counter` (a
    callable wrapping the plain tier) when given."""
    from icon_rt_tpu_torch.ops import march
    from icon_rt_tpu_torch.ops.fast import _F32Tier
    from icon_rt_tpu_torch.ops.fastq import _QTier
    wrap = counter or (lambda t: t)
    kw = dict(width=width, height=height)
    if qtabs is None:
        def run(acc, fb, kernel, cost=None):
            if kernel:
                march.march_f32(packed, loc, bands, lp, pix, acc, fb,
                                cost=cost, **kw)
            else:
                march._march_frame_torch(
                    wrap(_F32Tier(packed, loc)), bands, lp, pix, acc, fb,
                    width, height, cost)
    else:
        q, loc_q, tf = qtabs

        def run(acc, fb, kernel, cost=None):
            if kernel:
                march.march_q(q, loc_q, bands, tf, lp, pix, acc, fb,
                              finemap=fm, cost=cost, **kw)
            else:
                march._march_frame_torch(
                    wrap(_QTier(q, loc_q, tf, fm)), bands, lp, pix, acc, fb,
                    width, height, cost)
    return run


def compare_march_cost(label, run, width, height, n, dev):
    """K3's cost output (run from `march_runs`) against its plain version
    on the same lanes: exact on every pixel (the untraced ones untouched),
    and the kernel's frame with the cost bit-equal to its frame without.
    Raises otherwise; returns the plain version's ms."""
    import torch
    from icon_rt_tpu_torch.ops.render import alloc_frame
    frames, costs, plain_ms = [], [], 0.0
    for kernel, with_cost in ((True, True), (True, False), (False, True)):
        acc, fb = alloc_frame(width, height, device=dev)
        cost = torch.full((width * height,), -1, dtype=torch.int32,
                          device=dev) if with_cost else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(acc[:n], fb[:n], kernel, cost)
        torch.cuda.synchronize()
        if not kernel:
            plain_ms = (time.perf_counter() - t0) * 1e3
        frames.append((acc, fb))
        costs.append(cost)
    (ak, fk), (a0, f0), _ = frames
    ck, cp = costs[0], costs[2]
    exact = torch.equal(ck, cp)
    same = torch.equal(ak, a0) and torch.equal(fk, f0)
    traced = ck[ck >= 0]
    print(f"{label}: cost {'exact' if exact else 'DIFFERS'} on "
          f"{width * height} pixels ({traced.numel()} traced, max "
          f"{int(traced.max())}, mean {float(traced.double().mean()):.3f} "
          f"iterations); the frame with the cost "
          f"{'bit-equal to' if same else 'DIFFERS from'} the frame without")
    if not exact or not same or traced.numel() != n:
        raise AssertionError(f"{label}: K3's cost disagrees with its plain "
                             f"version or changes the frame")
    return plain_ms


def check_opacity_scale(cells, packed, tf, label):
    """K5c-f32 parts and apply against their plain versions (exact), and a
    scale-only edit's prof against a full K5a bake at the new scale (ULP
    printed, <= 1).  Returns max abs err (0 when exact)."""
    import torch
    from icon_rt_tpu_torch.ops import fast
    tf2 = tf._replace(opacity_scale=torch.full_like(tf.opacity_scale, 0.37))
    parts_k = fast.pack_alpha_scale_parts(cells, tf2)
    parts_p = fast._alpha_scale_parts_torch(cells.value, tf2)
    prof_k = fast.apply_opacity_scale(packed._replace(
        prof=packed.prof.clone()), parts_k, tf2.opacity_scale).prof
    prof_p = packed.prof.clone()
    fast._apply_opacity_scale_torch(prof_p, *parts_p, tf2.opacity_scale)
    exact = (torch.equal(parts_k[0], parts_p[0])
             and torch.equal(parts_k[1], parts_p[1]))
    exact_apply = torch.equal(prof_k, prof_p)
    full = fast.classify_bake(cells, tf2)[0]
    u = ulp_diff(prof_k, full)
    err = max(float((parts_k[0] - parts_p[0]).abs().max()),
              float((parts_k[1] - parts_p[1]).abs().max()),
              float((prof_k - prof_p).nan_to_num(posinf=0.0).abs().max()))
    print(f"{label} K5c-f32 parts at {tuple(cells.value.shape)}: exact "
          f"{exact}; apply exact {exact_apply}; scale-only edit vs full K5a "
          f"bake: max {u} ULP")
    if not (exact and exact_apply) or u > 1:
        raise AssertionError("K5c-f32 differs from its plain version or "
                             "from the full bake")
    return err


def finemap_agreement(acc_on, acc_off, n, label):
    """The quantized march with the fine map against without over the n
    traced lanes: raises unless >= 1 - FINEMAP_SHARE of them agree within
    FINEMAP_TOL (see FINEMAP_SHARE)."""
    d = (acc_on[:n] - acc_off[:n]).abs().amax(dim=1)
    far = int((d > FINEMAP_TOL).sum())
    print(f"{label}: K3-q fine map on vs off: {far} of {n} lanes differ by "
          f"more than {FINEMAP_TOL} (max {float(d.max()):.3e}; allowed "
          f"share {FINEMAP_SHARE})")
    if far > FINEMAP_SHARE * n:
        raise AssertionError("K3-q with the fine map differs from without")


#: check m's K3 views beyond the closeup: a camera inside the shell and one
#: grazing it (`march_view_lp`), at a unit distance at which most rays cross
#: several columns
MARCH_VIEWS = ("inside", "grazing")
VIEW_UD = 1e5


def march_view_lp(stats, view, size, dev):
    """Launch params of a camera inside the shell (half-way up it, looking
    along the horizon, 8 degrees) or at 1.6 shell tops with its view centre
    tangent to the sphere half-way up the shell (0.4 degrees): their rays
    cross columns on both sides of their apex, where both pieces of a
    crossing's integral are non-empty and a crossing spans many layers (as
    tests/test_torch_kernels_cuda.py `_march_view_lp`)."""
    from icon_rt_tpu_torch.ops.camera import Camera
    from icon_rt_tpu_torch.ops.render import make_launch_params
    lo, hi = (float(stats.spherical_bounds_lo[0]),
              float(stats.spherical_bounds_hi[0]))
    r = 0.5 * (lo + hi)
    cam = Camera()
    if view == "inside":
        org = np.array([r, 0.0, 0.0], np.float32)
        cam.set_orientation(org, org + np.array([0.0, r, 0.0], np.float32),
                            np.array([1, 0, 0], np.float32), 8.0)
    else:
        d = 1.6 * hi
        tangent = np.array([r * r / d, r * np.sqrt(1.0 - (r / d) ** 2),
                            0.0], np.float32)
        cam.set_orientation(np.array([d, 0.0, 0.0], np.float32), tangent,
                            np.array([0, 0, 1], np.float32), 0.4)
    return make_launch_params(cam.basis(size, size), stats.world_bounds_lo,
                              stats.world_bounds_hi, unit_distance=VIEW_UD,
                              device=dev)


def check_march_views(sc, qtabs, dev):
    """check m: K3 on both tiers (the quantized one without the fine map)
    in the MARCH_VIEWS on CHECK_LANES strided pixels of the check frame
    against the plain version: accum, fb and the cost bit-equal, else
    raises."""
    import torch
    from icon_rt_tpu_torch.ops.render import alloc_frame
    t0 = time.perf_counter()
    size = sc.width
    q, loc_q, _ = qtabs
    lanes = torch.arange(0, size * size, max(size * size // CHECK_LANES, 1),
                         dtype=torch.int32, device=dev)
    n = lanes.shape[0]
    for view in MARCH_VIEWS:
        lp = march_view_lp(sc.stats, view, size, dev)
        for tier, run in (
                ("f32", march_runs(sc.packed, sc.loc, sc.bands, lp, lanes,
                                   size, size)),
                ("q", march_runs(None, None, sc.bands, lp, lanes, size, size,
                                 qtabs=(q, loc_q, sc.tf)))):
            outs = []
            for kernel in (True, False):
                acc, fb = alloc_frame(size, size, device=dev)
                cost = torch.full((size * size,), -1, dtype=torch.int32,
                                  device=dev)
                run(acc[:n], fb[:n], kernel, cost)
                outs.append((acc, fb, cost))
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            acc, _, cost = outs[0]
            print(f"check m K3 march_{tier} {view} view on {n} strided "
                  f"pixels: accum, fb and cost "
                  f"{'bit-equal' if same else 'DIFFER'} to the plain "
                  f"version's; {int((acc[:n, 3] > 0).sum())} lanes with "
                  f"alpha > 0, {float(cost[lanes.long()].double().mean()):.2f}"
                  f" iterations a lane")
            if not same:
                raise AssertionError(f"K3 march_{tier} differs from its "
                                     f"plain version in the {view} view")
    print(f"check m views {time.perf_counter() - t0:.1f} s")


def check_march(sc, qtabs, dev):
    """K3 on both tiers and K5c-f32 against their plain versions on the
    check scene, accum_id 0 and 3."""
    import torch
    q, loc_q, fm = qtabs
    n, size = sc.n_cov, sc.width
    pix = sc.perm[:n].contiguous()
    errs = {"march_f32": 0.0, "march_q": 0.0}
    for aid in (0, 3):
        lp = sc.lp._replace(accum_id=torch.tensor(aid, dtype=torch.int32,
                                                  device=dev))
        errs["march_f32"] = max(errs["march_f32"], compare_march(
            f"check m K3 march_f32 accum_id={aid}",
            march_runs(sc.packed, sc.loc, sc.bands, lp, pix, size, size),
            size, size, n, dev)[0])
        acc = {}
        for f in (fm, None):
            tag = "on" if f is not None else "off"
            e, _, acc[tag] = compare_march(
                f"check m K3 march_q finemap={tag} accum_id={aid}",
                march_runs(None, None, sc.bands, lp, pix, size, size,
                           qtabs=(q, loc_q, sc.tf), fm=f),
                size, size, n, dev)
            errs["march_q"] = max(errs["march_q"], e)
        finemap_agreement(acc["on"], acc["off"], n,
                          f"check m accum_id={aid}")
    check_march_views(sc, qtabs, dev)
    errs["opacity_scale"] = check_opacity_scale(sc.cells, sc.packed, sc.tf,
                                                "check m")
    # check march cost: the cost output on both tiers (exact, else raises)
    compare_march_cost("check march cost K3 march_f32", march_runs(
        sc.packed, sc.loc, sc.bands, sc.lp, pix, size, size), size, size, n,
        dev)
    for f in (None, fm):
        compare_march_cost(
            f"check march cost K3 march_q finemap="
            f"{'on' if f is not None else 'off'}",
            march_runs(None, None, sc.bands, sc.lp, pix, size, size,
                       qtabs=(q, loc_q, sc.tf), fm=f), size, size, n, dev)
    errs.update(march_f32_cost=0.0, march_q_cost=0.0)
    return errs


def zero_counters():
    """Every kernel launch counter of the port to 0."""
    from icon_rt_tpu_torch.data import device_scene
    from icon_rt_tpu_torch.models import accel, finemap, locator, qcells
    from icon_rt_tpu_torch.ops import (fast, fastq, march, order, render,
                                       uelems)
    accel.launches = order.launches = 0
    fastq.launches = finemap.launches = 0
    for d in (fast.launches, qcells.launches, march.launches,
              device_scene.launches, locator.launches, render.launches,
              order.refine_launches, uelems.launches):
        for k in d:
            d[k] = 0


def peak_memory(tag):
    """Print the device's peak allocated memory since the last call (or the
    start) and reset the peak."""
    import torch
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{tag} peak device memory {gib:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    torch.cuda.reset_peak_memory_stats()
    return gib


def read_counters(quantized, marching):
    """({kernel name: launches} of the kernels a main path runs, {kernel
    name: launches} of the trackers it must not run)."""
    from icon_rt_tpu_torch.models import accel, finemap, locator, qcells
    from icon_rt_tpu_torch.ops import fast, fastq, march, order
    counts = {"max_opacity": accel.launches, "chord_keys": order.launches}
    if quantized:
        counts["bake_alpha_q"] = sum(qcells.launches.values())
        counts["locator_bins"] = sum(locator.launches.values())
    else:
        counts["classify_bake"] = fast.launches["classify_bake"]
    absent = {}
    if marching:
        tracker = "track_q" if quantized else "track_f32"
        absent[tracker] = fastq.launches if quantized \
            else fast.launches["track_f32"]
        cost = f"march_{'q' if quantized else 'f32'}_cost"
        absent[cost] = march.launches[cost]     # nothing asks for the cost
        if quantized:
            counts["march_q"] = march.launches["march_q"]
        else:
            counts["march_f32"] = march.launches["march_f32"]
            counts["opacity_scale"] = (fast.launches["alpha_scale_parts"]
                                       + fast.launches["apply_opacity_scale"])
    elif quantized:
        counts.update(track_q=fastq.launches, build_finemap=finemap.launches)
    else:
        counts["track_f32"] = fast.launches["track_f32"]
    return counts, absent


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


def main_argv(dev, name, limit, samples):
    """The app's arguments of the main paths: the synthetic subdiv 8 x 16
    scene at 1920x1080, bench.py's closeup camera, `limit` samples in
    launches of `samples` ("auto" too), the PNG <name>.png in OUT_DIR."""
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.data.lod import frame_camera
    from icon_rt_tpu_torch.models.cells import compute_stats
    stats = compute_stats(synthetic.icosphere(MAIN_SUB, MAIN_LAYERS))
    cam = frame_camera(stats, "closeup", MAIN_W, MAIN_H)
    pose = [*cam.position, *cam.get_poi(), *cam.up_vector]
    os.makedirs(OUT_DIR, exist_ok=True)
    return ["--device", dev.type, "--synthetic", f"{MAIN_SUB}:{MAIN_LAYERS}",
            "--size", str(MAIN_W), str(MAIN_H), "--sample-limit", str(limit),
            "--samples", str(samples),
            "--camera", *[repr(float(v)) for v in pose],
            "-fovy", repr(float(cam.get_fovy_degrees())),
            "-o", os.path.join(OUT_DIR, name)]


def main_path(dev, quantized=False, marching=False):
    """Run the app's main path (the f32 tier, or --quantized with the fine
    map built into an empty cache; with `marching` the --march path and its
    TF edits) with zeroed launch counters; returns (pipeline, counts,
    metrics)."""
    import torch
    from icon_rt_tpu_torch import app

    tag = "main " + ("m" if marching else "") + ("q" if quantized else "")
    tag = tag.rstrip()
    name = "chip_smoke" + ("_m" if marching else "") \
        + ("_q" if quantized else "")
    argv = main_argv(dev, name, MARCH_LIMIT if marching else MAIN_LIMIT,
                     MAIN_SPL)
    if quantized:
        argv.append("--quantized")
    if marching:
        argv.append("--march")
    spl = 1 if marching else MAIN_SPL

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
    what = ("scene; the quantized tables and the K7-loc locator are built "
            "by the first launch" if quantized else
            "scene, locator, tables on the card")
    print(f"{tag} build {build_s:.3f} s ({what}); launches "
          f"{n_launch}, ms per launch {[round(x, 3) for x in launch_ms]} "
          f"(the first also bakes and orders the rays); present "
          f"{present_s:.3f} s")

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

    edit_ms = {}
    if marching:
        # the TF edits belong to the path: each launches the march again
        edit_ms = march_tf_edits(pl, tag, quantized)
        n_launch += len(edit_ms)
    counts, absent = read_counters(quantized, marching)
    print(f"{tag} launch counts {json.dumps(counts)}"
          + (f"; must not run {json.dumps(absent)}" if absent else ""))
    for k, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{tag} path did not launch {k}")
    for k, c in absent.items():
        if c != 0:
            raise AssertionError(f"{tag} path launched {k} {c} times")
    tracker = ("march_q" if quantized else "march_f32") if marching \
        else ("track_q" if quantized else "track_f32")
    if counts[tracker] != n_launch:
        raise AssertionError(f"{tracker} launched {counts[tracker]} times "
                             f"in {n_launch} launches")

    # every launch but the first (which orders the rays and bakes the
    # tables) is a steady one; the Woodcock paths run on to STEADY_LIMIT
    if not marching:
        pl.sample_limit = STEADY_LIMIT
        run_loop(pl, launch_ms)
    steady = np.array(launch_ms[1:MARCH_LIMIT if marching else None])
    med = float(np.median(steady))
    mray = MAIN_W * MAIN_H * spl / (med * 1e-3) / 1e6
    print(f"{tag} steady launches {len(steady)} ({spl} "
          f"{'converged pass' if marching else 'samples'} each): ms per "
          f"launch median {med:.3f}, min {steady.min():.3f}, max "
          f"{steady.max():.3f}; all {[round(x, 3) for x in launch_ms]}")
    print(f"{tag} end-to-end full-frame rate {mray:.3f} Mray/s"
          + (f", {1e3 / med:.3f} converged frames/s" if marching else "")
          + " (median launch wall time, fb copied to the host)")
    return pl, counts, {"build_s": build_s, "launch_ms": launch_ms,
                        "mray_s": mray, "covered": covered,
                        "edit_ms": edit_ms}


def timed_edit(pl, tag, label, edit):
    """ms from a TF edit to the next launch's fb on the host; prints the
    share of the edit itself (its handler, the device synchronized)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    edit()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pl.launch()
    np.asarray(pl._last_fb.cpu())
    t2 = time.perf_counter()
    ms = (t2 - t0) * 1e3
    print(f"{tag} TF edit {label}: {ms:.3f} ms to the next launch's fb on "
          f"the host (the edit {(t1 - t0) * 1e3:.3f} ms, the launch "
          f"{(t2 - t1) * 1e3:.3f} ms)")
    return ms


def set_opacity(pl, v):
    pl.tfe.set_opacity_scale(v)
    pl.is_running()          # the loop's TF-editor harvest fires the edit


def set_lut(pl, lut):
    tf = pl.transfunc
    tf.set_lut(lut)
    pl.transfunc_update_handler(tf, pl.tf_index)
    pl.reset_accumulation()


def march_tf_edits(pl, tag, quantized):
    """TF edits on a march path, each timed to the next converged frame on
    the host: an opacity-scale edit (K5c-f32 on the f32 tier, K5c-q on the
    quantized tier), on the quantized tier a curve edit, and then the edit
    back to the path's transfer function, so that the phases after it
    measure the main path's state."""
    from icon_rt_tpu_torch.ops import fast
    lut0, scale0 = pl.transfunc.get_lut(), pl.tfe.get_opacity_scale()
    before = dict(fast.launches)
    out = {"opacity": timed_edit(pl, tag, "opacity scale 1.0 -> 0.5",
                                 lambda: set_opacity(pl, 0.5))}
    ran = {k: fast.launches[k] - before[k]
           for k in ("alpha_scale_parts", "apply_opacity_scale",
                     "classify_bake")}
    print(f"{tag} TF edit opacity scale: K5c-f32/K5a launches {ran}")
    if not quantized and (ran["apply_opacity_scale"] != 1
                          or ran["classify_bake"] != 0):
        raise AssertionError("the opacity-scale edit did not take the "
                             "scale-only re-bake")
    if quantized:
        lut = lut0.copy()
        lut[: lut.shape[0] // 2, 3] = 0.0
        out["curve"] = timed_edit(pl, tag, "curve, lower half transparent",
                                  lambda: set_lut(pl, lut))

    def restore():
        if quantized:
            set_lut(pl, lut0)
        set_opacity(pl, scale0)
    out["restore"] = timed_edit(pl, tag, "back to the path's TF", restore)
    return out


def tf_edits(pl):
    """Three TF edits on the quantized main path, each timed from the edit
    to the next launch's fb on the host: an opacity-scale edit (through the
    TF editor's dirty flags), a curve edit that changes <= 32 of the 256
    normalized alpha levels (JAX patches those) and one that changes most
    of them.  The app's get_q donates its table (models/qcells.py
    `bake_alpha_q`): each curve edit runs K5c-q's lookup once, into
    alpha_q's own storage."""
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

    def timed(label, edit, bakes):
        before = qcells.launches["bake_lookup"]
        ptr = pl.scene["get_q"]()[0].alpha_q.data_ptr()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        edit()
        pl.launch()
        np.asarray(pl._last_fb.cpu())
        ms = (time.perf_counter() - t0) * 1e3
        ran = qcells.launches["bake_lookup"] - before
        same = pl.scene["get_q"]()[0].alpha_q.data_ptr() == ptr
        print(f"main q TF edit {label}: {ms:.3f} ms to the next launch's fb "
              f"on the host; K5c-q launches {ran}, alpha_q in place {same}")
        if bakes and (ran != 1 or not same):
            raise AssertionError(f"TF edit {label} did not run K5c-q once "
                                 f"in place")
        return ms

    out = {"opacity": timed("opacity scale 1.0 -> 0.5",
                            lambda: set_opacity(pl, 0.5), False)}
    base = pl.transfunc.get_lut()
    narrow = None
    for k in range(base.shape[0] // 2, base.shape[0]):
        lut = base.copy()
        lut[k, 3] *= 0.5
        if 0 < level_changes(lut) <= 32:
            narrow = lut
            break
    if narrow is None:
        raise AssertionError("no single-entry curve edit changes <= 32 "
                             "alpha levels")
    out["curve_narrow"] = timed("curve, <= 32 levels",
                                lambda: set_lut(pl, narrow), True)
    wide = base.copy()
    wide[: base.shape[0] // 2, 3] = 0.0
    out["curve_full"] = timed("curve, lower half transparent",
                              lambda: set_lut(pl, wide), True)
    if not bool(torch.isfinite(pl.frame["accum"]).all()):
        raise AssertionError("accum not finite after the TF edits")
    return out


def kernel_row(rows, counts, errs, name, route, source, replaces, ms,
               plain_ms, bnd, library_ms=None, **extra):
    """Append one entry of the {"kernels": [...]} line and print its
    times; bnd is (bound ms, "bytes" or "operations")."""
    rows.append(dict(name=name, route=route, source=source,
                     replaces=replaces, launches=counts[name],
                     max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                     bound_ms=bnd[0], bound_by=bnd[1],
                     library_ms=library_ms, **extra))
    lib = "" if library_ms is None else f", library call {library_ms:.4f} ms"
    print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}){lib}")


def k5b_bound(nb, S):
    """(ms, by) of K5b's function over nb bins and an S-entry LUT: it
    reads each bin's range (8 bytes), the LUT's alpha column and the TF
    range, and writes each majorant (4 bytes); its operations are the
    sparse table's S * (floor(log2 S) + 1) maxima and K5B_OPS a bin."""
    return bound(nb * 12 + S * 4 + 8, S * S.bit_length() + nb * K5B_OPS)


def divergence(cost, perm, n_active):
    """The warp divergence factor of a launch's per-pixel cost output:
    the sum over warps (32 consecutive lanes of the pixel order) of 32 x
    their largest cost, over the sum of the costs."""
    import torch
    c = cost[perm[:n_active].long()].to(torch.int64)
    c = torch.cat([c, c.new_zeros((-c.numel()) % 32)]).view(-1, 32)
    return float(32 * c.amax(1).sum()) / max(float(c.sum()), 1.0)


def tracker_extras(name, tag, launch, perm, n_active):
    """The K1/K2 row's keys beyond the contract: registers, local bytes
    and resident blocks an SM (the library's occupancy query), the ptxas
    spill stores, the host reads of a steady `launch(None)` (run under
    torch.cuda.set_sync_debug_mode("error"): any read raises, so 0), and
    the divergence factor of `launch(cost)`'s step counts."""
    import torch
    from icon_rt_tpu_torch.utils import cuda_build
    occ = cuda_build.occupancy(name)
    spill = spill_stores(ptxas_lines(cuda_build.info(name)["log"]))
    launch(None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        launch(None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cost = torch.zeros(MAIN_W * MAIN_H, dtype=torch.int32,
                       device=perm.device)
    launch(cost)
    out = dict(occ, spill_store_bytes=spill,
               host_reads=0, divergence=divergence(cost, perm, n_active))
    print(f"{tag} {name}: {out['registers']} registers, "
          f"{out['local_bytes']} local bytes, {out['spill_store_bytes']} B "
          f"spill stores, {out['blocks_per_sm']} blocks an SM; a steady "
          f"call under sync debug mode 'error': no device-to-host read; "
          f"divergence factor {out['divergence']:.3f}")
    return out


def march_extras(tier):
    """The K3 row's keys beyond the contract: registers, local bytes and
    resident blocks an SM (the library's occupancy query) and the ptxas
    spill stores of K3's kernel of `tier` ("f32" or "q")."""
    from icon_rt_tpu_torch.ops.march import march_occupancy
    from icon_rt_tpu_torch.utils import cuda_build
    out = march_occupancy(tier)
    out["spill_store_bytes"] = spill_stores(ptxas_lines(
        cuda_build.info("march")["log"], f"march_{tier}_kernel"))
    print(f"time K3 march_{tier}: {out['registers']} registers, "
          f"{out['local_bytes']} local bytes, {out['spill_store_bytes']} B "
          f"spill stores, {out['blocks_per_sm']} blocks an SM")
    return out


def time_kernels(pl, errs, counts):
    """Each kernel and its plain version at the main path's shapes."""
    import torch
    from icon_rt_tpu_torch.models.accel import (compute_max_opacities_torch,
                                                max_opacity)
    from icon_rt_tpu_torch.ops import fast
    from icon_rt_tpu_torch.ops.order import (_camera, _chord_keys_torch,
                                             chord_keys)
    from icon_rt_tpu_torch.ops.render import alloc_frame

    s = pl.scene
    cells, loc, stats = s["cells"], s["locator"], s["stats"]
    packed, bands, tf = s["get_packed"](), s["get_bands"](), s["tf"]()
    frame = pl.frame
    W, H = MAIN_W, MAIN_H
    dev = cells.height.device
    lp = launch_params(pl)
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
    tier = CountingTier(fast._F32Tier(packed, loc))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # _render_frame_fast_torch, through the counting tier
    fast._track_torch(tier, bands, lp, pix, acc_p[:n], fb_p[:n], W, H,
                      MAIN_SPL, True)
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
    nl_f32 = lambda c: packed.test[c, 14]
    extras = tracker_extras(
        "track_f32", "time", lambda c: fast.track_f32(
            packed, loc, bands, lp, pix, acc[:n], fb[:n], width=W, height=H,
            samples=MAIN_SPL, preserve_cache=True, cost=c),
        frame["perm"], n)
    row("track_f32", "cuda", "icon_rt_tpu_torch/csrc/track_f32.cu",
        "icon_rt_tpu/ops/fast.py:451", k8, p8,
        tier.bound("track_f32", n, nl_f32), samples=MAIN_SPL, **extras)

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
    N = cells.height.shape[0]
    # reads height, value (N, 32) and num_layers, writes prof (N, 64) and
    # rgb (N, 96); ~25 operations per (cell, layer)
    row("classify_bake", "triton", "icon_rt_tpu_torch/ops/fast.py",
        "icon_rt_tpu/ops/fast.py:115", kb, pb,
        bound(N * (32 * 4 * 2 + 4 + (64 + 96) * 4), N * 32 * 25))

    mo_args = (bands.value_ranges, tf.values, tf.value_range)
    if not torch.equal(max_opacity(*mo_args),
                       compute_max_opacities_torch(*mo_args)):
        raise AssertionError("K5b differs from its plain version at the "
                             "main shape")
    km = time_cuda(lambda: max_opacity(*mo_args), reps=50)
    pm = time_cuda(lambda: compute_max_opacities_torch(*mo_args), reps=20)
    row("max_opacity", "cuda", "icon_rt_tpu_torch/csrc/majorant.cu",
        "icon_rt_tpu/models/accel.py:201", km, pm,
        k5b_bound(bands.value_ranges.shape[0], tf.size))

    cam = _camera(lp)
    r_in, r_out = stats.spherical_bounds_lo[0], stats.spherical_bounds_hi[0]
    f32 = lambda v: torch.tensor(float(np.float32(v)), device=dev)
    keys = lambda: chord_keys(cam, r_in, r_out, W, H)
    kk = time_cuda(keys, reps=20)
    dk = device_ms(keys, 10, ("chord_keys_kernel",), "K6 chord_keys")
    pk = time_cuda(lambda: _chord_keys_torch(cam, f32(r_in), f32(r_out),
                                             W, H), reps=10)
    errs["chord_keys"] = max(errs["chord_keys"], check_chord_keys(
        *keys(), *_chord_keys_torch(cam, f32(r_in), f32(r_out), W, H),
        f"time K6 chord_keys {W}x{H}"))
    # writes one f32 key a pixel and the covered count, reads the camera's
    # 12 floats; ~60 operations a pixel.  device_ms: the count's memset
    # and the kernel, a call
    row("chord_keys", "cuda", "icon_rt_tpu_torch/csrc/order.cu",
        "icon_rt_tpu/ops/order.py:23", kk, pk,
        bound(W * H * 4 + 4 + 48, W * H * 60), device_ms=dk)
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
    from icon_rt_tpu_torch.ops.render import alloc_frame

    s = pl.scene
    q, loc, k_cap = s["get_q"]()
    fm, bands, tf = s["fm"](), s["get_bands"](), s["tf"]()
    W, H = MAIN_W, MAIN_H
    dev = q.test12.device
    lp = launch_params(pl)
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
    plain_ms, tiers = {}, {}
    for f in (fm, None):
        err, plain_ms[f is not None], tiers[f is not None] = compare_track_q(
            tabs, lp, pix, n, W, H, MAIN_SPL, True, f, "time 1080p")
        errs["track_q"] = max(errs["track_q"], err)
    nl_q = lambda c: q.test12[c, 11]
    print(f"time K2 kernel rate {W * H * MAIN_SPL / (kms[True] * 1e-3) / 1e6:.3f}"
          f" Mray/s full frame ({MAIN_SPL} samples, fine map on, "
          f"{kms[True]:.3f} ms; off {kms[False]:.3f} ms; no host copy)")
    extras = tracker_extras(
        "track_q", "time", lambda c: fastq.track_q(
            *tabs, lp, pix, acc[:n], fb[:n], width=W, height=H,
            samples=MAIN_SPL, preserve_cache=True, finemap=fm, cost=c),
        pl.frame["perm"], n)
    row("track_q", "cuda", "icon_rt_tpu_torch/csrc/track_q.cu",
        "icon_rt_tpu/ops/fastq.py:80", kms[True], plain_ms[True],
        tiers[True].bound("track_q", n, nl_q), samples=MAIN_SPL,
        ms_no_finemap=kms[False], plain_ms_no_finemap=plain_ms[False],
        **extras)

    errs["bake_alpha_q"] = max(errs["bake_alpha_q"],
                               check_bakes(q, tf, dev, "time main shape"))
    q_tab = bake_inputs(q, tf)
    scratch = q.alpha_q.clone()
    kb = time_cuda(lambda: qcells.bake_lookup(q.value_q, q_tab), reps=20)
    pb = time_cuda(lambda: qcells._bake_lookup_torch(q.value_q, q_tab),
                   reps=5)
    ko = time_cuda(lambda: qcells.bake_lookup(q.value_q, q_tab, out=scratch),
                   reps=20)
    lib = time_cuda(lambda: q_tab[q.value_q.int()], reps=20)
    print(f"time K5c-q bake_lookup out= {ko:.4f} ms; occupancy "
          f"{qcells.bake_q_occupancy()}")
    # the lookup reads value_q and the 256-entry table, writes alpha_q; the
    # library call is the index tab[value_q] (with its cast to int32)
    row("bake_alpha_q", "cuda", "icon_rt_tpu_torch/csrc/bake_q.cu",
        "icon_rt_tpu/models/qcells.py:266", kb, pb,
        bound(2 * q.value_q.numel() + 256, 0), library_ms=lib,
        lookup_out_ms=ko)

    errs["build_finemap"] = max(errs["build_finemap"], check_finemap(
        loc, q.test12, "time main shape"))
    kf = time_cuda(lambda: finemap.finemap_slots(loc, q.test12), reps=5)
    pf = time_cuda(lambda: finemap._build_finemap_torch(loc, q.test12),
                   reps=1)
    F = int(fm.slots.shape[0])
    # reads the locator rows and the test rows, writes 4 u8 slots per fine
    # bin; at least one containment test (~20 operations) per sub-center
    row("build_finemap", "cuda", "icon_rt_tpu_torch/csrc/finemap.cu",
        "icon_rt_tpu/models/finemap.py:174", kf, pf,
        bound(loc.bins.numel() * 4 + q.test12.numel() * 4 + F * 4,
              4 * F * 20), fine_bins=F, k_cap=k_cap)
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
    return rows


def launch_params(pl):
    """The launch parameters of a main path's pipeline at accum_id 0."""
    from icon_rt_tpu_torch.ops.render import make_launch_params
    s = pl.scene
    return make_launch_params(s["camera"].basis(MAIN_W, MAIN_H),
                              s["stats"].world_bounds_lo,
                              s["stats"].world_bounds_hi,
                              unit_distance=s["unit_distance"](),
                              device=pl.frame["accum"].device)


def bench_march(pl_mq):
    """bench.py's r2b8m_closeup call (bench.py:523-531): the quantized march
    with the fine map, built by K7-fm into the emptied cache; one pass
    timed to its fb on the host, and held against the pass without the
    fine map (accum <= FINEMAP_TOL).  Returns the fine map."""
    import torch
    from icon_rt_tpu_torch.data.bigscene import build_finemap_cached
    from icon_rt_tpu_torch.ops.march import render_frame_march_q
    from icon_rt_tpu_torch.ops.render import alloc_frame
    s, frame = pl_mq.scene, pl_mq.frame
    q, loc, _ = s["get_q"]()
    bands, tf = s["get_bands"](), s["tf"]()
    lp = launch_params(pl_mq)
    dev = q.test12.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm = build_finemap_cached(loc, q.test12, factor=2,
                              cache_key=f"chip_smoke_s{MAIN_SUB}")
    torch.cuda.synchronize()
    fm_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(width=MAIN_W, height=MAIN_H, pixel_perm=frame["perm"],
              n_active=frame["n_active"])
    out = {}
    for f in (None, fm, fm):          # the first fine-map pass warms up
        acc, fb = alloc_frame(MAIN_W, MAIN_H, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame_march_q(q, loc, bands, tf, lp, acc, fb, finemap=f, **kw)
        fb_host = fb.cpu().numpy().view(np.uint32)
        out[f is not None] = (acc, (time.perf_counter() - t0) * 1e3, fb_host)
    acc_on, ms, fb_host = out[True]
    covered = float(((fb_host >> 24) > 0).mean())
    print(f"bench m r2b8m_closeup: fine map built in {fm_ms:.3f} ms "
          f"({fm.slots.shape[0]} fine bins); one converged pass with the "
          f"fine map {ms:.3f} ms to its fb on the host (without "
          f"{out[False][1]:.3f} ms, the first call); covered {covered:.4f}")
    finemap_agreement(acc_on, out[False][0], frame["n_active"], "bench m")
    return fm


#: the launches of K3's cost output on a main path
COST_PATH = ("none: check march cost only (no JAX app or bench path asks "
             "for the cost)")


def time_march_kernels(pl_m, pl_mq, fm, errs, counts_m, counts_mq):
    """K3 (f32; quantized with the fine map off, as the app, and on, as the
    bench row) and K5c-f32 against their plain versions at the march
    paths' shapes; torch.addcmul(A, B, s) as the library call of the
    K5c-f32 apply.  Returns (rows, the counting plain tiers of K3's rows
    by kernel, for `time_march_cost`)."""
    import torch
    from icon_rt_tpu_torch.ops import fast
    from icon_rt_tpu_torch.ops.render import alloc_frame
    W, H = MAIN_W, MAIN_H
    rows = []

    # -- K3 on the f32 tier --------------------------------------------------
    s, frame = pl_m.scene, pl_m.frame
    packed, loc, bands, tf = (s["get_packed"](), s["locator"],
                              s["get_bands"](), s["tf"]())
    lp = launch_params(pl_m)
    n = frame["n_active"]
    pix = frame["perm"][:n].contiguous()
    dev = pix.device
    acc, fb = alloc_frame(W, H, device=dev)
    km = time_cuda(lambda: march_runs(packed, loc, bands, lp, pix, W, H)(
        acc[:n], fb[:n], True), reps=5)
    tiers = []
    counter = lambda t: tiers.append(CountingTier(t)) or tiers[-1]
    err, pm, _ = compare_march(
        "time 1080p K3 march_f32",
        march_runs(packed, loc, bands, lp, pix, W, H, counter=counter),
        W, H, n, dev)
    errs["march_f32"] = max(errs["march_f32"], err)
    print(f"time K3 march_f32 kernel rate {W * H / (km * 1e-3) / 1e6:.3f} "
          f"Mray/s full frame, {1e3 / km:.3f} converged frames/s ({km:.3f} "
          f"ms, no host copy)")
    kernel_row(rows, counts_m, errs, "march_f32", "cuda",
               "icon_rt_tpu_torch/csrc/march.cu",
               "icon_rt_tpu/ops/march.py:301", km, pm,
               tiers[-1].bound("march_f32", n, lambda c: packed.test[c, 14]),
               **march_extras("f32"))
    counted = {"march_f32": tiers[-1]}

    # -- K5c-f32 --------------------------------------------------------------
    cells = s["cells"]
    errs["opacity_scale"] = max(errs["opacity_scale"], check_opacity_scale(
        cells, packed, tf, "time main shape"))
    parts = fast.pack_alpha_scale_parts(cells, tf)
    kparts = time_cuda(lambda: fast.pack_alpha_scale_parts(cells, tf),
                       reps=10)
    pparts = time_cuda(lambda: fast._alpha_scale_parts_torch(cells.value,
                                                             tf), reps=3)
    scale = tf.opacity_scale
    tgt = packed._replace(prof=packed.prof.clone())
    kapply = time_cuda(lambda: fast.apply_opacity_scale(tgt, parts, scale),
                       reps=20)
    papply = time_cuda(lambda: fast._apply_opacity_scale_torch(
        tgt.prof, *parts, scale), reps=5)
    lib = time_cuda(lambda: torch.addcmul(parts[0], parts[1], scale),
                    reps=20)
    N = cells.value.shape[0]
    pb = bound(3 * N * 32 * 4, 2 * N * 32)     # parts: value in, A and B out
    print(f"time K5c-f32 alpha_scale_parts: kernel {kparts:.4f} ms, plain "
          f"{pparts:.4f} ms, bound {pb[0]:.4f} ms ({pb[1]})")
    # the apply reads A and B and writes the alpha half of prof
    kernel_row(rows, counts_m, errs, "opacity_scale", "triton",
               "icon_rt_tpu_torch/ops/fast.py",
               "icon_rt_tpu/ops/fast.py:246", kapply, papply,
               bound(3 * N * 32 * 4, 2 * N * 32), library_ms=lib,
               parts_ms=kparts, parts_plain_ms=pparts, parts_bound_ms=pb[0])
    del parts, tgt

    # -- K3 on the quantized tier ---------------------------------------------
    s, frame = pl_mq.scene, pl_mq.frame
    q, loc_q, _ = s["get_q"]()
    bands, tf = s["get_bands"](), s["tf"]()
    lp = launch_params(pl_mq)
    n = frame["n_active"]
    pix = frame["perm"][:n].contiguous()
    kms, pms, accs, qtiers = {}, {}, {}, {}
    for f in (None, fm):
        on = f is not None
        kms[on] = time_cuda(lambda: march_runs(
            None, None, bands, lp, pix, W, H, qtabs=(q, loc_q, tf), fm=f)(
            acc[:n], fb[:n], True), reps=5)
        tiers = []
        err, pms[on], accs[on] = compare_march(
            f"time 1080p K3 march_q finemap={'on' if on else 'off'}",
            march_runs(None, None, bands, lp, pix, W, H,
                       qtabs=(q, loc_q, tf), fm=f, counter=counter),
            W, H, n, dev)
        qtiers[on] = tiers[-1]
        errs["march_q"] = max(errs["march_q"], err)
    finemap_agreement(accs[True], accs[False], n, "time 1080p")
    print(f"time K3 march_q kernel rate "
          f"{W * H / (kms[False] * 1e-3) / 1e6:.3f} Mray/s full frame "
          f"without the fine map ({kms[False]:.3f} ms), "
          f"{W * H / (kms[True] * 1e-3) / 1e6:.3f} with ({kms[True]:.3f} ms)")
    kernel_row(rows, counts_mq, errs, "march_q", "cuda",
               "icon_rt_tpu_torch/csrc/march.cu",
               "icon_rt_tpu/ops/march.py:449", kms[False], pms[False],
               qtiers[False].bound("march_q", n, lambda c: q.test12[c, 11]),
               ms_finemap=kms[True], plain_ms_finemap=pms[True],
               **march_extras("q"))
    counted["march_q"] = qtiers[False]
    for r in rows:
        r["max_abs_err"] = errs[r["name"]]
    return rows, counted


def time_march_cost(pl_m, pl_mq, errs, counted):
    """K3 with its cost output (JAX's return_cost) at the march paths'
    shapes: timed beside the launch without it, held against its plain
    version (`compare_march_cost`), the bound that of the counted plain run
    (`counted`, by kernel, from `time_march_kernels`) with 4 bytes more a
    lane.  No main path asks for the cost (main m and main mq read its
    count as 0).  Runs after the march paths' profiles: the plain
    versions' long loops leave the profiler without device events."""
    import torch
    W, H = MAIN_W, MAIN_H
    rows = []
    for name, pl in (("march_f32", pl_m), ("march_q", pl_mq)):
        s, frame = pl.scene, pl.frame
        bands, lp = s["get_bands"](), launch_params(pl)
        n = frame["n_active"]
        pix = frame["perm"][:n].contiguous()
        if name == "march_f32":
            packed, loc = s["get_packed"](), s["locator"]
            run = march_runs(packed, loc, bands, lp, pix, W, H)
            nl = lambda c: packed.test[c, 14]
        else:
            q, loc_q, _ = s["get_q"]()
            run = march_runs(None, None, bands, lp, pix, W, H,
                             qtabs=(q, loc_q, s["tf"]()))
            nl = lambda c: q.test12[c, 11]
        acc, fb = (x[:n] for x in (frame["accum"].clone(),
                                   frame["fb"].clone()))
        cost = torch.empty(W * H, dtype=torch.int32, device=pix.device)
        kc, k0 = time_turns(lambda: run(acc, fb, True, cost),
                            lambda: run(acc, fb, True), reps=5)
        pc = compare_march_cost(f"time 1080p K3 {name} cost", run, W, H, n,
                                pix.device)
        print(f"time K3 {name} with the cost {kc:.4f} ms, without "
              f"{k0:.4f} ms (CUDA events, in turns)")
        kernel_row(rows, {f"{name}_cost": 0}, errs, f"{name}_cost", "cuda",
                   "icon_rt_tpu_torch/csrc/march.cu",
                   "icon_rt_tpu/ops/march.py:302, :444-445", kc, pc,
                   counted[name].bound(name, n, nl,
                                       lane_bytes=LANE_BYTES + 4),
                   path=COST_PATH, ms_without_cost=k0)
    return rows


def rmse_q(dev):
    """bench.py `_rmse_q_vs_f32` on the card: the march on the f32 and the
    quantized tier of the same value-quantized scene (subdiv 8 x 16,
    480x270, closeup camera, accum_id 0), both through their kernels; the
    RMSE of accum over the pixels both cover."""
    import torch
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
    from icon_rt_tpu_torch.models.locator import build_locator
    from icon_rt_tpu_torch.models.qcells import (bake_alpha_q,
                                                 quantize_cells,
                                                 quantize_dataset_values)
    from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                                 update_band_majorants)
    from icon_rt_tpu_torch.models.transfunc import make_transfunc
    from icon_rt_tpu_torch.ops import march
    from icon_rt_tpu_torch.ops.fast import pack_cells
    from icon_rt_tpu_torch.ops.order import pixel_order
    from icon_rt_tpu_torch.ops.render import alloc_frame, make_launch_params
    from icon_rt_tpu_torch.data.lod import frame_camera
    t0 = time.perf_counter()
    W, H = RMSE_W, RMSE_H
    ds_q, lo, hi = quantize_dataset_values(
        synthetic.icosphere(MAIN_SUB, MAIN_LAYERS))
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), device=dev)
    bands = update_band_majorants(build_radial_bands(ds_q, 64, device=dev),
                                  tf.values, tf.value_range)
    cam = frame_camera(stats, "closeup", W, H)
    ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=ud,
                            device=dev)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], W, H)
    kw = dict(width=W, height=H, pixel_perm=perm, n_active=n_active)
    before = dict(march.launches)
    cells = build_cells(ds_q, device=dev)
    accum_f, _ = march.render_frame_march(
        cells, pack_cells(cells, tf), build_locator(ds_q, device=dev), bands,
        lp, *alloc_frame(W, H, device=dev), **kw)
    del cells
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi), device=dev),
                     tf)
    accum_q, _ = march.render_frame_march_q(
        q, bin_dataset(ds_q, dev), bands, tf, lp,
        *alloc_frame(W, H, device=dev), **kw)
    ran = {k: march.launches[k] - before[k] for k in before}
    af, aq = accum_f.cpu().numpy(), accum_q.cpu().numpy()
    both = (af[:, 3] > 0) & (aq[:, 3] > 0)
    rmse = float(np.sqrt(np.mean((af[both] - aq[both]) ** 2))) \
        if both.any() else float("nan")
    print(f"rmse_q {rmse:.6f} (march_q vs march_f32 accum over the "
          f"{int(both.sum())} pixels both cover of {W}x{H}; subdiv "
          f"{MAIN_SUB} x {MAIN_LAYERS}; K3 launches {ran}; "
          f"{time.perf_counter() - t0:.1f} s; docs/ROUND5.md:116 records "
          f"0.0016 for this scene)")
    if ran != {"march_f32": 1, "march_q": 1, "march_f32_cost": 0,
               "march_q_cost": 0} or not np.isfinite(rmse):
        raise AssertionError("rmse_q did not run both marches' kernels")
    return rmse


# ===========================================================================
# The reference-parity raygens (K8)
# ===========================================================================

def parity_tables(sub, layers, dev):
    """Cells, locator, transfer function and both accels (built on the
    host, majorants by K5b) of the synthetic subdiv-`sub` scene; returns
    (tables dict, stats, build seconds by part)."""
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.accel import (build_grid_accel,
                                                build_shell_accel,
                                                update_majorants)
    from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
    from icon_rt_tpu_torch.models.locator import build_locator
    from icon_rt_tpu_torch.models.transfunc import make_transfunc
    ds = synthetic.icosphere(sub, layers)
    stats = compute_stats(ds)
    secs = {}
    t0 = time.perf_counter()
    cells = build_cells(ds, device=dev)
    t1 = time.perf_counter()
    loc = build_locator(ds, device=dev)
    t2 = time.perf_counter()
    tf = make_transfunc(value_range=tuple(stats.data_range), device=dev)
    sph = update_majorants(build_shell_accel(
        ds, stats.spherical_bounds_lo, stats.spherical_bounds_hi,
        device=dev), tf.values, tf.value_range)
    t3 = time.perf_counter()
    grid = update_majorants(build_grid_accel(
        ds, stats.world_bounds_lo, stats.world_bounds_hi, device=dev),
        tf.values, tf.value_range)
    secs.update(cells=t1 - t0, locator=t2 - t1, sphere=t3 - t2,
                grid=time.perf_counter() - t3)
    return dict(cells=cells, loc=loc, tf=tf,
                accel={"sphere": sph, "grid": grid}), stats, secs


def parity_lp(stats, width, height, dev, k=0):
    """Closeup launch parameters with the app's unit distance."""
    from icon_rt_tpu_torch.ops.render import make_launch_params
    from icon_rt_tpu_torch.data.lod import frame_camera
    cam = frame_camera(stats, "closeup", width, height)
    ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    return make_launch_params(cam.basis(width, height),
                              stats.world_bounds_lo, stats.world_bounds_hi,
                              unit_distance=ud, accum_id=k, device=dev)


def parity_run(tabs, lp, raygen, sampler, pix, width, height, samples,
               kernel, work=None):
    # tabs["wedges"]: the Wedges of the wedge sampler (K9-p)
    """`samples` K8 samples (kernel, or its plain version on the same
    card) of the lanes `pix`; returns (accum, fb, debug of the first
    sample: final rng, iterations; seconds per sample).  `work`, an
    ops/woodcock.py `Work` (plain version only), counts the first
    sample's events."""
    import torch
    from icon_rt_tpu_torch.ops import render
    dev = pix.device
    n = pix.shape[0]
    acc = torch.zeros(n, 4, dtype=torch.float32, device=dev)
    fb = torch.zeros(n, dtype=torch.int32, device=dev)
    dbg = torch.zeros(n, 2, dtype=torch.int32, device=dev)
    accel = tabs["accel"].get(raygen)
    cells, loc = tabs["cells"], tabs["loc"]
    secs = []
    for k in range(samples):
        lpk = with_id(lp, k)
        d = dbg if k == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kernel:
            render.parity_track(cells, tabs["tf"], lpk, acc, fb,
                                width=width, height=height, raygen=raygen,
                                sampler=sampler, locator=loc, accel=accel,
                                pix=pix, debug=d, wedges=tabs.get("wedges"))
        else:
            render._parity_torch(cells, tabs["tf"], lpk, pix, acc, fb, d,
                                 width, height, raygen, sampler, loc, accel,
                                 work if k == 0 else None,
                                 tabs.get("wedges"))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return acc, fb, dbg, secs


def parity_bound(raygen, sampler, lanes, w, scale,
                 lane_bytes=PARITY_BYTES["lane"]):
    """(ms, by) of one K8 sample of `lanes` lanes from the work `w`
    (`Work.counts()`) of a plain run on lanes/scale of them: the events
    scaled to the frame, each by its own operations (the locate only for
    the samples that the whole-shell test keeps); the bytes of every
    lane (`lane_bytes` each), and the reads of the counted lanes (fewer
    than the frame's, so the bound stays a least time)."""
    o, b = PARITY_OPS, PARITY_BYTES
    if sampler == "wedge":
        return wedge_bound(raygen, lanes, w, scale)
    plane_tests = w["plane1"] + 2 * w["plane2"] + 3 * (w["plane3"]
                                                       + w["hit"])
    located = w["eval"] - w["shell"]        # the samples the shell kept
    ops = scale * (w["draw"] * o["draw"]
                   + w["advance"] * o["advance"][raygen]
                   + w["eval"] * (o["eval"] + o["shell"])
                   + (located * o["locate"] if sampler == "locator" else 0)
                   + (w["radial"] + w["plane1"] + w["plane2"] + w["plane3"]
                      + w["hit"]) * o["radial"]
                   + plane_tests * o["plane"]
                   + w["hit"] * o["hit"] + w["hit_layers"] * o["hit_layer"])
    nbytes = (lane_bytes * lanes + b["radial"] * w["radial_cells"]
              + b["planes"] * w["plane_cells"] + b["hit"] * w["hit_cells"]
              + b["layer"] * w["hit_cell_layers"] + b["entry"] * w["entries"])
    return bound(nbytes, ops)


def compare_parity(label, tabs, lp, raygen, sampler, pix, width, height,
                   samples, count=False):
    """K8 against its plain version on the lanes `pix`: the first sample's
    final rng and iterations equal on every lane, then after `samples`
    samples fb identical on >= 99.9% and accum within ACCUM_TOL; raises
    past them.  Returns (accum max abs err, plain seconds of the last
    sample, kernel seconds of the last sample, with `count` the plain
    version's work in the first sample (`Work.counts()`), else None).
    The lanes' equal rng and iterations make that work the kernel's."""
    import torch
    from icon_rt_tpu_torch.ops.woodcock import Work
    work = Work(tabs["cells"], sampler,
                tabs["loc"] if sampler != "brute" else None,
                tabs.get("wedges")) if count else None
    ak, fk, dk, ks = parity_run(tabs, lp, raygen, sampler, pix, width,
                                height, samples, True)
    ap, fp, dp, ps = parity_run(tabs, lp, raygen, sampler, pix, width,
                                height, samples, False, work)
    w = work.counts() if count else None
    same_rng = float((dk[:, 0] == dp[:, 0]).float().mean())
    same_it = float((dk[:, 1] == dp[:, 1]).float().mean())
    same = float((fk == fp).float().mean())
    err = float((ak - ap).abs().max())
    print(f"{label} {raygen} x {sampler}: first sample's rng equal on "
          f"{same_rng:.6f}, iterations on {same_it:.6f} of {pix.shape[0]} "
          f"lanes (max {int(dk[:, 1].max())}); after {samples} samples fb "
          f"identical on {same:.6f}, accum max abs diff {err:.3e}; last "
          f"sample kernel {ks[-1] * 1e3:.3f} ms, plain {ps[-1] * 1e3:.3f} "
          f"ms" + (f"; the first sample's work {json.dumps(w)}" if count
                   else ""))
    if same_rng < 1.0 or same_it < 1.0:
        bad = int(torch.nonzero((dk != dp).any(dim=1))[0, 0])
        raise AssertionError(
            f"{label}: K8 {raygen} x {sampler} lane {bad} (pixel "
            f"{int(pix[bad])}) ends with rng {int(dk[bad, 0])} after "
            f"{int(dk[bad, 1])} iterations, the plain version with "
            f"{int(dp[bad, 0])} after {int(dp[bad, 1])}")
    if same < 0.999 or not err <= ACCUM_TOL:
        raise AssertionError(f"{label}: K8 {raygen} x {sampler} disagrees "
                             f"with its plain version")
    if sampler == "wedge" and not int((fk != 0).sum()):
        raise AssertionError(f"{label}: K9-p {raygen} wrote no pixel")
    return err, ps[-1], ks[-1], w


def ptxas_lines(log, entry=None):
    """The lines of a build's ptxas report (`-Xptxas=-v`) of each entry
    function whose mangled name holds `entry` (every one where None): its
    "Compiling entry function" line, then its stack, spill and register
    lines."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line if entry is None or entry in line else None
            if cur is not None:
                out.append(line.strip())
        elif cur is not None and any(k in line for k in (
                "registers", "spill", "stack")):
            out.append(line.strip())
    return out


def spill_stores(lines):
    """The spill store bytes in `ptxas_lines` of one entry function, or
    None where the report has none."""
    import re
    for line in lines:
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            return int(m.group(1))
    return None


def parity_instance(raygen, sampler):
    """The part of the mangled name of csrc/parity.cu's finalizing kernel
    `parity_kernel<RAYGEN, SAMPLER, false>` that names its instance."""
    return "parity_kernelILi%dELi%dELb0E" % (
        {"ae": 0, "sphere": 1, "grid": 2}[raygen],
        {"locator": 0, "brute": 1, "wedge": 2}[sampler])


def parity_extras(tag, raygen, sampler, launch, dbg):
    """The K8 row's keys beyond the contract: the kernel's registers,
    local bytes and resident blocks an SM (ops/render.py
    `parity_occupancy`), the ptxas spill stores of its instance, the host
    reads of a steady `launch()` (run under
    torch.cuda.set_sync_debug_mode("error"): any read raises, so 0), and
    the warp divergence factor of the debug output's iterations `dbg`
    (warps of 32 consecutive lanes)."""
    import torch
    from icon_rt_tpu_torch.ops import render
    from icon_rt_tpu_torch.utils import cuda_build
    n = dbg.shape[0]
    occ = render.parity_occupancy(raygen, sampler)
    spill = spill_stores(ptxas_lines(cuda_build.info("parity")["log"],
                                     parity_instance(raygen, sampler)))
    launch()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        launch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out = dict(occ, spill_store_bytes=spill, host_reads=0,
               divergence=divergence(dbg[:, 1], torch.arange(
                   n, device=dbg.device), n))
    print(f"{tag} K8 {raygen} x {sampler}: {out['registers']} registers, "
          f"{out['local_bytes']} local bytes, {out['spill_store_bytes']} B "
          f"spill stores, {out['blocks_per_sm']} blocks an SM; a steady "
          f"launch under sync "
          f"debug mode 'error': no device-to-host read; divergence factor "
          f"{out['divergence']:.3f} (iterations a lane: mean "
          f"{float(dbg[:, 1].double().mean()):.1f}, max "
          f"{int(dbg[:, 1].max())})")
    return out


def shell_share(w):
    """The share of a run's samples that K8's whole-shell test rejects
    (`Work.counts()`)."""
    return w["shell"] / max(w["eval"], 1)


def check_parity_raw(label, tabs, lp, raygen, sampler, pix, width, height):
    """K8's raw mode against its plain version on the lanes `pix` at sample
    1: wrote bit-equal, the colour identical on >= 99.9% of lanes and
    within ACCUM_TOL; then the raw sample through K10's mean finalize over
    one rank bit-equal (accum and fb) to K8's finalizing launch of the same
    sample on a seeded accum history.  Raises past them; returns (max abs
    err, plain seconds, kernel seconds)."""
    import torch
    from icon_rt_tpu_torch.ops import composite, render
    from icon_rt_tpu_torch.ops.fast import alloc_raw
    dev, n = pix.device, pix.shape[0]
    lp1 = with_id(lp, 1)
    cells, tf, loc = tabs["cells"], tabs["tf"], tabs["loc"]
    accel = tabs["accel"].get(raygen)
    kw = dict(width=width, height=height, raygen=raygen, sampler=sampler,
              locator=loc, accel=accel, pix=pix)
    rk, rp = alloc_raw(n, dev), alloc_raw(n, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render.parity_track(cells, tf, lp1, None, None, out=rk, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    render._parity_torch(cells, tf, lp1, pix, None, None, None, width,
                         height, raygen, sampler, loc, accel, out=rp)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    wrote_eq = torch.equal(rk.wrote, rp.wrote)
    same = float((rk.ca == rp.ca).all(1).float().mean())
    err = float((rk.ca - rp.ca).abs().max())
    acc0 = torch.rand(n, 4, generator=torch.Generator().manual_seed(n)).to(
        dev)
    acc, fb = acc0.clone(), torch.zeros(n, dtype=torch.int32, device=dev)
    render.parity_track(cells, tf, lp1, acc, fb, **kw)
    acc_r, fb_r = acc0.clone(), torch.zeros_like(fb)
    composite.finalize_mean(composite.mean_payload(rk.wrote, rk.ca), acc_r,
                            fb_r, lp1.accum_id)
    fin = torch.equal(acc, acc_r) and torch.equal(fb, fb_r)
    print(f"{label} {raygen} x {sampler}: raw wrote "
          f"{'bit-equal' if wrote_eq else 'DIFFERS'} ({int(rk.wrote.sum())} "
          f"of {n} lanes), colour identical on {same:.6f}, max abs diff "
          f"{err:.3e}; raw + K10 mean finalize "
          f"{'bit-equal to' if fin else 'DIFFERS from'} K8's finalize; "
          f"kernel {(t1 - t0) * 1e3:.3f} ms, plain {(t2 - t1) * 1e3:.3f} ms")
    if not wrote_eq or same < 0.999 or not err <= ACCUM_TOL or not fin:
        raise AssertionError(f"{label}: K8 raw {raygen} x {sampler} "
                             f"disagrees with its plain version or with "
                             f"K8's finalize")
    return err, t2 - t1, t1 - t0


def check_parity(dev, errs):
    """K8's six raygen x sampler combinations against the plain version at
    subdiv 3 x 8, 128x128, closeup camera, app unit distance, 2 samples,
    and K8's raw mode against its plain version (`check parity raw`).
    Returns the brute-force rows' timings and bounds (they run here only)."""
    import torch
    from icon_rt_tpu_torch.ops import render
    t0 = time.perf_counter()
    tabs, stats, secs = parity_tables(PARITY_SUB, PARITY_LAYERS, dev)
    W = H = PARITY_W
    lp = parity_lp(stats, W, H, dev)
    pix = torch.arange(W * H, dtype=torch.int32, device=dev)
    print(f"check parity scene subdiv {PARITY_SUB} x {PARITY_LAYERS} "
          f"({tabs['cells'].num_cells} cells), {W}x{H}, build seconds "
          f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    brute = {}
    for raygen in PARITY_RAYGENS:
        for sampler in PARITY_SAMPLERS:
            name = f"parity_{raygen}_{sampler}"
            err, ps, ks, w = compare_parity(
                "check parity", tabs, lp, raygen, sampler, pix, W, H,
                PARITY_SAMPLES, count=sampler == "brute")
            errs[name] = max(errs.get(name, 0.0), err)
            err = check_parity_raw("check parity raw", tabs, lp, raygen,
                                   sampler, pix, W, H)[0]
            errs[f"{name}_raw"] = max(errs.get(f"{name}_raw", 0.0), err)
            if sampler == "brute":
                # one sample of the whole frame, kernel and plain; the
                # work counted on every lane
                acc = torch.zeros(W * H, 4, device=dev)
                fb = torch.zeros(W * H, dtype=torch.int32, device=dev)
                launch = lambda: render.parity_track(
                    tabs["cells"], tabs["tf"], lp, acc, fb, width=W,
                    height=H, raygen=raygen, sampler=sampler,
                    accel=tabs["accel"].get(raygen))
                ms = time_cuda(lambda: parity_run(
                    tabs, lp, raygen, sampler, pix, W, H, 1, True), reps=3)
                bnd = parity_bound(raygen, sampler, W * H, w, 1.0)
                print(f"bound {name}: {bnd[0]:.4f} ms ({bnd[1]}), the work "
                      f"of all {W * H} lanes; the whole-shell test rejects "
                      f"{shell_share(w):.6f} of {w['eval']} samples")
                dbg = parity_run(tabs, lp, raygen, sampler, pix, W, H, 1,
                                 True)[2]
                extra = parity_extras("check parity", raygen, sampler,
                                      launch, dbg)
                brute[name] = dict(ms=ms, plain_ms=ps * 1e3, bnd=bnd,
                                   lanes=W * H, scene=f"subdiv {PARITY_SUB}",
                                   shell_share=shell_share(w), **extra)
    print(f"check parity {time.perf_counter() - t0:.1f} s")
    return brute


def parity_argv(raygen, accel_mode, sampler, sub, layers, width, height,
                limit, name):
    """The app's argv of a parity path with the closeup camera; sampler
    "wedge" is given as -mode 2."""
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.cells import compute_stats
    from icon_rt_tpu_torch.data.lod import frame_camera
    stats = compute_stats(synthetic.icosphere(sub, layers))
    cam = frame_camera(stats, "closeup", width, height)
    pose = [*cam.position, *cam.get_poi(), *cam.up_vector]
    argv = ["--device", "cuda", "--synthetic", f"{sub}:{layers}",
            "--size", str(width), str(height), "--sample-limit", str(limit),
            "--camera", *[repr(float(v)) for v in pose],
            "-fovy", repr(float(cam.get_fovy_degrees())),
            "--raygen", "ae" if raygen == "ae" else "accel",
            *(["-mode", "2"] if sampler == "wedge" else
              ["--sampler", sampler]), "-o", os.path.join(OUT_DIR, name)]
    if raygen != "ae":
        argv += ["--accel-mode", accel_mode]
    return argv


def main_parity(dev, raygen, errs, mesh_path=None):
    """A parity raygen through the app (icon_rt_tpu_torch.app.build, the
    launch / is_running / present loop) at subdiv 8 x 16, 1920x1080, the
    closeup camera, the locator sampler and the app's unit distance:
    build seconds (cells, locator, the accel), PARITY_LIMIT launches of
    samples=1 (fb on the host), coverage, the maximum iterations per lane,
    tf_edit_s, K5b against its plain version at the accel's bin count, a
    profiled launch and the peak memory.  Returns (counts, the K8 row's
    numbers, `check`): check() holds K8 against its plain version on the
    first CHECK_LANES lanes of pixel_order's covered prefix (adding the
    plain time to the row) and on CHECK_LANES lanes strided over the
    frame, whose plain run counts the work of the bound, scaled to the
    frame; it runs after every profile of the script, because the plain
    version's long loops leave the profiler without device events for
    several windows.  With `mesh_path` the path's tables (cells, locator,
    TF, accel, the app's radial bands and launch params) are saved there
    for the mesh phases' ranks (`main_mesh`)."""
    import torch
    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.models import accel as accel_mod
    from icon_rt_tpu_torch.models.accel import (compute_max_opacities_torch,
                                                max_opacity)
    from icon_rt_tpu_torch.ops import render
    from icon_rt_tpu_torch.ops.order import pixel_order
    tag = "main ae" if raygen == "ae" else f"main accel {raygen}"
    name = f"parity_{raygen}_locator"
    W, H = MAIN_W, MAIN_H
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    pl = app.build(parity_argv(raygen, raygen, "locator", MAIN_SUB,
                               MAIN_LAYERS, W, H, PARITY_LIMIT,
                               f"chip_smoke_{raygen}"))
    build_s = time.perf_counter() - t0
    launch_ms = []
    run_loop(pl, launch_ms)
    pl.present()
    s = pl.scene
    secs = dict(s["timings"])
    print(f"{tag} build {build_s:.3f} s (app.build: cells and locator); "
          f"build seconds by part {json.dumps({k: round(v, 3) for k, v in secs.items()})}"
          f" (the accel and its K5b majorants in the first launch)")
    fb_host = pl.frame["fb"].cpu().numpy().view(np.uint32)
    covered = float(((fb_host >> 24) > 0).mean())
    acc = pl.frame["accum"]
    if not bool(torch.isfinite(acc).all()) or covered < 0.5:
        raise AssertionError(f"{tag}: image covers {covered:.4f} (< 0.5) or "
                             f"accum is not finite")
    steady = np.array(launch_ms[1:])
    med = float(np.median(steady))
    spread = float((steady.max() - steady.min()) / med)
    print(f"{tag} {len(launch_ms)} launches of 1 sample; ms per launch "
          f"{[round(x, 3) for x in launch_ms]} (the first also builds the "
          f"accel); steady median {med:.3f} ms, spread {spread:.3f}: "
          f"{W * H / (med * 1e-3) / 1e6:.3f} Mray/s full frame (fb copied "
          f"to the host); image covered fraction {covered:.4f}")
    counts = {name: render.launches[name]}
    if raygen != "ae":                  # the accel's majorants
        counts["max_opacity"] = accel_mod.launches
    require_counts(tag, counts)
    if counts[name] != len(launch_ms):
        raise AssertionError(f"{tag}: K8 launched {counts[name]} times in "
                             f"{len(launch_ms)} launches")

    cells, loc = s["get_f32"]()
    tf = s["tf"]()
    accel = s["get_accel"](raygen) if raygen != "ae" else None
    tabs = dict(cells=cells, loc=loc, tf=tf,
                accel={} if accel is None else {raygen: accel})
    lp = launch_params(pl)
    if mesh_path is not None:
        t0 = time.perf_counter()
        torch.save(dict(tabs, bands=s["get_bands"](), lp=lp), mesh_path)
        print(f"{tag} tables saved for the mesh phases in "
              f"{time.perf_counter() - t0:.2f} s "
              f"({os.path.getsize(mesh_path) / 2 ** 20:.0f} MiB)")
    full = torch.arange(W * H, dtype=torch.int32, device=dev)
    _, _, dbg, _ = parity_run(tabs, lp, raygen, "locator", full, W, H, 1,
                              True)
    print(f"{tag} iterations per lane over the frame: max "
          f"{int(dbg[:, 1].max())}, mean "
          f"{float(dbg[:, 1].double().mean()):.1f} (cap {render.MAX_ITERS})")
    if int(dbg[:, 1].max()) >= render.MAX_ITERS:
        raise AssertionError(f"{tag}: a lane reached the iteration cap")
    steady = lambda: render.parity_track(
        cells, tf, lp, acc, pl.frame["fb"], width=W, height=H,
        raygen=raygen, sampler="locator", locator=loc, accel=accel)
    ms = time_cuda(steady, reps=3)
    extra = parity_extras(tag, raygen, "locator", steady, dbg)

    if accel is not None:
        mo_args = (accel.value_ranges, tf.values, tf.value_range)
        got = max_opacity(*mo_args)
        want = compute_max_opacities_torch(*mo_args)
        km = time_cuda(lambda: max_opacity(*mo_args), reps=5)
        pm = time_cuda(lambda: compute_max_opacities_torch(*mo_args), reps=1)
        nb = accel.value_ranges.shape[0]
        k5b = dict(ms=km, plain_ms=pm, bnd=k5b_bound(nb, tf.size), bins=nb,
                   launches=counts["max_opacity"])
        print(f"{tag} K5b at {nb} bins: "
              f"{'exact' if torch.equal(got, want) else 'DIFFERS'}; kernel "
              f"{km:.4f} ms, plain {pm:.4f} ms, bound {k5b['bnd'][0]:.4f} "
              f"ms ({k5b['bnd'][1]})")
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: K5b differs from its plain "
                                 f"version at {got.shape[0]} bins")

    profile_render(lambda: render.parity_track(
        cells, tf, with_id(lp, PARITY_LIMIT), acc, pl.frame["fb"], width=W,
        height=H, raygen=raygen, sampler="locator", locator=loc,
        accel=accel), pl.frame["fb"], f"{tag} launch", "parity_kernel")

    lut0 = pl.transfunc.get_lut()
    timed_edit(pl, tag, "gain 0.95 (warm-up)", lambda: set_lut(
        pl, lut0 * np.float32(0.95)))
    edit_ms = timed_edit(pl, tag, "gain 0.9", lambda: set_lut(
        pl, lut0 * np.float32(0.9)))
    print(f"{tag} tf_edit_s {edit_ms / 1e3:.4f} (a gain edit: "
          f"{'K5b over the accel, ' if accel is not None else ''}the next "
          f"frame's fb on the host)")
    gib = peak_memory(tag)
    row = dict(ms=ms, lanes=W * H, launch_ms=med,
               max_iters=int(dbg[:, 1].max()), tf_edit_s=edit_ms / 1e3,
               peak_gib=gib, **extra)
    if accel is not None:
        row["k5b"] = k5b
    perm, _ = pixel_order(lp, s["stats"].spherical_bounds_lo[0],
                          s["stats"].spherical_bounds_hi[0], W, H)
    pix = perm[:CHECK_LANES].contiguous()
    stride = W * H // CHECK_LANES
    strided = full[::stride][:CHECK_LANES].contiguous()
    del pl, acc, dbg, perm, full

    def check():
        err, ps, ks, _ = compare_parity(
            f"{tag} K8 on {CHECK_LANES} covered lanes", tabs, lp, raygen,
            "locator", pix, W, H, 1)
        err2, _, _, w = compare_parity(
            f"{tag} K8 on {CHECK_LANES} lanes strided by {stride}", tabs,
            lp, raygen, "locator", strided, W, H, 1, count=True)
        errs[name] = max(errs.get(name, 0.0), err, err2)
        bnd = parity_bound(raygen, "locator", W * H, w,
                           W * H / CHECK_LANES)
        print(f"bound {name}: {bnd[0]:.4f} ms ({bnd[1]}), the work of "
              f"{CHECK_LANES} strided lanes scaled by "
              f"{W * H / CHECK_LANES:.2f}; the whole-shell test rejects "
              f"{shell_share(w):.6f} of their {w['eval']} samples")
        row.update(bnd=bnd, plain_ms=ps * 1e3, plain_lanes=CHECK_LANES,
                   ms_check_lanes=ks * 1e3, work=w,
                   shell_share=shell_share(w))
    return counts, row, check


def main_brute(dev):
    """The brute-force sampler through the app on the check scene (it is
    meant for small scenes): each parity raygen, 2 launches of 1 sample,
    counters zeroed before and read after.  Returns the counts."""
    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.ops import render
    zero_counters()
    for raygen in PARITY_RAYGENS:
        pl = app.build(parity_argv(raygen, raygen, "brute", PARITY_SUB,
                                   PARITY_LAYERS, PARITY_W, PARITY_W, 2,
                                   f"chip_smoke_{raygen}_brute"))
        run_loop(pl, [])
        pl.present()
    counts = {f"parity_{g}_brute": render.launches[f"parity_{g}_brute"]
              for g in PARITY_RAYGENS}
    require_counts("main brute", counts)
    return counts


def parity_rows(loc_rows, brute_rows, errs, counts):
    """The kernels line's K8 rows, one per raygen x sampler."""
    rows = []
    for raygen in PARITY_RAYGENS:
        for sampler in PARITY_SAMPLERS:
            name = f"parity_{raygen}_{sampler}"
            r = dict((loc_rows if sampler == "locator" else brute_rows)[name])
            r.pop("work", None)
            r.pop("k5b", None)
            kernel_row(rows, counts, errs, name, "cuda",
                       "icon_rt_tpu_torch/csrc/parity.cu",
                       PARITY_REPLACES[raygen], r.pop("ms"),
                       r.pop("plain_ms"), r.pop("bnd"), **r)
    return rows


def profile_launch(pl, quantized=False, marching=False):
    """One steady main-path launch (fb copied to the host) under
    torch.profiler: device time by kernel and the device's idle share of
    the launch's wall time."""
    from icon_rt_tpu_torch.ops.fast import render_frame_fast
    from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q
    from icon_rt_tpu_torch.ops.march import (render_frame_march,
                                             render_frame_march_q)

    s, frame = pl.scene, pl.frame
    lp = launch_params(pl)
    kw = dict(width=MAIN_W, height=MAIN_H, pixel_perm=frame["perm"],
              n_active=frame["n_active"])
    out = (frame["accum"], frame["fb"])
    if quantized:
        q, loc, _ = s["get_q"]()
        tables = (q, loc, s["get_bands"](), s["tf"]())
        if marching:
            render = lambda: render_frame_march_q(*tables, lp, *out, **kw)
        else:
            render = lambda: render_frame_fast_q(
                *tables, lp, *out, finemap=s["fm"](), samples=MAIN_SPL, **kw)
    else:
        tables = (s["cells"], s["get_packed"](), s["locator"],
                  s["get_bands"]())
        if marching:
            render = lambda: render_frame_march(*tables, lp, *out, **kw)
        else:
            render = lambda: render_frame_fast(*tables, lp, *out,
                                               samples=MAIN_SPL, **kw)

    what = ("march " if marching else "") + ("quantized " if quantized
                                             else "")
    kernel = ("march_" if marching else "track_") + ("q" if quantized
                                                      else "f32")
    profile_render(render, frame["fb"], f"steady {what}launch",
                   f"{kernel}_kernel")


def profile_window(call, require, what):
    """`call()` under torch.profiler, the device synchronised around it:
    (wall ms, [(name, start ms, length ms)] of its device events in start
    order, the first at 0).  The profiler may drop a window's first device
    events, a prefix that can reach past a whole short launch, and after
    the plain versions' long loops its windows can hold no device event
    for several tries (PERF.md §7): so each window opens with a lead-in of
    spin kernels (`torch.cuda._sleep`) and host time, longer at each try,
    then runs `call` once as a primer and keeps the device events of a
    second run that start after a host-side mark.  A window that lacks a
    device event whose name holds each entry of `require` (one of its
    "|"-separated strings) is reported and profiled again; none complete
    in PROFILE_WINDOWS tries raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, PROFILE_WINDOWS + 1):
        spins = LEAD_IN_SPINS * attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            time.sleep(LEAD_IN_S * attempt)
            call()
            torch.cuda.synchronize()
            with record_function("profile_window"):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        events = list(prof.events())
        mark = min(e.time_range.start for e in events
                   if e.name == "profile_window")
        # the host mark's own range shows on the device's timeline too
        dev_ev = sorted((e.time_range.start, e.time_range.elapsed_us(),
                         e.name) for e in events
                        if e.device_type == DeviceType.CUDA
                        and e.name != "profile_window")
        ev = [e for e in dev_ev if e[0] >= mark and "spin_kernel" not in e[2]]
        lacking = [r for r in require
                   if not any(alt in name for _, _, name in ev
                              for alt in r.split("|"))]
        if ev and not lacking:
            t_first = ev[0][0]
            return wall, [(name, (s0 - t_first) / 1e3, us / 1e3)
                          for s0, us, name in ev]
        seen = {r: [round((s0 - mark) / 1e3, 3) for s0, _, name in dev_ev
                    if any(alt in name for alt in r.split("|"))]
                for r in lacking}
        kept = sum("spin_kernel" in name for _, _, name in dev_ev)
        print(f"profile {what}: window {attempt} holds no {lacking} after "
              f"the mark (seen at ms from it: {seen}; {kept} of the "
              f"{spins} lead-in spins kept; device events "
              f"{sorted({name[:50] for _, _, name in dev_ev})}); profiled "
              f"again")
    raise AssertionError(f"profile {what}: no profiled window held "
                         f"{list(require)} in {PROFILE_WINDOWS} windows")


def device_ms(call, n, require, what):
    """Device time of one `call`: the device events of a profiled window
    (`profile_window`) of n calls in a row, summed, over n."""
    _, timeline = profile_window(lambda: [call() for _ in range(n)],
                                 require, what)
    return sum(ms for _, _, ms in timeline) / n


def profile_render(render, fb, what, kernel):
    """One call of `render` and the copy of fb to the host under
    `profile_window`: device time by kernel and the device's idle share of
    the call's wall time, printed only from a window that holds a device
    event named `kernel`."""
    def launch():
        render()
        return fb.cpu()

    wall, timeline = profile_window(launch, (kernel,), what)
    by_name = {}
    for name, _, ms in timeline:
        by_name[name] = by_name.get(name, 0.0) + ms
    # busy: the union of the device spans, so an event reported twice
    # counts once
    busy, end = 0.0, -float("inf")
    for _, a, ms in sorted(timeline, key=lambda x: x[1]):
        if a + ms > end:
            busy += a + ms - max(a, end)
            end = a + ms
    top = ", ".join(f"{k[:40]} {v:.3f} ms" for k, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:4])
    print(f"profile {what}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; {top}")
    if not 0.0 < busy <= wall:
        raise AssertionError(f"device busy {busy:.3f} ms is not within the "
                             f"launch's wall time {wall:.3f} ms")
    return {"wall_ms": wall, "idle_share": 1 - busy / wall,
            "kernel_ms": sum(v for k, v in by_name.items() if kernel in k)}


def scene_consts(sub, dev, lod=0):
    """K7-scene's constants of the synthetic subdiv-`sub` x 16 scene (its
    level-`lod` mip tier when lod > 0)."""
    from icon_rt_tpu_torch.data import device_scene
    from icon_rt_tpu_torch.data.synthetic import EARTH_RADIUS
    return device_scene._Consts(sub, R2B9_LAYERS, float(EARTH_RADIUS),
                                SCENE_THICKNESS, dev, lod=lod)


def u8_diff(a, b):
    """(largest level difference, share of equal entries) of two u8
    tables, without widening them."""
    import torch
    d = torch.maximum(a, b) - torch.minimum(a, b)
    return int(d.max()), 1.0 - float(torch.count_nonzero(d)) / max(d.numel(),
                                                                   1)


def compare_scene(got, want, label, whole):
    """K7-scene pass-2 outputs against the plain version's: test12 and the
    corner lat/lon bit-equal, value_q exact on >= 99.999% of its entries and
    within 1 level; for a whole scene also the per-layer u8 ranges.  Returns
    the largest value_q level difference."""
    import torch
    t12k, vqk, qmink, qmaxk, latk, lonk = got
    t12p, vqp, qminp, qmaxp, latp, lonp = want
    geo = torch.equal(t12k, t12p) and torch.equal(latk, latp) \
        and torch.equal(lonk, lonp)
    mx, same = u8_diff(vqk, vqp)
    ranges = (not whole) or (torch.equal(qmink, qminp)
                             and torch.equal(qmaxk, qmaxp))
    print(f"{label}: {t12k.shape[0]} cells; test12 and lat/lon bit-equal "
          f"{geo}; value_q identical on {same:.7f} of {vqk.numel()} "
          f"entries, max {mx} level(s)"
          + (f"; per-layer u8 ranges equal {ranges}" if whole else ""))
    if not geo or mx > 1 or same < 0.99999 or not ranges:
        raise AssertionError(f"{label}: K7-scene differs from its plain "
                             f"version")
    return float(mx)


def period_start(c, window):
    """The start of a `window`-cell index window centred on a multiple of
    K7-scene's ancestor period c.n_anc (where cell i's ancestor i %
    n_anc wraps), at or past window / 2 so that the window starts >= 0."""
    m = -(-(window // 2) // c.n_anc) * c.n_anc
    return m - window // 2


def compare_pass1(got, want, label, stash=None):
    """K7-scene pass 1 against its plain version: the aggregates, test12,
    the corner lat/lon and the field (the w stash at lod 0, given apart
    when pass 2 has quantized over it; the pooled values otherwise)
    bit-equal."""
    import torch
    field = (stash if stash is not None else got.field_term()) \
        if want.field is None else got.field
    want_field = want.field_term() if want.field is None else want.field
    same = {"agg": torch.equal(got.agg, want.agg),
            "test12": torch.equal(got.test12, want.test12),
            "lat/lon": torch.equal(got.lat, want.lat)
            and torch.equal(got.lon, want.lon),
            "field": torch.equal(field, want_field)}
    print(f"{label} pass 1: bit-equal {same}")
    if not all(same.values()):
        raise AssertionError(f"{label}: K7-scene pass 1 differs from its "
                             f"plain version: {got.agg.tolist()} vs "
                             f"{want.agg.tolist()}")


def scene_times(c, lo, scale):
    """(pass 1 ms, pass 2 ms) of K7-scene over the scene of `c` (the
    corners' lat/lon kept): CUDA events around pass 1 alone and around
    both passes (pass 2 quantizes over pass 1's stash, so it is timed as
    the difference)."""
    from icon_rt_tpu_torch.data import device_scene as ds
    k1 = time_cuda(lambda: ds.scene_pass1(c, latlon=True), reps=3)
    k12 = time_cuda(lambda: ds.scene_pass2(c, ds.scene_pass1(
        c, latlon=True), lo, scale), reps=3)
    return k1, k12 - k1


def scene_bound(c):
    """(ms, by) of K7-scene's function over the scene of `c` as the main
    path asks for it: test12, value_q and the corner lat/lon written once;
    the subdivision walk as a tree (cells share their prefixes, so the
    least walk is one step per cell of each depth, 20 * (4 + 16 + ... +
    4**s) steps), then orientation and corner lat/lon per cell.  A cell of
    a mip tier (c.lod > 0) takes no field of its own; its 4**lod
    descendants share the cell's walk and then each other's, a tree of 4 +
    16 + ... + 4**lod steps per cell, and each descendant adds its corner
    lat/lon, its centroid field and the per-layer clip and sum, but no
    orientation or quantization."""
    n, nl, s, lod = c.n, c.num_layers, c.subdivisions, c.lod
    nbytes = n * (48 + c.lm + 24)
    op = SCENE_OPS
    walk = sum(20 * 4 ** k for k in range(1, s + 1))
    ops = op["step"] * walk + n * (op["orient"] + op["latlon"]
                                   + nl * op["layer"] + op["normals"])
    if lod:
        tree = sum(4 ** k for k in range(1, lod + 1))
        ops += n * (op["step"] * tree
                    + 4 ** lod * (op["latlon"] + op["field"]
                                  + nl * op["pool"]))
    else:
        ops += n * op["field"]
    return bound(nbytes, ops)


def locator_bound(n, n_bins, k_cap):
    """(ms, by) of K7-loc's function: reads the corner lat/lon and writes
    the counts and the dense table once (the kernel's (N, 8) rectangles are
    its own intermediate); the f64 rectangles' operations."""
    nbytes = 24 * n + 4 * n_bins + 4 * n_bins * k_cap
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = LOCATOR_OPS * n / F64_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def short_name(name):
    """A device event's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.split("(anonymous namespace)::")[-1]
    name = name.split("<")[0].split("(")[0]
    return name.replace("void ", "").split("::")[-1].strip()


#: K7-loc's kernels, each of which a profiled window of bin_locator must
#: hold (csrc/locator.cu)
LOCATOR_KERNELS = ("locator_window_kernel", "locator_rects_kernel",
                   "locator_big_kernel", "locator_lists_kernel",
                   "locator_counts_kernel", "locator_rows_kernel")


def locator_split(call, tag):
    """One `call` (bin_locator) under `profile_window`: its wall time, each
    device event in the order it ran (start and length, ms) and the device
    ms by event name, printed; returns {"wall_ms", "device_ms", "by_name":
    {short event name: ms}}."""
    wall, timeline = profile_window(call, LOCATOR_KERNELS, tag)
    dev_ms = sum(ms for _, _, ms in timeline)
    print(f"{tag} split: wall {wall:.3f} ms, device events {dev_ms:.3f} ms "
          f"(the rest is host work and the host reads' waits); events "
          + "; ".join(f"{short_name(n)} at {s0:.3f} for {ms:.4f}"
                      for n, s0, ms in timeline))
    split = {}
    for n, _, ms in timeline:
        split[short_name(n)] = split.get(short_name(n), 0.0) + ms
    print(f"{tag} split by name: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sorted(split.items(),
                                            key=lambda kv: -kv[1])))
    return dict(wall_ms=wall, device_ms=dev_ms, by_name=split)


def plain_locator_args(lat, lon, label):
    """The plain version's (n_lat, n_lon, window) of bin_locator(lat, lon):
    sqrt(N/2) bins per axis and `_locator_window_torch`'s window.  K7-loc's
    window kernel must return that window exactly, or this raises."""
    from icon_rt_tpu_torch.models import locator
    side = max(1, int(np.sqrt(max(lat.shape[0], 1) / 2)))
    window = locator._locator_window_torch(lat, lon)
    got = locator.locator_window(lat, lon)
    print(f"{label}: window kernel {got}, plain {window}; exact "
          f"{got == window}")
    if got != window:
        raise AssertionError(f"{label}: K7-loc's window kernel differs from "
                             f"its plain version")
    return side, side, window


def compare_locator(got, want, args, label):
    """K7-loc's (loc, k_cap, counts, rect) against the plain version's
    (bins, k_cap, counts, rect), and the Locator's dims and window against
    `args`, the plain (n_lat, n_lon, window) the plain side binned over:
    everything exact.  On a mismatch the first differing cells' rectangles
    are printed."""
    import torch
    loc, k, counts, rect = got
    bins_p, k_p, counts_p, rect_p = want
    n_lat, n_lon, window = args
    same_rect = torch.equal(rect, rect_p)
    same_grid = (loc.dims.tolist() == [n_lat, n_lon]
                 and [float(v) for v in (loc.lat_lo, loc.lat_hi, loc.lon_lo,
                                         loc.lon_hi)]
                 == [float(np.float32(v)) for v in window])
    ok = (k == k_p and same_rect and same_grid
          and torch.equal(counts, counts_p) and torch.equal(loc.bins, bins_p))
    print(f"{label}: {rect.shape[0]} cells, {tuple(loc.bins.shape)} bins, "
          f"k_cap {k} (plain {k_p}); dims and window exact {same_grid}; "
          f"rectangles, counts and bins exact {ok}")
    if not same_rect:
        bad = torch.nonzero((rect != rect_p).any(1)).squeeze(1)[:5]
        for c in bad.tolist():
            print(f"{label}: cell {c} rect kernel {rect[c].tolist()} plain "
                  f"{rect_p[c].tolist()}")
    if not ok:
        raise AssertionError(f"{label}: K7-loc differs from its plain "
                             f"version")
    return 0.0


def locator_invariants(loc, k_cap, counts, rect, n, label):
    """The dense locator's invariants: counts sum to the rectangles' area
    (int64), k_cap == max(counts), each row holds counts[b] ids in
    ascending order with -1 only past them, and every cell id appears."""
    import torch
    r = rect.to(torch.int64)
    area = ((r[:, 1] - r[:, 0] + 1) * (r[:, 3] - r[:, 2] + 1)).sum() + (
        (r[:, 5] - r[:, 4] + 1) * (r[:, 7] - r[:, 6] + 1)
        * (r[:, 4] >= 0)).sum()
    total = int(counts.to(torch.int64).sum())
    bins = loc.bins
    valid = bins >= 0
    filled = valid.sum(1, dtype=torch.int32)
    prefix = bool((valid[:, :-1] | ~valid[:, 1:]).all())
    ascending = bool(((bins[:, 1:] >= bins[:, :-1]) | ~valid[:, 1:]).all())
    seen = torch.zeros(n, dtype=torch.bool, device=bins.device)
    seen[bins[valid].long()] = True
    checks = {"area": total == int(area), "k_cap": k_cap == int(counts.max()),
              "rows": bool(torch.equal(filled, counts)) and prefix,
              "ascending": ascending, "every_cell": bool(seen.all())}
    print(f"{label}: {total} entries (rectangle area {int(area)}), k_cap "
          f"{k_cap}, invariants {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"{label}: the locator breaks an invariant")


def scene9(dev, errs):
    """K7-scene and K7-loc against their plain versions (subdiv 8 whole,
    R2B9 windows and whole), the R2B9 invariants, and K7-fm at R2B9.
    Returns the timing entries of the kernels line."""
    import torch
    from icon_rt_tpu_torch.data import bigscene
    from icon_rt_tpu_torch.data import device_scene as ds
    from icon_rt_tpu_torch.models import finemap, locator
    t = {}

    # -- subdiv 8: the whole scene against the plain version ----------------
    c8 = scene_consts(MAIN_SUB, dev)
    label8 = f"scene9 K7-scene subdiv {MAIN_SUB} whole"
    p1k = ds.scene_pass1(c8, latlon=True)
    p1p = ds._scene_pass1_torch(c8, 0, c8.n, True)
    compare_pass1(p1k, p1p, label8)
    lo, hi = (float(v) for v in p1k.agg[:2])
    scale = float(ds.quant_scale(lo, hi))
    out8 = ds.scene_pass2(c8, p1k, lo, scale)
    errs["synth_scene"] = compare_scene(
        out8, ds._scene_pass2_torch(c8, p1p, lo, scale), label8, True)
    del p1k, p1p
    lat8, lon8 = out8[4], out8[5]
    got8 = locator.bin_locator(lat8, lon8)
    label8 = f"scene9 K7-loc subdiv {MAIN_SUB} whole"
    args8 = plain_locator_args(lat8, lon8, label8)
    n_lat, n_lon, win8 = args8
    errs["locator_bins"] = compare_locator(
        got8, locator._locator_bins_torch(lat8, lon8, *args8), args8, label8)
    t["locator_ms_sub8"] = time_cuda(lambda: locator.bin_locator(lat8, lon8),
                                     reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    locator._locator_bins_torch(lat8, lon8, n_lat, n_lon, win8)
    torch.cuda.synchronize()
    t["locator_plain_ms_sub8"] = (time.perf_counter() - t0) * 1e3
    # the reference's bench bins R2B9 from the HOST scene's lat/lon while
    # its tables come from the device scene; count what that changes
    sc = bigscene.synth_quantized(MAIN_SUB, MAIN_LAYERS)
    lat_h = torch.from_numpy(sc.lat).to(dev)
    lon_h = torch.from_numpy(sc.lon).to(dev)
    loc_h, k_h = locator.bin_locator(lat_h, lon_h)[:2]
    ll_diff = int(((lat_h != lat8) | (lon_h != lon8)).any(1).sum())
    if loc_h.bins.shape == got8[0].bins.shape:
        rows = int((loc_h.bins != got8[0].bins).any(1).sum())
    else:
        rows = -1
    print(f"scene9 host vs device lat/lon at subdiv {MAIN_SUB}: {ll_diff} "
          f"of {c8.n} cells differ in a corner lat/lon; k_cap {k_h} vs "
          f"{got8[1]}; {rows} of {n_lat * n_lon} locator rows differ "
          f"(-1: the tables' widths differ)")
    del out8, lat8, lon8, got8, sc, lat_h, lon_h, loc_h
    peak_memory("scene9 subdiv 8")

    # -- R2B9 --------------------------------------------------------------
    c = scene_consts(R2B9_SUB, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1 = ds.scene_pass1(c, latlon=True)
    agg = p1.agg
    lo, hi = (float(v) for v in agg[:2])
    scale = float(ds.quant_scale(lo, hi))
    stash = p1.field_term().clone()
    out = ds.scene_pass2(c, p1, lo, scale)
    del p1
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tables = (out[0].numel() * 4 + out[1].numel()) / 1e9
    print(f"scene9 K7-scene subdiv {R2B9_SUB} x {R2B9_LAYERS}: {c.n} cells "
          f"in {build_s:.3f} s (both passes, one host read); tables test12 + "
          f"value_q {tables:.3f} GB, corner lat/lon "
          f"{2 * out[4].numel() * 4 / 1e9:.3f} GB; value range [{lo:.7f}, "
          f"{hi:.7f}]; per-layer u8 min {out[2].tolist()} max "
          f"{out[3].tolist()}")
    k1, k2 = scene_times(c, lo, scale)
    for name, s0 in (("first", 0),
                     ("ancestor period", period_start(c, WINDOW_CELLS)),
                     ("last", c.n - WINDOW_CELLS)):
        w = ds._scene_window_torch(c, s0, WINDOW_CELLS, lo, scale, True)
        rows = slice(s0, s0 + WINDOW_CELLS)
        compare_scene(tuple(x[rows] for x in out[:2]) + w[2:4]
                      + tuple(x[rows] for x in out[4:]), w,
                      f"scene9 K7-scene R2B9 {name} window [{s0}, "
                      f"{s0 + WINDOW_CELLS})", False)
        del w
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1p = ds._scene_pass1_torch(c, 0, c.n, True)
    torch.cuda.synchronize()
    p1 = (time.perf_counter() - t0) * 1e3
    label = "scene9 K7-scene R2B9 whole"
    compare_pass1(ds.Pass1(agg, out[0], None, None, out[4], out[5]), p1p,
                  label, stash)
    del stash
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = ds._scene_pass2_torch(c, p1p, lo, scale)
    torch.cuda.synchronize()
    p2 = (time.perf_counter() - t0) * 1e3
    del p1p
    errs["synth_scene"] = max(errs["synth_scene"], compare_scene(
        out, whole, label, True))
    del whole
    t["scene"] = dict(ms=k1 + k2, plain_ms=p1 + p2, pass1_ms=k1,
                      pass2_ms=k2, plain_pass1_ms=p1, plain_pass2_ms=p2,
                      build_s=build_s, bnd=scene_bound(c), cells=c.n)
    print(f"scene9 K7-scene R2B9 kernel pass 1 {k1:.3f} ms + pass 2 "
          f"{k2:.3f} ms; plain {p1:.1f} + {p2:.1f} ms")
    peak_memory("scene9 K7-scene R2B9")

    test12, lat, lon = out[0], out[4], out[5]
    del out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = locator.bin_locator(lat, lon)
    torch.cuda.synchronize()
    loc_s = time.perf_counter() - t0
    loc, k_cap, counts, rect = got
    n_lat, n_lon = (int(d) for d in loc.dims.tolist())
    print(f"scene9 K7-loc R2B9: {loc_s:.3f} s (the window and three "
          f"steps, three host reads); dims {n_lat} x {n_lon}, k_cap {k_cap}, table "
          f"{loc.bins.numel() * 4 / 1e9:.3f} GB")
    locator_invariants(loc, k_cap, counts, rect, c.n, "scene9 K7-loc R2B9")
    kl = time_cuda(lambda: locator.bin_locator(lat, lon), reps=2)
    split = locator_split(lambda: locator.bin_locator(lat, lon),
                          "scene9 K7-loc R2B9")
    label = "scene9 K7-loc R2B9 whole"
    args = plain_locator_args(lat, lon, label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = locator._locator_bins_torch(lat, lon, *args)
    torch.cuda.synchronize()
    pl = (time.perf_counter() - t0) * 1e3
    compare_locator(got, want, args, label)
    del want, got, rect, counts
    t["locator"] = dict(ms=kl, plain_ms=pl, build_s=loc_s, split=split,
                        bnd=locator_bound(c.n, n_lat * n_lon, k_cap),
                        dims=[n_lat, n_lon], k_cap=k_cap,
                        ms_subdiv8=t["locator_ms_sub8"],
                        plain_ms_subdiv8=t["locator_plain_ms_sub8"])
    print(f"scene9 K7-loc R2B9 kernel {kl:.3f} ms, plain {pl:.1f} ms")
    peak_memory("scene9 K7-loc R2B9")

    del lat, lon
    t["finemap"] = finemap_r2b9(loc, test12, errs)
    del loc, test12
    torch.cuda.empty_cache()
    peak_memory("scene9 K7-fm R2B9")
    return t


def finemap_check_bins(f_lat, f_lon, dev):
    """The fine bins of K7-fm's check at R2B9: FM_RANDOM_BINS random bins,
    every bin of the first and last fine rows and of the longitude seam's
    two columns, and the edge bins of FM_EDGE_TILES random tiles of the
    kernel (finemap.TILE, which the launcher keeps at k_cap 18)."""
    import torch
    from icon_rt_tpu_torch.models import finemap
    rng = np.random.default_rng(12)
    t_lat, t_lon = finemap.TILE
    rows = np.arange(f_lat, dtype=np.int64)[:, None] * f_lon
    cols = np.arange(f_lon, dtype=np.int64)
    tl = rng.integers(0, -(-f_lat // t_lat), FM_EDGE_TILES)
    to = rng.integers(0, -(-f_lon // t_lon), FM_EDGE_TILES)
    a, b = np.meshgrid(np.arange(t_lat), np.arange(t_lon), indexing="ij")
    edge = (a == 0) | (a == t_lat - 1) | (b == 0) | (b == t_lon - 1)
    fl = tl[:, None] * t_lat + a[edge][None, :]
    fo = to[:, None] * t_lon + b[edge][None, :]
    inside = (fl < f_lat) & (fo < f_lon)
    ids = np.concatenate([
        rng.integers(0, f_lat * f_lon, FM_RANDOM_BINS), cols,
        (f_lat - 1) * f_lon + cols, rows[:, 0], rows[:, 0] + f_lon - 1,
        (fl * f_lon + fo)[inside]])
    return torch.from_numpy(np.unique(ids)).to(dev)


def finemap_r2b9(loc, test12, errs):
    """K7-fm on the R2B9 locator: the first call's seconds (the slots'
    allocation included) and its peak above what the scene holds, the warm
    time, one profiled call, and the slots exact against
    `_finemap_bins_torch` on finemap_check_bins.  Returns the timing
    entry of the kernels line."""
    import torch
    from icon_rt_tpu_torch.models import finemap
    tag = "scene9 K7-fm R2B9"
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    slots = finemap.finemap_slots(loc, test12)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    above = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    F = slots.shape[0]
    f_lat, f_lon = (2 * int(d) for d in loc.dims.tolist())
    ms = time_cuda(lambda: finemap.finemap_slots(loc, test12), reps=3)
    wall, timeline = profile_window(
        lambda: finemap.finemap_slots(loc, test12), ("finemap",), tag)
    split = {}
    for n, _, e_ms in timeline:
        split[short_name(n)] = split.get(short_name(n), 0.0) + e_ms
    fb = finemap_check_bins(f_lat, f_lon, loc.bins.device)
    t0 = time.perf_counter()
    want = finemap._finemap_bins_torch(loc, test12, 2, fb)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    exact = torch.equal(slots[fb], want)
    k_cap = loc.bins.shape[1]
    bnd = bound(loc.bins.numel() * 4 + test12.numel() * 4 + F * 4,
                4 * F * 20)
    print(f"{tag}: {f_lat} x {f_lon} fine bins ({slots.numel() / 1e9:.3f} "
          f"GB), k_cap {k_cap}; first call {first_s:.4f} s, its peak "
          f"{above:.3f} GiB above the {held / 2 ** 30:.3f} GiB held; warm "
          f"{ms:.3f} ms (CUDA events), bound {bnd[0]:.3f} ms ({bnd[1]}); "
          f"profiled call wall {wall:.3f} ms, device "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
          + f"; slots exact on {fb.numel()} sampled bins {exact} (plain "
          f"{plain_s:.2f} s)")
    if not exact:
        bad = fb[(slots[fb] != want).any(1)][:5].tolist()
        raise AssertionError(f"{tag}: K7-fm differs from its plain version "
                             f"on fine bins {bad}")
    errs["build_finemap_r2b9"] = 0.0
    return dict(ms=ms, plain_ms=plain_s * 1e3, plain_fine_bins=fb.numel(),
                first_s=first_s, peak_gib_above_scene=above, split=split,
                profiled_wall_ms=wall, fine_bins=F, bnd=bnd, k_cap=k_cap)


def scene9lod(dev, errs):
    """K7-scene's mip tier as r2b9q_viewall builds it (subdiv 8 x 16, each
    cell pooled over its 64 subdivision-11 descendants) against its plain
    version: pass 1 on the whole tier (aggregates, test12, lat/lon and the
    pooled field bit-equal), pass 2 on the whole tier, and both passes on a
    head, an ancestor-period and a tail window of LOD_WINDOW coarse cells
    (test12 and lat/lon bit-equal, value_q within 1 level on >= 99.999%,
    per-layer u8 ranges equal).  Returns the timing entry of the kernels
    line."""
    import torch
    from icon_rt_tpu_torch.data import device_scene as ds
    tag = "scene9lod"
    c = scene_consts(R2B9_SUB - R2B9V_LOD, dev, lod=R2B9V_LOD)
    p1k = ds.scene_pass1(c, latlon=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1p = ds._scene_pass1_torch(c, 0, c.n, True)
    torch.cuda.synchronize()
    p1 = (time.perf_counter() - t0) * 1e3
    agg = p1k.agg
    print(f"{tag} K7-scene lod {c.lod} subdiv {c.subdivisions} x "
          f"{c.num_layers}: {c.n} cells of {4 ** c.lod} descendants each; "
          f"pass 1 {agg.tolist()}")
    compare_pass1(p1k, p1p, f"{tag} whole")
    lo, hi = (float(v) for v in agg[:2])
    scale = float(ds.quant_scale(lo, hi))
    for name, s0 in (("head", 0),
                     ("ancestor period", period_start(c, LOD_WINDOW)),
                     ("tail", c.n - LOD_WINDOW)):
        errs["synth_scene_lod"] = max(errs.get("synth_scene_lod", 0.0),
                                      compare_scene(
            ds.scene_window(c, s0, LOD_WINDOW, lo, scale, latlon=True),
            ds._scene_window_torch(c, s0, LOD_WINDOW, lo, scale, True),
            f"{tag} {name} window [{s0}, {s0 + LOD_WINDOW})", True))
    out = ds.scene_pass2(c, p1k, lo, scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = ds._scene_pass2_torch(c, p1p, lo, scale)
    torch.cuda.synchronize()
    p2 = (time.perf_counter() - t0) * 1e3
    errs["synth_scene_lod"] = max(errs["synth_scene_lod"], compare_scene(
        out, whole, f"{tag} whole", True))
    del out, whole, p1k, p1p
    k1, k2 = scene_times(c, lo, scale)
    bnd = scene_bound(c)
    print(f"{tag} kernel pass 1 {k1:.3f} ms + pass 2 {k2:.3f} ms; plain "
          f"{p1:.1f} + {p2:.1f} ms; bound {bnd[0]:.3f} ms ({bnd[1]})")
    peak_memory(tag)
    return dict(ms=k1 + k2, plain_ms=p1 + p2, pass1_ms=k1, pass2_ms=k2,
                plain_pass1_ms=p1, plain_pass2_ms=p2, bnd=bnd, cells=c.n,
                lod=c.lod)


def r2b9_scene(dev, tag, lod=0):
    """build_q_scene(11, 16, field_lod=lod) on the card, timed by phase
    (the peak memory counted from its start); returns its tuple."""
    import torch
    from icon_rt_tpu_torch.data import bigscene
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    out = bigscene.build_q_scene(R2B9_SUB, R2B9_LAYERS, device=dev,
                                 finemap_factor=2, field_lod=lod,
                                 timings=timings)
    build_s = time.perf_counter() - t0
    q, loc, k_cap, _, _, _, fm, _, eff = out
    gb = (q.test12.numel() * 4 + q.value_q.numel() + q.alpha_q.numel()
          + loc.bins.numel() * 4 + fm.slots.numel()) / 1e9
    phases = ", ".join(f"{k} {v:.3f} s (peak "
                       f"{timings.get(k + '_peak_bytes', 0) / 2 ** 30:.2f} GiB)"
                       for k, v in timings.items() if not k.endswith("bytes"))
    print(f"{tag} build_q_scene({R2B9_SUB}, {R2B9_LAYERS}, field_lod={lod}) "
          f"{build_s:.3f} s: {phases}; {q.num_cells} cells (subdiv {eff}), "
          f"locator "
          f"{tuple(loc.dims.tolist())} k_cap {k_cap}, fine map "
          f"{tuple(fm.dims.tolist())}; tables {gb:.3f} GB; {held:.2f} GiB "
          f"held before the build (inside every peak)")
    return out


def r2b9_frame(stats, width, height, dev, framing="closeup"):
    """(launch params, pixel order, covered lanes) of a bench framing's
    camera (bench.py `_camera`)."""
    from icon_rt_tpu_torch.data.lod import frame_camera
    from icon_rt_tpu_torch.ops.order import pixel_order
    from icon_rt_tpu_torch.ops.render import make_launch_params
    cam = frame_camera(stats, framing, width, height)
    ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(width, height), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=ud,
                            device=dev)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], width, height)
    return lp, perm, n_active


def with_id(lp, k):
    import torch
    return lp._replace(accum_id=torch.tensor(k, dtype=torch.int32,
                                             device=lp.accum_id.device))


def gain_edit(tf, gain, scale):
    """bench.py's worst-case TF edit: every LUT entry scaled by gain and a
    new opacity scale."""
    import torch
    return tf._replace(values=tf.values * gain,
                       opacity_scale=torch.full_like(tf.opacity_scale, scale))


def stroke_edit(tf, gain):
    """bench.py's freehand stroke: alpha of n/16 LUT entries from 2/5 of
    the LUT scaled by gain (a few of the 256 normalized levels move)."""
    vals = tf.values.clone()
    n = vals.shape[0]
    vals[(n * 2) // 5:(n * 2) // 5 + max(n // 16, 1), 3] *= gain
    return tf._replace(values=vals)


def require_counts(tag, counts):
    print(f"{tag} launch counts {json.dumps(counts)}")
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"{tag} path did not launch {k}")


def scene_counts(lod=0):
    """{kernel name: launches} of the R2B9 build's own kernels (K7-scene's
    lod-0 passes, or its mip tier's)."""
    from icon_rt_tpu_torch.data import device_scene
    from icon_rt_tpu_torch.models import accel, finemap, locator, qcells
    dl = device_scene.launches
    pre = "scene_lod_" if lod else "scene_"
    scene = {"synth_scene_lod" if lod else "synth_scene": sum(
        dl[pre + k] for k in ("ancestors", "pass1", "pass2"))}
    return {**scene,
            "locator_bins": sum(locator.launches.values()),
            "build_finemap": finemap.launches,
            "bake_alpha_q": sum(qcells.launches.values()),
            "max_opacity": accel.launches}


def bakes_r2b9(q, tag, errs, launches):
    """K5c-q's lookup over the R2B9 scene's (N, Lm) u8 value table, after
    main r2b9q's counts are read; returns its kernels-line row.  Checks,
    each byte-equal: into a new table and into a given one (out=) against
    each other and against the live alpha_q over the whole table, and
    against the plain version on CHECK_LANES strided rows.  Times (CUDA
    events): the lookup, out= (into a scratch table), the plain version
    and the library call tab[value_q.int()]; bound: 2n bytes at 3.35
    TB/s."""
    import torch
    from icon_rt_tpu_torch.models import qcells
    vq = q.value_q
    n, N = vq.numel(), vq.shape[0]
    tab = torch.from_numpy(q.alpha_tab).to(vq.device)
    rows = torch.arange(0, N, max(1, N // CHECK_LANES), device=vq.device)
    got = qcells.bake_lookup(vq, tab)
    scratch = torch.zeros_like(vq)
    into = qcells.bake_lookup(vq, tab, out=scratch)
    plain = qcells._bake_lookup_torch(vq[rows], tab)
    same = {"out= = new table": into is scratch and torch.equal(into, got),
            "new table = alpha_q": torch.equal(got, q.alpha_q),
            "= plain (strided rows)": torch.equal(got[rows], plain)}
    print(f"{tag} K5c-q check at {tuple(vq.shape)}: {same}")
    if not all(same.values()):
        raise AssertionError(f"{tag}: K5c-q's lookup differs")
    errs["bake_alpha_q_r2b9"] = float((got[rows].int() - plain.int())
                                      .abs().max())
    del got, into, plain
    ms_l = time_cuda(lambda: qcells.bake_lookup(vq, tab), reps=10)
    ms_o = time_cuda(lambda: qcells.bake_lookup(vq, tab, out=scratch),
                     reps=10)
    ms_p = time_cuda(lambda: qcells._bake_lookup_torch(vq, tab), reps=2)
    ms_lib = time_cuda(lambda: tab[vq.int()], reps=3)
    del scratch
    b_l = bound(2 * n, 0)
    print(f"{tag} K5c-q at {tuple(vq.shape)} u8: bake_lookup {ms_l:.4f} ms, "
          f"out= {ms_o:.4f} ms (bound {b_l[0]:.4f} ms, {b_l[1]}), plain "
          f"{ms_p:.4f} ms, tab[value_q.int()] {ms_lib:.4f} ms; CUDA events")
    row = []
    kernel_row(row, {"bake_alpha_q_r2b9": launches}, errs,
               "bake_alpha_q_r2b9", "cuda", "icon_rt_tpu_torch/csrc/bake_q.cu",
               "icon_rt_tpu/models/qcells.py:266", ms_l, ms_p, b_l,
               library_ms=ms_lib, lookup_out_ms=ms_o)
    return row[0]


def main_r2b9q(dev, errs, framing="closeup", rows=None):
    """bench.py `_measure_row_q` (bench.py:581-743) through the port, for
    the row r2b9q_closeup (framing "closeup", LOD 0) or r2b9q_viewall
    ("viewall", the reference's default framing, whose auto-LOD level
    frame_lod must be R2B9V_LOD): the build, the steady launches, fps1 and
    the three edit latencies; K2 and its cost output against the plain
    version on the first CHECK_LANES covered lanes.  With `rows` the K2
    R2B9 row is appended to it: the kernel over the covered lanes (CUDA
    events, and profiled), its tracker_extras, and the bound counted by
    the plain version on CHECK_LANES strided lanes.  Returns the launch
    counts of the path."""
    import torch
    from icon_rt_tpu_torch.data.lod import frame_lod
    from icon_rt_tpu_torch.models import qcells
    from icon_rt_tpu_torch.models.qcells import bake_alpha_q
    from icon_rt_tpu_torch.models.shells import update_band_majorants
    from icon_rt_tpu_torch.ops import fastq, order
    from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q
    from icon_rt_tpu_torch.ops.order import inverse_order
    from icon_rt_tpu_torch.ops.render import alloc_frame, fb_to_image
    from icon_rt_tpu_torch.utils.png import write_png
    row = "r2b9q" + ("v" if framing == "viewall" else "")
    tag = f"main {row}"
    W, H = MAIN_W, MAIN_H
    lod = frame_lod(R2B9_SUB, framing, W, H)
    print(f"{tag} frame_lod({R2B9_SUB}, {framing!r}, {W}, {H}) = level {lod}")
    if lod != (R2B9V_LOD if framing == "viewall" else 0):
        raise AssertionError(f"{tag}: auto-LOD picked level {lod}")
    zero_counters()
    q, loc, _, bands, tf, stats, fm, _, _ = r2b9_scene(dev, tag, lod)
    lp, perm, n_active = r2b9_frame(stats, W, H, dev, framing)
    kw = dict(width=W, height=H, pixel_perm=perm, n_active=n_active,
              finemap=fm)
    accum, fb = alloc_frame(W, H, device=dev)
    launch_ms = []
    for k in range(R2B9_LIMIT // R2B9_SPL):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        render_frame_fast_q(q, loc, bands, tf, with_id(lp, k * R2B9_SPL),
                            accum, fb, samples=R2B9_SPL, **kw)
        fb_host = fb.cpu().numpy().view(np.uint32)
        e1.record()
        torch.cuda.synchronize()
        launch_ms.append(e0.elapsed_time(e1))
    main_launches = fastq.launches
    covered = float(((fb_host >> 24) > 0).mean())
    if not bool(torch.isfinite(accum).all()) \
            or covered < MIN_COVERED[framing]:
        raise AssertionError(f"{tag}: image covers {covered:.4f} (< "
                             f"{MIN_COVERED[framing]}) or accum is not "
                             f"finite")
    inv = inverse_order(perm).cpu().numpy()
    os.makedirs(OUT_DIR, exist_ok=True)
    write_png(os.path.join(OUT_DIR, f"chip_smoke_{row}.png"),
              fb_to_image(fb_host[inv].view(np.int32), W, H))
    steady = np.array(launch_ms[1:])
    med = float(np.median(steady))
    spread = float((steady.max() - steady.min()) / med)
    mray = W * H * R2B9_SPL / (med * 1e-3) / 1e6
    mray_t = n_active * R2B9_SPL / (med * 1e-3) / 1e6
    print(f"{tag} {len(launch_ms)} launches of {R2B9_SPL} samples to "
          f"{R2B9_LIMIT}; ms per launch {[round(x, 3) for x in launch_ms]} "
          f"(the first is the warm-up)")
    print(f"{tag} steady launch median {med:.3f} ms, spread {spread:.3f}; "
          f"{mray:.3f} Mray/s full, {mray_t:.3f} Mray/s traced ({n_active} "
          f"covered lanes); image covered fraction {covered:.4f}")

    prof = profile_render(lambda: render_frame_fast_q(
        q, loc, bands, tf, with_id(lp, R2B9_LIMIT), accum, fb,
        samples=R2B9_SPL, **kw), fb, f"{tag} steady launch",
        "track_q_kernel")
    t1s = []
    for j in range(4):          # the first warms the samples=1 launch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame_fast_q(q, loc, bands, tf, with_id(lp, R2B9_LIMIT + j),
                            accum, fb, samples=1, **kw)
        np.asarray(fb.cpu())
        t1s.append(time.perf_counter() - t0)
    fps1 = 1.0 / float(np.median(t1s[1:]))
    print(f"{tag} fps1 {fps1:.3f} (median of 3 samples=1 launches, "
          f"{[round(x * 1e3, 3) for x in t1s[1:]]} ms)")

    def tf_edit(tf2, lp_, perm_, n_act_, w, h, base=q, donate=False):
        """(seconds from the edit to the next samples=1 frame's fb on the
        host, K5c-q launches and levels changed, the edited table, the
        edit's peak device memory above what was held, GiB)."""
        before = dict(qcells.launches)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        q2 = bake_alpha_q(base, tf2, donate=donate)
        bands2 = update_band_majorants(bands, tf2.values, tf2.value_range)
        a2, f2 = alloc_frame(w, h, device=dev)
        render_frame_fast_q(q2, loc, bands2, tf2, lp_, a2, f2, width=w,
                            height=h, pixel_perm=perm_, n_active=n_act_,
                            samples=1, finemap=fm)
        np.asarray(f2.cpu())
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        levels = int((q2.alpha_tab != base.alpha_tab).sum())
        return dt, dict({k: qcells.launches[k] - before[k] for k in before},
                        levels=levels), q2, peak

    peak_memory(f"{tag} before the TF edits")
    full = (lp, perm, n_active, W, H)
    tf_edit(gain_edit(tf, 0.95, 0.9), *full)
    edit_s, ran_e, _, _ = tf_edit(gain_edit(tf, 0.9, 0.8), *full)
    tf_edit(stroke_edit(tf, 0.7), *full)
    stroke_s, ran_s, _, peak_s = tf_edit(stroke_edit(tf, 0.5), *full)
    lp_p, perm_p, n_p = r2b9_frame(stats, PREVIEW_W, PREVIEW_H, dev,
                                   framing)
    prev = (lp_p, perm_p, n_p, PREVIEW_W, PREVIEW_H)
    tf_edit(gain_edit(tf, 0.97, 0.95), *prev)
    preview_s, ran_p, _, _ = tf_edit(gain_edit(tf, 0.93, 0.85), *prev)
    print(f"{tag} tf_edit_s {edit_s:.4f} (gain 0.9, opacity 0.8; K5c-q "
          f"launches and alpha levels changed {ran_e}), tf_stroke_s "
          f"{stroke_s:.4f} ({ran_s}; peak {peak_s:.3f} GiB above the held), "
          f"tf_preview_s {preview_s:.4f} ({PREVIEW_W}x{PREVIEW_H}; {ran_p}): "
          f"each from one base, the edit to the next samples=1 frame's fb "
          f"on the host")
    # from one base the table is not donated: the lookup into a new table
    if not (0 < ran_s["levels"] and ran_s["bake_lookup"] == 1):
        raise AssertionError(f"{tag}: the stroke edit from one base is not "
                             f"one lookup")
    # the app's path: a chain of stroke edits, each donating the table
    # before it (a copy of q's, so q stays as it was) to the lookup
    qd = q._replace(alpha_q=q.alpha_q.clone())
    ptr = qd.alpha_q.data_ptr()
    chain = []
    for g in (0.7, 0.5, 0.7, 0.5):
        dt, ran, qd, peak = tf_edit(stroke_edit(tf, g), *full, base=qd,
                                    donate=True)
        chain.append((dt, ran, peak))
    # the main path ends here: its counts leave out the checks' launches
    counts = dict(scene_counts(lod), chord_keys=order.launches,
                  track_q=fastq.launches)
    require_counts(tag, counts)
    print(f"{tag} donated chain of stroke edits: tf_stroke_s "
          f"{[round(c[0], 4) for c in chain]}, K5c-q launches and levels "
          f"{[c[1] for c in chain]}, peak "
          f"{[round(c[2], 3) for c in chain]} GiB above the held")
    for _, ran, _ in chain:
        if ran["bake_lookup"] != 1 or ran["levels"] == 0:
            raise AssertionError(f"{tag}: a donated stroke edit of "
                                 f"{ran['levels']} levels did not run the "
                                 f"lookup once")
    if qd.alpha_q.data_ptr() != ptr:
        raise AssertionError(f"{tag}: the donated chain moved alpha_q")
    if not torch.equal(qd.alpha_q, qcells.bake_lookup(
            q.value_q, torch.from_numpy(qd.alpha_tab).to(dev))):
        raise AssertionError(f"{tag}: the donated chain's table differs from "
                             f"the lookup of its normalized table")
    del qd
    if framing == "closeup" and rows is not None:
        rows.append(bakes_r2b9(q, tag, errs, counts["bake_alpha_q"]))

    pix = perm[:CHECK_LANES].contiguous()
    for f in (fm, None):
        err, _, _ = compare_track_q((q, loc, bands, tf), lp, pix,
                                    CHECK_LANES, W, H, 4, True, f, tag)
        errs["track_q"] = max(errs["track_q"], err)
    pix = strided_lanes(perm, n_active)
    err, pm, tier = compare_track_q((q, loc, bands, tf), lp, pix,
                                    pix.shape[0], W, H, R2B9_SPL, True, fm,
                                    f"{tag} strided", cost=True)
    errs["track_q"] = max(errs["track_q"], err)
    if rows is not None:
        # K2's R2B9 row: the main path's launch over the covered lanes
        lanes = perm[:n_active].contiguous()
        a9, f9 = alloc_frame(W, H, device=dev)
        launch = lambda c: fastq.track_q(
            q, loc, bands, tf, lp, lanes, a9[:n_active], f9[:n_active],
            width=W, height=H, samples=R2B9_SPL, finemap=fm, cost=c)
        km = time_cuda(lambda: launch(None), reps=5)
        errs["track_q_r2b9"] = err
        kernel_row(rows, {"track_q_r2b9": main_launches}, errs,
                   "track_q_r2b9", "cuda",
                   "icon_rt_tpu_torch/csrc/track_q.cu",
                   "icon_rt_tpu/ops/fastq.py:80", km, pm,
                   tier.bound("track_q", n_active, lambda c: q.test12[c, 11],
                              scale=n_active / pix.shape[0]),
                   samples=R2B9_SPL, n_active=n_active,
                   plain_lanes=pix.shape[0],
                   profiled_kernel_ms=prof["kernel_ms"],
                   launch_idle_share=prof["idle_share"],
                   **tracker_extras("track_q", tag, launch, perm, n_active))
    peak_memory(tag)
    return counts


def main_r2b9m(dev, errs):
    """bench.py `_measure_row_m` (bench.py:498-578) through the port: the
    scene built again, one converged pass per launch with the fine map
    (median of 3), tf_edit_s to the next converged frame; the pass against
    the pass without the fine map, and K3-q against its plain version on
    the first CHECK_LANES covered lanes."""
    import torch
    from icon_rt_tpu_torch.models.qcells import bake_alpha_q
    from icon_rt_tpu_torch.models.shells import update_band_majorants
    from icon_rt_tpu_torch.ops import march, order
    from icon_rt_tpu_torch.ops.march import render_frame_march_q
    from icon_rt_tpu_torch.ops.render import alloc_frame
    tag = "main r2b9m"
    W, H = MAIN_W, MAIN_H
    zero_counters()
    q, loc, _, bands, tf, stats, fm, _, _ = r2b9_scene(dev, tag)
    lp, perm, n_active = r2b9_frame(stats, W, H, dev)
    kw = dict(width=W, height=H, pixel_perm=perm, n_active=n_active)

    def sweep(q_, bands_, tf_, k, frame=None, f=fm):
        acc, fb = frame if frame is not None else alloc_frame(W, H,
                                                              device=dev)
        render_frame_march_q(q_, loc, bands_, tf_, with_id(lp, k), acc, fb,
                             finemap=f, **kw)
        return acc, fb.cpu().numpy().view(np.uint32)

    frame = alloc_frame(W, H, device=dev)
    # the kernels line's launches of K3-q at R2B9 are the main path's own
    # passes (the warm one and the 3 timed), not the profiled window's
    # (which retries) nor the TF edits'
    for k in march.launches:
        march.launches[k] = 0
    _, fb_host = sweep(q, bands, tf, 0, frame)           # warm + coverage
    covered = float(((fb_host >> 24) > 0).mean())
    times = []
    for k in range(1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep(q, bands, tf, k, frame)
        times.append(time.perf_counter() - t0)
    main_launches = march.launches["march_q"]
    dt = float(np.median(times))
    spread = float((max(times) - min(times)) / dt)
    print(f"{tag} converged pass (fine map on) median {dt * 1e3:.3f} ms of "
          f"{[round(x * 1e3, 3) for x in times]}, spread {spread:.3f}: "
          f"{1.0 / dt:.3f} converged frames/s, {W * H / dt / 1e6:.3f} Mray/s "
          f"full, {n_active / dt / 1e6:.3f} Mray/s traced; covered "
          f"{covered:.4f}")
    if covered < 0.5:
        raise AssertionError(f"{tag}: image covers only {covered:.4f}")
    profile_render(lambda: render_frame_march_q(
        q, loc, bands, tf, with_id(lp, 4), *frame, finemap=fm, **kw),
        frame[1], f"{tag} converged pass", "march_q_kernel")

    def tf_edit(tf2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q2 = bake_alpha_q(q, tf2)
        bands2 = update_band_majorants(bands, tf2.values, tf2.value_range)
        sweep(q2, bands2, tf2, 0)
        return time.perf_counter() - t0

    tf_edit(gain_edit(tf, 0.95, 0.9))
    edit_s = tf_edit(gain_edit(tf, 0.9, 0.8))
    print(f"{tag} tf_edit_s {edit_s:.4f} (gain 0.9, opacity 0.8, to the next "
          f"converged frame's fb on the host)")
    counts = dict(scene_counts(), chord_keys=order.launches,
                  march_q=main_launches)
    require_counts(tag, counts)

    acc_on, _ = sweep(q, bands, tf, 0)
    acc_off, _ = sweep(q, bands, tf, 0, f=None)
    finemap_agreement(acc_on, acc_off, n_active, tag)
    pix = perm[:CHECK_LANES].contiguous()
    for f in (fm, None):
        err, _, _ = compare_march(
            f"{tag} K3 march_q finemap={'on' if f is not None else 'off'} "
            f"on {CHECK_LANES} lanes",
            march_runs(None, None, bands, lp, pix, W, H,
                       qtabs=(q, loc, tf), fm=f), W, H, CHECK_LANES, dev)
        errs["march_q"] = max(errs["march_q"], err)

    # K3-q's R2B9 row: the kernel over the covered lanes (CUDA events), a
    # steady call under sync debug mode "error" (it reads nothing back), and
    # the bound counted by the plain version on CHECK_LANES strided lanes
    lanes_all = perm[:n_active].contiguous()
    acc, fb = alloc_frame(W, H, device=dev)
    run = march_runs(None, None, bands, lp, lanes_all, W, H,
                     qtabs=(q, loc, tf), fm=fm)
    km = time_cuda(lambda: run(acc[:n_active], fb[:n_active], True), reps=10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(acc[:n_active], fb[:n_active], True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"{tag} a steady K3-q call under sync debug mode 'error': no "
          f"device-to-host read")
    lanes = strided_lanes(perm, n_active)
    tiers = []
    err, pm, _ = compare_march(
        f"{tag} K3 march_q finemap=on on {lanes.shape[0]} strided lanes",
        march_runs(None, None, bands, lp, lanes, W, H, qtabs=(q, loc, tf),
                   fm=fm, counter=lambda t: tiers.append(CountingTier(t))
                   or tiers[-1]), W, H, lanes.shape[0], dev)
    errs["march_q_r2b9"] = max(errs["march_q"], err)
    rows = []
    kernel_row(rows, {"march_q_r2b9": main_launches}, errs,
               "march_q_r2b9", "cuda", "icon_rt_tpu_torch/csrc/march.cu",
               "icon_rt_tpu/ops/march.py:449", km, pm,
               tiers[-1].bound("march_q", n_active,
                               lambda c: q.test12[c, 11],
                               scale=n_active / lanes.shape[0]),
               n_active=n_active, plain_lanes=lanes.shape[0],
               **march_extras("q"))
    peak_memory(tag)
    return rows


def scene_rows(t, errs, counts):
    """The kernels line's rows of K7-scene and K7-loc (timed in scene9,
    launches from main r2b9q)."""
    rows = []
    sc, lo = t["scene"], t["locator"]
    kernel_row(rows, counts, errs, "synth_scene", "cuda",
               "icon_rt_tpu_torch/csrc/scene.cu",
               "icon_rt_tpu/data/device_scene.py:103", sc["ms"],
               sc["plain_ms"], sc["bnd"],
               **{k: sc[k] for k in ("pass1_ms", "pass2_ms", "plain_pass1_ms",
                                     "plain_pass2_ms", "build_s", "cells")})
    kernel_row(rows, counts, errs, "locator_bins", "cuda",
               "icon_rt_tpu_torch/csrc/locator.cu",
               "icon_rt_tpu/models/locator.py:239 (host binning, no TPU "
               "kernel)", lo["ms"], lo["plain_ms"], lo["bnd"],
               **{k: lo[k] for k in ("build_s", "dims", "k_cap", "ms_subdiv8",
                                     "plain_ms_subdiv8", "split")})
    # K7-fm at R2B9: the whole plain image does not fit beside the scene
    # (its slot search alone gathers 12 GB of rows), so its plain time is
    # `_finemap_bins_torch` on the plain_fine_bins sampled bins
    fm = t["finemap"]
    kernel_row(rows, {"build_finemap_r2b9": counts["build_finemap"]}, errs,
               "build_finemap_r2b9", "cuda",
               "icon_rt_tpu_torch/csrc/finemap.cu",
               "icon_rt_tpu/models/finemap.py:174", fm["ms"], fm["plain_ms"],
               fm["bnd"], **{k: fm[k] for k in (
                   "fine_bins", "plain_fine_bins", "k_cap", "first_s",
                   "peak_gib_above_scene", "split", "profiled_wall_ms")})
    return rows


def compare_track_f32(tabs, lp, pix, width, height, samples, label,
                      return_fb=False):
    """K1 with its cost output against the plain version on the same lanes
    (column cache kept): fb identical on >= 99.9%, accum <= ACCUM_TOL, the
    step counts as compare_cost.  Returns the accum error (and the plain
    version's fb with return_fb)."""
    import torch
    from icon_rt_tpu_torch.ops import fast
    from icon_rt_tpu_torch.ops.render import alloc_frame
    n = pix.shape[0]
    outs = []
    for run in (fast.track_f32, None):
        acc, fb = alloc_frame(width, height, device=pix.device)
        cost = torch.zeros(width * height, dtype=torch.int32,
                           device=pix.device)
        if run is not None:
            run(*tabs, lp, pix, acc[:n], fb[:n], width=width, height=height,
                samples=samples, cost=cost)
        else:
            fast._render_frame_fast_torch(*tabs, lp, pix, acc[:n], fb[:n],
                                          width, height, samples, True, cost)
        outs.append((acc, fb, cost))
    torch.cuda.synchronize()
    (ak, fk, ck), (ap, fp, cp) = outs
    same = float((fk == fp).float().mean())
    err = float((ak - ap).abs().max())
    print(f"{label} K1 track_f32 samples={samples} on {n} lanes: fb "
          f"identical on {same:.6f}, accum max abs diff {err:.3e}")
    if same < 0.999 or not err <= ACCUM_TOL:
        raise AssertionError("K1 disagrees with its plain version")
    compare_cost(ck, cp, pix, f"{label} K1 track_f32")
    return (err, fp) if return_fb else err


def resort_runs(render, perm, n_active, width, height, dev, label):
    """Three launches of R2B9_SPL samples with return_cost, once without
    and once with the K6b re-sort between launches (refine_order_device on
    the launch's cost, then repermute_device of accum and fb).  The
    unpermuted fb and accum must be identical, and so must every launch's
    cost in natural pixel order.  Prints both runs' launch times beside
    each other; returns (the last launch's perm, inverse, cost, accum, fb)
    of the re-sorted run, for the K6b timings."""
    import torch
    from icon_rt_tpu_torch.ops import order
    from icon_rt_tpu_torch.ops.render import alloc_frame
    runs = {}
    for resort in (False, True):
        p, inv = perm, order.inverse_order(perm)
        acc, fb = alloc_frame(width, height, device=dev)
        ms, sort_ms, costs = [], [], []
        for k in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            acc, fb, cost = render(k * R2B9_SPL, p, acc, fb)
            ev[1].record()
            last = (p, inv, cost, acc, fb)
            if resort:
                p2 = order.refine_order_device(p, n_active, cost)
                acc, fb = order.repermute_device(acc, fb, p2, inv)
                p, inv = p2, order.inverse_order(p2)
            ev[2].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            sort_ms.append(ev[1].elapsed_time(ev[2]))
            costs.append(cost)
        nat = inv.long()
        runs[resort] = dict(acc=acc[nat], fb=fb[nat], costs=costs, ms=ms,
                            sort_ms=sort_ms, perm=p, last=last)
    a, b = runs[False], runs[True]
    same = torch.equal(a["fb"], b["fb"]) and torch.equal(a["acc"], b["acc"])
    same_cost = all(torch.equal(x, y) for x, y in zip(a["costs"],
                                                      b["costs"]))
    moved = float((a["perm"][:n_active] != b["perm"][:n_active]).float()
                  .mean())
    c = a["costs"][-1][perm[:n_active].long()].float()
    print(f"{label}: ms per {R2B9_SPL}-sample launch, static order "
          f"{[round(x, 3) for x in a['ms']]} | re-sorted "
          f"{[round(x, 3) for x in b['ms']]} (+ re-sort "
          f"{[round(x, 3) for x in b['sort_ms']]} ms); steps per covered "
          f"lane mean {float(c.mean()):.1f}, max {int(c.max())}; "
          f"{moved:.4f} of the {n_active} covered lanes moved; unpermuted fb "
          f"and accum identical {same}, costs identical {same_cost}")
    if not (same and same_cost):
        raise AssertionError(f"{label}: the re-sort changed the image")
    return b["last"]


def order_refine(dev, errs):
    """The measured-cost re-sort K6b on the R2B8 closeup at 1080p, the f32
    tier (the scene as the app builds it) and the quantized tier
    (build_q_scene(8, 16), fine map on): resort_runs for each, with
    every counter zeroed before and read after; then K1's cost output
    against its plain version, and K6b's kernels against their plain
    versions and the library calls at these shapes.  Returns (the path's
    launch counts, the timing entries of the kernels line)."""
    import torch
    from icon_rt_tpu_torch.data import bigscene, synthetic
    from icon_rt_tpu_torch.models.cells import build_cells, compute_stats
    from icon_rt_tpu_torch.models.locator import build_locator
    from icon_rt_tpu_torch.models.shells import (build_radial_bands,
                                                 update_band_majorants)
    from icon_rt_tpu_torch.models.transfunc import make_transfunc
    from icon_rt_tpu_torch.ops import fast, fastq, order
    tag = "order refine"
    W, H = MAIN_W, MAIN_H
    zero_counters()
    t0 = time.perf_counter()
    ds = synthetic.icosphere(MAIN_SUB, MAIN_LAYERS)
    stats = compute_stats(ds)
    cells = build_cells(ds, device=dev)
    loc = build_locator(ds, device=dev)
    tf = make_transfunc(value_range=tuple(stats.data_range), device=dev)
    bands = update_band_majorants(build_radial_bands(ds, 64, device=dev),
                                  tf.values, tf.value_range)
    packed = fast.pack_cells(cells, tf)
    del ds
    lp, perm, n_act = r2b9_frame(stats, W, H, dev)
    print(f"{tag} R2B8 f32 closeup built in {time.perf_counter() - t0:.3f} "
          f"s; {n_act} covered lanes")
    tabs = (packed, loc, bands)
    last = resort_runs(lambda k, p, acc, fb: fast.render_frame_fast(
        cells, *tabs, with_id(lp, k), acc, fb, width=W, height=H,
        pixel_perm=p, n_active=n_act, samples=R2B9_SPL, return_cost=True),
        perm, n_act, W, H, dev, f"{tag} f32")

    q, qloc, _, qbands, qtf, qstats, fm, _, _ = bigscene.build_q_scene(
        MAIN_SUB, MAIN_LAYERS, device=dev)
    qlp, qperm, qn = r2b9_frame(qstats, W, H, dev)
    resort_runs(lambda k, p, acc, fb: fastq.render_frame_fast_q(
        q, qloc, qbands, qtf, with_id(qlp, k), acc, fb, width=W, height=H,
        pixel_perm=p, n_active=qn, samples=R2B9_SPL, finemap=fm,
        return_cost=True), qperm, qn, W, H, dev, f"{tag} q")
    counts = dict(track_f32=fast.launches["track_f32"],
                  track_q=fastq.launches, chord_keys=order.launches,
                  **order.refine_launches)
    require_counts(tag, counts)
    del q, qloc, qbands, fm

    errs["track_f32"] = max(errs["track_f32"], compare_track_f32(
        tabs, lp, strided_lanes(perm, n_act), W, H, R2B9_SPL, tag))

    # K6 as a camera move runs it: pixel_order from the keys to n_covered
    # on the host (its one read ends each call)
    r_in, r_out = stats.spherical_bounds_lo[0], stats.spherical_bounds_hi[0]
    order.pixel_order(lp, r_in, r_out, W, H)
    t1 = time.perf_counter()
    for _ in range(20):
        order.pixel_order(lp, r_in, r_out, W, H)
    po_ms = (time.perf_counter() - t1) / 20 * 1e3
    print(f"{tag} K6 pixel_order at {W}x{H} (keys, covered count, sort, "
          f"n_covered on the host): {po_ms:.4f} ms a call, 20 calls")

    # K6b at these shapes: the f32 run's last re-sort
    p, inv, cost, acc, fb = last
    new = order.refine_order_device(p, n_act, cost)
    keys_k = order.refine_keys(p, n_act, cost)
    srt = torch.sort(keys_k, stable=True).indices       # int64, as it comes
    perm_k = order.refine_perm(p, n_act, srt)
    moved_k = order.repermute_device(acc, fb, new, inv)
    moved_p = order._repermute_torch(acc, fb, new, inv)
    host = torch.from_numpy(order.refine_order(
        p.cpu().numpy(), n_act, cost.cpu().numpy())).to(dev)
    exact = (torch.equal(keys_k, order._refine_keys_torch(p, n_act, cost)),
             torch.equal(perm_k, order._refine_perm_torch(p, n_act, srt))
             and torch.equal(perm_k, new) and torch.equal(perm_k, host)
             and torch.equal(order.refine_perm(p, n_act,
                                               srt.to(torch.int32)), perm_k),
             torch.equal(moved_k[0], moved_p[0])
             and torch.equal(moved_k[1], moved_p[1]))
    print(f"{tag} K6b refine_keys exact {exact[0]}, refine_perm exact "
          f"{exact[1]}, repermute exact {exact[2]} ({n_act} keys, "
          f"{p.shape[0]} lanes)")
    if not all(exact):
        raise AssertionError("K6b differs from its plain version")
    errs["refine_keys"] = errs["refine_perm"] = errs["repermute"] = 0.0
    head, tail = p[:n_act], p[n_act:]

    def library_resort():
        keys = cost.index_select(0, head)
        srt = head.index_select(0, torch.sort(keys, stable=True).indices)
        src = inv.index_select(0, torch.cat([srt, tail]))
        return acc.index_select(0, src), fb.index_select(0, src)

    def port_resort():
        n2 = order.refine_order_device(p, n_act, cost)
        return order.repermute_device(acc, fb, n2, inv)

    lib_out = library_resort()
    if not (torch.equal(lib_out[0], moved_k[0])
            and torch.equal(lib_out[1], moved_k[1])):
        raise AssertionError("K6b's re-sort differs from the library's")
    keys = lambda: order.refine_keys(p, n_act, cost)
    keys_lib = lambda: cost.index_select(0, head)
    keys_ms, keys_lib_ms = time_turns(keys, keys_lib, reps=20)
    perm = lambda: order.refine_perm(p, n_act, srt)
    perm_lib = lambda: torch.cat([head.index_select(0, srt), tail])
    perm_ms, perm_lib_ms = time_turns(perm, perm_lib, reps=20)
    dev_ms = {}
    for name, fn, need in (("keys", keys, ("refine_keys_kernel",)),
                           ("lib", keys_lib, ()), ("lib", keys_lib, ()),
                           ("keys", keys, ("refine_keys_kernel",)),
                           ("perm", perm, ("refine_perm_kernel",)),
                           ("perm_lib", perm_lib, ()),
                           ("perm_lib", perm_lib, ()),
                           ("perm", perm, ("refine_perm_kernel",))):
        ms = device_ms(fn, 10, need, f"{tag} K6b {name}")
        dev_ms[name] = dev_ms.get(name, 0.0) + ms / 2
    t = dict(
        keys=keys_ms, keys_device=dev_ms["keys"],
        keys_plain=time_cuda(lambda: order._refine_keys_torch(p, n_act,
                                                              cost), reps=20),
        keys_lib=keys_lib_ms, keys_lib_device=dev_ms["lib"],
        perm=perm_ms, perm_device=dev_ms["perm"],
        perm_plain=time_cuda(lambda: order._refine_perm_torch(p, n_act, srt),
                             reps=20),
        perm_lib=perm_lib_ms, perm_lib_device=dev_ms["perm_lib"],
        pixel_order=po_ms,
        move=time_cuda(lambda: order.repermute_device(acc, fb, new, inv),
                       reps=20),
        move_plain=time_cuda(lambda: order._repermute_torch(acc, fb, new,
                                                            inv), reps=20),
        move_lib=time_cuda(lambda: (lambda src: (acc.index_select(0, src),
                                                 fb.index_select(0, src)))(
            inv.index_select(0, new)), reps=20),
        resort=time_cuda(port_resort, reps=20),
        resort_lib=time_cuda(library_resort, reps=20),
        n_active=n_act, lanes=p.shape[0])
    print(f"{tag} K6b at {W}x{H}: refine_keys {t['keys']:.4f} ms (plain "
          f"{t['keys_plain']:.4f}, index_select {t['keys_lib']:.4f}; in "
          f"turns, 20 calls; device time a call {t['keys_device']:.4f}, "
          f"index_select's {t['keys_lib_device']:.4f}); "
          f"refine_perm {t['perm']:.4f} ms (plain {t['perm_plain']:.4f}, "
          f"index_select + cat {t['perm_lib']:.4f}; in turns, 20 calls; "
          f"device time a call {t['perm_device']:.4f}, index_select + "
          f"cat's {t['perm_lib_device']:.4f}); repermute {t['move']:.4f} ms "
          f"(plain {t['move_plain']:.4f}, "
          f"index_select {t['move_lib']:.4f}); the whole re-sort "
          f"{t['resort']:.4f} ms (torch.sort + index_select "
          f"{t['resort_lib']:.4f})")
    peak_memory(tag)
    return counts, t


def lod_rows(t9l, t_o, errs, counts):
    """The kernels line's rows of K7-scene's mip tier (timed in scene9lod,
    launches from main r2b9qv) and of K6b (timed and launched in order
    refine)."""
    rows = []
    sc = t9l
    kernel_row(rows, counts, errs, "synth_scene_lod", "cuda",
               "icon_rt_tpu_torch/csrc/scene.cu",
               "icon_rt_tpu/data/device_scene.py:179", sc["ms"],
               sc["plain_ms"], sc["bnd"],
               **{k: sc[k] for k in ("pass1_ms", "pass2_ms", "plain_pass1_ms",
                                     "plain_pass2_ms", "cells", "lod")})
    n, lanes = t_o["n_active"], t_o["lanes"]
    # keys: perm and the gathered cost read, the key written, per covered
    # lane; refine_perm: the sort's int64 order read per covered lane, perm
    # read and the new perm written per lane; repermute: new_perm, inv_old,
    # accum and fb read, accum and fb written, per lane (no arithmetic to
    # speak of)
    kernel_row(rows, counts, errs, "refine_keys", "cuda",
               "icon_rt_tpu_torch/csrc/order.cu",
               "icon_rt_tpu/ops/order.py:109", t_o["keys"], t_o["keys_plain"],
               bound(12 * n, 0), library_ms=t_o["keys_lib"],
               device_ms=t_o["keys_device"],
               library_device_ms=t_o["keys_lib_device"],
               resort_ms=t_o["resort"], resort_library_ms=t_o["resort_lib"])
    kernel_row(rows, counts, errs, "refine_perm", "cuda",
               "icon_rt_tpu_torch/csrc/order.cu",
               "icon_rt_tpu/ops/order.py:109", t_o["perm"], t_o["perm_plain"],
               bound(8 * n + 8 * lanes, 0), library_ms=t_o["perm_lib"],
               device_ms=t_o["perm_device"],
               library_device_ms=t_o["perm_lib_device"])
    kernel_row(rows, counts, errs, "repermute", "triton",
               "icon_rt_tpu_torch/ops/order.py",
               "icon_rt_tpu/ops/order.py:124", t_o["move"], t_o["move_plain"],
               bound(48 * lanes, 0), library_ms=t_o["move_lib"])
    return rows


# ===========================================================================
# Unstructured elements: the fast wedge tier (K9-w), the Newton wedge
# sampler of the parity raygens (K9-p) and the intersectors (K9-n)
# ===========================================================================

def wedge_bound(raygen, lanes, w, scale):
    """(ms, by) of one K9-p sample of `lanes` lanes from the work `w`
    (`Work.counts()`, wedge sampler) of a plain run on lanes/scale of them:
    the events scaled to the frame (the wedge shell test charged to every
    sample, the locate only to those that pass it), the reads of the
    counted lanes (each visited column's heights, layer count and first
    wedge, each inverted wedge's 18 vertex floats and 6 scalars, the
    locator entries)."""
    o, b, nw = PARITY_OPS, PARITY_BYTES, NEWTON_OPS
    located = w["eval"] - w["shell"]        # the samples the shell kept
    ops = scale * (w["draw"] * o["draw"]
                   + w["advance"] * o["advance"][raygen]
                   + w["eval"] * (o["eval"] + o["shell"])
                   + located * o["locate"]
                   + w["wcol_layers"] * nw["col_layer"]
                   + w["newton"] * nw["newton"]
                   + w["newton_iters"] * nw["iter"] + w["hit"] * o["hit"])
    nbytes = (b["lane"] * lanes + b["hit"] * w["hit_cells"]
              + b["layer"] * w["hit_cell_layers"]
              + b["wedge"] * w["wedges_read"] + b["entry"] * w["entries"])
    return bound(nbytes, ops)


def wedge_tables(ds, cells, tf, dev):
    """The fast wedge tier's packed rows (pack_cells_wedge: K5a over bv)
    and bands (build_radial_bands_wedge, K5b majorants)."""
    from icon_rt_tpu_torch.models.shells import (build_radial_bands_wedge,
                                                 update_band_majorants)
    from icon_rt_tpu_torch.ops import fast
    bands = update_band_majorants(build_radial_bands_wedge(ds, 64,
                                                           device=dev),
                                  tf.values, tf.value_range)
    return fast.pack_cells_wedge(cells, tf), bands


def compare_track_wedge(packed, loc, bands, lp, pix, width, height, samples,
                        preserve, label, count=False):
    """K9-w against its plain version (`_track_torch` on `_WedgeTier`) on
    the lanes `pix`, each writing its own accum and fb entry: fb identical
    on >= 99.9% of the lanes, accum <= ACCUM_TOL; raises past them.
    Returns (accum max abs err, plain ms, the plain run's CountingTier if
    `count`)."""
    import torch
    from icon_rt_tpu_torch.ops import fast
    n = pix.shape[0]
    tier = CountingTier(fast._WedgeTier(packed, loc))
    outs = []
    for kernel in (True, False):
        acc = torch.zeros(n, 4, device=pix.device)
        fb = torch.zeros(n, dtype=torch.int32, device=pix.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kernel:
            fast.track_wedge(packed, loc, bands, lp, pix, acc, fb,
                             width=width, height=height, samples=samples,
                             preserve_cache=preserve)
        else:
            fast._track_torch(tier if count else fast._WedgeTier(packed, loc),
                              bands, lp, pix, acc, fb, width, height,
                              samples, preserve)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        outs.append((acc, fb))
    (ak, fk), (ap, fp) = outs
    same = float((fk == fp).float().mean())
    err = float((ak - ap).abs().max())
    written = int((fk != 0).sum())
    print(f"{label} K9-w track_wedge samples={samples} preserve_cache="
          f"{preserve} on {n} lanes: fb identical on {same:.6f} of them, "
          f"accum max abs diff {err:.3e}, written {written} lanes")
    if same < 0.999 or not err <= ACCUM_TOL:
        raise AssertionError("K9-w disagrees with its plain version")
    if not written:
        raise AssertionError(f"{label}: K9-w wrote no lane")
    return err, plain_ms, tier if count else None


def uelems_inputs(nv, m, dev, seed):
    """m seeded points on jittered unit elements of nv vertices."""
    import torch
    base = {5: [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]],
            6: [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1],
                [0, 1, 1]],
            8: [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1],
                [1, 0, 1], [1, 1, 1], [0, 1, 1]]}[nv]
    rs = np.random.default_rng(seed)
    V = (np.asarray(base, np.float32)[None]
         + rs.normal(size=(m, nv, 3)) * 0.15).astype(np.float32)
    S = rs.random((m, nv)).astype(np.float32)
    P = (rs.normal(size=(m, 3)) * 0.5 + 0.45).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (P, V, S))


def uelems_bound(nv, m, n_inside, iters):
    """(ms, by) of K9-n on m points of nv vertices: each point's P and
    vertices read and its flag and value written (12 + 12 nv + 5 bytes),
    the scalars of a point inside read (4 nv bytes), against NEWTON_OPS
    (the wedge's) for each Newton and each of the `iters` iterations the
    plain version counted."""
    return bound(m * (17 + 12 * nv) + 4 * nv * n_inside,
                 m * NEWTON_OPS["newton"] + iters * NEWTON_OPS["iter"])


def check_uelems(uelems, nv, m, dev, out=False):
    """K9-n on `uelems_inputs(nv, m)` (into fresh out= tensors if `out`,
    and then again with NaN scalars on every element that does not
    contain its point, which the kernel must leave unread) against the
    plain `newton`: flags (bool) and values bit-equal, or raises.
    Returns (P, V, S, the plain run's inside count, iterations summed)."""
    import torch
    P, V, S = uelems_inputs(nv, m, dev, nv)
    o = ((torch.empty(m, dtype=torch.bool, device=dev),
          torch.empty(m, dtype=torch.float32, device=dev)) if out else None)
    hk, vk = uelems.uelems_points(P, V, S, out=o)
    hp, vp, it = uelems.newton(P, V, S, return_iters=True)
    same = bool(hk.dtype == torch.bool and torch.equal(hk, hp)
                and torch.equal(vk, vp)
                and (o is None or (hk is o[0] and vk is o[1])))
    if out:
        hn, vn = uelems.uelems_points(
            P, V, torch.where(hp[:, None], S, float("nan")), out=o)
        same = same and bool(torch.equal(hn, hp) and torch.equal(vn, vp))
    print(f"check w K9-n uelems_points nv={nv} on {m} points"
          f"{' into out= (and NaN scalars outside)' if out else ''}: "
          f"inside "
          f"{float(hp.float().mean()):.4f}, flags and values "
          f"{'bit-equal' if same else 'DIFFER'}; iterations mean "
          f"{float(it.float().mean()):.2f}")
    if not same:
        raise AssertionError(f"K9-n nv={nv} on {m} points differs from its "
                             f"plain version")
    return P, V, S, int(hp.sum()), int(it.sum())


def uelems_timing(uelems, P, V, S, n_in, iters, reps):
    """K9-n's events ms (`reps` wrapper calls back to back), profiled
    kernel and device ms a call (10 calls in a window) and bound on the
    wedges P, V, S."""
    nv, m = V.shape[1], P.shape[0]
    call = lambda: uelems.uelems_points(P, V, S)
    ms = time_cuda(call, reps=reps)
    _, tl = profile_window(lambda: [call() for _ in range(10)],
                           ("uelems_kernel",), f"K9-n {m} points")
    return dict(ms=ms, kernel_ms=sum(t for n, _, t in tl
                                     if "uelems_kernel" in n) / 10,
                device_ms=sum(t for _, _, t in tl) / 10,
                bnd=uelems_bound(nv, m, n_in, iters))


def check_wedge(sc, dev):
    """`check w`: K5a over bv (<= 1 ULP), K9-w (samples=4, both
    preserve_cache settings) and K9-n (UELEMS_POINTS points per shape,
    the wedge at UELEMS_FRAME and UELEMS_RAGGED points into out=,
    bit-equal) against their plain versions on the check scene.  Returns
    ({kernel: max abs err}, K9-n's timing row numbers)."""
    import torch
    from icon_rt_tpu_torch.models.wedges import bv_all, layer_pad
    from icon_rt_tpu_torch.ops import fast, uelems
    errs = {}
    t0 = time.perf_counter()
    packed, bands = wedge_tables(sc.ds, sc.cells, sc.tf, dev)
    bv = torch.from_numpy(np.ascontiguousarray(bv_all(
        sc.ds.value, sc.ds.num_layers))).to(dev)
    prof_p, rgb_p = fast._profile_rows_torch(sc.cells.height, bv,
                                             sc.cells.num_layers, sc.tf)
    u = max(ulp_diff(packed.prof, prof_p), ulp_diff(packed.rgb, rgb_p))
    print(f"check w subdiv {SMOKE_SUB} x {SMOKE_LAYERS}: layer_pad "
          f"{layer_pad(sc.ds)}; K5a over bv: max {u} ULP")
    if u > 1:
        raise AssertionError(f"K5a over bv differs by {u} ULP")
    n = sc.n_cov
    pix = sc.perm[:n].contiguous()
    errs["track_wedge"] = 0.0
    for preserve in (True, False):
        err, _, _ = compare_track_wedge(packed, sc.loc, bands, sc.lp, pix,
                                        sc.width, sc.height, 4, preserve,
                                        "check w")
        errs["track_wedge"] = max(errs["track_wedge"], err)
    t1 = time.perf_counter()
    n0 = uelems.launches["uelems_points"]
    timing = {}
    for nv in (5, 6, 8):
        P, V, S, n_in, iters = check_uelems(uelems, nv, UELEMS_POINTS, dev)
        if nv == 6:      # the wedge, the element of the cuBQL path
            timing = uelems_timing(uelems, P, V, S, n_in, iters, 20)
            timing["plain_ms"] = time_cuda(lambda: uelems.newton(P, V, S),
                                           reps=3)
    for m in (UELEMS_FRAME,) + UELEMS_RAGGED:
        P, V, S, n_in, iters = check_uelems(uelems, 6, m, dev, out=True)
        if m == UELEMS_FRAME:
            big = uelems_timing(uelems, P, V, S, n_in, iters, 20)
    timing.update({f"{k}_{UELEMS_FRAME}": v for k, v in big.items()},
                  points=UELEMS_POINTS, **uelems.uelems_occupancy(6),
                  check_launches=uelems.launches["uelems_points"] - n0)
    print(f"check w K9-n {time.perf_counter() - t1:.1f} s: wedge "
          f"{UELEMS_POINTS} points {timing['ms']:.4f} ms events, kernel "
          f"{timing['kernel_ms']:.4f}, bound {timing['bnd'][0]:.4f} "
          f"({timing['bnd'][1]}); {UELEMS_FRAME} points "
          f"{big['ms']:.4f} ms events, kernel {big['kernel_ms']:.4f}, "
          f"bound {big['bnd'][0]:.4f} ({big['bnd'][1]}); "
          f"{timing['registers']} registers, {timing['blocks_per_sm']} "
          f"blocks an SM; {timing['check_launches']} launches")
    errs["uelems_points"] = 0.0
    print(f"check w {time.perf_counter() - t0:.1f} s")
    return errs, timing


def main_wedge(dev, errs):
    """`main w`: the app with -mode 2 on the fast raygen (the wedge tier,
    K9-w) at the main path's scale and camera, 16 samples (8 per launch)
    then on to STEADY_LIMIT; the counters of K9-w, K5a, K5b and K6 zeroed
    before the build and read after (K1 must read 0); layer_pad and the
    build seconds of bands_w and packed_w; an opacity-scale and a curve
    edit timed to the next fb on the host; a profiled launch; K9-w against
    its plain version on the first CHECK_LANES covered lanes and on
    CHECK_LANES lanes strided over the covered prefix, whose counted work
    gives the bound.  Returns (counts, rows)."""
    import torch
    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.data.lod import frame_camera
    from icon_rt_tpu_torch.models import accel
    from icon_rt_tpu_torch.models.cells import compute_stats
    from icon_rt_tpu_torch.models.wedges import layer_pad
    from icon_rt_tpu_torch.ops import fast, order
    tag = "main w"
    ds = synthetic.icosphere(MAIN_SUB, MAIN_LAYERS)
    stats = compute_stats(ds)
    cam = frame_camera(stats, "closeup", MAIN_W, MAIN_H)
    pose = [*cam.position, *cam.get_poi(), *cam.up_vector]
    argv = ["--device", "cuda", "--synthetic", f"{MAIN_SUB}:{MAIN_LAYERS}",
            "--size", str(MAIN_W), str(MAIN_H), "--sample-limit",
            str(MAIN_LIMIT), "--samples", str(MAIN_SPL), "--camera",
            *[repr(float(v)) for v in pose], "-fovy",
            repr(float(cam.get_fovy_degrees())), "-mode", "2",
            "-o", os.path.join(OUT_DIR, "chip_smoke_w")]
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    pl = app.build(argv)
    build_s = time.perf_counter() - t0
    launch_ms = []
    run_loop(pl, launch_ms)
    pl.present()
    n_launch = len(launch_ms)
    secs = {k: round(v, 3) for k, v in pl.scene["timings"].items()}
    print(f"{tag} build {build_s:.3f} s (app.build: scene, cells, locator); "
          f"build seconds {json.dumps(secs)} (bands_w and packed_w in the "
          f"first launch); layer_pad {layer_pad(ds)}; launches {n_launch}, "
          f"ms {[round(x, 3) for x in launch_ms]}")
    fb = pl.frame["fb"].cpu().numpy().view(np.uint32)
    covered = float(((fb >> 24) > 0).mean())
    n = pl.frame["n_active"]
    acc = pl.frame["accum"]
    print(f"{tag} image covered fraction {covered:.4f} (K6 covered prefix "
          f"{n} of {MAIN_W * MAIN_H} lanes)")
    if covered < 0.5 or not bool(torch.isfinite(acc).all()):
        raise AssertionError(f"{tag}: image covers {covered:.4f} (< 0.5) or "
                             f"accum is not finite")
    counts = {"track_wedge": fast.launches["track_wedge"],
              "classify_bake": fast.launches["classify_bake"],
              "max_opacity": accel.launches, "chord_keys": order.launches}
    require_counts(tag, counts)
    if fast.launches["track_f32"] != 0:
        raise AssertionError(f"{tag}: K1 launched "
                             f"{fast.launches['track_f32']} times")
    if counts["track_wedge"] != n_launch:
        raise AssertionError(f"{tag}: K9-w launched {counts['track_wedge']}"
                             f" times in {n_launch} launches")
    pl.sample_limit = STEADY_LIMIT
    run_loop(pl, launch_ms)
    steady = np.array(launch_ms[1:])
    med = float(np.median(steady))
    spread = float((steady.max() - steady.min()) / med)
    mray = MAIN_W * MAIN_H * MAIN_SPL / (med * 1e-3) / 1e6
    traced = n * MAIN_SPL / (med * 1e-3) / 1e6
    print(f"{tag} steady launches {len(steady)} ({MAIN_SPL} samples each): "
          f"ms per launch median {med:.3f}, spread {spread:.3f}; "
          f"{mray:.3f} Mray/s full frame, {traced:.3f} traced ({n} lanes; "
          f"fb copied to the host); K1 launches "
          f"{fast.launches['track_f32']}")

    s = pl.scene
    lut0 = pl.transfunc.get_lut()
    edit = {"opacity": timed_edit(pl, tag, "opacity scale 1.0 -> 0.5 "
                                  "(K5b, the full wedge re-bake)",
                                  lambda: set_opacity(pl, 0.5))}
    lut = lut0.copy()
    lut[: lut.shape[0] // 2, 3] = 0.0
    edit["curve"] = timed_edit(pl, tag, "curve, lower half transparent",
                               lambda: set_lut(pl, lut))
    print(f"{tag} tf_edit_s {edit['opacity'] / 1e3:.4f} (opacity), "
          f"{edit['curve'] / 1e3:.4f} (curve)")
    set_lut(pl, lut0)
    set_opacity(pl, 1.0)
    cells, loc = s["cells"], s["locator"]
    packed, bands = s["get_packed_wedge"](), s["get_bands_wedge"]()
    lp = launch_params(pl)
    perm = pl.frame["perm"]
    render = lambda: fast.render_frame_fast(
        cells, packed, loc, bands, lp, acc, pl.frame["fb"], width=MAIN_W,
        height=MAIN_H, pixel_perm=perm, n_active=n, samples=MAIN_SPL,
        sampler="wedge")
    profile_render(render, pl.frame["fb"], f"{tag} steady launch",
                   "track_wedge_kernel")
    gib = peak_memory(tag)

    pix = perm[:n].contiguous()
    accf = torch.zeros(n, 4, device=dev)
    fbf = torch.zeros(n, dtype=torch.int32, device=dev)
    launch_w = lambda cost: fast.track_wedge(
        packed, loc, bands, lp, pix, accf, fbf, width=MAIN_W, height=MAIN_H,
        samples=MAIN_SPL, cost=cost)
    ms = time_cuda(lambda: launch_w(None), reps=3)
    extras = tracker_extras("track_wedge", tag, launch_w, perm, n)
    head = perm[:CHECK_LANES].contiguous()
    err, plain_ms, _ = compare_track_wedge(
        packed, loc, bands, lp, head, MAIN_W, MAIN_H, MAIN_SPL, True,
        f"{tag} first {CHECK_LANES} covered lanes")
    strided = strided_lanes(perm, n)
    err2, plain2, tier = compare_track_wedge(
        packed, loc, bands, lp, strided, MAIN_W, MAIN_H, MAIN_SPL, True,
        f"{tag} {CHECK_LANES} strided lanes", count=True)
    errs["track_wedge"] = max(errs.get("track_wedge", 0.0), err, err2)
    bnd = tier.bound("track_wedge", n, lambda c: packed.test[c, 14],
                     scale=n / strided.shape[0])
    print(f"time K9-w kernel {ms:.3f} ms ({MAIN_SPL} samples, {n} lanes, "
          f"{MAIN_W * MAIN_H * MAIN_SPL / (ms * 1e-3) / 1e6:.3f} Mray/s full "
          f"frame, no host copy); plain {plain_ms:.1f} ms on {CHECK_LANES} "
          f"lanes; bound {bnd[0]:.4f} ms ({bnd[1]}), the work of "
          f"{strided.shape[0]} strided lanes scaled by "
          f"{n / strided.shape[0]:.2f}")
    rows = []
    kernel_row(rows, counts, errs, "track_wedge", "cuda",
               "icon_rt_tpu_torch/csrc/track_wedge.cu",
               "icon_rt_tpu/ops/fast.py:451", ms, plain_ms, bnd,
               samples=MAIN_SPL, plain_lanes=CHECK_LANES,
               launch_ms=med, mray_s=mray, covered=covered,
               tf_edit_s=edit["opacity"] / 1e3, peak_gib=gib, **extras)
    del pl
    return counts, rows


def wedge_shell_holds(tag, cells, loc, w):
    """The wedge shell (`Wedges.shell`) against the plain wedge search run
    without it (`wedge_candidates`: every candidate column's window, Newton
    on each wedge), at the scene K9-p runs: on `shell_probes`' points
    (WEDGE_SHELL_COLUMNS seeded columns and the extreme ones, dense across
    their bottom and top faces and vertices, and both shell radii) no
    accepted point fails `in_wedge_shell`.  Raises if one does, or if the
    probes give fewer than 100 accepted points or none that the shell
    rejects; prints how close the accepted points come to the shell's
    edges."""
    import torch
    from icon_rt_tpu_torch.models.wedges import (in_wedge_shell,
                                                 shell_probes,
                                                 wedge_candidates)
    t0 = time.perf_counter()
    pos = shell_probes(w, WEDGE_SHELL_COLUMNS, seed=16)
    accepted = torch.cat([
        wedge_candidates(cells, w, loc, p)["hit"].flatten(1).any(1)
        for p in pos.split(8192)])
    inner = in_wedge_shell(w, pos)
    bad, n_acc = int((accepted & ~inner).sum()), int(accepted.sum())
    r = torch.linalg.vector_norm(pos[accepted].double(), dim=1)
    lo, hi = (float(x) for x in w.shell[:2])
    print(f"{tag} wedge shell held on {pos.shape[0]} probe points "
          f"({WEDGE_SHELL_COLUMNS} seeded columns): {n_acc} accepted by "
          f"the search without the shell test, {bad} of them outside it; "
          f"{int((~inner).sum())} rejected by it; accepted radii "
          f"[{float(r.min()):.3f}, {float(r.max()):.3f}] m in the shell "
          f"[{lo:.3f}, {hi:.3f}]; {time.perf_counter() - t0:.2f} s")
    if bad or n_acc < 100 or bool(inner.all()):
        raise AssertionError(f"{tag}: {bad} accepted points outside the "
                             f"wedge shell ({n_acc} accepted, "
                             f"{int((~inner).sum())} rejected)")


def main_parity_wedge(dev, raygen, errs):
    """`main accel w` / `main ae w`, BASELINE configs[2] (bench.py:945),
    and `main grid w`: the app with -mode 2 and --raygen accel
    --accel-mode sphere, --raygen ae, or --raygen accel --accel-mode grid,
    at subdiv 7 x 16 (the r2b7 scene), 1024x1024, the closeup
    camera, one sample per launch (W7_LIMIT launches), after every earlier
    table is freed: build seconds of cells, locator, wedges and the shell
    accel, ms per launch (fb on the host), Mray/s, coverage, peak memory,
    layer_pad and K9-p's launch count.  Returns (counts, the K9-p row's
    numbers, check): check() holds the wedge shell against the search
    without it (`wedge_shell_holds`), then K9-p against its plain version
    on WEDGE_CHECK_LANES seeded lanes spread over the frame, whose counted
    work, scaled to the frame, gives the bound."""
    import torch
    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.models import accel as accel_mod
    from icon_rt_tpu_torch.ops import render
    tag = {"ae": "main ae w", "sphere": "main accel w",
           "grid": "main grid w"}[raygen]
    name = f"parity_{raygen}_wedge"
    W = H = W7_W
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    pl = app.build(parity_argv(raygen, raygen, "wedge", W7_SUB, W7_LAYERS, W,
                               H, W7_LIMIT[raygen], f"chip_smoke_{raygen}_w"))
    build_s = time.perf_counter() - t0
    launch_ms = []
    run_loop(pl, launch_ms)
    pl.present()
    s = pl.scene
    w = s["get_wedges"]()
    secs = {k: round(v, 3) for k, v in s["timings"].items()}
    fb = pl.frame["fb"].cpu().numpy().view(np.uint32)
    covered = float(((fb >> 24) > 0).mean())
    if covered < 0.5 or not bool(torch.isfinite(pl.frame["accum"]).all()):
        raise AssertionError(f"{tag}: image covers {covered:.4f} (< 0.5) or "
                             f"accum is not finite")
    steady = np.array(launch_ms[1:])
    med = float(np.median(steady))
    spread = float((steady.max() - steady.min()) / med)
    print(f"{tag} subdiv {W7_SUB} x {W7_LAYERS} "
          f"({s['get_f32']()[0].num_cells} columns, {w.verts.shape[0]} "
          f"wedges, layer_pad {w.layer_pad}), {W}x{H}: build {build_s:.3f} "
          f"s (app.build: cells and locator), build seconds "
          f"{json.dumps(secs)} (wedges{' and the accel' if raygen != 'ae' else ''}"
          f" in the first launch); {len(launch_ms)} launches of 1 sample, ms "
          f"{[round(x, 3) for x in launch_ms]}; steady median {med:.3f} ms,"
          f" spread {spread:.3f}: {W * H / (med * 1e-3) / 1e6:.3f} Mray/s "
          f"full frame (fb copied to the host); covered {covered:.4f}")
    counts = {name: render.launches[name]}
    if raygen != "ae":
        counts["max_opacity"] = accel_mod.launches
    require_counts(tag, counts)
    if counts[name] != len(launch_ms):
        raise AssertionError(f"{tag}: K9-p launched {counts[name]} times in "
                             f"{len(launch_ms)} launches")
    cells, loc = s["get_f32"]()
    tf = s["tf"]()
    accel = s["get_accel"](raygen) if raygen != "ae" else None
    tabs = dict(cells=cells, loc=loc, tf=tf, wedges=w,
                accel={} if accel is None else {raygen: accel})
    lp = launch_params_wh(pl, W, H)
    steady = lambda: render.parity_track(
        cells, tf, lp, pl.frame["accum"], pl.frame["fb"], width=W, height=H,
        raygen=raygen, sampler="wedge", locator=loc, accel=accel, wedges=w)
    ms = time_cuda(steady, reps=1 if raygen == "ae" else 3)
    dbg = torch.zeros(W * H, 2, dtype=torch.int32, device=dev)
    render.parity_track(cells, tf, with_id(lp, W7_LIMIT[raygen]),
                        pl.frame["accum"], pl.frame["fb"], width=W, height=H,
                        raygen=raygen, sampler="wedge", locator=loc,
                        accel=accel, wedges=w, debug=dbg)
    extra = parity_extras(tag, raygen, "wedge", steady, dbg)
    gib = peak_memory(tag)
    print(f"{tag} wedge shell [{float(w.shell[0]):.1f}, "
          f"{float(w.shell[1]):.1f}] m (the cells' [{float(cells.shell[0]):.1f}"
          f", {float(cells.shell[1]):.1f}])")
    row = dict(ms=ms, lanes=W * H, launch_ms=med, peak_gib=gib,
               layer_pad=w.layer_pad, covered=covered,
               mray_s=W * H / (med * 1e-3) / 1e6,
               wedge_shell=[float(x) for x in w.shell[:2]],
               build_s={**secs, "app_build": round(build_s, 3)}, **extra)
    del dbg
    n_chk = WEDGE_CHECK_LANES[raygen]
    # seeded lanes spread over the frame (a stride of W * H / n_chk, a
    # multiple of W, would take column 0 alone: rays beside the globe,
    # whose counted work scaled to the frame overstates the bound)
    g = torch.Generator().manual_seed(16)
    strided = torch.sort(torch.randperm(W * H, generator=g)[:n_chk])[0].to(
        device=dev, dtype=torch.int32).contiguous()
    del pl

    def check():
        wedge_shell_holds(tag, cells, loc, w)
        err, ps, ks, wk = compare_parity(
            f"{tag} K9-p on {n_chk} seeded lanes spread over the frame",
            tabs, lp, raygen, "wedge", strided, W, H, 1, count=True)
        errs[name] = max(errs.get(name, 0.0), err)
        bnd = parity_bound(raygen, "wedge", W * H, wk, W * H / n_chk)
        print(f"bound {name}: {bnd[0]:.4f} ms ({bnd[1]}), the work of "
              f"{n_chk} seeded lanes scaled by {W * H / n_chk:.1f}; the "
              f"wedge shell test rejects {shell_share(wk):.6f} of their "
              f"{wk['eval']} samples")
        row.update(bnd=bnd, plain_ms=ps * 1e3, plain_lanes=n_chk,
                   ms_check_lanes=ks * 1e3, shell_share=shell_share(wk))
    return counts, row, check


def launch_params_wh(pl, width, height):
    """The launch parameters of an app pipeline of width x height at
    accum_id 0."""
    from icon_rt_tpu_torch.ops.render import make_launch_params
    s = pl.scene
    return make_launch_params(s["camera"].basis(width, height),
                              s["stats"].world_bounds_lo,
                              s["stats"].world_bounds_hi,
                              unit_distance=s["unit_distance"](),
                              device=pl.frame["accum"].device)


def check_parity_wedge(dev, errs):
    """`check parity` for the wedge sampler: K9-p x {ae, accel sphere,
    accel grid} against the plain version at subdiv 3 x 8, 64x64, the
    closeup camera, the app's unit distance, 2 samples, on
    WEDGE_CHECK_LANES lanes strided over the frame."""
    import torch
    from icon_rt_tpu_torch.data import synthetic
    from icon_rt_tpu_torch.models.wedges import build_wedges
    t0 = time.perf_counter()
    tabs, stats, _ = parity_tables(PARITY_SUB, PARITY_LAYERS, dev)
    tabs["wedges"] = build_wedges(synthetic.icosphere(PARITY_SUB,
                                                      PARITY_LAYERS),
                                  device=dev)
    W = H = 64
    lp = parity_lp(stats, W, H, dev)
    print(f"check parity wedge scene subdiv {PARITY_SUB} x {PARITY_LAYERS}, "
          f"{W}x{H}, layer_pad {tabs['wedges'].layer_pad}")
    for raygen in PARITY_RAYGENS:
        n = WEDGE_CHECK_LANES[raygen]
        pix = torch.arange(0, W * H, W * H // n, dtype=torch.int32,
                           device=dev)
        err, _, _, _ = compare_parity(
            f"check parity {n} strided lanes", tabs, lp, raygen, "wedge",
            pix, W, H, PARITY_SAMPLES)
        name = f"parity_{raygen}_wedge"
        errs[name] = max(errs.get(name, 0.0), err)
    print(f"check parity wedge {time.perf_counter() - t0:.1f} s")


def wedge_rows(w_rows, p_rows, k9n, errs, counts):
    """The kernels line's K9-p rows (from `main accel w`, `main ae w` and
    `main grid w`) and the K9-n row (no app path launches it: 0 launches
    on the main path; its numbers come from `check w`)."""
    rows = list(w_rows)
    for raygen, r in p_rows.items():
        r = dict(r)
        kernel_row(rows, counts, errs, f"parity_{raygen}_wedge", "cuda",
                   "icon_rt_tpu_torch/csrc/parity.cu",
                   "icon_rt_tpu/models/wedges.py:104", r.pop("ms"),
                   r.pop("plain_ms"), r.pop("bnd"), **r)
    r = dict(k9n)
    bnd = r.pop(f"bnd_{UELEMS_FRAME}")
    r.update({f"bound_ms_{UELEMS_FRAME}": bnd[0],
              f"bound_by_{UELEMS_FRAME}": bnd[1]})
    kernel_row(rows, {"uelems_points": 0}, errs, "uelems_points", "cuda",
               "icon_rt_tpu_torch/csrc/uelems.cu",
               "icon_rt_tpu/ops/uelems.py:126", r.pop("ms"),
               r.pop("plain_ms"), r.pop("bnd"),
               path="none: check w only (no app path calls it)", **r)
    return rows


# ===========================================================================
# Multi-device phases: K10, the tile x sample mesh, the scene shard and the
# time-animated R2B9 4K sequence (BASELINE configs[4])
# ===========================================================================

#: seconds a run of ranks may take before the phase fails
MD_TIMEOUT = 300
ANIM_W, ANIM_H, ANIM_SPF = 3840, 2160, 8   # BASELINE configs[4]'s frame
SLAB_SPP = 16                # main slabs: samples per run
SAMPLES_LAUNCHES = 4         # main samples: steps of 2 samples
#: lanes of the K10 checks: 1080p and 4K frames
K10_LANES = (MAIN_W * MAIN_H, ANIM_W * ANIM_H)
#: K10's bytes per lane by mode: what it reads and writes once (t 4, t_min
#: 4, win 4, ca 16, wrote 1, cand 4, the send buffers 16 / 20, accum 16 in
#: and 16 out, fb 4)
K10_BYTES = {"cand": 12, "payload": 44, "mean": 37, "first_hit": 57,
             "mean_fin": 56}
K10_REPLACES = ("icon_rt_tpu/parallel/scene_shard.py:162; "
                "icon_rt_tpu/parallel/sharded.py:243")


def k10_inputs(dev, L, D=3, seed=0):
    """Crafted K10 inputs of L lanes on the card: this slab's t with +inf
    lanes, t_min tied with it on every 5th lane and +inf on every 11th (no
    slab collides), random winners, NaN-free payloads, a reduced (L, 5)
    mean buffer with counts 0-2."""
    import torch
    g = torch.Generator().manual_seed(seed)
    t = torch.rand(L, generator=g)
    t[torch.rand(L, generator=g) < 0.3] = float("inf")
    t_min = torch.minimum(t, torch.rand(L, generator=g))
    t_min[::5] = t[::5]
    t_min[::11] = float("inf")
    t[::11] = float("inf")
    x = dict(t=t, t_min=t_min,
             win=torch.randint(0, D, (L,), generator=g, dtype=torch.int32),
             ca=torch.rand(L, 4, generator=g),
             wrote=torch.rand(L, generator=g) > 0.3,
             accum=torch.rand(L, 4, generator=g),
             fb=torch.randint(0, 2 ** 31 - 1, (L,), generator=g,
                              dtype=torch.int32),
             total=torch.cat([torch.rand(L, 4, generator=g) * 2,
                              torch.randint(0, 3, (L, 1), generator=g)
                              .float()], 1))
    return {k: v.to(dev) for k, v in x.items()}


def k10_calls(x, aid, copy=True):
    """{mode: (kernel call, plain call)} of K10 on inputs x; each call
    returns its outputs.  The finalizes update copies of x's accum and fb,
    or (copy=False, for timing) x's own in place."""
    from icon_rt_tpu_torch.ops import composite as c

    def fin(kernel, mode):
        def run():
            a, f = x["accum"], x["fb"]
            if copy:
                a, f = a.clone(), f.clone()
            if mode == c.FIRST_HIT and kernel:
                c.finalize_first_hit(x["ca"], x["t_min"], x["wrote"], a, f,
                                     aid)
            elif mode == c.FIRST_HIT:
                c._finalize_torch(mode, x["ca"], a, f, aid, t_min=x["t_min"],
                                  wrote=x["wrote"])
            elif kernel:
                c.finalize_mean(x["total"], a, f, aid)
            else:
                c._finalize_torch(mode, x["total"], a, f, aid)
            return a, f
        return run

    return {
        "cand": (lambda: c.select_candidates(x["t"], x["t_min"], 1, 3),
                 lambda: c._mask_torch(c.CAND, 1, 3, t=x["t"],
                                       t_min=x["t_min"])),
        "payload": (lambda: c.select_payload(x["t"], x["t_min"], x["win"],
                                             x["ca"], 1),
                    lambda: c._mask_torch(c.PAYLOAD, 1, 3, t=x["t"],
                                          t_min=x["t_min"], win=x["win"],
                                          ca=x["ca"])),
        "mean": (lambda: c.mean_payload(x["wrote"], x["ca"]),
                 lambda: c._mask_torch(c.MEAN, 0, 0, ca=x["ca"],
                                       wrote=x["wrote"])),
        "first_hit": (fin(True, c.FIRST_HIT), fin(False, c.FIRST_HIT)),
        "mean_fin": (fin(True, c.MEAN_FIN), fin(False, c.MEAN_FIN))}


def compare_raw(label, kern, plain, n, dev, salt):
    """K1/K2 raw mode with `salt` against the plain version on n lanes:
    wrote and t identical on >= 99.9%, the colour as the fb gate (identical
    on >= 99.9% of lanes) and within ACCUM_TOL.  Returns (max abs err, the
    kernel's RawSample)."""
    import torch
    from icon_rt_tpu_torch.ops.fast import alloc_raw
    rk, rp = alloc_raw(n, dev), alloc_raw(n, dev)
    kern(rk, salt)
    plain(rp, salt)
    torch.cuda.synchronize()
    same = float((rk.ca == rp.ca).all(1).float().mean())
    same_t = float((rk.t == rp.t).float().mean())
    err = float((rk.ca - rp.ca).abs().max())
    print(f"check composite {label} raw rng_salt={salt}: wrote "
          f"{'identical' if torch.equal(rk.wrote, rp.wrote) else 'DIFFER'}, "
          f"colour identical on {same:.6f} and t on {same_t:.6f} of {n} "
          f"lanes, colour max abs diff {err:.3e}")
    if not torch.equal(rk.wrote, rp.wrote) or same < 0.999 \
            or same_t < 0.999 or not err <= ACCUM_TOL:
        raise AssertionError(f"{label} raw mode disagrees with its plain "
                             f"version")
    return err, rk


def check_composite(sc, qtabs, dev):
    """`check composite`: K10's masks and finalizes against their plain
    versions on crafted inputs of K10_LANES lanes, exact; K1 and K2 in raw
    mode, with and without rng_salt, against their plain versions on the
    check scene; a raw sample through K10's mean finalize bit-equal to the
    finalizing launch of the same sample.  Returns {kernel: max abs err}."""
    import torch
    from icon_rt_tpu_torch.ops import composite, fast, fastq
    from icon_rt_tpu_torch.ops.render import alloc_frame
    t0 = time.perf_counter()
    aid = torch.tensor(3, dtype=torch.int32, device=dev)
    for L in K10_LANES:
        x = k10_inputs(dev, L, seed=L)
        for mode, (kern, plain) in k10_calls(x, aid).items():
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"check composite K10 {mode} on {L} lanes: "
                  f"{'bit-equal' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"K10 {mode} differs from its plain "
                                     f"version")
    q, loc, fm = qtabs
    n, size = sc.n_cov, sc.width
    pix = sc.perm[:n].contiguous()
    f32 = (sc.packed, sc.loc, sc.bands, sc.lp)
    qt = (q, loc, sc.bands, sc.tf, sc.lp)
    tiers = {
        "K1 track_f32": (
            lambda out, s: fast.track_f32(*f32, pix, None, None, width=size,
                                          height=size, rng_salt=s, out=out),
            lambda out, s: fast._render_frame_fast_torch(
                *f32, pix, None, None, size, size, 1, True, None,
                fast._F32Tier, s, out),
            lambda a, f: fast.track_f32(*f32, pix, a, f, width=size,
                                        height=size)),
        "K2 track_q": (
            lambda out, s: fastq.track_q(*qt, pix, None, None, width=size,
                                         height=size, finemap=fm,
                                         rng_salt=s, out=out),
            lambda out, s: fastq._render_frame_fast_q_torch(
                *qt, pix, None, None, size, size, 1, True, fm, None, s, out),
            lambda a, f: fastq.track_q(*qt, pix, a, f, width=size,
                                       height=size, finemap=fm))}
    errs = {"track_f32": 0.0, "track_q": 0.0}
    for (label, (kern, plain, launch)), name in zip(tiers.items(), errs):
        for salt in (0, 1, 2):
            err, rk = compare_raw(label, kern, plain, n, dev, salt)
            errs[name] = max(errs[name], err)
            if salt:
                continue
            a, f = (x[:n] for x in alloc_frame(size, size, device=dev))
            launch(a, f)
            ar, fr = (x[:n] for x in alloc_frame(size, size, device=dev))
            composite.finalize_mean(composite.mean_payload(rk.wrote, rk.ca),
                                    ar, fr, sc.lp.accum_id)
            same = torch.equal(a, ar) and torch.equal(f, fr)
            print(f"check composite {label}: the raw sample through K10's "
                  f"finalize and the finalizing launch "
                  f"{'bit-equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"{label}: raw + finalize differs from "
                                     f"the finalizing launch")
    errs.update(composite_mask=0.0, composite_finalize=0.0)
    print(f"check composite {time.perf_counter() - t0:.1f} s")
    return errs


def time_composite(dev, errs, counts):
    """K10's kernels and plain versions timed at the 1080p slab frame's
    lanes (CUDA events), each mode; the rows carry the slab path's modes
    (the payload mask, the first-hit finalize) and list the others."""
    import torch
    from icon_rt_tpu_torch.ops import composite
    L = MAIN_W * MAIN_H
    x = k10_inputs(dev, L, seed=1)
    aid = torch.tensor(3, dtype=torch.int32, device=dev)
    t = {}
    for mode, (kern, plain) in k10_calls(x, aid, copy=False).items():
        t[mode] = (time_cuda(kern, reps=50, warmup=3),
                   time_cuda(plain, reps=20, warmup=2),
                   bound(K10_BYTES[mode] * L, 0))
        print(f"time K10 {mode} ({L} lanes): kernel {t[mode][0]:.4f} ms, "
              f"plain {t[mode][1]:.4f} ms, bound {t[mode][2][0]:.4f} ms "
              f"(bytes)")
    rows = []
    for name, mode, others in (("composite_mask", "payload",
                                ("cand", "mean")),
                               ("composite_finalize", "first_hit",
                                ("mean_fin",))):
        occ = composite.composite_occupancy(name.split("_")[1])
        print(f"time K10 {name}: {occ['registers']} registers, "
              f"{occ['local_bytes']} local bytes, {occ['blocks_per_sm']} "
              f"blocks an SM")
        kernel_row(rows, counts, errs, name, "cuda",
                   "icon_rt_tpu_torch/csrc/composite.cu", K10_REPLACES,
                   t[mode][0], t[mode][1], t[mode][2], mode=mode, lanes=L,
                   other_modes={m: dict(ms=t[m][0], plain_ms=t[m][1],
                                        bound_ms=t[m][2][0])
                                for m in others}, **occ)
    return rows


def run_md(tag, job, world, backend, **kw):
    """run_ranks of `job` with kw on `world` new ranks over `backend`,
    printing the backend, the world size and how many cards they share.
    Returns the ranks' results."""
    import torch
    from icon_rt_tpu_torch.parallel import ranks
    cards = torch.cuda.device_count()
    print(f"{tag} backend {backend}, world size {world}, "
          f"{min(world, cards)} card(s) shared by {-(-world // cards)} "
          f"rank(s) each")
    rdv = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    t0 = time.perf_counter()
    try:
        out = ranks.run_ranks(functools.partial(job, **kw), world, backend,
                              timeout=MD_TIMEOUT, rendezvous_dir=rdv)
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    print(f"{tag} {world} rank(s) ran {time.perf_counter() - t0:.1f} s "
          f"(start, build and path)")
    return out


def sum_counts(results):
    out = {}
    for r in results:
        for k, v in r["counts"].items():
            out[k] = out.get(k, 0) + v
    return out


def main_anim(dev):
    """`main anim r2b9q 4k`: BASELINE configs[4] at full size --
    build_q_scene(11, 16), the closeup camera at 3840x2160, two timesteps
    (the second value_q halved on the card), ANIM_SPF samples per frame,
    the fine map on -- through data/animation.py `animate_fastq_sharded`:
    (a) one process, (b) tiles=1 over NCCL (world size 1), (c) tiles=2 over
    gloo (two ranks sharing the card, each with the whole scene).  The
    frames of (a), (b) and (c) bit-equal, the two timesteps different.
    Returns the launch counts of the three runs."""
    import torch
    from icon_rt_tpu_torch.ops.render import fb_to_image
    from icon_rt_tpu_torch.parallel import ranks
    from icon_rt_tpu_torch.utils.png import write_png
    tag = "main anim r2b9q 4k"
    W, H = ANIM_W, ANIM_H
    kw = dict(inputs=functools.partial(ranks.r2b9_animation, W, H),
              tier="q", width=W, height=H, samples_per_frame=ANIM_SPF,
              finemap=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"{tag} (a) one process, no process group")
    runs = {"a": [ranks.animate_job(0, 1, None, dev, mesh=False, **kw)]}
    torch.cuda.empty_cache()
    runs["b"] = run_md(f"{tag} (b)", ranks.animate_job, 1, "nccl", tiles=1,
                       **kw)
    runs["c"] = run_md(f"{tag} (c)", ranks.animate_job, 2, "gloo", tiles=2,
                       **kw)
    frames = runs["a"][0]["frames"]
    for name, rs in runs.items():
        for r, res in enumerate(rs):
            tm, n_f = res["timings"], len(frames)
            n_s = n_f * ANIM_SPF
            print(f"{tag} ({name}) rank {r}: build {res['build_s']:.2f} s; "
                  f"{res['seconds'] / n_f * 1e3:.1f} ms per frame "
                  f"({ANIM_SPF} samples; bake "
                  f"{tm['bake'] / n_f * 1e3:.2f} ms, order and deal "
                  f"{tm['order'] / n_f * 1e3:.2f} ms, K2 "
                  f"{tm['track'] / n_s * 1e3:.3f} ms per sample launch, "
                  f"gather and scatter {tm['gather'] / n_f * 1e3:.2f} ms); "
                  f"{W * H * n_s / res['seconds'] / 1e6:.1f} Mray/s; peak "
                  f"{res['peak_gib']:.2f} GiB")
        if name == "a":
            continue
        got = rs[0]["frames"]
        same = len(got) == 2 and all(np.array_equal(g, f)
                                     for g, f in zip(got, frames))
        verdict = "bit-equal to" if same else "DIFFER from"
        print(f"{tag} ({name}) frames {verdict} (a)'s")
        if not same:
            raise AssertionError(f"{tag}: run ({name}) differs from (a)")
    cov = [float(((f >> 24) > 0).mean()) for f in frames]
    differ = not np.array_equal(frames[0], frames[1])
    n_diff = int((frames[0] != frames[1]).sum())
    print(f"{tag} covered {cov[0]:.4f}, {cov[1]:.4f}; timesteps "
          f"{'differ' if differ else 'IDENTICAL'} ({n_diff} pixels)")
    if not differ or min(cov) < MIN_COVERED["closeup"]:
        raise AssertionError(f"{tag}: the timesteps do not differ or the "
                             f"image covers too little")
    os.makedirs(OUT_DIR, exist_ok=True)
    for t, f in enumerate(frames):
        write_png(os.path.join(OUT_DIR, f"chip_smoke_anim_t{t}.png"),
                  fb_to_image(f.view(np.int32), W, H))
    counts = sum_counts([r for rs in runs.values() for r in rs])
    require_counts(tag, {k: counts[k] for k in ("track_q", "bake_alpha_q",
                                                "chord_keys")})
    peak_memory(tag)
    return counts


def per_step(tag, tm, n, keys, unit="sample"):
    """Print the seconds per part of `tm` over n steps as ms per step."""
    print(f"{tag} ms per {unit}: " + ", ".join(
        f"{k} {tm.get(k, 0.0) / n * 1e3:.3f}" for k in keys))


def main_slabs(dev):
    """`main slabs`: the scene shard at subdiv 8 x 16, 1080p, closeup,
    quantized: D=2 slabs x 1 tile (two gloo ranks, with rank 0's unsharded
    K2 image of the same field), then 2 x 2 (four ranks); SLAB_SPP samples.
    The 2 x 2 accum and fb bit-equal to the 2 x 1 ones; the composite's
    coverage equal to the unsharded image's and its RMSE over covered
    pixels below 0.55 / sqrt(spp) (tests/test_scene_shard.py:100-104).
    Returns the launch counts of both runs."""
    from icon_rt_tpu_torch.parallel import ranks
    tag = "main slabs"
    W, H = MAIN_W, MAIN_H
    kw = dict(inputs=functools.partial(ranks.synthetic_scene, "slab",
                                       MAIN_SUB, MAIN_LAYERS, W, H),
              slabs=2, width=W, height=H, spp=SLAB_SPP)
    one = run_md(f"{tag} 2x1", ranks.slab_job, 2, "gloo", reference=True,
                 **kw)
    two = run_md(f"{tag} 2x2", ranks.slab_job, 4, "gloo", tiles=2, **kw)
    keys = ("track", "t_min", "cand", "payload", "composite")
    for name, rs in (("2x1", one), ("2x2", two)):
        for r, res in enumerate(rs):
            per_step(f"{tag} {name} rank {r} (build {res['build_s']:.1f} "
                       f"s, peak {res['peak_gib']:.2f} GiB)",
                       res["timings"], SLAB_SPP, keys)
    r0, r2 = one[0], two[0]
    print(f"{tag} K2 raw mode (rng_salt 1, one sample, slab 0 of 2): "
          f"{r0['k2_raw_ms']:.3f} ms per launch over {W * H} lanes (2x1), "
          f"{r2['k2_raw_ms']:.3f} ms over {W * H // 2} (2x2), CUDA events")
    same = np.array_equal(r0["accum"], r2["accum"]) \
        and np.array_equal(r0["fb"], r2["fb"])
    verdict = "bit-equal to" if same else "DIFFER from"
    print(f"{tag} 2x2 accum and fb {verdict} 2x1")
    acc, ref = r0["accum"], r0["ref_accum"]
    cov, cov_r = acc[:, 3] > 0, ref[:, 3] > 0
    rmse = float(np.sqrt(np.mean((acc[cov_r] - ref[cov_r]) ** 2)))
    limit = 0.55 / np.sqrt(SLAB_SPP)
    cov_same = np.array_equal(cov, cov_r)
    print(f"{tag} composite against the unsharded K2 image after "
          f"{SLAB_SPP} samples: coverage "
          f"{'equal' if cov_same else 'DIFFERS'} ({float(cov_r.mean()):.4f}),"
          f" RMSE {rmse:.5f} over covered pixels (bound {limit:.5f})")
    if not same or not cov_same or not rmse < limit \
            or not np.isfinite(acc).all():
        raise AssertionError(f"{tag}: the slab composite fails its checks")
    counts = sum_counts(one + two)
    require_counts(tag, {k: counts[k] for k in (
        "track_q", "composite_mask", "composite_finalize")})
    return counts


def main_samples(dev):
    """`main samples`: the samples axis on the f32 tier, subdiv 8 x 16,
    1080p, closeup: tiles=1 x samples=2 (two gloo ranks),
    SAMPLES_LAUNCHES steps.  Each rank's K10 mean composite equals the
    plain mean on the card; pixels every one of whose samples wrote equal
    the sequential frame of the same samples to accum 1e-6
    (icon_rt_tpu/parallel/sharded.py:14-20).  Returns the launch counts."""
    from icon_rt_tpu_torch.parallel import ranks
    tag = "main samples"
    rs = run_md(f"{tag} 1x2", ranks.samples_job, 2, "gloo",
                inputs=functools.partial(ranks.synthetic_scene, "f32",
                                         MAIN_SUB, MAIN_LAYERS, MAIN_W,
                                         MAIN_H),
                width=MAIN_W, height=MAIN_H, launches=SAMPLES_LAUNCHES,
                samples=2, reference=True)
    for r, res in enumerate(rs):
        per_step(f"{tag} rank {r} (build {res['build_s']:.1f} s, peak "
                 f"{res['peak_gib']:.2f} GiB)", res["timings"],
                 SAMPLES_LAUNCHES, ("track", "composite", "all_reduce"),
                 unit="step of 2 samples")
    r0 = rs[0]
    aw = r0["all_wrote"]
    err = float(np.abs(r0["accum"][aw] - r0["ref_accum"][aw]).max())
    equal = all(r["mean_equal"] for r in rs)
    verdict = "equals" if equal else "DIFFERS from"
    print(f"{tag} K10 mean composite {verdict} the plain mean on every "
          f"rank; {int(aw.sum())} pixels all of "
          f"whose {2 * SAMPLES_LAUNCHES} samples wrote: accum max abs diff "
          f"{err:.3e} against the sequential frame; fb differs on "
          f"{int((r0['fb'] != r0['ref_fb']).sum())} pixels (silhouettes)")
    if not equal or not err <= 1e-6 or aw.sum() < 0.5 * MAIN_W * MAIN_H:
        raise AssertionError(f"{tag}: the samples axis fails its checks")
    counts = sum_counts(rs)
    require_counts(tag, {k: counts[k] for k in (
        "track_f32", "composite_mask", "composite_finalize")})
    return counts


#: main mesh accel sphere and main mesh fast: steps of every layout
MESH_STEPS = 8
#: main mesh ae: steps (the AE raygen takes ~230 ms per 1080p launch)
MESH_AE_STEPS = 2
#: 8-bit RMSE per channel of a samples layout's image against the
#: sequential one (tests/test_sharded.py:359-396)
MESH_RMSE = 2.0
#: K8 raw mode's bytes per lane: pix read, wrote and colour written
PARITY_RAW_LANE_BYTES = 21
MESH_REPLACES = ("icon_rt_tpu/parallel/sharded.py:124 (frame_pixels_accel "
                 "without _finalize)")


def mesh_frames(tabs, raygen, n, width, height, dev, raw=False):
    """One process's frame of n samples (accum_id 0..n-1) of raygen
    ("sphere", "ae" or "fast") in natural order: the finalizing launches
    (render_frame_accel / render_frame_ae / render_frame_fast, one sample
    each) or, with `raw`, raw-mode launches each finalized by K10's mean
    over one rank (bit-equal to the finalizing launch: check parity raw,
    check composite), which also count the samples each pixel wrote.
    Returns numpy (accum, fb, wrote count or None)."""
    import torch
    from icon_rt_tpu_torch.ops import composite, render
    from icon_rt_tpu_torch.ops.fast import (alloc_raw, pack_cells,
                                            render_frame_fast, track_f32)
    L = width * height
    cells, tf, loc = tabs["cells"], tabs["tf"], tabs["loc"]
    accel = tabs["accel"].get(raygen)
    acc, fb = render.alloc_frame(width, height, device=dev)
    pix = torch.arange(L, dtype=torch.int32, device=dev)
    cnt = torch.zeros(L, dtype=torch.int32, device=dev)
    out = alloc_raw(L, dev) if raw else None
    packed = pack_cells(cells, tf) if raygen == "fast" else None
    kw = dict(width=width, height=height)
    for k in range(n):
        lpk = with_id(tabs["lp"], k)
        if raygen == "fast" and raw:
            track_f32(packed, loc, tabs["bands"], lpk, pix, None, None,
                      out=out, **kw)
        elif raygen == "fast":
            render_frame_fast(cells, packed, loc, tabs["bands"], lpk, acc,
                              fb, **kw)
        else:
            render.parity_track(cells, tf, lpk, None if raw else acc,
                                None if raw else fb, raygen=raygen,
                                sampler="locator", locator=loc, accel=accel,
                                out=out, **kw)
        if raw:
            cnt += out.wrote
            composite.finalize_mean(composite.mean_payload(out.wrote, out.ca),
                                    acc, fb, lpk.accum_id)
    return (acc.cpu().numpy(), fb.cpu().numpy(),
            cnt.cpu().numpy() if raw else None)


def mesh_report(tag, res, run, width, height):
    """Print a run of parity_job per rank: ms per step by part, the gather,
    Mray/s of the mesh (rank 0's clock) and peak GiB."""
    steps, n_s = run["steps"], run["samples"]
    for r, rr in enumerate(res):
        x = rr["runs"][run["i"]]
        tm = x["timings"]
        print(f"{tag} rank {r}: ms per step: " + ", ".join(
            f"{k} {tm.get(k, 0.0) / steps * 1e3:.3f}"
            for k in ("track", "composite", "all_reduce"))
            + f"; gather {tm['gather'] * 1e3:.2f} ms; "
            f"{width * height * n_s * steps / x['seconds'] / 1e6:.1f} "
            f"Mray/s ({steps} steps of {n_s} sample(s) over the frame in "
            f"{x['seconds'] * 1e3:.1f} ms); peak {x['peak_gib']:.3f} GiB "
            f"(build {rr['build_s']:.1f} s)")


def mesh_gate_equal(tag, x, ref):
    """A tile layout's gathered frame bit-equal to one process's."""
    same = np.array_equal(x["accum"], ref[0]) and np.array_equal(x["fb"],
                                                                 ref[1])
    print(f"{tag}: fb and accum {'bit-equal to' if same else 'DIFFER from'}"
          f" one process's frame")
    if not same:
        raise AssertionError(f"{tag}: the tile layout differs from one "
                             f"process")


def mesh_gate_samples(tag, x, seq, width, height):
    """A samples layout against the sequential frame of the same samples:
    accum within 1e-6 where every sample wrote, the same coverage and the
    8-bit image within MESH_RMSE per channel (tests/test_sharded.py:359)."""
    from icon_rt_tpu_torch.ops.render import fb_to_image
    acc_s, fb_s, cnt = seq
    aw = cnt == cnt.max()
    err = float(np.abs(x["accum"][aw] - acc_s[aw]).max())
    img_m, img_s = fb_to_image(x["fb"], width, height), \
        fb_to_image(fb_s, width, height)
    cov_m, cov_s = img_m[..., 3] > 0, img_s[..., 3] > 0
    d = img_m.astype(np.float64) - img_s.astype(np.float64)
    rmse = np.sqrt((d * d).mean(axis=(0, 1)))
    print(f"{tag}: {int(aw.sum())} pixels all of whose {int(cnt.max())} "
          f"samples wrote, accum max abs diff {err:.3e} against the "
          f"sequential frame; coverage "
          f"{'equal' if np.array_equal(cov_m, cov_s) else 'DIFFERS'} "
          f"({float(cov_s.mean()):.4f}); 8-bit RMSE per channel "
          f"{[round(float(v), 4) for v in rmse]} (bound {MESH_RMSE}); fb "
          f"differs on {int((x['fb'] != fb_s).sum())} pixels")
    if not err <= 1e-6 or not np.array_equal(cov_m, cov_s) \
            or not rmse.max() < MESH_RMSE or aw.mean() < 0.5 \
            or cov_s.mean() < MIN_COVERED["closeup"]:
        raise AssertionError(f"{tag}: the samples layout fails its gates")


def main_mesh(dev, path, errs, work):
    """`main mesh accel sphere`, `main mesh ae`, `main mesh fast`:
    parallel/sharded.py `render_frame_sharded` (ranks.py `parity_job`) on
    the tables that main accel sphere saved at `path` (subdiv 8 x 16, the
    closeup camera at 1080p, the locator sampler, the ShellAccel; each
    rank loads them).  Sphere, MESH_STEPS steps: one process, NCCL world 1
    and gloo tiles 2 x samples 1 bit-equal to one process's
    render_frame_accel; gloo tiles 1 x samples 2 against the sequential
    frame of the same samples.  AE, MESH_AE_STEPS steps on gloo 2 x 1,
    bit-equal to render_frame_ae.  Fast (K1), MESH_STEPS steps: gloo 2 x 1
    bit-equal to render_frame_fast, gloo 2 x 2 against the sequential
    frame.  Then K8's raw mode timed at the frame and held against its
    plain version on CHECK_LANES strided lanes; `work` is the main accel
    sphere row's counted work for its bound.  Returns (launch counts of
    every run, the raw row's numbers)."""
    import torch
    from icon_rt_tpu_torch.ops import render
    from icon_rt_tpu_torch.ops.fast import alloc_raw
    from icon_rt_tpu_torch.ops.render import fb_to_image
    from icon_rt_tpu_torch.parallel import ranks
    from icon_rt_tpu_torch.utils.png import write_png
    W, H = MAIN_W, MAIN_H
    sphere = dict(raygen="accel", accel_mode="sphere", steps=MESH_STEPS)
    ae = dict(raygen="ae", steps=MESH_AE_STEPS)
    fast = dict(raygen="fast", steps=MESH_STEPS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tabs = ranks.saved(path, dev)
    print(f"main mesh tables loaded in {time.perf_counter() - t0:.2f} s")
    ref = {g: mesh_frames(tabs, g, steps, W, H, dev) for g, steps in (
        ("sphere", MESH_STEPS), ("ae", MESH_AE_STEPS), ("fast", MESH_STEPS))}
    seq = {g: mesh_frames(tabs, g, 2 * MESH_STEPS, W, H, dev, raw=True)
           for g in ("sphere", "fast")}
    inputs = functools.partial(ranks.saved, path)
    kw = dict(inputs=inputs, width=W, height=H)
    one_runs = [dict(sphere, tiles=1, samples=1, i=0),
                dict(ae, tiles=1, samples=1, i=1),
                dict(fast, tiles=1, samples=1, i=2)]
    one = [ranks.parity_job(0, 1, None, dev, mesh=False, runs=one_runs,
                            **kw)]
    nccl_runs = [dict(sphere, tiles=1, samples=1, i=0)]
    nccl = run_md("main mesh accel sphere NCCL world 1", ranks.parity_job, 1,
                  "nccl", runs=nccl_runs, **kw)
    gloo2_runs = [dict(sphere, tiles=2, samples=1, i=0),
                  dict(sphere, tiles=1, samples=2, i=1),
                  dict(ae, tiles=2, samples=1, i=2),
                  dict(fast, tiles=2, samples=1, i=3)]
    gloo2 = run_md("main mesh gloo 2 ranks", ranks.parity_job, 2, "gloo",
                   runs=gloo2_runs, **kw)
    gloo4_runs = [dict(fast, tiles=2, samples=2, i=0)]
    gloo4 = run_md("main mesh fast gloo 4 ranks", ranks.parity_job, 4,
                   "gloo", runs=gloo4_runs, **kw)
    checks = (
        ("main mesh accel sphere one process", one, one_runs[0], "sphere"),
        ("main mesh accel sphere NCCL world 1", nccl, nccl_runs[0],
         "sphere"),
        ("main mesh accel sphere gloo tiles 2 x samples 1", gloo2,
         gloo2_runs[0], "sphere"),
        ("main mesh accel sphere gloo tiles 1 x samples 2", gloo2,
         gloo2_runs[1], "sphere seq"),
        ("main mesh ae one process", one, one_runs[1], "ae"),
        ("main mesh ae gloo tiles 2 x samples 1", gloo2, gloo2_runs[2],
         "ae"),
        ("main mesh fast one process", one, one_runs[2], "fast"),
        ("main mesh fast gloo tiles 2 x samples 1", gloo2, gloo2_runs[3],
         "fast"),
        ("main mesh fast gloo tiles 2 x samples 2", gloo4, gloo4_runs[0],
         "fast seq"))
    for tag, res, run, gate in checks:
        mesh_report(tag, res, run, W, H)
        x = res[0]["runs"][run["i"]]
        if not np.isfinite(x["accum"]).all():
            raise AssertionError(f"{tag}: accum is not finite")
        if gate.endswith("seq"):
            mesh_gate_samples(tag, x, seq[gate.split()[0]], W, H)
        else:
            mesh_gate_equal(tag, x, ref[gate])
    os.makedirs(OUT_DIR, exist_ok=True)
    write_png(os.path.join(OUT_DIR, "chip_smoke_mesh_sphere.png"),
              fb_to_image(gloo2[0]["runs"][1]["fb"], W, H))
    counts = sum_counts([x for res in (nccl, gloo2, gloo4)
                         for rr in res for x in rr["runs"]])
    require_counts("main mesh", {k: counts[k] for k in (
        "parity_sphere_locator", "parity_sphere_locator_raw",
        "parity_ae_locator", "track_f32", "composite_mask",
        "composite_finalize")})

    # K8's raw mode at the frame: the samples layout's launch
    name = "parity_sphere_locator_raw"
    acc, fb = render.alloc_frame(W, H, device=dev)
    raw = alloc_raw(W * H, dev)
    kw = dict(width=W, height=H, raygen="sphere", sampler="locator",
              locator=tabs["loc"], accel=tabs["accel"]["sphere"])
    cells, tf, lp = tabs["cells"], tabs["tf"], tabs["lp"]
    ms, ms_fin = time_turns(
        lambda: render.parity_track(cells, tf, lp, None, None, out=raw,
                                    **kw),
        lambda: render.parity_track(cells, tf, lp, acc, fb, **kw), reps=10)
    stride = W * H // CHECK_LANES
    strided = torch.arange(0, W * H, stride, dtype=torch.int32,
                           device=dev)[:CHECK_LANES].contiguous()
    err, ps, _ = check_parity_raw(
        f"main mesh K8 raw on {CHECK_LANES} lanes strided by {stride}",
        tabs, lp, "sphere", "locator", strided, W, H)
    errs[name] = max(errs.get(name, 0.0), err)
    bnd = parity_bound("sphere", "locator", W * H, work,
                       W * H / CHECK_LANES, lane_bytes=PARITY_RAW_LANE_BYTES)
    print(f"main mesh K8 raw sphere x locator at {W}x{H}: {ms:.4f} ms per "
          f"launch against {ms_fin:.4f} ms for the finalizing launch (CUDA "
          f"events, in turns); bound {bnd[0]:.4f} ms ({bnd[1]})")
    del tabs, raw, acc, fb
    torch.cuda.empty_cache()
    peak_memory("main mesh")
    return counts, dict(ms=ms, plain_ms=ps * 1e3, bnd=bnd, lanes=W * H,
                        plain_lanes=CHECK_LANES, finalize_ms=ms_fin)


# ---------------------------------------------------------------------------
# The app's interactive front and data ingest: the preview tier, --samples
# auto, the HTTP viewer, NetCDF -> convert_icon -> .ic at R2B7
# ---------------------------------------------------------------------------

PREVIEW_SCALE = 4           # --preview 4, the viewer's default
PREVIEW_REPS = 10           # preview launches timed by events
IC_SUB, IC_LEVELS = 7, 16   # scripts/e2e_netcdf.py's R2B7 x 16 levels
IC_SPL = 8                  # main ic r2b7: 8 samples in one launch
IC_STEADY = 3               # ... then 3 more launches of 8 timed


def counters():
    """{kernel: launches} of every counter of the port (dict counters by
    key), as zero_counters clears them."""
    from icon_rt_tpu_torch.data import device_scene
    from icon_rt_tpu_torch.models import accel, finemap, locator, qcells
    from icon_rt_tpu_torch.ops import (fast, fastq, march, order, render,
                                       uelems)
    out = {"max_opacity": accel.launches, "chord_keys": order.launches,
           "track_q": fastq.launches, "build_finemap": finemap.launches}
    for d in (fast.launches, qcells.launches, march.launches,
              device_scene.launches, locator.launches, render.launches,
              order.refine_launches, uelems.launches):
        out.update(d)
    return {k: v for k, v in out.items() if v}


def events_ms(call):
    """ms of `call()` by CUDA events, the device synchronized after it."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def turn_camera(cam, degrees):
    """A camera move: the eye turned about the z axis through the point of
    interest."""
    a = np.deg2rad(degrees)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    poi = np.asarray(cam.get_poi(), np.float32)
    eye = rot @ (np.asarray(cam.position, np.float32) - poi) + poi
    cam.set_orientation(eye, poi, np.asarray(cam.up_vector, np.float32),
                        cam.fovy)


def full_frame_launch(pl, lp, samples):
    """One launch of the app's fast path at full res as after a reset: K6's
    order, then K1 or K2 over the covered lanes into a new frame, the fb
    copied to the host and unpermuted.  Returns the host fb."""
    from icon_rt_tpu_torch.ops.fast import render_frame_fast
    from icon_rt_tpu_torch.ops.fastq import render_frame_fast_q
    from icon_rt_tpu_torch.ops.order import inverse_order, pixel_order
    from icon_rt_tpu_torch.ops.render import alloc_frame
    s = pl.scene
    st = s["stats"]
    perm, n = pixel_order(lp, st.spherical_bounds_lo[0],
                          st.spherical_bounds_hi[0], MAIN_W, MAIN_H)
    acc, fb = alloc_frame(MAIN_W, MAIN_H, device=lp.accum_id.device)
    kw = dict(width=MAIN_W, height=MAIN_H, pixel_perm=perm, n_active=n,
              samples=samples)
    if s["cells"] is None:
        q, loc, _ = s["get_q"]()
        render_frame_fast_q(q, loc, s["get_bands"](), s["tf"](), lp, acc, fb,
                            finemap=s["fm"](), **kw)
    else:
        render_frame_fast(s["cells"], s["get_packed"](), s["locator"],
                          s["get_bands"](), lp, acc, fb, **kw)
    return fb.cpu().numpy()[inverse_order(perm.cpu().numpy())]


def main_preview(pl, errs, quantized=False):
    """--preview 4 on a main path's pipeline (f32, or --quantized with the
    fine map): after a camera move and a reset, the preview launch renders
    one sample at 480x270 through K6 and K1 (K2) on K6's covered lanes; K1
    (K2) held against its plain version on those lanes, the presented fb
    (1920x1080, constant 4x4 blocks) equal to the plain version's frame
    upscaled; frame_id still 0 after is_running() (fault F2 not copied);
    the next full-res launch bit-equal to a launch of the same camera
    without a preview.  Prints the preview launch's ms (events, the fb on
    the host before the clock is read), the device time of K6 and K1 (K2)
    within it, and a full-res one-sample launch's ms beside it.  Leaves the
    pipeline's camera, sample limit and preview tier (off) as it found
    them.  Returns the phase's launch counts."""
    import torch
    from icon_rt_tpu_torch.ops.order import inverse_order, pixel_order
    tag = "main preview" + (" q" if quantized else "")
    s, st = pl.scene, pl.scene["stats"]
    sc = PREVIEW_SCALE
    wp, hp = MAIN_W // sc, MAIN_H // sc
    cam = s["camera"]
    saved = {k: np.copy(v) for k, v in vars(cam).items()}, pl.sample_limit
    pl.preview_scale, pl.sample_limit = sc, MAIN_LIMIT
    turn_camera(cam, 10.0)
    pl.reset_accumulation()
    zero_counters()
    torch.cuda.synchronize()
    ms = events_ms(pl.launch)
    counts = counters()
    fb = pl._last_fb
    if not isinstance(fb, np.ndarray) or fb.shape != (MAIN_W * MAIN_H,) \
            or pl.samples_per_launch != 0 or pl.preview_pending:
        raise AssertionError(f"{tag}: the launch after the reset is not a "
                             f"preview")
    blocks = fb.reshape(hp, sc, wp, sc)
    if not (blocks == blocks[:, :1, :, :1]).all():
        raise AssertionError(f"{tag}: the presented fb is not 4x4 blocks")
    tracker = "track_q" if quantized else "track_f32"
    if counts.get("chord_keys") != 1 or counts.get(tracker) != 1:
        raise AssertionError(f"{tag}: the preview launched {counts}")
    pl.is_running()
    if pl.frame_id != 0:
        raise AssertionError(f"{tag}: frame_id {pl.frame_id} after the "
                             f"preview (fault F2)")

    # the preview's inputs: its frame's lanes against the plain version
    lp = launch_params_wh(pl, wp, hp)
    perm, n = pixel_order(lp, st.spherical_bounds_lo[0],
                          st.spherical_bounds_hi[0], wp, hp)
    pix = perm[:n].contiguous()
    if quantized:
        q, loc, _ = s["get_q"]()
        err, _, _, fp = compare_track_q(
            (q, loc, s["get_bands"](), s["tf"]()), lp, pix, n, wp, hp, 1,
            True, s["fm"](), tag, return_fb=True)
    else:
        err, fp = compare_track_f32(
            (s["get_packed"](), s["locator"], s["get_bands"]()), lp, pix, wp,
            hp, 1, tag, return_fb=True)
    errs[tracker] = max(errs[tracker], err)
    small = fp.cpu().numpy()[inverse_order(perm.cpu().numpy())]
    plain = np.repeat(np.repeat(small.reshape(hp, wp), sc, axis=0), sc,
                      axis=1).ravel()
    same = float((plain == fb).mean())
    print(f"{tag} presented {MAIN_W}x{MAIN_H} fb against the plain version's "
          f"{wp}x{hp} frame upscaled: identical on {same:.6f} of the pixels; "
          f"{n} covered lanes of {wp * hp}")
    if same < 0.999:
        raise AssertionError(f"{tag}: the preview differs from its plain "
                             f"version")

    # the next launch does frame 0's work, as a run without a preview
    pl.launch()
    after = pl.frame["fb"].clone()
    pl.preview_scale = 0
    pl.reset_accumulation()
    pl.launch()
    if not torch.equal(after, pl.frame["fb"]):
        raise AssertionError(f"{tag}: the full-res launch after the preview "
                             f"differs from one without a preview")
    pl.preview_scale = sc

    def preview():
        pl.reset_accumulation()
        pl.launch()

    times = [events_ms(preview) for _ in range(PREVIEW_REPS)]
    kernel = f"{tracker}_kernel"
    wall, timeline = profile_window(preview, ("chord_keys_kernel", kernel),
                                    tag)
    dev_ms = {}
    for name, _, t in timeline:
        key = ("K6" if "chord_keys" in name else "K1/K2" if kernel in name
               else "other")
        dev_ms[key] = dev_ms.get(key, 0.0) + t
    busy = sum(dev_ms.values())
    lp_full = launch_params(pl)
    full = [events_ms(lambda: full_frame_launch(pl, lp_full, 1))
            for _ in range(PREVIEW_REPS)]
    print(f"{tag} preview launch ms (events, fb on the host) median "
          f"{np.median(times):.3f}, min {min(times):.3f}, max "
          f"{max(times):.3f}; profiled wall {wall:.3f} ms: K6 chord_keys "
          f"{dev_ms.get('K6', 0.0):.4f} ms, {kernel} "
          f"{dev_ms.get('K1/K2', 0.0):.4f} ms, other device "
          f"{dev_ms.get('other', 0.0):.4f} ms (the sort, copies), idle share "
          f"{1 - busy / wall:.3f}; a full-res one-sample launch as after a "
          f"reset (K6, {tracker} 1 sample, fb to the host, unpermuted) "
          f"median {np.median(full):.3f} ms, min {min(full):.3f}")
    print(f"{tag} launch counts {json.dumps(counts)} (the preview launch)")
    vars(cam).update(saved[0])
    pl.sample_limit, pl.preview_scale = saved[1], 0
    pl.reset_accumulation()
    return counts


def http_get(url, timeout=120):
    """(headers, body) of a GET, retrying the viewer's long-poll 204."""
    import urllib.request
    deadline = time.time() + timeout
    while True:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            if r.status != 204 or time.time() > deadline:
                return dict(r.headers), r.read()


def http_post(url, obj):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status


#: main viewer's events in order: (label, events posted, first frame a
#: preview); the drag comes last, so its converged frame is compared with a
#: direct render under the edited transfer function
VIEWER_EVENTS = [
    ("TFE stroke", [{"type": "tfe", "etype": e, "x": x, "y": 148,
                     "button": 0}
                    for e, x in [("down", 10)]
                    + [("move", x) for x in range(20, 150, 10)]
                    + [("up", 150)]], True),
    ("Raygen ae", [{"type": "param", "name": "Raygen", "value": "ae"}],
     False),
    ("Raygen fast", [{"type": "param", "name": "Raygen", "value": "fast"}],
     True),
    ("view drag", [{"type": "view", "etype": e, "x": x, "y": y, "button": 0,
                    "alt": False}
                   for e, x, y in (("down", 960, 540), ("move", 1060, 560),
                                   ("up", 1060, 560))], True),
]


def main_viewer(pl):
    """apps/viewer_torch.serve on the main path's f32 pipeline (127.0.0.1,
    port 0, preview 4 by default, sample limit 16 in launches of 8): the
    first frame, then a TFE stroke, the Raygen toggle to ae and back to
    fast, and a view drag, each posted while the viewer is idle.  Holds:
    each reset's first frame is a preview (ae: its first launch) with
    X-Accum-Id 0, the frames then advance to the sample limit, and the
    converged frame after the drag equals a direct render (K6, two K1
    launches of 8 samples) of the same camera, bit for bit.  Prints per
    event the edit latency, the first frame's launch and PNG-encode ms, the
    converged frame's, fps and Mray/s from /stats; the phase's launch
    counts on a line of their own."""
    import threading
    import torch
    sys.path.insert(0, os.path.join(ROOT, "apps"))
    import viewer_torch
    tag = "main viewer"
    pl.sample_limit, pl.preview_scale = MAIN_LIMIT, 0
    pl.reset_accumulation()
    log, held = [], {}
    present = pl.present_fn

    def logged(fb, w, h):       # on serve's loop thread, the fb on the host
        log.append((pl.frame_id, pl.samples_per_launch, pl.frame["natural"]))
        held["fb"] = fb
        present(fb, w, h)
    pl.present_fn = logged
    zero_counters()
    st = viewer_torch.ViewerState()
    th = threading.Thread(target=viewer_torch.serve, args=(pl,),
                          kwargs=dict(port=0, host="127.0.0.1", state=st),
                          daemon=True)
    t0 = time.perf_counter()
    th.start()

    def settled(fid):
        """The log entries after frame fid once the run they start has
        reached the sample limit and its last frame is published."""
        deadline = time.time() + 120
        while time.time() < deadline:
            new = log[fid + 1:]
            if new and new[-1][0] + new[-1][1] >= MAIN_LIMIT \
                    and st.frame_id == len(log) - 1:
                return new
            time.sleep(0.01)
        raise AssertionError(f"{tag}: no run reached the sample limit after "
                             f"frame {fid}: {log[fid + 1:]}")

    try:
        while not hasattr(st, "port"):
            if time.perf_counter() - t0 > 120 or not th.is_alive():
                raise AssertionError(f"{tag}: the server did not start")
            time.sleep(0.01)
        base = f"http://127.0.0.1:{st.port}"
        heads, png = http_get(base + "/frame.png?since=-1")
        first = settled(-1)
        print(f"{tag} first frame {heads['X-Launch-Ms']} ms launch, "
              f"{heads['X-Encode-Ms']} ms encode ({len(png)} B PNG); frames "
              f"{first} (frame_id, samples, preview)")
        if first != [(0, MAIN_SPL, False), (MAIN_SPL, MAIN_SPL, False)]:
            raise AssertionError(f"{tag}: the first run is {first}")
        for label, events, preview in VIEWER_EVENTS:
            fid = len(log) - 1
            got = {}
            waiter = threading.Thread(target=lambda: got.update(
                h=http_get(base + f"/frame.png?since={fid}")[0]))
            waiter.start()
            time.sleep(0.2)      # the long poll waits before the events
            for ev in events:
                http_post(base + "/event", ev)
            waiter.join(120)
            new = settled(fid)
            h = got["h"]
            full = [e for e in new if not e[2]]
            want = [(k, MAIN_SPL if preview else 1, False)
                    for k in range(0, MAIN_LIMIT,
                                   MAIN_SPL if preview else 1)]
            if int(h["X-Frame-Id"]) != fid + 1 or h["X-Accum-Id"] != "0" \
                    or new[0] != ((0, 0, True) if preview else want[0]) \
                    or full[-len(want):] != want:
                raise AssertionError(f"{tag} {label}: frames {new}, first "
                                     f"frame's headers {h}")
            stats = json.loads(http_get(base + "/stats")[1])
            print(f"{tag} {label}: edit latency {h['X-Edit-Latency-Ms']} ms "
                  f"to the first frame ({'a preview' if preview else 'K8'},"
                  f" X-Accum-Id {h['X-Accum-Id']}): launch "
                  f"{h['X-Launch-Ms']} ms, PNG encode {h['X-Encode-Ms']} ms;"
                  f" the converged frame: launch {stats['launch_ms']:.3f} ms,"
                  f" encode {stats['encode_ms']:.3f} ms; {stats['fps']:.2f} "
                  f"fps, {stats['mray']:.3f} Mray/s (/stats); {len(new)} "
                  f"frames {[e[:2] for e in new]}")
    finally:
        st.stop = True
        th.join(60)
        pl.present_fn = present
    counts = counters()
    print(f"{tag} launch counts {json.dumps(counts)}")
    for k in ("chord_keys", "track_f32", "classify_bake", "max_opacity",
              "parity_ae_locator"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{tag}: the viewer did not launch {k}")

    # the drag's converged frame against a direct render, the server gone
    from icon_rt_tpu_torch.ops.fast import render_frame_fast
    from icon_rt_tpu_torch.ops.order import pixel_order
    from icon_rt_tpu_torch.ops.render import alloc_frame
    s, sts = pl.scene, pl.scene["stats"]
    lp = launch_params(pl)
    perm, n = pixel_order(lp, sts.spherical_bounds_lo[0],
                          sts.spherical_bounds_hi[0], MAIN_W, MAIN_H)
    acc, fb = alloc_frame(MAIN_W, MAIN_H, device=lp.accum_id.device)
    for k in range(0, MAIN_LIMIT, MAIN_SPL):
        render_frame_fast(s["cells"], s["get_packed"](), s["locator"],
                          s["get_bands"](), with_id(lp, k), acc, fb,
                          width=MAIN_W, height=MAIN_H, pixel_perm=perm,
                          n_active=n, samples=MAIN_SPL)
    direct = fb.cpu().numpy()
    if not np.array_equal(direct, held["fb"]):
        raise AssertionError(f"{tag}: the converged frame after the drag "
                             f"differs from a direct render on "
                             f"{int((direct != held['fb']).sum())} pixels")
    print(f"{tag} the drag's converged frame equals a direct render of its "
          f"camera ({MAIN_LIMIT} samples), bit for bit; the phase "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def main_auto(dev, errs):
    """--samples auto on the main path's scene and camera (f32, sample limit
    16): launches of 1, 1, then the pick clamped to the limit; the probe
    (frame 1) is read once the card has finished (the stream idle when
    auto_spp is called, and the probe at least the device time, profiled,
    of a one-sample launch of the frame).  Prints the probe's seconds, the
    pick, the spl sequence and the covered share."""
    import torch
    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.ops.fast import render_frame_fast
    from icon_rt_tpu_torch.ops.render import alloc_frame
    from icon_rt_tpu_torch.utils import autosize
    tag = "main auto"
    probes = []
    pick = autosize.auto_spp

    def recorded(probe_s, *a, **k):
        probes.append((probe_s, torch.cuda.current_stream().query()))
        return pick(probe_s, *a, **k)

    zero_counters()
    autosize.auto_spp = recorded
    try:
        t0 = time.perf_counter()
        pl = app.build(main_argv(dev, "chip_smoke_auto", MAIN_LIMIT, "auto"))
        build_s = time.perf_counter() - t0
        seq, launch_ms = [], []
        while True:
            launch_ms.append(events_ms(lambda: (pl.launch(),
                                                pl._last_fb.cpu())))
            seq.append(pl.samples_per_launch)
            if not pl.is_running():
                break
    finally:
        autosize.auto_spp = pick
    counts = counters()
    spl = pl.scene["auto_spl"]()
    want, left = [1, 1], MAIN_LIMIT - 2
    while left:
        want.append(min(spl, left))
        left -= want[-1]
    if len(probes) != 1 or seq != want:
        raise AssertionError(f"{tag}: probes {probes}, launches {seq}, not "
                             f"{want}")
    probe_s, idle = probes[0]
    s, frame = pl.scene, pl.frame
    lp = with_id(launch_params(pl), 1)
    acc, fb = alloc_frame(MAIN_W, MAIN_H, device=dev)
    k1 = device_ms(lambda: render_frame_fast(
        s["cells"], s["get_packed"](), s["locator"], s["get_bands"](), lp,
        acc, fb, width=MAIN_W, height=MAIN_H, pixel_perm=frame["perm"],
        n_active=frame["n_active"], samples=1), 5, ("track_f32_kernel",),
        f"{tag} K1")
    fbh = frame["fb"].cpu().numpy().view(np.uint32)
    covered = float(((fbh >> 24) > 0).mean())
    print(f"{tag} build {build_s:.3f} s; probe {probe_s:.6f} s (frame 1, "
          f"read with the stream idle: {idle}; a one-sample launch of the "
          f"frame {k1:.4f} ms of device time) -> {spl} samples a launch at "
          f"AUTO_BUDGET_S {app.AUTO_BUDGET_S} s; launches {seq}, ms "
          f"{[round(x, 3) for x in launch_ms]}; covered share "
          f"{frame['n_active'] / (MAIN_W * MAIN_H):.4f} of the lanes, image "
          f"{covered:.4f}")
    if not idle or probe_s * 1e3 < k1:
        raise AssertionError(f"{tag}: the probe ({probe_s * 1e3:.4f} ms) was "
                             f"read before the card finished")
    if counts.get("track_f32") != len(seq):
        raise AssertionError(f"{tag}: {counts} in {len(seq)} launches")
    print(f"{tag} launch counts {json.dumps(counts)}")
    del pl
    return counts


def main_ic_r2b7(dev, errs):
    """NetCDF -> convert_icon -> .ic at R2B7 (scripts/e2e_netcdf_torch.py:
    327,680 columns x 16 levels, DWD layout, in a temporary directory), the
    .ic's columns and layers held against the HHL inputs, then the app on
    the .ic at 1080p (bench.py's closeup camera), f32 and --quantized with
    the fine map built into an empty cache: 8 samples in one launch, then
    3 launches of 8 timed; K1 and K2 against their plain versions on
    CHECK_LANES lanes strided over the covered prefix.  Prints the seconds
    of the write, the convert, the read and the build, ms per launch and
    peak memory."""
    import torch
    from icon_rt_tpu_torch import app
    from icon_rt_tpu_torch.data import bigscene, netcdf
    from icon_rt_tpu_torch.data.icfile import read_ic
    from icon_rt_tpu_torch.tools import convert_icon
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import e2e_netcdf_torch as e2e
    tag = "main ic r2b7"
    build_dir = os.path.join(ROOT, "icon_rt_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_ic_", dir=build_dir)
    cache = bigscene.CACHE_DIR
    bigscene.CACHE_DIR = os.path.join(work, "scenes")
    counts = {}
    try:
        t0 = time.perf_counter()
        inputs = e2e.make_netcdf_inputs(work, IC_SUB, IC_LEVELS)
        t1 = time.perf_counter()
        out = os.path.join(work, "r2b7")
        if convert_icon.main(e2e.convert_argv(inputs, out)) != 0:
            raise AssertionError(f"{tag}: convert_icon failed")
        t2 = time.perf_counter()
        ds = read_ic(out + ".ic")
        t3 = time.perf_counter()
        ncell = netcdf.Dataset(inputs[2][0]).dimensions["cell"]
        if ds.num_cells != ncell or ncell != 20 * 4 ** IC_SUB \
                or not (ds.num_layers == len(inputs[2]) - 1).all():
            raise AssertionError(f"{tag}: the .ic holds {ds.num_cells} "
                                 f"columns of {set(ds.num_layers.tolist())} "
                                 f"layers for {ncell} cells and "
                                 f"{len(inputs[2])} HHL levels")
        mb = sum(os.path.getsize(p) for p in
                 [inputs[0], inputs[1], *inputs[2], *inputs[3]]) / 1e6
        print(f"{tag} NetCDF write {t1 - t0:.3f} s ({mb:.1f} MB, "
              f"{len(inputs[2])} HHL + {len(inputs[3])} data files), "
              f"convert_icon {t2 - t1:.3f} s "
              f"({os.path.getsize(out + '.ic') / 1e6:.1f} MB .ic), read_ic "
              f"{t3 - t2:.3f} s: {ds.num_cells} columns of {IC_LEVELS} "
              f"layers")
        camera = e2e.camera_argv(ds, MAIN_W, MAIN_H)
        for quantized in (False, True):
            name = "chip_smoke_ic_r2b7" + ("q" if quantized else "")
            argv = [out + ".ic", "--device", dev.type, "--size", str(MAIN_W),
                    str(MAIN_H), "--sample-limit", str(IC_SPL), "--samples",
                    str(IC_SPL), *camera, "-o", os.path.join(OUT_DIR, name)]
            if quantized:
                argv.append("--quantized")
            label = tag + (" q" if quantized else "")
            zero_counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            pl = app.build(argv)
            build_s = time.perf_counter() - t0
            launch_ms = []
            run_loop(pl, launch_ms)
            pl.sample_limit = IC_SPL * (1 + IC_STEADY)
            run_loop(pl, launch_ms)
            pl.present()
            frame, s = pl.frame, pl.scene
            fbh = frame["fb"].cpu().numpy().view(np.uint32)
            covered = float(((fbh >> 24) > 0).mean())
            c, _ = read_counters(quantized, False)
            require_counts(label, c)
            counts.update({f"{k} ({'q' if quantized else 'f32'})": v
                           for k, v in c.items()})
            pix = strided_lanes(frame["perm"], frame["n_active"])
            lp = launch_params(pl)
            if quantized:
                q, loc, _ = s["get_q"]()
                err, _, _ = compare_track_q(
                    (q, loc, s["get_bands"](), s["tf"]()), lp, pix,
                    pix.shape[0], MAIN_W, MAIN_H, IC_SPL, True, s["fm"](),
                    f"{label} strided")
                errs["track_q"] = max(errs["track_q"], err)
            else:
                errs["track_f32"] = max(errs["track_f32"], compare_track_f32(
                    (s["get_packed"](), s["locator"], s["get_bands"]()), lp,
                    pix, MAIN_W, MAIN_H, IC_SPL, f"{label} strided"))
            steady = launch_ms[1:]
            built = ("the quantized tables, K7-loc and K7-fm in the first "
                     "launch" if quantized else "the f32 tables")
            print(f"{label} app build {build_s:.3f} s (read_ic, {built}); "
                  f"ms per launch of {IC_SPL} samples "
                  f"{[round(x, 3) for x in launch_ms]} (the first also "
                  f"bakes and orders the rays), steady median "
                  f"{np.median(steady):.3f}; image covered {covered:.4f} "
                  f"({frame['n_active']} covered lanes)")
            peak_memory(label)
            if covered < 0.5:
                raise AssertionError(f"{label}: the image covers only "
                                     f"{covered:.3f} of the frame")
            del pl, frame, s
            torch.cuda.empty_cache()
    finally:
        bigscene.CACHE_DIR = cache
        shutil.rmtree(work, ignore_errors=True)
    return counts


def build_all():
    """nvcc of every csrc/*.cu kernel, started together; prints seconds and
    the ptxas register/spill lines."""
    from icon_rt_tpu_torch.models.finemap import build_finemap_kernel
    from icon_rt_tpu_torch.ops.fast import build_track_f32
    from icon_rt_tpu_torch.ops.fastq import build_track_q
    from icon_rt_tpu_torch.ops.march import build_march
    from icon_rt_tpu_torch.data.device_scene import build_scene_kernel
    from icon_rt_tpu_torch.models.locator import build_locator_kernel
    from icon_rt_tpu_torch.ops.render import build_parity
    from icon_rt_tpu_torch.ops.uelems import build_uelems
    from icon_rt_tpu_torch.ops.composite import build_composite
    from icon_rt_tpu_torch.models.accel import build_majorant_kernel
    from icon_rt_tpu_torch.ops.order import build_order_kernel
    from icon_rt_tpu_torch.models.qcells import build_bake_q
    from icon_rt_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CU_SOURCES)) as ex:
        for f in [ex.submit(b) for b in (build_track_f32, build_track_q,
                                          build_finemap_kernel,
                                          build_march, build_scene_kernel,
                                          build_locator_kernel,
                                          build_parity,
                                          lambda: build_track_f32(
                                              "track_wedge"),
                                          build_uelems, build_composite,
                                          build_majorant_kernel,
                                          build_order_kernel, build_bake_q)]:
            f.result()
    for name in CU_SOURCES:
        info = cuda_build.info(name)
        print(f"build {name}.cu nvcc+load {info['seconds']:.2f} s")
        for line in ptxas_lines(info["log"]):
            print(f"build ptxas {name}: {line}")
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
    torch.cuda.reset_peak_memory_stats()
    build_all()
    t1 = time.perf_counter()
    errs, sc = check_kernels(dev)   # first Triton compiles happen in here
    q_errs, qtabs = check_q_kernels(sc, dev)
    errs.update(q_errs)
    errs.update(check_march(sc, qtabs, dev))
    w_errs, k9n = check_wedge(sc, dev)
    errs.update(w_errs)
    for k, v in check_composite(sc, qtabs, dev).items():
        errs[k] = max(errs.get(k, 0.0), v)
    del sc, qtabs
    print(f"build+check Triton compiles and checks "
          f"{time.perf_counter() - t1:.2f} s")
    peak_memory("check")

    pl, counts, _ = main_path(dev)
    rows = time_kernels(pl, errs, counts)
    profile_launch(pl)
    # the interactive front on the main path's pipeline: the preview tier,
    # then the HTTP viewer
    t0 = time.perf_counter()
    front = {"main preview": main_preview(pl, errs)}
    t1 = time.perf_counter()
    front["main viewer"] = main_viewer(pl)
    print(f"time main preview {t1 - t0:.1f} s, main viewer "
          f"{time.perf_counter() - t1:.1f} s")
    del pl
    torch.cuda.empty_cache()
    peak_memory("main")

    # the fast wedge tier (-mode 2) at the main path's scale
    t0 = time.perf_counter()
    counts_w, w_rows = main_wedge(dev, errs)
    torch.cuda.empty_cache()
    print(f"time main w {time.perf_counter() - t0:.1f} s")

    # the quantized paths build their fine map into an empty cache (K7-fm)
    bigscene.CACHE_DIR = tempfile.mkdtemp(
        prefix="chip_smoke_fmap_", dir=os.path.dirname(bigscene.CACHE_DIR))
    try:
        pl_q, counts_q, _ = main_path(dev, quantized=True)
        rows += time_q_kernels(pl_q, errs, counts_q)
        profile_launch(pl_q, quantized=True)
        # the preview before the TF edits, under the TF main preview has
        t0 = time.perf_counter()
        front["main preview q"] = main_preview(pl_q, errs, quantized=True)
        print(f"time main preview q {time.perf_counter() - t0:.1f} s")
        tf_edits(pl_q)
        del pl_q
        torch.cuda.empty_cache()
        peak_memory("main q")

        pl_m, counts_m, _ = main_path(dev, marching=True)
        pl_mq, counts_mq, _ = main_path(dev, quantized=True, marching=True)
        fm = bench_march(pl_mq)
        m_rows, counted = time_march_kernels(pl_m, pl_mq, fm, errs,
                                             counts_m, counts_mq)
        rows += m_rows
        profile_launch(pl_m, marching=True)
        profile_launch(pl_mq, quantized=True, marching=True)
        rows += time_march_cost(pl_m, pl_mq, errs, counted)
        del pl_m, pl_mq, fm
        torch.cuda.empty_cache()
        peak_memory("main m, main mq, bench m")
    finally:
        shutil.rmtree(bigscene.CACHE_DIR, ignore_errors=True)
    rmse_q(dev)
    torch.cuda.empty_cache()
    peak_memory("rmse_q")

    # --samples auto, and real-data ingest at R2B7
    t0 = time.perf_counter()
    front["main auto"] = main_auto(dev, errs)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    front["main ic r2b7"] = main_ic_r2b7(dev, errs)
    torch.cuda.empty_cache()
    print(f"time main auto {t1 - t0:.1f} s, main ic r2b7 "
          f"{time.perf_counter() - t1:.1f} s")
    print(f"front launch counts {json.dumps(front)}")

    # the R2B9 headline scene, every earlier table freed
    t0 = time.perf_counter()
    t9 = scene9(dev, errs)
    t1 = time.perf_counter()
    rows_q9 = []
    counts9 = main_r2b9q(dev, errs, rows=rows_q9)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    rows_m9 = main_r2b9m(dev, errs)
    torch.cuda.empty_cache()
    print(f"time R2B9 phases: scene9 {t1 - t0:.1f} s, main r2b9q "
          f"{t2 - t1:.1f} s, main r2b9m {time.perf_counter() - t2:.1f} s")
    rows += scene_rows(t9, errs, counts9) + rows_q9 + rows_m9

    # the mip tier of the reference's default framing, and the re-sort
    t0 = time.perf_counter()
    t9l = scene9lod(dev, errs)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    counts9v = main_r2b9q(dev, errs, framing="viewall")
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    counts_o, t_o = order_refine(dev, errs)
    torch.cuda.empty_cache()
    print(f"time LOD and re-sort phases: scene9lod {t1 - t0:.1f} s, main "
          f"r2b9qv {t2 - t1:.1f} s, order refine "
          f"{time.perf_counter() - t2:.1f} s")
    rows += lod_rows(t9l, t_o, errs, {**counts9v, **counts_o})
    next(r for r in rows if r["name"] == "chord_keys")["pixel_order_ms"] = \
        t_o["pixel_order"]

    # the reference-parity raygens (K8), every earlier table freed; the
    # plain versions' long loops come after every profile of the script
    t0 = time.perf_counter()
    counts_p, loc_rows, checks = {}, {}, []
    mesh_path = os.path.join(ROOT, "icon_rt_tpu_torch", "_build",
                             "chip_smoke_mesh_tables.pt")
    os.makedirs(os.path.dirname(mesh_path), exist_ok=True)
    for raygen in PARITY_RAYGENS:
        c, loc_rows[f"parity_{raygen}_locator"], chk = main_parity(
            dev, raygen, errs,
            mesh_path=mesh_path if raygen == "sphere" else None)
        counts_p.update(c)
        checks.append(chk)
        torch.cuda.empty_cache()
    counts_p.update(main_brute(dev))
    torch.cuda.empty_cache()
    # BASELINE configs[2] (the wedge sampler on the sphere accel and AE),
    # then the grid accel at the same scene
    t1 = time.perf_counter()
    p_rows, w_checks = {}, []
    for raygen in ("sphere", "ae", "grid"):
        c, p_rows[raygen], chk = main_parity_wedge(dev, raygen, errs)
        counts_p.update(c)
        w_checks.append(chk)
        torch.cuda.empty_cache()
    print(f"time main accel w, main ae w, main grid w "
          f"{time.perf_counter() - t1:.1f} s")
    brute_rows = check_parity(dev, errs)
    for chk in checks:
        chk()
    del checks
    t1 = time.perf_counter()
    check_parity_wedge(dev, errs)
    for chk in w_checks:
        chk()
    del w_checks
    print(f"time K9-p checks {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    peak_memory("check parity, the parity paths' checks")
    print(f"time parity phases {time.perf_counter() - t0:.1f} s")
    rows += parity_rows(loc_rows, brute_rows, errs, counts_p)
    # K5b at the grid accel's 256^3 bins, as main accel grid ran it
    k5b = loc_rows["parity_grid_locator"]["k5b"]
    errs["max_opacity_grid"] = 0.0             # held exact in main_parity
    kernel_row(rows, {"max_opacity_grid": k5b["launches"]}, errs,
               "max_opacity_grid", "cuda",
               "icon_rt_tpu_torch/csrc/majorant.cu",
               "icon_rt_tpu/models/accel.py:201", k5b["ms"],
               k5b["plain_ms"], k5b["bnd"], bins=k5b["bins"])
    rows += wedge_rows(w_rows, p_rows, k9n, errs, {**counts_p, **counts_w})

    # the multi-device phases, every earlier table freed; their ranks are
    # processes of their own (icon_rt_tpu_torch/parallel/ranks.py)
    t0 = time.perf_counter()
    main_anim(dev)
    t1 = time.perf_counter()
    counts_s = main_slabs(dev)
    t2 = time.perf_counter()
    counts_x = main_samples(dev)
    t3 = time.perf_counter()
    try:
        counts_mesh, raw_row = main_mesh(
            dev, mesh_path, errs, loc_rows["parity_sphere_locator"]["work"])
    finally:
        os.remove(mesh_path)
    t4 = time.perf_counter()
    rows += time_composite(dev, errs, {
        k: counts_s[k] + counts_x[k] + counts_mesh[k]
        for k in ("composite_mask", "composite_finalize")})
    kernel_row(rows, counts_mesh, errs, "parity_sphere_locator_raw", "cuda",
               "icon_rt_tpu_torch/csrc/parity.cu", MESH_REPLACES,
               raw_row.pop("ms"), raw_row.pop("plain_ms"),
               raw_row.pop("bnd"), **raw_row)
    print(f"time multi-device phases {time.perf_counter() - t0:.1f} s: main "
          f"anim r2b9q 4k {t1 - t0:.1f} s, main slabs {t2 - t1:.1f} s, main "
          f"samples {t3 - t2:.1f} s, main mesh {t4 - t3:.1f} s")
    for r in rows:              # the R2B9 checks ran after the first rows
        r["max_abs_err"] = errs[r["name"]]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
