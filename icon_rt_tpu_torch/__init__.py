"""icon_rt_tpu_torch — the PyTorch/CUDA port of icon_rt_tpu.

The same ICON direct-volume renderer (Woodcock tracking of scalar fields on
triangular prism columns, progressive accumulation, transfer-function
classification), written against PyTorch tensors with its hot device loops
as kernels written by hand for NVIDIA Hopper (sm_90a):

  K1+K4  ops/fast.py       track_f32      CUDA C++ (csrc/track_f32.cu)
  K2     ops/fastq.py      track_q        CUDA C++ (csrc/track_q.cu)
  K3     ops/march.py      march_f32, march_q        CUDA C++ (csrc/march.cu)
  K5a    ops/fast.py       classify_bake  Triton
  K5b    models/accel.py   max_opacity    CUDA C++ (csrc/majorant.cu)
  K5c-q  models/qcells.py  bake_lookup    CUDA C++ (csrc/bake_q.cu)
  K5c-f32 ops/fast.py      pack_alpha_scale_parts, apply_opacity_scale  Triton
  K6     ops/order.py      chord_keys     CUDA C++ (csrc/order.cu)
  K6b    ops/order.py      refine_keys, refine_perm  CUDA C++
                           (csrc/order.cu); repermute  Triton
  K7-fm  models/finemap.py build_finemap  CUDA C++ (csrc/finemap.cu)
  K7-scene data/device_scene.py scene_ancestors, scene_pass1, scene_pass2
         CUDA C++ (csrc/scene.cu; with field_lod > 0 the value-space mip
         tier)
  K7-loc models/locator.py locator_bins   CUDA C++ (csrc/locator.cu)
  K8     ops/render.py     parity_track   CUDA C++ (csrc/parity.cu)
  K9-w   ops/fast.py       track_wedge    CUDA C++ (csrc/track_wedge.cu)
  K9-p   ops/render.py     parity_track(sampler="wedge")  CUDA C++
         (csrc/parity.cu with the Newton of csrc/uelems.cuh)
  K9-n   ops/uelems.py     uelems_points  CUDA C++ (csrc/uelems.cu: one
         thread a point running the Newton of csrc/uelems.cuh; bool
         flags, optional out=)
  K10    ops/composite.py  composite_mask, composite_finalize  CUDA C++
         (csrc/composite.cu: the multi-device composites)

K1, K2 and K3 share the lane setup of csrc/track_common.cuh and the storage
tiers of csrc/tier_f32.cuh and csrc/tier_q.cuh; K1, K2 and K9-w (the wedge
tier, csrc/tier_wedge.cuh) also share its Woodcock tracking machine.  K3
is the deterministic march (the app's --march).  K8 is the
reference-parity raygens (--raygen ae / accel), the renderer's ground
truth; K9-p is K8 with the cuBQL mode's Newton wedge sampler (-mode 2),
and K9-n holds the Newton intersectors of all three element types
against their plain version.  K10 joins the ranks of a sharded frame
around `torch.distributed` collectives: the first hit over latitude slabs
and the mean over the samples axis, from K1's and K2's raw mode.

Every kernel has a plain-PyTorch version in the same module.  A wrapper
launches its kernel for a CUDA tensor and runs the plain version for a CPU
tensor; anything else raises.  This package never imports jax or
icon_rt_tpu (the JAX reference package beside it).

Layer map (bottom-up), mirroring icon_rt_tpu:
  utils/     — LCG, color, PNG, vector math, image metrics, native host
               module loader
  data/      — .ic IO, synthetic icosphere scenes, the north-star scene
               built on the device (build_q_scene), its LOD mip tiers
               (lod.py), the locator and fine-map caches, time series
               (animation.py)
  models/    — cells, quantized cells, transfer function, locator (dense
               and CSR), fine map, radial bands, majorant grids, wedges
  ops/       — camera, ray ordering and the measured-cost re-sort,
               launch params, the fast trackers
               (f32, quantized and wedge tiers), the march, the parity
               raygens (Woodcock tracking, majorant traversals) and the
               Newton intersectors of unstructured elements
  parallel/  — the tile x sample mesh (sharded.py), the latitude-slab
               scene shard (scene_shard.py), the ranks' launcher and jobs
               (ranks.py), over torch.distributed
  pipeline/  — frame loop, CLI flags, .xf IO, TF editor
  app.py     — the icon_rt application (apps/icon_rt_torch.py)
"""

__version__ = "0.1.0"
