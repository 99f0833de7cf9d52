// K1+K4 `track_f32`: radial-band Woodcock tracking of the f32 fast tier,
// with the frame epilogue (accumulate lerp, sRGB, RGBA8 pack) fused in.
//
// Replaces the XLA-fused loops of icon_rt_tpu/ops/fast.py: `step_core`,
// `_raygen_soa`, `_init_lanes`, `_locate`, `_test_and_fill_f32`,
// `_fill_slots`, the `retire` step of `batch_loop`, `render_fast_batch`,
// `_shade` and `render_frame_fast`, plus icon_rt_tpu/ops/render.py
// `_finalize` and icon_rt_tpu/utils/color.py `linear_to_srgb`/`make_rgba`.
// Its plain-PyTorch version is `_render_frame_fast_torch` in ops/fast.py.
// The per-lane machine is csrc/track_common.cuh, the f32 storage tier
// csrc/tier_f32.cuh (first containing candidate in bin order wins; the
// layer index is #(h < r) over the 32 inf-padded ceilings and index 32
// classifies to 0).
//
// What bounds it on the H100.  Not arithmetic: a lane spends ~20 flops per
// step.  It is bound by divergence (lanes of a warp take different numbers
// of steps and only some of them miss the cache) and by the latency of
// dependent random reads on a miss (bins row -> K candidate test rows ->
// the winner's heights and alpha).  The pixel order from K6 groups lanes
// of similar chord length into warps, which trims the divergence.  This
// first version keeps the two cached columns' 14-float test rows and cell
// ids in registers and reads heights and alpha from the `prof` table
// through __ldg on every cached evaluation: the tables do not change
// during a launch, so that is value-identical to caching the 64-float
// rows, at the price of 32 L1/L2-resident loads per collision candidate.
// Keeping the rows in shared memory is the next step.
#include "tier_f32.cuh"

namespace {

__global__ void __launch_bounds__(128)
track_f32_kernel(const TrackParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.c.n_lanes) return;
  track::track_lane(p.c, F32Tier{p}, lane);
}

}  // namespace

// Launches the kernel on `stream` (PyTorch's current stream); allocates
// nothing and does not synchronise.  Returns cudaGetLastError().
extern "C" int track_f32_launch(const TrackParams* params, void* stream) {
  if (params->c.n_lanes <= 0) return 0;
  constexpr int kBlock = 128;
  const int grid = (params->c.n_lanes + kBlock - 1) / kBlock;
  track_f32_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *params);
  return static_cast<int>(cudaGetLastError());
}
