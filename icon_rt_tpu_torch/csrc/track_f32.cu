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
// of steps and only some of them miss the cache; 1.91 at 1080p, subdiv 8)
// and by the latency of dependent random reads (bins row -> candidate test
// rows -> the winner's ceilings and alpha), which only warps in flight
// hide.  The pixel order from K6 groups lanes of similar chord length into
// warps.  The design (PERF.md, each part measured in turns):
//   * each cache slot keeps the layer of its last evaluation, its alpha
//     and the bracket (h[l - 1], h[l]] of ceilings around it; an
//     evaluation inside the bracket reads nothing, any other
//     binary-searches the column's num_layers ceilings (at most 5-6
//     dependent loads, where the count over all 32 read 33), and the shade
//     reads the accepted layer's RGB (3 loads, where three counts read
//     99);
//   * a slot keeps its cell id, not its test row, which each containment
//     test re-reads as four float4 (L1 or L2 hits): with
//     __launch_bounds__(128, 10) the kernel takes 48 registers (80 bytes
//     of stack) and 10 blocks an SM, where 126 registers allowed 4; 8 and
//     12 blocks were slower;
//   * the frame's scalars are read on the card (csrc/track_common.cuh
//     `TrackFrame`), so a launch reads nothing back;
//   * the first band of a sample is a binary search over the band edges.
#include "tier_f32.cuh"

namespace {

// the blocks an SM the kernel must fit (see above)
constexpr int kMinBlocks = 10;

__global__ void __launch_bounds__(128, kMinBlocks)
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

// The kernel's blocks an SM, registers and local bytes (track::occupancy).
extern "C" int track_f32_occupancy(int* out) {
  return track::occupancy(track_f32_kernel, 128, out);
}
