// K2 `track_q`: radial-band Woodcock tracking of the quantized tier (u8
// values and alpha, u16-grid heights), with the fine-map-first locate and
// the frame epilogue fused in.
//
// Replaces the XLA-fused loops of icon_rt_tpu/ops/fastq.py: `_expand_test16`,
// `_locate_q`, `_test_and_fill`, `_refresh_q`, `_locate_q_fine`, `_shade_q`,
// `render_fast_q`, `render_fast_q_batch` and `render_frame_fast_q`, the
// shared machine of icon_rt_tpu/ops/fast.py (`step_core` with ml = a_off =
// Lm, `_init_lanes`, `_fill_slots`, `batch_loop`, `_two_stage_locate`),
// icon_rt_tpu/models/finemap.py `slots_to_cells` and
// icon_rt_tpu/models/transfunc.py `post_classify_packed`.  Its plain-PyTorch
// version is `_render_frame_fast_q_torch` in ops/fastq.py.  The per-lane
// machine (RNG stream, draw order, band stepping, slot-0 pinning, MRU rule,
// restarts, epilogue) is csrc/track_common.cuh, shared with K1.
//
// The tier (12-float storage rows, the two-stage locate, dequantization
// at the point of use in the JAX expression order, shading through the
// live LUT) is csrc/tier_q.cuh, shared with the quantized march K3.
//
// What bounds it on the H100: as K1, divergence and the latency of
// dependent random reads on a cache miss (fine-map row -> coarse bins row
// -> 4 candidate rows; on a fine-map miss the k_cap candidate rows).  The
// design is K1's (csrc/track_f32.cu; PERF.md): each slot's layer and its
// bracket of dequantized ceilings, a binary search over them on a miss
// that dequantizes only the ceilings it probes, the shade from the
// accepted layer's u8 value; slots keep cell ids and re-read their 48-byte
// test rows as three float4; the fine map's 4 slots come in one uint32;
// with __launch_bounds__(128, 9) the kernel takes 56 registers and 9
// blocks an SM (5 before, at 96 registers; 7 and 8 blocks were 2-8%
// slower at 1080p, subdiv 8, and within 0.3% at R2B9).
#include "tier_q.cuh"

namespace {

// the blocks an SM the kernel must fit (see above)
constexpr int kMinBlocks = 9;

__global__ void __launch_bounds__(128, kMinBlocks)
track_q_kernel(const TrackQParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.c.n_lanes) return;
  track::track_lane(p.c, QTier{p}, lane);
}

}  // namespace

// Launches the kernel on `stream` (PyTorch's current stream); allocates
// nothing and does not synchronise.  Returns cudaGetLastError().
extern "C" int track_q_launch(const TrackQParams* params, void* stream) {
  if (params->c.n_lanes <= 0) return 0;
  constexpr int kBlock = 128;
  const int grid = (params->c.n_lanes + kBlock - 1) / kBlock;
  track_q_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *params);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's blocks an SM, registers and local bytes (track::occupancy).
extern "C" int track_q_occupancy(int* out) {
  return track::occupancy(track_q_kernel, 128, out);
}
