// K9-w `track_wedge`: the reference's cuBQL mode (-mode 2) on the fast
// raygen -- radial-band Woodcock tracking on the wedge tier, with the frame
// epilogue (accumulate lerp, sRGB, RGBA8 pack) fused in.
//
// Replaces the XLA-fused loops of icon_rt_tpu/ops/fast.py with
// flat_vert=True: `step_core` :451 (its flat branch :507-513),
// `_test_and_fill_f32` :703 (:722-724), `_shade` :1445 (:1456-1460) and
// `render_frame_fast(sampler="wedge")` :1481.  Its plain-PyTorch version is
// `_track_torch` on `_WedgeTier` in ops/fast.py.  The per-lane machine is
// K1's (csrc/track_common.cuh); the storage tier is csrc/tier_wedge.cuh:
// the cached column holds n', containment and the layer pick compare
// s = dot(P, n') with the heights, the band traversal stays radial.  No
// fine-map primary.
//
// What bounds it on the H100: as K1, divergence and the dependent reads of
// a cache miss (bins row -> candidate test rows -> heights and alpha); the
// cached columns are 3 floats wider than K1's.  As K1's, each cache slot
// keeps its layer's bracket of ceilings, so an evaluation that stays in it
// reads nothing and the shade reads only the accepted layer's RGB.
#include "tier_wedge.cuh"

namespace {

// 8 resident blocks an SM: 64 registers and 48 bytes of stack; 10 and 12
// blocks (48, 40 registers) and the rows kept in registers at 8 ran
// 2.62-2.92 ms against 2.53 (PERF.md §6)
__global__ void __launch_bounds__(128, 8)
track_wedge_kernel(const TrackParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.c.n_lanes) return;
  track::track_lane(p.c, WedgeTier{p}, lane);
}

}  // namespace

// Launches the kernel on `stream` (PyTorch's current stream); allocates
// nothing and does not synchronise.  Returns cudaGetLastError().
extern "C" int track_wedge_launch(const TrackParams* params, void* stream) {
  if (params->c.n_lanes <= 0) return 0;
  constexpr int kBlock = 128;
  const int grid = (params->c.n_lanes + kBlock - 1) / kBlock;
  track_wedge_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *params);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's blocks an SM, registers and local bytes (track::occupancy).
extern "C" int track_wedge_occupancy(int* out) {
  return track::occupancy(track_wedge_kernel, 128, out);
}
