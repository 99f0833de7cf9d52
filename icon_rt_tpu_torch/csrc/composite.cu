// K10: the multi-device composites, on either side of the collectives that
// join the ranks' samples (parallel/sharded.py, parallel/scene_shard.py).
//
// Replaces the XLA-fused loops of icon_rt_tpu/parallel/scene_shard.py
// `_argmin_select` (the first-hit select over latitude slabs) and the psum
// mean of the samples axis in icon_rt_tpu/parallel/sharded.py (:127-131,
// :243-248), each followed by icon_rt_tpu/ops/render.py `_finalize`.  Its
// plain-PyTorch versions are `_mask_torch` and `_finalize_torch` in
// ops/composite.py.
//
// `composite_mask` builds what a rank sends:
//   kCand     cand = (t == t_min) ? rank : n_ranks            (int32; MIN)
//   kPayload  send = (t == t_min && win == rank) ? ca : 0      (L, 4; SUM)
//   kMean     send = [wrote ? ca : 0, wrote ? 1 : 0]           (L, 5; SUM)
// so one all_reduce of the (L, 5) buffer carries both of JAX's psums.
// `composite_finalize` turns the reduced buffer into the sample and
// accumulates it:
//   kFirstHit ca = isfinite(t_min) ? sum : 0, written where `wrote` (the ray
//             met the shell; the same on every slab)
//   kMeanFin  ca = sum[:4] / max(n, 1), written where n = sum[4] > 0
// through the same `blend` and `store_pixel` device functions as K1/K2's
// epilogue (csrc/track_common.cuh), so the RGBA8 pack is the trackers' own
// code and equals `_finalize` bit for bit.
//
// What bounds it on the H100: bytes.  One thread per lane reads and writes
// each input and output once (12-57 bytes a lane) and does a handful of
// compares; chip_smoke.py times it beside the bytes at 3.35 TB/s.  The
// finalize reads the launch's sample id on the card, so a call reads
// nothing back to the host: with a host read (int(accum_id)) a 1080p call
// took ~0.09 ms around a 0.044 ms kernel.  Moving the rows as float4,
// 1-4 lanes a thread, and staging the mean mode's 20-byte rows through
// shared memory were measured and not kept: the kernel was as fast or
// slower (PERF.md).  Built with -fmad=false: the blend rounds each
// operation as eager PyTorch does.
#include "track_common.cuh"

// Mirror of `_CompositeParams` in ops/composite.py (same field order).
struct CompositeParams {
  const float* t;          // (L,) this rank's collision parameter
  const float* t_min;      // (L,) its minimum over the slabs
  const int32_t* win;      // (L,) the winning slab
  const float* ca;         // (L, 4) this rank's sample
  const uint8_t* wrote;    // (L,) the ray met the shell
  const float* sum;        // (L, 4) or (L, 5): the reduced send buffer
  int32_t* cand;           // (L,) out (kCand)
  float* send;             // (L, 4) or (L, 5) out (kPayload, kMean)
  float* accum;            // (L, 4) in/out (finalize)
  int32_t* fb;             // (L,) in/out (finalize)
  const int32_t* accum_id; // () the launch's sample id (finalize)
  int n_lanes, mode, rank, n_ranks;
};

namespace {

constexpr int kCand = 0, kPayload = 1, kMean = 2;   // composite_mask
constexpr int kFirstHit = 0, kMeanFin = 1;          // composite_finalize
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
composite_mask_kernel(const CompositeParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_lanes) return;
  if (p.mode == kCand) {
    p.cand[i] = p.t[i] == p.t_min[i] ? p.rank : p.n_ranks;
  } else if (p.mode == kPayload) {
    const bool mine = p.t[i] == p.t_min[i] && p.win[i] == p.rank;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      p.send[i * 4 + k] = mine ? p.ca[i * 4 + k] : 0.0f;
  } else {
    const bool w = p.wrote[i] != 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      p.send[i * 5 + k] = w ? p.ca[i * 4 + k] : 0.0f;
    p.send[i * 5 + 4] = w ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(kBlock)
composite_finalize_kernel(const CompositeParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_lanes) return;
  float c[4];
  bool w;
  if (p.mode == kFirstHit) {
    w = p.wrote[i] != 0;
    const bool got = isfinite(p.t_min[i]);
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = got ? p.sum[i * 4 + k] : 0.0f;
  } else {
    const float n = p.sum[i * 5 + 4];
    w = n > 0.0f;
    const float d = fmaxf(n, 1.0f);
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = p.sum[i * 5 + k] / d;
  }
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = p.accum[i * 4 + k];
  if (w) {
    const float sc = 1.0f / (static_cast<float>(__ldg(p.accum_id)) + 1.0f);
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = track::blend(sc, c[k], a[k]);
  }
  track::store_pixel(p.accum, p.fb, i, a[0], a[1], a[2], a[3], w);
}

int grid_of(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// Launch on `stream` (PyTorch's current stream); allocate nothing and do not
// synchronise.  Return cudaGetLastError().
extern "C" int composite_mask_launch(const CompositeParams* p, void* stream) {
  if (p->n_lanes <= 0) return 0;
  composite_mask_kernel<<<grid_of(p->n_lanes), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_finalize_launch(const CompositeParams* p,
                                         void* stream) {
  if (p->n_lanes <= 0) return 0;
  composite_finalize_kernel<<<grid_of(p->n_lanes), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// The resident 256-thread blocks an SM, registers and local bytes a
// thread (out[0..2]) of the mask (which 0) or the finalize (1).  Returns
// the first CUDA error.
extern "C" int composite_occupancy(int which, int* out) {
  return which == 0
             ? track::occupancy(composite_mask_kernel, kBlock, out)
             : track::occupancy(composite_finalize_kernel, kBlock, out);
}
