// K1+K4 `track_f32`: radial-band Woodcock tracking of the f32 fast tier,
// with the frame epilogue (accumulate lerp, sRGB, RGBA8 pack) fused in.
//
// Replaces the XLA-fused loops of icon_rt_tpu/ops/fast.py: `step_core`,
// `_raygen_soa`, `_init_lanes`, `_locate`, `_test_and_fill_f32`,
// `_fill_slots`, the `retire` step of `batch_loop`, `render_fast_batch`,
// `_shade` and `render_frame_fast`, plus icon_rt_tpu/ops/render.py
// `_finalize` and icon_rt_tpu/utils/color.py `linear_to_srgb`/`make_rgba`.
// Its plain-PyTorch version is `_render_frame_fast_torch` in ops/fast.py.
// The per-lane machine is csrc/track_common.cuh; this file is the f32
// storage tier: first containing candidate in bin order wins; the layer
// index is #(h < r) over the 32 inf-padded ceilings and index 32
// classifies to 0.
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
#include "track_common.cuh"

namespace {

constexpr int kLayers = 32;   // MAX_LAYERS
constexpr int kTestW = 16;    // packed test row
constexpr int kProfW = 64;    // heights | alpha
constexpr int kRgbW = 96;     // R | G | B

}  // namespace

// Mirror of `_TrackParams` in ops/fast.py (same field order).
struct TrackParams {
  TrackCommon c;
  const float* test;     // (N, 16)
  const float* prof;     // (N, 64)
  const float* rgb;      // (N, 96)
  const int32_t* bins;   // (n_lat * n_lon, k_cap), -1 padded
  float lat_lo, lat_hi, lon_lo, lon_hi;
  int n_lat, n_lon, k_cap;
};

namespace {

// Layer of radius r in a prof row (#(h < r) over the inf-padded heights),
// then the entry of that layer in `values` (0 above the top layer).
__device__ __forceinline__ float layer_pick(const float* heights,
                                            const float* values, float r) {
  int layer = 0;
#pragma unroll 8
  for (int k = 0; k < kLayers; ++k)
    layer += (r > __ldg(heights + k)) ? 1 : 0;
  return layer < kLayers ? __ldg(values + layer) : 0.0f;
}

struct F32Tier {
  // A cached column: 3 side planes and the radial bounds of its test row.
  struct Col {
    float pl[12];
    float h_bot, h_top;
  };
  const TrackParams& p;

  __device__ __forceinline__ void load(int c, Col& col) const {
    const float* row = p.test + static_cast<size_t>(c) * kTestW;
#pragma unroll
    for (int j = 0; j < 12; ++j) col.pl[j] = __ldg(row + j);
    col.h_bot = __ldg(row + 12);
    col.h_top = __ldg(row + 13);
  }

  __device__ __forceinline__ bool inside(const Col& c, float px, float py,
                                         float pz, float r) const {
    const float ev1 = c.pl[0] * px + c.pl[1] * py + c.pl[2] * pz - c.pl[3];
    const float ev2 = c.pl[4] * px + c.pl[5] * py + c.pl[6] * pz - c.pl[7];
    const float ev3 = c.pl[8] * px + c.pl[9] * py + c.pl[10] * pz - c.pl[11];
    return (r >= c.h_bot) && (r <= c.h_top) && (ev1 <= 0.0f) &&
           (ev2 <= 0.0f) && (ev3 <= 0.0f);
  }

  // Locator query: the first candidate of the point's bin (in bin order)
  // whose column contains the point, or -1.
  __device__ __forceinline__ int locate(float px, float py, float pz,
                                        float r, Col& col) const {
    const float lat = asinf(fminf(fmaxf(pz / r, -1.0f), 1.0f));
    const float lon = atan2f(py, px);
    const int bl = track::grid_bin(lat, p.lat_lo, p.lat_hi, p.n_lat);
    const int bo = track::grid_bin(lon, p.lon_lo, p.lon_hi, p.n_lon);
    const int32_t* cand =
        p.bins + static_cast<size_t>(bl * p.n_lon + bo) * p.k_cap;
    for (int k = 0; k < p.k_cap; ++k) {
      const int c = __ldg(cand + k);
      if (c < 0) continue;
      load(c, col);
      if (inside(col, px, py, pz, r)) return c;
    }
    return -1;
  }

  __device__ __forceinline__ float alpha(int cid, float r) const {
    const float* row = p.prof + static_cast<size_t>(cid) * kProfW;
    return layer_pick(row, row + kLayers, r);
  }

  __device__ __forceinline__ void shade(int cid, float r, float& cr,
                                        float& cg, float& cb) const {
    const float* heights = p.prof + static_cast<size_t>(cid) * kProfW;
    const float* rgb = p.rgb + static_cast<size_t>(cid) * kRgbW;
    cr = layer_pick(heights, rgb, r);
    cg = layer_pick(heights, rgb + kLayers, r);
    cb = layer_pick(heights, rgb + 2 * kLayers, r);
  }
};

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
