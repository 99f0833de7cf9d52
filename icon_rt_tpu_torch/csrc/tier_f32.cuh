// The f32 storage tier of the fast kernels: K1+K4 `track_f32`
// (csrc/track_f32.cu) and the f32 march K3 (csrc/march.cu).
//
// A column is its packed test row (ops/fast.py `pack_test_rows`): three
// side planes (n, w), h_bot, h_top, float(num_layers).  The locate takes
// the first candidate of the point's locator bin (in bin order) whose
// column contains the point.  Per-layer data are the K5a bake: `prof`
// holds the 32 inf-padded ceilings then the classified alpha, `rgb` the
// classified R | G | B; the layer of radius r is #(h < r) and index 32
// classifies to 0.
#pragma once

#include "track_common.cuh"

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

struct F32Tier {
  static constexpr int kLayers = 32;   // MAX_LAYERS
  static constexpr int kTestW = 16;    // packed test row
  static constexpr int kProfW = 64;    // heights | alpha
  static constexpr int kRgbW = 96;     // R | G | B

  // A cached column: 3 side planes and the radial bounds of its test row.
  struct Col {
    float pl[12];
    float h_bot, h_top;
  };
  const TrackParams& p;

  // Layer of radius r in a prof row (#(h < r) over the inf-padded heights),
  // then the entry of that layer in `values` (0 above the top layer).
  static __device__ __forceinline__ float layer_pick(const float* heights,
                                                     const float* values,
                                                     float r) {
    int layer = 0;
#pragma unroll 8
    for (int k = 0; k < kLayers; ++k)
      layer += (r > __ldg(heights + k)) ? 1 : 0;
    return layer < kLayers ? __ldg(values + layer) : 0.0f;
  }

  __device__ __forceinline__ void load(int c, Col& col) const {
    const float* row = p.test + static_cast<size_t>(c) * kTestW;
#pragma unroll
    for (int j = 0; j < 12; ++j) col.pl[j] = __ldg(row + j);
    col.h_bot = __ldg(row + 12);
    col.h_top = __ldg(row + 13);
  }

  // Side plane j (0..2) of a column: normal and offset.
  static __device__ __forceinline__ void plane(const Col& c, int j, float& nx,
                                               float& ny, float& nz,
                                               float& w) {
    nx = c.pl[4 * j];
    ny = c.pl[4 * j + 1];
    nz = c.pl[4 * j + 2];
    w = c.pl[4 * j + 3];
  }

  // The coordinate a column's layers are looked up by: the radius.
  __device__ __forceinline__ float coord(const Col&, float, float, float,
                                         float r) const {
    return r;
  }

  __device__ __forceinline__ bool inside(const Col& c, float px, float py,
                                         float pz, float r) const {
    const float ev1 = c.pl[0] * px + c.pl[1] * py + c.pl[2] * pz - c.pl[3];
    const float ev2 = c.pl[4] * px + c.pl[5] * py + c.pl[6] * pz - c.pl[7];
    const float ev3 = c.pl[8] * px + c.pl[9] * py + c.pl[10] * pz - c.pl[11];
    return (r >= c.h_bot) && (r <= c.h_top) && (ev1 <= 0.0f) &&
           (ev2 <= 0.0f) && (ev3 <= 0.0f);
  }

  // Candidate k of locator bin `bid` (cell id, -1 = empty): the bin's
  // candidate rows, for the march's gap skip.
  __device__ __forceinline__ int cand(int bid, int k) const {
    return __ldg(p.bins + static_cast<size_t>(bid) * p.k_cap + k);
  }

  // Locator query: the first candidate of the point's bin (in bin order)
  // whose column contains the point, or -1; `bid` is the point's bin.
  __device__ __forceinline__ int locate(float px, float py, float pz,
                                        float r, Col& col, int& bid) const {
    const float lat = asinf(fminf(fmaxf(pz / r, -1.0f), 1.0f));
    const float lon = atan2f(py, px);
    const int bl = track::grid_bin(lat, p.lat_lo, p.lat_hi, p.n_lat);
    const int bo = track::grid_bin(lon, p.lon_lo, p.lon_hi, p.n_lon);
    bid = bl * p.n_lon + bo;
    for (int k = 0; k < p.k_cap; ++k) {
      const int c = cand(bid, k);
      if (c < 0) continue;
      load(c, col);
      if (inside(col, px, py, pz, r)) return c;
    }
    return -1;
  }

  __device__ __forceinline__ int locate(float px, float py, float pz,
                                        float r, Col& col) const {
    int bid;
    return locate(px, py, pz, r, col, bid);
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
