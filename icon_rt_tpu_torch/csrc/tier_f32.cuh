// The f32 storage tier of the fast kernels: K1+K4 `track_f32`
// (csrc/track_f32.cu) and the f32 march K3 (csrc/march.cu).
//
// A column is its packed test row (ops/fast.py `pack_test_rows`): three
// side planes (n, w), h_bot, h_top, float(num_layers), read as four
// float4.  The locate takes the first candidate of the point's locator bin
// (in bin order) whose column contains the point.  Per-layer data are the
// K5a bake: `prof` holds the 32 inf-padded ceilings then the classified
// alpha, `rgb` the classified R | G | B; the layer of radius r is #(h < r)
// and index 32 classifies to 0.  The trackers keep each cache slot's layer
// and its bracket of ceilings (`Layer`) and search a column only when r
// leaves it; the march reads its layers in order (csrc/march.cu).
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

  // the trackers' slots keep cell ids and re-read test rows (csrc/
  // track_common.cuh `contains`), so K1 fits 10 blocks an SM

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
    const float4* v = reinterpret_cast<const float4*>(row);
    const float4 a = __ldg(v), b = __ldg(v + 1), d = __ldg(v + 2),
                 e = __ldg(v + 3);
    col.pl[0] = a.x, col.pl[1] = a.y, col.pl[2] = a.z, col.pl[3] = a.w;
    col.pl[4] = b.x, col.pl[5] = b.y, col.pl[6] = b.z, col.pl[7] = b.w;
    col.pl[8] = d.x, col.pl[9] = d.y, col.pl[10] = d.z, col.pl[11] = d.w;
    col.h_bot = e.x;
    col.h_top = e.y;
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

  // A slot's cached layer: index l, its bracket (lo, hi] = (h[l - 1],
  // h[l]] (-inf below the first ceiling, +inf above the last) and its
  // classified alpha.  For ascending ceilings (models/cells.py
  // `check_ceilings`) every r in the bracket has #(h < r) = l.
  struct Layer {
    float lo, hi, a;
    int l;
  };

  // x if b, else y: field by field, so that both slots stay in registers
  static __device__ __forceinline__ Layer pick(bool b, const Layer& x,
                                               const Layer& y) {
    return Layer{b ? x.lo : y.lo, b ? x.hi : y.hi, b ? x.a : y.a,
                 b ? x.l : y.l};
  }

  static __device__ __forceinline__ void forget(Layer& lay) {
    lay.lo = __int_as_float(0x7f800000);   // no r is above +inf
    lay.hi = -lay.lo;
    lay.a = 0.0f;
    lay.l = 0;
  }

  // Classified alpha of coordinate r in column cid: from the slot's
  // bracket when r lies in it, else from the layer #(h < r) of the
  // column's prof row, found by binary search over its first num_layers
  // ceilings (the rest are +inf; num_layers is entry 14 of the column's
  // test row, kW floats wide), which refills the bracket.  The f32 and
  // wedge tiers' lookup.
  template <int kW>
  static __device__ __forceinline__ float bracket_alpha(const TrackParams& p,
                                                        int cid, float r,
                                                        Layer& lay) {
    if (lay.lo < r && r <= lay.hi) return lay.a;
    const float* row = p.prof + static_cast<size_t>(cid) * kProfW;
    const int n = min(max(static_cast<int>(__ldg(
                              p.test + static_cast<size_t>(cid) * kW + 14)),
                          0), kLayers);
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(row + mid) < r)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int l = lo;
    const float inf = __int_as_float(0x7f800000);
    lay.l = l;
    lay.lo = l > 0 ? __ldg(row + l - 1) : -inf;
    lay.hi = l < kLayers ? __ldg(row + l) : inf;
    lay.a = l < kLayers ? __ldg(row + kLayers + l) : 0.0f;
    return lay.a;
  }

  // The baked RGB of the layer of the slot's last `bracket_alpha`.
  static __device__ __forceinline__ void layer_rgb(const TrackParams& p,
                                                   int cid, const Layer& lay,
                                                   float& cr, float& cg,
                                                   float& cb) {
    const float* rgb = p.rgb + static_cast<size_t>(cid) * kRgbW;
    cr = cg = cb = 0.0f;
    if (lay.l < kLayers) {
      cr = __ldg(rgb + lay.l);
      cg = __ldg(rgb + kLayers + lay.l);
      cb = __ldg(rgb + 2 * kLayers + lay.l);
    }
  }

  __device__ __forceinline__ float alpha(int cid, float r, Layer& lay) const {
    return bracket_alpha<kTestW>(p, cid, r, lay);
  }

  // The baked RGB of the layer of alpha's last evaluation in the slot.
  __device__ __forceinline__ void shade(int cid, float, const Layer& lay,
                                        float& cr, float& cg,
                                        float& cb) const {
    layer_rgb(p, cid, lay, cr, cg, cb);
  }
};
