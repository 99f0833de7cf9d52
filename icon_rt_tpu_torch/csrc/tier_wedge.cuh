// The wedge storage tier of the fast kernels: K9-w `track_wedge`
// (csrc/track_wedge.cu), the reference's cuBQL mode on the fast raygen.
//
// The f32 tier (csrc/tier_f32.cuh) on the tables of ops/fast.py
// `pack_cells_wedge`: a column's test row is 32 floats wide, the f32 row in
// 0..14 and the flat-face normal n' in 16..18, and its per-layer alpha and
// RGB are the bake of the per-wedge constants bv.  A wedge's faces are
// flat, and the face of height h is {x : dot(x, n') = h}, so containment
// and the layer pick compare the coordinate s = dot(P, n') (summed x, y, z,
// as icon_rt_tpu/ops/fast.py `step_core(flat_vert=True)`) with the heights
// where the f32 tier compares the radius; the locate bins by the radius
// and tests each candidate at its own s.  Each cache slot keeps its
// layer's bracket of ceilings in s, as K1's slots do in r.
#pragma once

#include "tier_f32.cuh"

struct WedgeTier {
  static constexpr int kTestW = 32;    // ops/fast.py TEST_W_WEDGE

  // A cached column: the f32 tier's planes and heights, and n'.
  struct Col {
    float pl[12];
    float h_bot, h_top;
    float n[3];
  };
  const TrackParams& p;

  // the slots keep cell ids and re-read their rows at each test, as K1's
  // (csrc/track_common.cuh `contains`): with the layer bracket, rows kept
  // in registers took 123 registers (4 blocks an SM, 2.70 ms a 1080p
  // launch), re-read rows 64 at 8 blocks (track_wedge.cu's launch bounds,
  // 2.53 ms; PERF.md §6)

  __device__ __forceinline__ void load(int c, Col& col) const {
    const float* row = p.test + static_cast<size_t>(c) * kTestW;
#pragma unroll
    for (int j = 0; j < 12; ++j) col.pl[j] = __ldg(row + j);
    col.h_bot = __ldg(row + 12);
    col.h_top = __ldg(row + 13);
#pragma unroll
    for (int j = 0; j < 3; ++j) col.n[j] = __ldg(row + 16 + j);
  }

  // s = dot(P, n') of column c.
  __device__ __forceinline__ float coord(const Col& c, float px, float py,
                                         float pz, float) const {
    return px * c.n[0] + py * c.n[1] + pz * c.n[2];
  }

  __device__ __forceinline__ bool inside(const Col& c, float px, float py,
                                         float pz, float s) const {
    const float ev1 = c.pl[0] * px + c.pl[1] * py + c.pl[2] * pz - c.pl[3];
    const float ev2 = c.pl[4] * px + c.pl[5] * py + c.pl[6] * pz - c.pl[7];
    const float ev3 = c.pl[8] * px + c.pl[9] * py + c.pl[10] * pz - c.pl[11];
    return (s >= c.h_bot) && (s <= c.h_top) && (ev1 <= 0.0f) &&
           (ev2 <= 0.0f) && (ev3 <= 0.0f);
  }

  // Locator query: the first candidate of the point's bin (in bin order)
  // whose column contains the point at its own s, or -1.
  __device__ __forceinline__ int locate(float px, float py, float pz,
                                        float r, Col& col) const {
    const float lat = asinf(fminf(fmaxf(pz / r, -1.0f), 1.0f));
    const float lon = atan2f(py, px);
    const int bl = track::grid_bin(lat, p.lat_lo, p.lat_hi, p.n_lat);
    const int bo = track::grid_bin(lon, p.lon_lo, p.lon_hi, p.n_lon);
    const int32_t* row = p.bins + static_cast<size_t>(bl * p.n_lon + bo) *
                                      p.k_cap;
    for (int k = 0; k < p.k_cap; ++k) {
      const int c = __ldg(row + k);
      if (c < 0) continue;
      load(c, col);
      if (inside(col, px, py, pz, coord(col, px, py, pz, r))) return c;
    }
    return -1;
  }

  // Each slot keeps its layer's bracket of ceilings, as the f32 tier's
  // (`F32Tier::Layer`), in s: an evaluation whose s stays in it reads
  // nothing, a miss binary-searches the column's num_layers ceilings
  // (entry 14 of the 32-float test row), and the shade reads the accepted
  // layer's three entries.
  using Layer = F32Tier::Layer;
  static __device__ __forceinline__ Layer pick(bool b, const Layer& x,
                                               const Layer& y) {
    return F32Tier::pick(b, x, y);
  }
  static __device__ __forceinline__ void forget(Layer& lay) {
    F32Tier::forget(lay);
  }

  __device__ __forceinline__ float alpha(int cid, float s, Layer& lay) const {
    return F32Tier::bracket_alpha<kTestW>(p, cid, s, lay);
  }

  __device__ __forceinline__ void shade(int cid, float, const Layer& lay,
                                        float& cr, float& cg,
                                        float& cb) const {
    F32Tier::layer_rgb(p, cid, lay, cr, cg, cb);
  }
};
