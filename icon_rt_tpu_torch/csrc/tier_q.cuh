// The quantized storage tier of the fast kernels: K2 `track_q`
// (csrc/track_q.cu) and the quantized march K3 (csrc/march.cu).
//
//   * a column is its 12-float storage row: 3 side-plane normals (the
//     planes pass through the origin, w == 0), h_bot, h_top, num_layers,
//     read as three float4;
//   * locate: with the fine map, the point's fine bin gives 4 u8 slots (one
//     uint32 load) into
//     the coarse locator row of the integer-divided parent bin; the first
//     slot whose column contains the point wins.  Otherwise (no fine map,
//     or no slot contains the point) the full coarse query over k_cap
//     candidates in row order runs -- the two-stage locate of
//     icon_rt_tpu/ops/fast.py `_two_stage_locate`, per lane;
//   * tables are dequantized at the point of use, in the JAX expression
//     order (icon_rt_tpu/ops/fastq.py:115-130), so the bits equal those of
//     JAX's cached f32 rows: h = h_bot + hf * ((h_top - h_bot) * (1/65535))
//     (+inf past num_layers), a = aq * (alpha_max / 255),
//     v = value_lo + vq * ((value_hi - value_lo) / 255);
//   * shading classifies the accepted layer's value through the live LUT
//     (postClassify with the reference's asymmetric lerp; RGB only, so the
//     opacity scale does not enter);
//   * the trackers keep each cache slot's layer and its bracket of
//     dequantized ceilings (`Layer`) and search a column only when r
//     leaves it, as the f32 tier.
#pragma once

#include "track_common.cuh"

// Mirror of `_TrackQParams` in ops/fastq.py (same field order).
struct TrackQParams {
  TrackCommon c;
  const float* test12;     // (N, 12)
  const float* hfrac;      // (1, Lm) shared or (N, Lm), f32 on the u16 grid
  const uint8_t* vq;       // (N, Lm)
  const uint8_t* aq;       // (N, Lm)
  const int32_t* bins;     // (n_lat * n_lon, k_cap), -1 padded
  const uint8_t* fslots;   // (f_lat * f_lon, 4), 255 = empty; unused if
                           // use_fine == 0
  const float* lut;        // (S, 4) live transfer function
  float value_lo, value_hi, alpha_max, tf_lo, tf_hi;
  float lat_lo, lat_hi, lon_lo, lon_hi;        // coarse locator window
  float f_lat_lo, f_lat_hi, f_lon_lo, f_lon_hi;  // fine-map window
  int hf_stride, lm, lut_size;
  int n_lat, n_lon, k_cap;
  int f_lat, f_lon, factor, use_fine;
};

struct QTier {
  static constexpr int kTestW = 12;    // storage test row
  static constexpr int kCand = 4;      // fine-map slots per bin
  static constexpr float kInv65535 = static_cast<float>(1.0 / 65535.0);

  struct Col {
    float n[9];
    float h_bot, h_top;
  };
  const TrackQParams& p;

  // the trackers' slots keep cell ids and re-read test rows (csrc/
  // track_common.cuh `contains`), so K2 fits 9 blocks an SM

  __device__ __forceinline__ void load(int c, Col& col) const {
    const float* row = p.test12 + static_cast<size_t>(c) * kTestW;
    const float4* v = reinterpret_cast<const float4*>(row);
    const float4 a = __ldg(v), b = __ldg(v + 1), d = __ldg(v + 2);
    col.n[0] = a.x, col.n[1] = a.y, col.n[2] = a.z, col.n[3] = a.w;
    col.n[4] = b.x, col.n[5] = b.y, col.n[6] = b.z, col.n[7] = b.w;
    col.n[8] = d.x;
    col.h_bot = d.y;
    col.h_top = d.z;
  }

  // Side plane j (0..2) of a column: normal and offset (0: the side planes
  // pass through the origin).
  static __device__ __forceinline__ void plane(const Col& c, int j, float& nx,
                                               float& ny, float& nz,
                                               float& w) {
    nx = c.n[3 * j];
    ny = c.n[3 * j + 1];
    nz = c.n[3 * j + 2];
    w = 0.0f;
  }

  // The coordinate a column's layers are looked up by: the radius.
  __device__ __forceinline__ float coord(const Col&, float, float, float,
                                         float r) const {
    return r;
  }

  __device__ __forceinline__ bool inside(const Col& c, float px, float py,
                                         float pz, float r) const {
    const float ev1 = c.n[0] * px + c.n[1] * py + c.n[2] * pz;
    const float ev2 = c.n[3] * px + c.n[4] * py + c.n[5] * pz;
    const float ev3 = c.n[6] * px + c.n[7] * py + c.n[8] * pz;
    return (r >= c.h_bot) && (r <= c.h_top) && (ev1 <= 0.0f) &&
           (ev2 <= 0.0f) && (ev3 <= 0.0f);
  }

  // Candidate k of coarse locator bin `bid` (cell id, -1 = empty): the
  // bin's candidate rows, for the march's gap skip.
  __device__ __forceinline__ int cand(int bid, int k) const {
    return __ldg(p.bins + static_cast<size_t>(bid) * p.k_cap + k);
  }

  // The two-stage locate; `bid` is the point's coarse bin.
  __device__ __forceinline__ int locate(float px, float py, float pz,
                                        float r, Col& col, int& bid) const {
    const float lat = asinf(fminf(fmaxf(pz / r, -1.0f), 1.0f));
    const float lon = atan2f(py, px);
    const int bl = track::grid_bin(lat, p.lat_lo, p.lat_hi, p.n_lat);
    const int bo = track::grid_bin(lon, p.lon_lo, p.lon_hi, p.n_lon);
    bid = bl * p.n_lon + bo;
    if (p.use_fine) {
      // stage 1: the fine bin's 4 slots, decoded through the coarse row of
      // its integer-divided parent bin (never a second f32 binning)
      const int fl = track::grid_bin(lat, p.f_lat_lo, p.f_lat_hi, p.f_lat);
      const int fo = track::grid_bin(lon, p.f_lon_lo, p.f_lon_hi, p.f_lon);
      // int: f_lat * f_lon is 168M at subdiv 11, factor 2; the fine-map
      // wrapper (models/finemap.py) rejects grids of 2^31 bins or more
      const int fbid = fl * p.f_lon + fo;
      const int pbid = (fbid / p.f_lon / p.factor) * p.n_lon +
                       (fbid % p.f_lon) / p.factor;
      const uint32_t word = __ldg(reinterpret_cast<const unsigned int*>(
          p.fslots) + fbid);
#pragma unroll
      for (int s = 0; s < kCand; ++s) {
        const int slot = static_cast<int>((word >> (8 * s)) & 0xFFu);
        if (slot == 255 || slot >= p.k_cap) continue;
        const int c = cand(pbid, slot);
        if (c < 0) continue;
        load(c, col);
        if (inside(col, px, py, pz, r)) return c;
      }
    }
    // stage 2: the full coarse query, first containing candidate in order
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

  // Dequantized ceiling k (0-based) of a column: h_bot + hf * s, +inf past
  // its nl layers; s = (h_top - h_bot) * (1/65535).
  __device__ __forceinline__ float height(int cid, int k, float h_bot,
                                          float s, int nl) const {
    const float* hf = p.hfrac + static_cast<size_t>(cid) * p.hf_stride;
    return (k + 1 <= nl) ? h_bot + __ldg(hf + k) * s
                         : __int_as_float(0x7f800000);
  }

  // A slot's cached layer, as the f32 tier's (csrc/tier_f32.cuh): index
  // l, its bracket (lo, hi] of dequantized ceilings and its alpha.  The
  // ceilings ascend when each column's h_frac row does over its
  // num_layers and h_top >= h_bot (models/qcells.py
  // `check_q_ceilings`): h_bot + hf * s rounds monotonically in hf.
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

  __device__ __forceinline__ void forget(Layer& lay) const {
    lay.lo = __int_as_float(0x7f800000);   // no r is above +inf
    lay.hi = -lay.lo;
    lay.a = 0.0f;
    lay.l = 0;
  }

  // Classified alpha of radius r in column cid: from the slot's bracket
  // when r lies in it, else from the layer #(h < r) over the dequantized
  // ceilings (+inf past num_layers; lm means above the top layer), found
  // by binary search over the first min(num_layers, lm), each probed
  // ceiling dequantized in the JAX expression order; refills the bracket.
  __device__ __forceinline__ float alpha(int cid, float r, Layer& lay) const {
    if (lay.lo < r && r <= lay.hi) return lay.a;
    const float4 t = __ldg(reinterpret_cast<const float4*>(
                               p.test12 + static_cast<size_t>(cid) * kTestW) +
                           2);                  // n[8], h_bot, h_top, nl
    const float h_bot = t.y;
    const float s = (t.z - t.y) * kInv65535;
    const int nl = static_cast<int>(t.w);
    const float* hf = p.hfrac + static_cast<size_t>(cid) * p.hf_stride;
    const float inf = __int_as_float(0x7f800000);
    const int n = min(max(nl, 0), p.lm);
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (h_bot + __ldg(hf + mid) * s < r)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int l = lo;
    lay.l = l;
    lay.lo = l > 0 ? h_bot + __ldg(hf + l - 1) * s : -inf;
    lay.hi = (l < p.lm && l + 1 <= nl) ? h_bot + __ldg(hf + l) * s : inf;
    lay.a = l < p.lm ? static_cast<float>(__ldg(
                           p.aq + static_cast<size_t>(cid) * p.lm + l)) *
                           (p.alpha_max / 255.0f)
                     : 0.0f;
    return lay.a;
  }

  // The colour of the layer of alpha's last evaluation in the slot: its
  // dequantized value through the live LUT.
  __device__ __forceinline__ void shade(int cid, float, const Layer& lay,
                                        float& cr, float& cg,
                                        float& cb) const {
    float v = 0.0f;
    if (lay.l < p.lm) {
      const float vq = static_cast<float>(
          __ldg(p.vq + static_cast<size_t>(cid) * p.lm + lay.l));
      v = p.value_lo + vq * ((p.value_hi - p.value_lo) / 255.0f);
    }
    // postClassify (ref: deviceCode.cu:127-135), RGB channels
    const int S = p.lut_size;
    const float vn = (v - p.tf_lo) / (p.tf_hi - p.tf_lo);
    const float vs = vn * static_cast<float>(S);
    const int idx = static_cast<int>(vs);
    const float frac = vs - static_cast<float>(idx);
    const float* l1 = p.lut + min(max(idx, 0), S - 1) * 4;
    const float* l2 = p.lut + min(max(idx + 1, 0), S - 1) * 4;
    const float w2 = 1.0f - frac;
    cr = __ldg(l1 + 0) * frac + __ldg(l2 + 0) * w2;
    cg = __ldg(l1 + 1) * frac + __ldg(l2 + 1) * w2;
    cb = __ldg(l1 + 2) * frac + __ldg(l2 + 2) * w2;
  }
};
