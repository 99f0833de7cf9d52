// The per-lane machinery shared by the fast tiers' kernels: K1+K4
// `track_f32` (csrc/track_f32.cu), K2 `track_q` (csrc/track_q.cu) and the
// march K3 (csrc/march.cu).
//
// `init_lane` is the lane setup all three share (the JAX package's
// icon_rt_tpu/ops/fast.py `_raygen_soa` and `_init_lanes`): the jittered
// pinhole ray with its two LCG draws, the clip to the shell (up to two
// segments, t >= 0) and the first radial band.  `store_lane` is the K4
// epilogue (sRGB, RGBA8 pack).  `track_lane` is the Woodcock tracking
// machine of K1 and K2.
//
// One thread per pixel lane runs the pixel's `samples` samples to
// completion and writes its accum/fb entries once.  This computes, per
// lane, exactly what the JAX tracking machine (icon_rt_tpu/ops/fast.py
// `step_core`, `_init_lanes`, `batch_loop`) computes; the TPU's batched
// refresh/pending/EVAL phases collapse into straight-line code because a
// cache miss locates inline.  Per lane the draw order is unchanged: the
// flight uniform xi, then -- only for a point inside the volume, after the
// cached or inline locate -- the acceptance uniform.  The rules that decide
// bit-equality are kept: slot 0 is pinned to the lane's first column ever
// entered and later fills go to slot 1; when both slots contain a point the
// MRU slot wins; after a fill the evaluation reads the filled (MRU) slot;
// direction components with |d| < 1e-5 become +1e-5; the seed is
// (accum_id + samp) * W * H + x with u32 wrap-around.
//
// What the lanes keep in registers decides the kernels' speed: they are
// bound by warp divergence and the latency of dependent reads, so by the
// warps an SM holds.  A cache slot keeps its cell id and its `Layer` (the
// layer of its last evaluation with the bracket of ceilings around it, so
// that an evaluation that stays in the bracket reads nothing); its test
// row is read again at each containment test (`contains`, an L1 or L2
// hit), and the shade reads the accepted layer's entries only.  The
// frame's scalars are read from the launch params' tensors (`TrackFrame`,
// shared with K3), so a launch reads nothing back from the card.
//
// A storage tier (csrc/tier_f32.cuh, csrc/tier_q.cuh, csrc/tier_wedge.cuh)
// plugs in as a `Tier` type with
//   struct Col;                                    // a column's test row
//   void  load(int cid, Col&) const;               // read it
//   struct Layer;                                  // a slot's cached layer
//   float coord(const Col&, px, py, pz, r) const;  // the coordinate its
//                                                  // layers are looked up
//                                                  // by: r, or the wedge
//                                                  // tier's dot(P, n')
//   bool  inside(const Col&, px, py, pz, c) const; // containment at coord c
//   int   locate(px, py, pz, r, Col& out) const;   // cell id or -1
//   void  forget(Layer&) const;                    // a new column's slot
//   static Layer pick(bool b, const Layer& x, const Layer& y); // b ? x : y
//   float alpha(int cid, float c, Layer&) const;   // classified alpha
//   void  shade(int cid, float c, const Layer&, float& r, float& g,
//               float& b) const;                   // of alpha's last layer
// Built with -fmad=false and without --use_fast_math: every operation
// rounds on its own, as in eager PyTorch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Mirror of `_TrackFrame` in ops/fast.py (same field order): a frame's
// scalars, read on the card from the launch params' tensors, so that a
// launch reads nothing back from the card.
struct TrackFrame {
  const float* cam_org;     // (3,)
  const float* cam_dir00;   // (3,)
  const float* cam_du;      // (3,)
  const float* cam_dv;      // (3,)
  const float* amb;         // (3,) ambient colour
  const float* amb_rad;     // () ambient radiance
  const float* ud;          // () unit distance
  const int32_t* accum_id;  // () the frame's first sample
};

// Mirror of `_TrackCommon` in ops/fast.py (same field order).
struct TrackCommon {
  const float* edges;    // (nb + 1,) band radii
  const float* majors;   // (nb,) band majorants
  const int32_t* pix;    // (n_lanes,) pixel id of each lane
  float* accum;          // (n_lanes, 4) in/out
  int32_t* fb;           // (n_lanes,) in/out, u32 bits
  int32_t* cost;         // (width * height,) out in natural pixel order, or
                         // null: each lane's tracking steps (K1, K2) or
                         // march iterations (K3)
  uint8_t* raw_wrote;    // raw mode (K1, K2; null = finalize): per lane the
  float* raw_ca;         // sample's wrote flag (L,), its colour and alpha
  float* raw_t;          // (L, 4) and (or null) the accepted collision's t
                         // (L,), +inf without one; accum and fb untouched
  TrackFrame frame;
  int nb, n_lanes, width, height, samples, preserve_cache, max_steps;
  uint32_t rng_salt;     // != 0 re-keys each lane's tracking stream
};

namespace track {

__device__ __forceinline__ uint32_t lcg_init(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ float lcg_next(uint32_t& state) {
  state = 1664525u * state + 1013904223u;
  return static_cast<float>(static_cast<int>(state & 0x00FFFFFFu)) *
         (1.0f / 16777216.0f);
}

__device__ __forceinline__ float r_of(float t, float od, float oo) {
  return sqrtf(fmaxf(oo + 2.0f * t * od + t * t, 1e-30f));
}

// The radial band of radius r: the count of the sorted band edges below r,
// less one, clamped to [0, nb - 1] (ops/fast.py `_band_of`), by binary
// search.
__device__ __forceinline__ int band_of(const float* edges, int nb, float r) {
  int lo = 0, hi = nb + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(edges + mid) < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  return min(max(lo - 1, 0), nb - 1);
}

// Closed-form t where the ray leaves the band [r_lo, r_hi], capped at shi;
// use_in tells whether it leaves through the inner edge.
__device__ __forceinline__ float band_exit(float t, float r_lo, float r_hi,
                                           float shi, float od, float oo,
                                           bool& use_in) {
  const float disc_in = od * od - oo + r_lo * r_lo;
  const float t_in = -od - sqrtf(fmaxf(disc_in, 0.0f));
  const float disc_out = od * od - oo + r_hi * r_hi;
  const float t_out = -od + sqrtf(fmaxf(disc_out, 0.0f));
  use_in = (t < -od) && (disc_in > 0.0f) && (t_in > t);
  return fminf(use_in ? t_in : t_out, shi);
}

// Bin of an angle a (latitude or longitude) on an axis of n bins over
// [lo, hi], clamped (the locator and fine-map binning).
__device__ __forceinline__ int grid_bin(float a, float lo, float hi, int n) {
  const int b = static_cast<int>((a - lo) / (hi - lo) *
                                 static_cast<float>(n));
  return min(max(b, 0), n - 1);
}

__device__ __forceinline__ float linear_to_srgb(float x) {
  return x <= 0.0031308f
             ? 12.92f * x
             : 1.055f * powf(x, static_cast<float>(1.0 / 2.4)) - 0.055f;
}

__device__ __forceinline__ uint32_t make_8bit(float f) {
  const int i = static_cast<int>(f * 256.0f);
  return static_cast<uint32_t>(min(max(i, 0), 255));
}

// The frame's scalars of a lane, read on the card from the launch params'
// tensors (`TrackFrame`); cam[i] is the camera (org | dir00 | du | dv).
struct DeviceFrame {
  const TrackFrame& f;
  __device__ __forceinline__ float operator[](int i) const {
    const float* v = i < 3 ? f.cam_org
                           : (i < 6 ? f.cam_dir00
                                    : (i < 9 ? f.cam_du : f.cam_dv));
    return __ldg(v + i % 3);
  }
  __device__ __forceinline__ float amb(int i) const {
    return __ldg(f.amb + i) * __ldg(f.amb_rad);
  }
  __device__ __forceinline__ float ud() const { return __ldg(f.ud); }
  __device__ __forceinline__ int accum_id() const {
    return __ldg(f.accum_id);
  }
};

// A lane after setup: its ray, the shell segments and the first band.
struct Lane {
  float dx, dy, dz, od;   // unit direction (tiny components -> 1e-5)
  float t, seg_hi;        // position and end of the current shell segment
  float s1_lo, s1_hi;     // the second shell segment (empty if s1_hi <= s1_lo)
  float seg_end, m;       // exit of the first band, its majorant
  int si, band;           // shell segment index, first band
  bool was_in, wrote, done;
  uint32_t rng;           // the LCG state after the two jitter draws
};

// Ray setup of sample `aid` of pixel (x, y) (ref: deviceCode.cu:36-49): the
// jittered pinhole ray, its clip to the shell and its first band; the
// lane's tracking stream continues from `rng`.
__device__ __forceinline__ Lane init_lane(const TrackCommon& p,
                                          const DeviceFrame& cam, int x,
                                          int y, int aid_i, float oo) {
  const float ox = cam[0], oy = cam[1], oz = cam[2];
  const int nb = p.nb;
  const float r_in = __ldg(p.edges);
  const float r_out = __ldg(p.edges + nb);
  const float inf = __int_as_float(0x7f800000);
  Lane L;
  const uint32_t aid = static_cast<uint32_t>(aid_i);
  L.rng = lcg_init(
      aid * static_cast<uint32_t>(p.width * p.height) +
          static_cast<uint32_t>(x),
      static_cast<uint32_t>(y));
  const float jx = lcg_next(L.rng);
  const float jy = lcg_next(L.rng);
  // rng_salt re-keys the tracking stream after the jitter draws: every slab
  // of a scene-sharded frame traces the same ray with an independent stream
  // (icon_rt_tpu/ops/fast.py:601-604; the product wraps in u32 by design)
  if (p.rng_salt != 0u) {
    L.rng ^= p.rng_salt * 2654435761u;
    lcg_next(L.rng);
  }
  const float u = static_cast<float>(x) + 0.5f + jx;
  const float v = static_cast<float>(y) + 0.5f + jy;
  float dx = cam[3] + u * cam[6] + v * cam[9];
  float dy = cam[4] + u * cam[7] + v * cam[10];
  float dz = cam[5] + u * cam[8] + v * cam[11];
  const float inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
  if (fabsf(dx) < 1e-5f) dx = 1e-5f;
  if (fabsf(dy) < 1e-5f) dy = 1e-5f;
  if (fabsf(dz) < 1e-5f) dz = 1e-5f;
  const float od = ox * dx + oy * dy + oz * dz;
  L.dx = dx;
  L.dy = dy;
  L.dz = dz;
  L.od = od;

  // -- clip to the shell: up to two segments, t >= 0 -----------------------
  const float disc_o = od * od - oo + r_out * r_out;
  const float sq_o = sqrtf(fmaxf(disc_o, 0.0f));
  const float to0 = -od - sq_o, to1 = -od + sq_o;
  const float disc_i = od * od - oo + r_in * r_in;
  const float sq_i = sqrtf(fmaxf(disc_i, 0.0f));
  const float ti0 = -od - sq_i, ti1 = -od + sq_i;
  const bool hit_o = disc_o > 0.0f, hit_i = disc_i > 0.0f;
  const bool outer_only = hit_o && !hit_i;
  const float s0_lo = fmaxf(to0, 0.0f);
  const float s0_hi = outer_only ? to1 : ti0;
  L.s1_lo = fmaxf(outer_only ? inf : ti1, 0.0f);
  L.s1_hi = outer_only ? -inf : to1;
  L.wrote = hit_o && (to1 > 0.0f);
  const bool s0_bad = s0_hi <= s0_lo;
  L.t = s0_bad ? L.s1_lo : s0_lo;
  L.seg_hi = s0_bad ? L.s1_hi : s0_hi;
  L.si = s0_bad ? 1 : 0;
  L.band = band_of(p.edges, nb, r_of(L.t, od, oo));
  L.seg_end = band_exit(L.t, __ldg(p.edges + L.band),
                        __ldg(p.edges + L.band + 1), L.seg_hi, od, oo,
                        L.was_in);
  L.m = __ldg(p.majors + L.band);
  L.done = !(L.wrote && L.seg_hi > L.t);
  return L;
}

// The progressive average of one sample (ref: deviceCode.cu:267-274).
__device__ __forceinline__ float blend(float sc, float c, float acc) {
  return sc * c + (1.0f - sc) * acc;
}

// A lane's running average into accum and, if any of its samples wrote,
// its sRGB RGBA8 pack into fb (K4; also the K10 composites' epilogue,
// csrc/composite.cu).
__device__ __forceinline__ void store_pixel(float* accum, int32_t* fb,
                                            int lane, float ar, float ag,
                                            float ab, float aa, bool wany) {
  accum[lane * 4 + 0] = ar;
  accum[lane * 4 + 1] = ag;
  accum[lane * 4 + 2] = ab;
  accum[lane * 4 + 3] = aa;
  if (wany) {
    const uint32_t packed = make_8bit(linear_to_srgb(ar)) |
                            (make_8bit(linear_to_srgb(ag)) << 8) |
                            (make_8bit(linear_to_srgb(ab)) << 16) |
                            (make_8bit(aa) << 24);
    fb[lane] = static_cast<int32_t>(packed);
  }
}

__device__ __forceinline__ void store_lane(const TrackCommon& p, int lane,
                                           float ar, float ag, float ab,
                                           float aa, bool wany) {
  store_pixel(p.accum, p.fb, lane, ar, ag, ab, aa, wany);
}

// Whether cached cell cid contains the point: its test row is read again
// (an L1 or L2 hit), so that a cache slot holds its cell id in a register
// and not its row.
template <class Tier>
__device__ __forceinline__ bool contains(const Tier& T, int cid, float px,
                                         float py, float pz, float r) {
  typename Tier::Col c;
  T.load(cid, c);
  return T.inside(c, px, py, pz, T.coord(c, px, py, pz, r));
}

// One lane: `samples` progressive samples of pixel p.pix[lane], then the
// K4 epilogue (accumulate lerp, sRGB, RGBA8 pack).  With p.cost the lane
// also stores the tracking steps it took over its samples (iterations of
// the step loop: draws and band or segment advances) at its pixel, the
// measured cost the re-sort K6b orders the next launch's lanes by (the
// reference's `return_cost`, ops/fast.py:1190-1191, counts wavefront
// iterations instead).  The count lives in a register; the one store is
// skipped when p.cost is null, as on the main path.  In raw mode (p.raw_ca
// set, one sample) the lane stores its sample's wrote, colour and t for a
// composite across ranks (csrc/composite.cu) and reads and writes neither
// accum nor fb.
template <class Tier>
__device__ __forceinline__ void track_lane(const TrackCommon& p,
                                           const Tier& T, int lane) {
  using Col = typename Tier::Col;
  using Layer = typename Tier::Layer;
  const DeviceFrame F{p.frame};
  const int pixel = p.pix[lane];
  const int x = pixel % p.width;
  const int y = pixel / p.width;
  const float ox = F[0], oy = F[1], oz = F[2];
  const float oo = ox * ox + oy * oy + oz * oz;
  const float ud = F.ud();
  const int aid = F.accum_id();
  const int nb = p.nb;

  const bool raw = p.raw_ca != nullptr;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, aa = 0.0f;
  if (!raw) {
    ar = p.accum[lane * 4 + 0];
    ag = p.accum[lane * 4 + 1];
    ab = p.accum[lane * 4 + 2];
    aa = p.accum[lane * 4 + 3];
  }
  bool wany = false;

  // two-slot column cache: slot 0 pinned to the first column; each slot
  // keeps its cell id and the layer of its last evaluation in registers;
  // of its row only what the tier's coord reads (the wedge tier's n'; the
  // compiler drops the rest of col0 and col1)
  Col col0, col1;
  Layer lay0, lay1;
  T.forget(lay0);
  T.forget(lay1);
  int cid0 = 0, cid1 = 0;
  bool valid0 = false, valid1 = false;
  int mru = 0;
  int steps = 0;

  for (int samp = 0; samp < p.samples; ++samp) {
    if (!p.preserve_cache) {
      valid0 = valid1 = false;
      mru = 0;
    }
    const Lane L = init_lane(p, F, x, y, aid + samp, oo);
    const float dx = L.dx, dy = L.dy, dz = L.dz, od = L.od;
    const float s1_lo = L.s1_lo, s1_hi = L.s1_hi;
    const bool wrote = L.wrote;
    uint32_t rng = L.rng;
    float t = L.t;
    float seg_hi = L.seg_hi;
    int si = L.si;
    int band = L.band;
    bool was_in = L.was_in;
    float seg_end = L.seg_end;
    float m = L.m;
    bool done = L.done;
    float alpha = 0.0f;

    // -- delta tracking ----------------------------------------------------
    // max_steps (ops/fast.py MAX_STEPS, the JAX loop's 16384 x 8 cap) ends
    // a sample without a collision; no lane of the tests or of
    // chip_smoke.py comes near it.
    int step = 0;
    for (; !done && step < p.max_steps; ++step) {
      if (m > 0.0f) {
        const float xi = lcg_next(rng);
        const float t_new = t - logf(1.0f - xi) / (m / ud);
        if (!(t_new > seg_end)) {
          // tentative collision at t_new
          t = t_new;
          const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
          const float r = r_of(t, od, oo);
          const bool in0 = valid0 && contains(T, cid0, px, py, pz, r);
          const bool in1 = valid1 && contains(T, cid1, px, py, pz, r);
          bool hit_vol = true;
          if (in0 || in1) {
            mru = mru ? (in1 ? 1 : 0) : ((in1 && !in0) ? 1 : 0);
          } else {
            Col col;
            const int c = T.locate(px, py, pz, r, col);
            if (c < 0) {
              hit_vol = false;
            } else if (!valid0) {
              col0 = col;
              cid0 = c;
              T.forget(lay0);
              valid0 = true;
              mru = 0;
            } else {
              col1 = col;
              cid1 = c;
              T.forget(lay1);
              valid1 = true;
              mru = 1;
            }
          }
          if (hit_vol) {
            // the MRU slot's layer: its cached bracket, else looked up
            Layer lay = Tier::pick(mru, lay1, lay0);
            const float a =
                T.alpha(mru ? cid1 : cid0,
                        mru ? T.coord(col1, px, py, pz, r)
                            : T.coord(col0, px, py, pz, r), lay);
            if (mru)
              lay1 = lay;
            else
              lay0 = lay;
            const float uu = lcg_next(rng);
            if (a >= uu * m) {
              alpha = a;
              done = true;
            }
          }
          continue;
        }
      }
      // overshoot or zero majorant: advance to the next band or segment
      float t_adv = seg_end;
      const bool at_seg_end = t_adv >= seg_hi;
      int band_n = band + (was_in ? -1 : 1);
      const bool to_seg1 = at_seg_end && si == 0 && s1_hi > s1_lo;
      float shi_n = seg_hi;
      if (to_seg1) {
        t_adv = s1_lo;
        band_n = band_of(p.edges, nb, r_of(t_adv, od, oo));
        shi_n = s1_hi;
      }
      band_n = min(max(band_n, 0), nb - 1);
      seg_end = band_exit(t_adv, __ldg(p.edges + band_n),
                          __ldg(p.edges + band_n + 1), shi_n, od, oo,
                          was_in);
      t = t_adv;
      band = band_n;
      m = __ldg(p.majors + band_n);
      if (to_seg1) {
        seg_hi = shi_n;
        si = 1;
      }
      if (at_seg_end && !to_seg1) done = true;
    }
    steps += step;

    // -- shade (ref: deviceCode.cu:333-340) and accumulate (:267-274): the
    // accepted evaluation's layer is the MRU slot's ------------------------
    float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f;
    if (alpha > 0.0f) {
      const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
      const float r = r_of(t, od, oo);
      T.shade(mru ? cid1 : cid0, mru ? T.coord(col1, px, py, pz, r)
                                     : T.coord(col0, px, py, pz, r),
              Tier::pick(mru, lay1, lay0), cr, cg, cb);
      cr = cr * F.amb(0);
      cg = cg * F.amb(1);
      cb = cb * F.amb(2);
      ca = 1.0f;
    }
    if (raw) {
      p.raw_wrote[lane] = wrote ? 1 : 0;
      p.raw_ca[lane * 4 + 0] = cr;
      p.raw_ca[lane * 4 + 1] = cg;
      p.raw_ca[lane * 4 + 2] = cb;
      p.raw_ca[lane * 4 + 3] = ca;
      if (p.raw_t != nullptr)
        p.raw_t[lane] = alpha > 0.0f ? t : __int_as_float(0x7f800000);
    } else if (wrote) {
      const float sc = 1.0f / (static_cast<float>(aid + samp) + 1.0f);
      ar = blend(sc, cr, ar);
      ag = blend(sc, cg, ag);
      ab = blend(sc, cb, ab);
      aa = blend(sc, ca, aa);
      wany = true;
    }
  }
  if (!raw) store_lane(p, lane, ar, ag, ab, aa, wany);
  if (p.cost != nullptr) p.cost[pixel] = steps;
}

// A kernel's resident blocks an SM at `block` threads, its registers and
// its local (stack and spill) bytes a thread: out[0..2].  Returns the
// first CUDA error.
template <class Kernel>
int occupancy(Kernel kernel, int block, int* out) {
  cudaFuncAttributes a;
  int err = static_cast<int>(cudaFuncGetAttributes(&a, kernel));
  if (err) return err;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, block, 0));
}

}  // namespace track
