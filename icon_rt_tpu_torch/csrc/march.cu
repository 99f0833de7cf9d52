// K3 `march_f32` / `march_q`: the deterministic transmittance march of the
// fast tiers, with the frame epilogue (accumulate lerp, sRGB, RGBA8 pack)
// fused in.
//
// Replaces the XLA-fused loops of icon_rt_tpu/ops/march.py:
// `_integrate_column`, `_column_exit`, `_candidate_entries`, `_bin_exit`,
// `_bin_indices`, `_march_loop`, `march_rays`, `march_rays_q`,
// `_march_generic`, `_frame_driver`, `render_frame_march` and
// `render_frame_march_q`, plus icon_rt_tpu/ops/render.py `_finalize`.  Its
// plain-PyTorch version is `_march_torch` in ops/march.py, whose loop
// order over the layers is the spec this kernel follows operation for
// operation.  The lane setup is csrc/track_common.cuh `init_lane` (shared
// with K1 and K2); the storage tiers are csrc/tier_f32.cuh and
// csrc/tier_q.cuh, one instantiation each.
//
// One thread per ray marches front to back over the ray's column crossings
// with no RNG after the jitter draws.  Per iteration: the shell-segment
// advance; a zero-majorant band is skipped to its exit; otherwise the lane
// locates the column at t + eps and either integrates the crossing
// [t, t_exit] in closed form or, on a miss, jumps to the exact next event
// (the bin's candidates' next entry, the locator-bin boundary, the band
// exit).  The lane ends on exhausting the shell, at transmittance below
// et_eps, or after max_outer iterations of its own.  With a non-null
// `cost` ((W*H,) int32, natural pixel order) the lane stores how many
// iterations it entered, the one that ends it included, 0 for a lane that
// misses the shell: per lane the JAX march's `n_it` of that lane alone
// (icon_rt_tpu/ops/march.py `return_cost`, :444-445) wherever every lane
// is served, as without the fine map, up to the f32 ties of ops/march.py's
// docstring (one zero-width gap iteration more or less).
//
// The TPU scheduling of the JAX march is not ported: generational
// compaction, the fine map's two-stage tail cap with its rank-gather
// merge, and the lax.map chunking only decide when a lane's work runs.
// There is no column cache either: a monotonic walk never re-enters a
// column (icon_rt_tpu/ops/march.py:542-544).
//
// What bounds it on the H100: the latency of the dependent reads of each
// crossing (bins row -> candidate test rows -> the winner's prof and rgb
// rows, or on the q tier its u8 rows) and divergence between rays of very
// different crossing counts; per crossing ~20 flops per layer of nonzero
// length.  The design:
//   * a lane's radial band is a binary search over the sorted band edges
//     (csrc/track_common.cuh `band_of`, the count of edges below r, as the
//     plain version's `_band_of`), not a scan of all nb + 1 of them at
//     every iteration;
//   * every per-layer table entry is streamed through __ldg in both pieces
//     of the integral, and each piece takes its spheres' half chords as it
//     goes: a variant that kept the chords and the column's bytes in
//     registers for both pieces needed 95-127 registers and was 1.3-1.8x
//     slower (PERF.md), one that kept the chords in shared memory
//     was no faster at R2B9;
//   * a crossing's integral visits only the layers whose length can be
//     > 0, found with its own f32 predicates (`integrate`): an empty piece
//     costs nothing (on the app's closeups every ascending piece is
//     empty), and a piece runs from the layer where its near end lies to
//     where it ends (5.0 of the 32 visits of a crossing add anything at
//     R2B8, 1.6 at R2B9; PERF.md);
//   * the locate reads its candidates one at a time: reading four rows'
//     bounds and first planes ahead of the tests took K3-f32 from 64 to 94
//     registers (5 blocks an SM) and was 19% slower (PERF.md);
//   * on the q tier the (256, 4) code table of the live TF is built on the
//     card by a one-block kernel launched ahead of the march on the same
//     stream (the f32 expressions of models/transfunc.py `post_classify`,
//     so the table is bit-equal to the plain version's), and every colour
//     is read from it through __ldg: built in each block's shared memory
//     instead, a prologue and a barrier a block, the march was 5% slower
//     at R2B8 and R2B9 (PERF.md);
//   * layers past the column's num_layers and layers of zero optical depth
//     add exactly nothing and are skipped.
// Lanes stay one a thread: refilling a warp's finished lanes from a block
// queue was slower at R2B9 at every queue length tried (2-16 lanes a
// thread; PERF.md).
// A K3 launch reads nothing back from the card: the camera, the frame's
// accum_id, the ambient terms and the unit distance (csrc/track_common.cuh
// `TrackFrame`, shared with K1 and K2) and (q tier) the TF's value range
// are read by the kernel from their tensors, and the tables' scalars come
// from host copies refreshed only when those tensors change (ops/fast.py
// `host_values`).
//
// Built with -fmad=false, full-precision expf/sinf/cosf/asinf/atan2f and
// IEEE division and square root: every operation rounds as in eager
// PyTorch, so the kernel equals its plain version bit for bit.
#include "tier_f32.cuh"
#include "tier_q.cuh"

// Mirror of `_MarchArgs` in ops/march.py (same field order).
struct MarchArgs {
  float* tab;         // (256, 4) RGB_ of every u8 value code (q tier)
  float a_scale;      // alpha_max / 255 (q tier)
  float v_scale;      // (value_hi - value_lo) / 255 (q tier)
  float inv_span;     // 255 / max(value_hi - value_lo, 1e-30) (q tier)
  float et_eps;       // early-termination transmittance
  int max_outer;      // iteration cap of a lane
  const float* tf_range;  // (2,) the TF's value range, read on the card
                          // (q tier)
};

namespace {

constexpr int kBlock = 128;
// K3-q's blocks an SM must hold: 64 registers a thread, half the SM's
// threads (at 72 registers, 7 blocks an SM or unbounded, it was 1-2%
// slower, with no spill; PERF.md)
constexpr int kQMinBlocks = 8;

__device__ __forceinline__ float big() { return __int_as_float(0x7f7fffff); }

// sqrt(max(od^2 - oo + h^2, 0)): the half chord of the sphere of radius h
// (+inf for h = +inf).
__device__ __forceinline__ float half_chord(float h, float od, float oo) {
  return sqrtf(fmaxf(od * od - oo + h * h, 0.0f));
}

// Per-layer data of a located column on the f32 tier: the K5a rows.
struct F32Layers {
  static constexpr bool kSearch = true;   // see `integrate`
  const float* h;     // 32 inf-padded ceilings, then 32 alpha
  const float* rgb;   // R | G | B
  float h_bot;
  int kn;             // the layers that can hold extinction
  __device__ F32Layers(const F32Tier& T, const MarchArgs&, int cid,
                       const F32Tier::Col& col)
      : h(T.p.prof + static_cast<size_t>(cid) * F32Tier::kProfW),
        rgb(T.p.rgb + static_cast<size_t>(cid) * F32Tier::kRgbW),
        h_bot(col.h_bot),
        kn(min(static_cast<int>(
                   __ldg(T.p.test + static_cast<size_t>(cid) *
                                        F32Tier::kTestW + 14)),
               F32Tier::kLayers)) {}
  __device__ __forceinline__ float height(int k) const {
    return __ldg(h + k);
  }
  __device__ __forceinline__ float alpha(int k) const {
    return __ldg(h + F32Tier::kLayers + k);
  }
  __device__ __forceinline__ void color(int k, float& r, float& g,
                                        float& b) const {
    r = __ldg(rgb + k);
    g = __ldg(rgb + F32Tier::kLayers + k);
    b = __ldg(rgb + 2 * F32Tier::kLayers + k);
  }
};

// Per-layer data of a located column on the quantized tier, dequantized
// at use; a layer's colour is its value re-quantized to a u8 code and
// looked up in the code table (icon_rt_tpu/ops/march.py:478-482).
struct QLayers {
  static constexpr bool kSearch = false;  // see `integrate`
  const QTier& T;
  const MarchArgs& m;
  int cid;
  float h_bot, s;
  int nl, kn;
  const uint8_t* aq;
  const uint8_t* vq;
  __device__ QLayers(const QTier& T_, const MarchArgs& m_, int cid_,
                     const QTier::Col& col)
      : T(T_), m(m_), cid(cid_), h_bot(col.h_bot),
        s((col.h_top - col.h_bot) * QTier::kInv65535),
        nl(static_cast<int>(__ldg(T_.p.test12 +
                                  static_cast<size_t>(cid_) * QTier::kTestW +
                                  11))),
        kn(min(nl, T_.p.lm)),   // layers past nl have zero extinction
        aq(T_.p.aq + static_cast<size_t>(cid_) * T_.p.lm),
        vq(T_.p.vq + static_cast<size_t>(cid_) * T_.p.lm) {}
  __device__ __forceinline__ float height(int k) const {
    return T.height(cid, k, h_bot, s, nl);
  }
  __device__ __forceinline__ float alpha(int k) const {
    return static_cast<float>(__ldg(aq + k)) * m.a_scale;
  }
  __device__ __forceinline__ void color(int k, float& r, float& g,
                                        float& b) const {
    const float v =
        T.p.value_lo + static_cast<float>(__ldg(vq + k)) * m.v_scale;
    const float code =
        fminf(fmaxf(rintf((v - T.p.value_lo) * m.inv_span), 0.0f), 255.0f);
    const float* row = m.tab + static_cast<int>(code) * 4;
    r = __ldg(row);
    g = __ldg(row + 1);
    b = __ldg(row + 2);
  }
};

// The first layer of a crossing's descending piece, from the top, whose
// length can be > 0: with Lay::kSearch the count of the ceilings h_j,
// j < kn - 1, with -od - s(h_j) > t0 (layer j + 1's far end lies after
// t0), else the top layer kn - 1.  s(h) = half_chord(h) is non-decreasing
// in h >= 0 under round-to-nearest and the ceilings ascend
// (models/cells.py `check_ceilings`, models/qcells.py `check_q_ceilings`),
// so the predicate holds on a prefix of j: binary search with the
// integral's own expression.  Layers above add nothing.
template <class Lay>
__device__ __forceinline__ int desc_top(const Lay& c, int kn, float od,
                                        float oo, float t0) {
  if (!Lay::kSearch || kn <= 0) return kn - 1;
  int lo = 0, hi = kn - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (-od - half_chord(c.height(mid), od, oo) > t0)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The first layer of the ascending piece, from the bottom, whose length
// can be > 0: with Lay::kSearch the count of the ceilings h_j, j < kn,
// with !(-od + s(h_j) > tm) (layer j ends before tm), a prefix of j as
// above, else 0.  Layers below add nothing.
template <class Lay>
__device__ __forceinline__ int asc_bottom(const Lay& c, int kn, float od,
                                          float oo, float tm) {
  if (!Lay::kSearch) return 0;
  int lo = 0, hi = kn;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(-od + half_chord(c.height(mid), od, oo) > tm))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Closed-form emission-absorption integral of one column crossing [t0, t1]
// (icon_rt_tpu/ops/march.py `_integrate_column`), in the plain version's
// order: the descending piece [t0, tm] with k from the top (suffix depth
// `suf`), then the ascending piece [tm, t1] with k from the bottom
// (prefix depth `c2`); colours accumulate inside both passes, and each
// pass carries a sphere's half chord from one layer to the next.  A piece
// visits only the layers whose length can be > 0 and adds what the plain
// loop adds over all of them:
//   * an empty piece (!(tm > t0), !(t1 > tm)) is skipped whole: on the
//     app's closeups every crossing's ascending piece is empty;
//   * a piece starts at the layer `desc_top` or `asc_bottom` gives, its
//     half chord computed afresh (the same expression on the same input
//     as the carry);
//   * it stops where its near end passes its far end, which then holds
//     for every later layer (descending: -od - s(h_k) >= tm; ascending,
//     for k > 0: -od + s(h_{k-1}) >= t1);
//   * a layer in between whose length is 0 is still skipped.
// The f32 tier finds a piece's start by binary search; the quantized tier
// walks from the piece's end, whose empty layers cost it less than the
// search's probes (PERF.md §6: each won in turns on its tier).
template <class Lay>
__device__ __forceinline__ void integrate(const Lay& c, float t0, float t1,
                                          float od, float oo, float ud,
                                          float& tmul, float& cr, float& cg,
                                          float& cb) {
  const float tm = fminf(fmaxf(-od, t0), t1);
  const int kn = c.kn;
  cr = cg = cb = 0.0f;
  float suf = 0.0f;
  if (tm > t0) {
    const int top = desc_top(c, kn, od, oo, t0);
    float s_hi = top >= 0 ? half_chord(c.height(top), od, oo) : 0.0f;
    for (int k = top; k >= 0; --k) {
      const float d_hi = -od - s_hi;
      if (!(d_hi < tm)) break;
      const float s_lo =
          half_chord(k == 0 ? c.h_bot : c.height(k - 1), od, oo);
      const float d_lo = -od - s_lo;
      const float len1 = fmaxf(0.0f, fminf(d_lo, tm) - fmaxf(d_hi, t0));
      s_hi = s_lo;
      if (!(len1 > 0.0f)) continue;
      const float od1 = (c.alpha(k) / ud) * len1;
      suf = suf + od1;
      if (!(od1 > 0.0f)) continue;
      const float w1 = expf(-(suf - od1)) * (1.0f - expf(-od1));
      float r, g, b;
      c.color(k, r, g, b);
      cr = cr + w1 * r;
      cg = cg + w1 * g;
      cb = cb + w1 * b;
    }
  }
  const float tau1 = suf;
  float c2 = 0.0f;
  if (t1 > tm) {
    int k = asc_bottom(c, kn, od, oo, tm);
    float s_lo = half_chord(k == 0 ? c.h_bot : c.height(k - 1), od, oo);
    for (; k < kn; ++k) {
      const float i_lo = -od + s_lo;
      if (k > 0 && !(i_lo < t1)) break;
      const float s_up = half_chord(c.height(k), od, oo);
      const float i_hi = -od + s_up;
      const float len2 = fmaxf(0.0f, fminf(i_hi, t1) - fmaxf(i_lo, tm));
      s_lo = s_up;
      if (!(len2 > 0.0f)) continue;
      const float od2 = (c.alpha(k) / ud) * len2;
      c2 = c2 + od2;
      if (!(od2 > 0.0f)) continue;
      const float w2 = expf(-(tau1 + c2 - od2)) * (1.0f - expf(-od2));
      float r, g, b;
      c.color(k, r, g, b);
      cr = cr + w2 * r;
      cg = cg + w2 * g;
      cb = cb + w2 * b;
    }
  }
  tmul = expf(-(tau1 + c2));
}


// Where the ray leaves the located column: the side-plane crossings with
// n.D > 0 (even at or before t0: then an f32 tie re-located the column the
// lane just left, and the caller's floor at t + eps advances it by eps;
// ops/march.py `_column_exit`), the inward bottom-sphere crossing after t0
// and the outward top-sphere crossing after t0, clamped to the shell
// segment end.
template <class Tier>
__device__ __forceinline__ float column_exit(const typename Tier::Col& col,
                                             float t0, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, float od, float oo,
                                             float seg_hi) {
  float t_exit = fminf(seg_hi, big());
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float nx, ny, nz, w;
    Tier::plane(col, j, nx, ny, nz, w);
    const float a = nx * ox + ny * oy + nz * oz - w;
    const float b = nx * dx + ny * dy + nz * dz;
    if (b > 1e-30f) t_exit = fminf(t_exit, -a / fmaxf(b, 1e-30f));
  }
  const float disc_b = od * od - oo + col.h_bot * col.h_bot;
  const float tb_in = -od - sqrtf(fmaxf(disc_b, 0.0f));
  t_exit = fminf(t_exit, (disc_b > 0.0f && tb_in > t0) ? tb_in : big());
  const float tt_out = -od + half_chord(col.h_top, od, oo);
  return fminf(t_exit, tt_out > t0 ? tt_out : big());
}

// Next entry t >= t_now of one candidate column: three half-spaces give an
// interval [pl_lo, pl_hi] in t, the annulus [h_bot, h_top] up to two
// intervals (two when the ray dips below h_bot); big() if none is ahead.
template <class Tier>
__device__ __forceinline__ float candidate_entry(
    const typename Tier::Col& col, float t_now, float ox, float oy, float oz,
    float dx, float dy, float dz, float od, float oo) {
  float pl_lo = -big(), pl_hi = big();
  bool nonempty = true;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float nx, ny, nz, w;
    Tier::plane(col, j, nx, ny, nz, w);
    const float a = nx * ox + ny * oy + nz * oz - w;
    const float b = nx * dx + ny * dy + nz * dz;
    const float tcross = -a / (fabsf(b) > 1e-30f ? b : 1e-30f);
    if (b > 1e-30f) pl_hi = fminf(pl_hi, tcross);
    if (b < -1e-30f) pl_lo = fmaxf(pl_lo, tcross);
    nonempty = nonempty && !(fabsf(b) <= 1e-30f && a > 0.0f);
  }
  const float disc_b = od * od - oo + col.h_bot * col.h_bot;
  const float disc_t = od * od - oo + col.h_top * col.h_top;
  const bool has_b = disc_b > 0.0f;
  const float sb = sqrtf(fmaxf(disc_b, 0.0f));
  const float st = sqrtf(fmaxf(disc_t, 0.0f));
  const float tt0 = -od - st, tt1 = -od + st;
  const float tb0 = -od - sb, tb1 = -od + sb;
  nonempty = nonempty && disc_t > 0.0f;
  float ent = big();
  if (!nonempty) return ent;
  // annulus piece 1: [tt0, has_b ? min(tb0, tt1) : tt1]
  const float lo1 = fmaxf(fmaxf(tt0, pl_lo), t_now);
  const float hi1 = fminf(has_b ? fminf(tb0, tt1) : tt1, pl_hi);
  if (hi1 >= lo1) ent = fminf(ent, lo1);
  // annulus piece 2 (re-entry after dipping below h_bot): [tb1, tt1]
  if (has_b) {
    const float lo2 = fmaxf(fmaxf(fmaxf(tb1, tt0), pl_lo), t_now);
    const float hi2 = fminf(tt1, pl_hi);
    if (hi2 >= lo2) ent = fminf(ent, lo2);
  }
  return ent;
}

// First crossing after t_now of the locator-bin boundary: two latitude
// cones |z| = sin(lat_e) r, solved squared (the mirror cone's roots are
// kept: earlier crossings only shorten the skip), and two longitude planes
// through the z axis.
template <class Params>
__device__ __forceinline__ float bin_exit(const Params& p, int bid,
                                          float t_now, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float od, float oo) {
  const int bl = bid / p.n_lon;
  const int bo = bid - bl * p.n_lon;
  const float lat_step =
      (p.lat_hi - p.lat_lo) / static_cast<float>(p.n_lat);
  const float lon_step =
      (p.lon_hi - p.lon_lo) / static_cast<float>(p.n_lon);
  float out = big();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float s = sinf(p.lat_lo + (static_cast<float>(bl) +
                                     static_cast<float>(e)) * lat_step);
    const float s2 = s * s;
    const float A = dz * dz - s2;
    const float B = 2.0f * (oz * dz - s2 * od);
    const float C = oz * oz - s2 * oo;
    const float disc = B * B - 4.0f * A * C;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const bool quad = fabsf(A) > 1e-30f;
    const float safe_a = quad ? 2.0f * A : 1e-30f;
    if (quad && disc > 0.0f) {
      const float r1 = (-B - sq) / safe_a;
      const float r2 = (-B + sq) / safe_a;
      if (r1 > t_now) out = fminf(out, r1);
      if (r2 > t_now) out = fminf(out, r2);
    }
    if (!quad && fabsf(B) > 1e-30f) {
      const float rl = -C / B;
      if (rl > t_now) out = fminf(out, rl);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float le = p.lon_lo + (static_cast<float>(bo) +
                                 static_cast<float>(e)) * lon_step;
    const float nx = -sinf(le), ny = cosf(le);
    const float a = nx * ox + ny * oy;
    const float b = nx * dx + ny * dy;
    if (fabsf(b) > 1e-30f) {
      const float tc = -a / b;
      if (tc > t_now) out = fminf(out, tc);
    }
  }
  return out;
}

// One ray of pixel p.pix[lane]: the march, then the K4 epilogue.
template <class Tier, class Lay>
__device__ __forceinline__ void march_lane(const TrackCommon& p,
                                           const Tier& T, const MarchArgs& m,
                                           int lane) {
  using Col = typename Tier::Col;
  const track::DeviceFrame F{p.frame};
  const int pixel = p.pix[lane];
  const int x = pixel % p.width;
  const int y = pixel / p.width;
  const float ox = F[0], oy = F[1], oz = F[2];
  const float oo = ox * ox + oy * oy + oz * oz;
  const track::Lane L = track::init_lane(p, F, x, y, F.accum_id(), oo);
  const float dx = L.dx, dy = L.dy, dz = L.dz, od = L.od;
  const float ud = F.ud();
  const float eps_abs = 1e-4f * ud;

  float t = L.t, seg_hi = L.seg_hi;
  int si = L.si;
  float tr = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f;
  int it = 0;   // iterations entered, the one that ends the lane included
  if (!L.done) {
    while (it < m.max_outer) {
      ++it;
      // shell-segment advance / exhaustion
      if (t >= seg_hi) {
        if (si == 0 && L.s1_hi > L.s1_lo) {
          t = L.s1_lo;
          seg_hi = L.s1_hi;
          si = 1;
        } else {
          break;
        }
      }
      const float eps = fmaxf(eps_abs, fabsf(t) * 4e-7f);
      const float tl = t + eps;
      const float r = track::r_of(tl, od, oo);
      const int band = track::band_of(p.edges, p.nb, r);
      bool was_in;
      const float seg_end =
          track::band_exit(tl, __ldg(p.edges + band),
                           __ldg(p.edges + band + 1), seg_hi, od, oo, was_in);
      if (__ldg(p.majors + band) <= 0.0f) {
        t = fmaxf(seg_end, tl);           // zero band: skip it
      } else {
        const float px = ox + dx * tl, py = oy + dy * tl, pz = oz + dz * tl;
        Col col;
        int bid;
        const int c = T.locate(px, py, pz, r, col, bid);
        if (c >= 0) {
          // hit: integrate the crossing [t, t_exit]
          const float t_exit =
              fmaxf(column_exit<Tier>(col, t, ox, oy, oz, dx, dy, dz, od, oo,
                                      seg_hi),
                    tl);
          float tmul, cr, cg, cb;
          integrate(Lay(T, m, c, col), t, t_exit, od, oo, ud, tmul, cr, cg,
                    cb);
          ar = ar + tr * cr;
          ag = ag + tr * cg;
          ab = ab + tr * cb;
          tr = tr * tmul;
          t = t_exit;
        } else {
          // miss: the exact next event of the gap
          float skip = bin_exit(T.p, bid, tl, ox, oy, oz, dx, dy, dz, od, oo);
          for (int k = 0; k < T.p.k_cap; ++k) {
            const int cc = T.cand(bid, k);
            if (cc < 0) continue;
            T.load(cc, col);
            skip = fminf(skip, candidate_entry<Tier>(col, tl, ox, oy, oz, dx,
                                                     dy, dz, od, oo));
          }
          t = fmaxf(fminf(skip, seg_end), tl);
        }
      }
      if (tr < m.et_eps) break;
    }
  }

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f;
  if (L.wrote) {
    cr = ar * F.amb(0);
    cg = ag * F.amb(1);
    cb = ab * F.amb(2);
    ca = 1.0f - tr;
  }
  float accr = p.accum[lane * 4 + 0], accg = p.accum[lane * 4 + 1];
  float accb = p.accum[lane * 4 + 2], acca = p.accum[lane * 4 + 3];
  if (L.wrote) {
    const float sc = 1.0f / (static_cast<float>(F.accum_id()) + 1.0f);
    accr = track::blend(sc, cr, accr);
    accg = track::blend(sc, cg, accg);
    accb = track::blend(sc, cb, accb);
    acca = track::blend(sc, ca, acca);
  }
  track::store_lane(p, lane, accr, accg, accb, acca, L.wrote);
  if (p.cost != nullptr) p.cost[pixel] = it;
}

__global__ void __launch_bounds__(kBlock)
march_f32_kernel(const TrackParams p, const MarchArgs m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.c.n_lanes) return;
  march_lane<F32Tier, F32Layers>(p.c, F32Tier{p}, m, lane);
}

// The code table of the live TF, one thread a code: code k's value
// value_lo + k * v_scale through postClassify (models/transfunc.py
// `post_classify`, ref: deviceCode.cu:127-135), RGB, in its f32 order.
__global__ void __launch_bounds__(256)
code_table_kernel(const TrackQParams p, const MarchArgs m) {
  const int code = threadIdx.x;
  const float tf_lo = __ldg(m.tf_range), tf_hi = __ldg(m.tf_range + 1);
  const int S = p.lut_size;
  const float v = p.value_lo + static_cast<float>(code) * m.v_scale;
  const float vn = (v - tf_lo) / (tf_hi - tf_lo);
  const float vs = vn * static_cast<float>(S);
  const int idx = static_cast<int>(vs);
  const float frac = vs - static_cast<float>(idx);
  const float* l1 = p.lut + min(max(idx, 0), S - 1) * 4;
  const float* l2 = p.lut + min(max(idx + 1, 0), S - 1) * 4;
  const float w2 = 1.0f - frac;
  reinterpret_cast<float4*>(m.tab)[code] =
      make_float4(__ldg(l1 + 0) * frac + __ldg(l2 + 0) * w2,
                  __ldg(l1 + 1) * frac + __ldg(l2 + 1) * w2,
                  __ldg(l1 + 2) * frac + __ldg(l2 + 2) * w2, 0.0f);
}

__global__ void __launch_bounds__(kBlock, kQMinBlocks)
march_q_kernel(const TrackQParams p, const MarchArgs m) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.c.n_lanes) return;
  march_lane<QTier, QLayers>(p.c, QTier{p}, m, lane);
}

}  // namespace

// Launch the f32 / quantized march on `stream` (PyTorch's current stream);
// the quantized one first writes the code table into margs->tab, which the
// caller allocates.  They allocate nothing and do not synchronise.  Return
// cudaGetLastError().
extern "C" int march_f32_launch(const TrackParams* params,
                                const MarchArgs* margs, void* stream) {
  if (params->c.n_lanes <= 0) return 0;
  const int grid = (params->c.n_lanes + kBlock - 1) / kBlock;
  march_f32_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *params, *margs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int march_q_launch(const TrackQParams* params,
                              const MarchArgs* margs, void* stream) {
  if (params->c.n_lanes <= 0) return 0;
  const int grid = (params->c.n_lanes + kBlock - 1) / kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  code_table_kernel<<<1, 256, 0, s>>>(*params, *margs);
  march_q_kernel<<<grid, kBlock, 0, s>>>(*params, *margs);
  return static_cast<int>(cudaGetLastError());
}

// K3's kernel of `tier` (0: f32, 1: quantized): out[0] its resident
// 128-thread blocks an SM, out[1] its registers, out[2] its local (stack
// and spill) bytes a thread.  Returns the first CUDA error.
extern "C" int march_occupancy(int tier, int* out) {
  return tier == 0 ? track::occupancy(march_f32_kernel, kBlock, out)
                   : track::occupancy(march_q_kernel, kBlock, out);
}
