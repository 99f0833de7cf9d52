// K8 `parity_track`: the reference-parity raygens, one thread per pixel.
//
// Replaces the XLA-fused loops of icon_rt_tpu/ops/render.py
// (`generate_ray`, `_pixel_ae`, `_pixel_accel`, `_finalize`),
// icon_rt_tpu/ops/woodcock.py `woodcock_track`, icon_rt_tpu/ops/traverse.py
// (`_woodcock_step`, `trace_dda3`, `trace_sdda` and their helpers),
// icon_rt_tpu/models/cells.py (`find_layer`, `sample_one_cell`,
// `sample_brute_force`), icon_rt_tpu/models/locator.py `sample_locator` and,
// as the wedge sampler (K9-p), icon_rt_tpu/models/wedges.py `sample_wedges`
// with icon_rt_tpu/ops/uelems.py `_newton` and `intersect_wedge`.  Its
// plain-PyTorch version is `_parity_torch` in ops/render.py.
//
// The shape is the reference's own (deviceCode.cu:239-341): each thread
// takes its pixel's LCG seed and jittered ray, clips it to the volume box,
// runs the tracking loop with its point sampler as a device function,
// classifies through the (S, 4) LUT and finalizes (running-average lerp,
// sRGB, RGBA8 pack; a ray that misses the box leaves accum and fb as they
// were).  In raw mode (non-null raw_ca) it stores the sample instead --
// wrote = the box test, the colour and alpha it would blend, 0 without a
// box hit -- and leaves the finalize to K10's mean over a samples axis
// (icon_rt_tpu/parallel/sharded.py:127-132).  One template covers raygen
// {AE, SPHERE, GRID} x sampler {LOCATOR, BRUTE, WEDGE}:
//   AE      Woodcock tracking of the whole box segment at majorant 1;
//   GRID    the Cartesian 3-DDA over per-bin majorants (DDA.h:37-136);
//   SPHERE  the spherical-shell DDA with the reference's degenerate r = 0
//           lat/lon planes (ShellAccel.h:82-229): the whole shell segment
//           at the entry cell's majorant, then zero-length visits that step
//           lat and lon together, one draw each where the majorant is > 0.
// The traversals are the JAX package's state machines, one Woodcock step
// and at most one advance per iteration, so a lane's iteration count (the
// debug output) is the plain version's.
// The WEDGE sampler (the reference's cuBQL mode) takes the point's locator
// bin, and for each candidate column in bin order the window of layer_pad
// wedges upward from find_layer(r), and returns the value of the first
// wedge whose Newton inversion (csrc/uelems.cuh) contains the point: the
// JAX package's argmax order.  No candidate is skipped before the hit on
// any other test (a side-plane pre-test would change results at boundary
// ties); the window stops at the column's top layer, where the JAX
// version masks.
//
// Bit for bit with the plain version: built with -fmad=false and without
// --use_fast_math (IEEE division and square root), every expression in the
// plain version's operation order; the direction is normalised by three
// divisions (not the fast tiers' reciprocal multiply); |d| < 1e-5 becomes
// +1e-5; the seed is accum_id * W * H + x in wrapping u32; the sdda bin
// wraps with a floored modulo.
//
// The frame's scalars -- the camera, the box bounds, the ambient terms, the
// unit distance and accum_id (`TrackFrame`, shared with K1-K3), the TF's
// value range and opacity scale, the cells' radial shell, the locator
// window and the accel bounds -- are read on the card from the tensors that
// hold them, so a launch reads nothing back from the card.
//
// What bounds it on the H100: the serial chain of each AE lane's free-path
// draws (an AE ray that crosses the box beside the globe takes ~1e4 steps
// at the app's unit distance), the dependent reads of each locate (bins row
// -> candidate planes -> heights and value) and of the brute-force scan,
// and the divergence of lanes whose paths differ by orders of magnitude in
// steps.  Two exact short cuts keep the results bit for bit:
//   * the whole-shell test: a point whose radius lies outside [min h_bot,
//     max h_top] of the cells (or is NaN) fails every cell's radial test,
//     so the locator and brute samplers return no cell without a square
//     root, a locate or a read (it tests the squared radius against the
//     exact bounds of the squares, `Shell`); the wedge sampler tests the
//     wedges' own shell (models/wedges.py `wedge_shell`: a wedge's flat
//     faces dip below its column's h_bot, and Newton accepts points a
//     little outside a wedge's hull), which no point it accepts lies
//     outside;
//   * the brute-force scan reads the radii and first planes of kGroup cells
//     together, then tests them in id order.
// Drawing AE's free paths ahead of the samples that consume them gained
// nothing on top of these (scripts/time_parity.py), so AE draws as the
// plain loop does.
#include <type_traits>

#include "track_common.cuh"
#include "uelems.cuh"

struct ParityParams {
  const float* planes;       // (N, 3, 4), rows read as float4
  const float* h_bot;        // (N,)
  const float* h_top;        // (N,)
  const float* heights;      // (N, 32)
  const float* value;        // (N, 32)
  const int32_t* num_layers; // (N,)
  const int32_t* bins;       // (n_lat * n_lon, k_cap), ascending, -1 tail
  const float* majors;       // (prod(dims),) accel majorants
  const float* lut;          // (S, 4)
  const int32_t* pix;        // (n_lanes,) pixel ids, or null: lane = pixel
  float* accum;              // (n_lanes, 4) in/out
  int32_t* fb;               // (n_lanes,) in/out, u32 bits
  int32_t* dbg;              // (n_lanes, 2) final rng, iterations; or null
  TrackFrame frame;          // camera, ambient terms, unit distance, accum_id
  const float* blo;          // (3,) volume world bounds
  const float* bhi;          // (3,)
  const float* vr;           // (2,) TF value range
  const float* opacity_scale;  // ()
  const float* shell;        // (4,) min h_bot, max h_top, their squares'
                             // bounds (models/cells.py `shell_range`);
                             // the WEDGE sampler's models/wedges.py
                             // `wedge_shell`
  const float* win[4];       // locator lat_lo, lat_hi, lon_lo, lon_hi (())
  const float* acc_lo;       // (3,) accel bounds (world, or r/lat/lon)
  const float* acc_hi;       // (3,)
  int dims[3];
  int n_cells, n_lat, n_lon, k_cap, lut_size;
  int n_lanes, width, height, max_iters;
  const float* wverts;         // (W, 6, 3) wedge vertices (WEDGE sampler)
  const float* wscalars;       // (W, 6)
  const int32_t* woffset;      // (N,) first wedge of each column
  int layer_pad;               // the radial window's width
  uint8_t* raw_wrote;          // raw mode (null = finalize): per lane
  float* raw_ca;               // wrote (L,) and colour, alpha (L, 4); accum
                               // and fb untouched
};

namespace {

constexpr int kAE = 0, kSphere = 1, kGrid = 2;
constexpr int kLocator = 0, kBrute = 1, kWedge = 2;
constexpr int kSamplers = 3;
constexpr float kFltMax = 3.40282347e38f;
// cells whose radii and first planes the brute-force scan reads together
constexpr int kGroup = 4;

// The sampler's radial shell [lo, hi] as bounds of the squared radius s,
// shell[2] and shell[3] of models/cells.py `shell_range` (the WEDGE
// sampler's: models/wedges.py `wedge_shell`): sqrtf is
// correctly rounded, so monotone, and lo <= sqrtf(s) <= hi holds exactly
// when s_lo <= s <= s_hi (NaN in neither).
struct Shell {
  float s_lo, s_hi;
};

__device__ __forceinline__ float min3(const float v[3]) {
  return fminf(fminf(v[0], v[1]), v[2]);
}

// The side-plane test of cell c (ICONGrid.h:197-208), its first plane's
// row e0 already read; the other two are read as float4 while they pass.
__device__ __forceinline__ bool inside_planes(const ParityParams& p, int c,
                                              float4 e, float px, float py,
                                              float pz) {
  const float4* pl =
      reinterpret_cast<const float4*>(p.planes) + static_cast<size_t>(c) * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k > 0) e = __ldg(pl + k);
    const float ev = e.x * px + e.y * py + e.z * pz - e.w;
    if (!(ev <= 0.0f)) return false;
  }
  return true;
}

// Containment of a point with radius r in cell c (ICONGrid.h:181-208).
__device__ __forceinline__ bool inside_cell(const ParityParams& p, int c,
                                            float px, float py, float pz,
                                            float r) {
  if (!(r >= __ldg(p.h_bot + c) && r <= __ldg(p.h_top + c))) return false;
  return inside_planes(
      p, c,
      __ldg(reinterpret_cast<const float4*>(p.planes) +
            static_cast<size_t>(c) * 3),
      px, py, pz);
}

// The layer of cell c at radius r: the number of ceilings
// height[1..num_layers] below r (find_layer's masked count).  A binary
// search over the first min(nl, 31) ceilings gives the same layer for
// ascending ceilings and was measured (PERF.md §6): 3% faster on the
// wedge sampler's `main ae w` and `main grid w`, 20% slower on grid x
// brute at the check scene, so the count stays.
__device__ __forceinline__ int find_layer(const ParityParams& p, int c,
                                          int nl, float r) {
  const float* h = p.heights + static_cast<size_t>(c) * 32;
  int layer = 0;
  for (int k = 1; k < 32 && k <= nl; ++k) layer += (__ldg(h + k) < r) ? 1 : 0;
  return layer;
}

// The value of cell c's layer at radius r.
__device__ __forceinline__ float layer_value(const ParityParams& p, int c,
                                             float r) {
  const int layer = find_layer(p, c, __ldg(p.num_layers + c), r);
  return __ldg(p.value + static_cast<size_t>(c) * 32 + layer);
}

// The wedge sampler's test of column c: the window of layer_pad wedges
// upward from find_layer(r), each inverted by Newton; true and the value
// of the first that contains the point.
__device__ __forceinline__ bool wedge_column(const ParityParams& p, int c,
                                             float px, float py, float pz,
                                             float r, float& value) {
  const int nl = __ldg(p.num_layers + c);
  const int base = find_layer(p, c, nl, r);
  const int w0 = __ldg(p.woffset + c);
  for (int d = 0; d < p.layer_pad; ++d) {
    const int layer = base + d;
    if (layer >= nl) return false;    // the rest of the window is above
    const size_t w = static_cast<size_t>(w0 + layer);
    float V[6][3];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        V[k][j] = __ldg(p.wverts + w * 18 + k * 3 + j);
    }
    // the wedge's scalars are read only if it contains the point
    if (uelems::newton<6>(px, py, pz, V, p.wscalars + w * 6, value))
      return true;
  }
  return false;
}

// Point sample: true and the value if a cell contains the point.  Each
// sampler first tests its whole shell: a radius outside it (or NaN) fails
// every cell's radial test below, or every wedge's Newton inversion.
template <int SAMPLER>
__device__ bool sample(const ParityParams& p, const Shell& sh, float px,
                       float py, float pz, float& value) {
  const float s = px * px + py * py + pz * pz;
  if (!(s >= sh.s_lo && s <= sh.s_hi)) return false;
  const float r = sqrtf(s);
  if (SAMPLER == kBrute) {
    // kGroup cells at a time: their radii and first planes read together,
    // then tested in id order, so the first containing cell wins
    const float4* planes = reinterpret_cast<const float4*>(p.planes);
    int c = 0;
    for (; c + kGroup <= p.n_cells; c += kGroup) {
      float hb[kGroup], ht[kGroup];
      float4 e0[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        hb[j] = __ldg(p.h_bot + c + j);
        ht[j] = __ldg(p.h_top + c + j);
        e0[j] = __ldg(planes + static_cast<size_t>(c + j) * 3);
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (r >= hb[j] && r <= ht[j] &&
            inside_planes(p, c + j, e0[j], px, py, pz)) {
          value = layer_value(p, c + j, r);
          return true;
        }
      }
    }
    for (; c < p.n_cells; ++c) {
      if (inside_cell(p, c, px, py, pz, r)) {
        value = layer_value(p, c, r);
        return true;
      }
    }
    return false;
  } else {
    const float lat = asinf(pz / r);
    const float lon = atan2f(py, px);
    const int bl = track::grid_bin(lat, __ldg(p.win[0]), __ldg(p.win[1]),
                                   p.n_lat);
    const int bo = track::grid_bin(lon, __ldg(p.win[2]), __ldg(p.win[3]),
                                   p.n_lon);
    const int bin = bl * p.n_lon + bo;
    const int32_t* row = p.bins + static_cast<size_t>(bin) * p.k_cap;
    // candidates ascend by id and -1 pads only the tail, so the first
    // containing one is the lowest-id cell, as the brute-force scan's
    for (int s = 0; s < p.k_cap; ++s) {
      const int c = __ldg(row + s);
      if (c < 0) break;
      if (SAMPLER == kWedge) {
        if (wedge_column(p, c, px, py, pz, r, value)) return true;
      } else if (inside_cell(p, c, px, py, pz, r)) {
        value = layer_value(p, c, r);
        return true;
      }
    }
    return false;
  }
}

// postClassify (deviceCode.cu:127-135) with the reference's asymmetric
// lerp: lut[i] * frac + lut[i+1] * (1 - frac) * (1, 1, 1, opacity_scale).
__device__ __forceinline__ void classify(const ParityParams& p, float v,
                                         float rgba[4]) {
  const int S = p.lut_size;
  const float lo = __ldg(p.vr), hi = __ldg(p.vr + 1);
  const float vn = (v - lo) / (hi - lo);
  const float vs = vn * static_cast<float>(S);
  const int idx = static_cast<int>(vs);
  const float frac = vs - static_cast<float>(idx);
  const float* a = p.lut + min(max(idx, 0), S - 1) * 4;
  const float* b = p.lut + min(max(idx + 1, 0), S - 1) * 4;
  const float os = __ldg(p.opacity_scale);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const float sc = ch == 3 ? os : 1.0f;
    rgba[ch] = __ldg(a + ch) * frac + __ldg(b + ch) * (1.0f - frac) * sc;
  }
}

// A lane's ray, its LCG state, its result and its iterations.
struct Ray {
  float o[3], d[3];
  uint32_t rng;
  float color[3], alpha;
  int it;
};

// One tentative collision of the accel raygen (deviceCode.cu:160-183) and
// woodcockFunc's window check (:304-323).  Returns seg_over; sets
// `collided` and the sample's rgba.
template <int SAMPLER>
__device__ bool woodcock_step(const ParityParams& p, const Shell& sh, Ray& R,
                              float ud, float& wt, float seg0, float seg1,
                              float m, bool& collided, float rgba[4]) {
  collided = false;
  if (!(m > 0.0f)) return true;          // a zero majorant draws nothing
  const float xi = track::lcg_next(R.rng);
  wt = wt - logf(1.0f - xi) / (m / ud);
  if (wt > seg1) return true;            // beyond the segment
  float value;
  if (!sample<SAMPLER>(p, sh, R.o[0] + R.d[0] * wt, R.o[1] + R.d[1] * wt,
                       R.o[2] + R.d[2] * wt, value))
    return false;
  classify(p, value, rgba);
  const float u = track::lcg_next(R.rng);
  if (!(rgba[3] >= u * m)) return false;
  collided = (wt > seg0) && (wt < seg1);
  return true;
}

__device__ __forceinline__ void record(Ray& R, const float rgba[4]) {
  R.color[0] = rgba[0];
  R.color[1] = rgba[1];
  R.color[2] = rgba[2];
  R.alpha = rgba[3] > 0.0f ? 1.0f : 0.0f;
}

// AE: the whole box segment [t0, t1] at majorant 1 (woodcock.py:31).
template <int SAMPLER>
__device__ void track_ae(const ParityParams& p, const Shell& sh, Ray& R,
                         float ud, float t0, float t1) {
  const float rate = 1.0f / ud;
  float t = t0;
  while (R.it < p.max_iters) {
    ++R.it;
    const float xi = track::lcg_next(R.rng);
    t = t - logf(1.0f - xi) / rate;
    if (t > t1) return;
    float value;
    if (!sample<SAMPLER>(p, sh, R.o[0] + R.d[0] * t, R.o[1] + R.d[1] * t,
                         R.o[2] + R.d[2] * t, value))
      continue;
    float rgba[4];
    classify(p, value, rgba);
    const float u = track::lcg_next(R.rng);
    if (rgba[3] >= u * 1.0f) {
      R.color[0] = rgba[0];
      R.color[1] = rgba[1];
      R.color[2] = rgba[2];
      R.alpha = rgba[3] > 0.0f ? 1.0f : 0.0f;
      return;
    }
  }
}

__device__ __forceinline__ int linear_index(const int cell[3],
                                            const int dims[3]) {
  return cell[2] * dims[0] * dims[1] + cell[1] * dims[0] + cell[0];
}

// GRID: the Cartesian 3-DDA (traverse.py:84-184).
template <int SAMPLER>
__device__ void track_grid(const ParityParams& p, const Shell& sh, Ray& R,
                           float ud, float tmin, float tmax) {
  const float ray_tmin = tmin;
  const float tmax_s = tmax - ray_tmin;
  int cell[3], step[3], stop[3];
  float tnext[3], dist[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float os = R.o[k] + ray_tmin * R.d[k];     // shifted so tmin = 0
    const float rcp = 1.0f / R.d[k];
    const float alo = __ldg(p.acc_lo + k), ahi = __ldg(p.acc_hi + k);
    const float lo = (alo - os) * rcp;
    const float hi = (ahi - os) * rcp;
    const float tnear = fminf(lo, hi), tfar = fmaxf(lo, hi);
    const float dimf = static_cast<float>(p.dims[k]);
    const float v01 = (os - alo) / (ahi - alo);
    cell[k] = min(max(static_cast<int>(v01 * dimf), 0), p.dims[k] - 1);
    dist[k] = fmaxf(0.0f, (tfar - tnear) / dimf);
    const bool pos = R.d[k] > 0.0f;
    step[k] = pos ? 1 : -1;
    stop[k] = pos ? p.dims[k] : -1;
    tnext[k] = pos ? tnear + static_cast<float>(cell[k] + 1) * dist[k]
                   : tnear + static_cast<float>(p.dims[k] - cell[k]) * dist[k];
  }
  float t1 = fminf(min3(tnext), tmax_s);
  float seg0 = ray_tmin + 0.0f, seg1 = ray_tmin + t1;
  float m = __ldg(p.majors + linear_index(cell, p.dims));
  float wt = seg0;
  while (R.it < p.max_iters) {
    ++R.it;
    bool collided;
    float rgba[4];
    const bool seg_over =
        woodcock_step<SAMPLER>(p, sh, R, ud, wt, seg0, seg1, m, collided,
                               rgba);
    if (collided) {
      record(R, rgba);
      return;
    }
    if (!seg_over) continue;
    // DDA advance (DDA.h:110-133): every axis at the closest crossing
    // steps, in order, up to the first that leaves the grid
    const float tc = min3(tnext);
    bool out = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (!out && tnext[k] == tc) {
        tnext[k] = tnext[k] + dist[k];
        cell[k] += step[k];
        out = cell[k] == stop[k];
      }
    }
    if (out) return;
    const float t0 = t1;
    t1 = fminf(min3(tnext), tmax_s);
    seg0 = ray_tmin + t0;
    seg1 = ray_tmin + t1;
    m = __ldg(p.majors + linear_index(cell, p.dims));
    wt = seg0;
  }
}

// Origin-centred sphere of radius rad (ShellAccel.h:34-53).
__device__ __forceinline__ bool intersect_sphere(const Ray& R, float rad,
                                                 float& tn, float& tf) {
  const float a = R.d[0] * R.d[0] + R.d[1] * R.d[1] + R.d[2] * R.d[2];
  const float b = (R.d[0] * R.o[0] + R.d[1] * R.o[1] + R.d[2] * R.o[2]) *
                  2.0f;
  const float c = (R.o[0] * R.o[0] + R.o[1] * R.o[1] + R.o[2] * R.o[2]) -
                  rad * rad;
  const float disc = b * b - 4.0f * a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float q = b < 0.0f ? -0.5f * (b - sq) : -0.5f * (b + sq);
  const float t1 = q / a, t2 = c / q;
  tn = fminf(t1, t2);
  tf = fmaxf(t1, t2);
  return disc >= 0.0f;
}

// (r, lat, lon) of the point o + d * t, projected on the shell grid
// unclamped and scaled by dims - 1 (ShellAccel.h:57-68).
__device__ __forceinline__ void project_point(const ParityParams& p,
                                              const Ray& R, float t,
                                              float sph[3], int idx[3]) {
  const float x = R.o[0] + R.d[0] * t, y = R.o[1] + R.d[1] * t,
              z = R.o[2] + R.d[2] * t;
  const float r = sqrtf(x * x + y * y + z * z);
  sph[0] = r;
  sph[1] = asinf(z / r);
  sph[2] = atan2f(y, x);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    idx[k] = static_cast<int>((sph[k] - __ldg(p.acc_lo + k)) /
                              (__ldg(p.acc_hi + k) - __ldg(p.acc_lo + k)) *
                              static_cast<float>(p.dims[k] - 1));
}

// Enter range [rlo, rhi] (ShellAccel.h:113-162); false if it is empty.
__device__ __forceinline__ bool range_setup(const ParityParams& p,
                                            const Ray& R, float rlo,
                                            float rhi, float eps, int cell[3],
                                            int step[3], int stop[3],
                                            float tnext[3]) {
  float sp1[3], sp2[3];
  int c2[3];
  project_point(p, R, rlo + eps, sp1, cell);
  project_point(p, R, rhi - eps, sp2, c2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    step[k] = sp1[k] < sp2[k] ? 1 : -1;
    stop[k] = c2[k] + step[k];
  }
  // the lat/lon planes are degenerate (r = 0, a zero plane): eval == 0
  tnext[0] = rhi;
  tnext[1] = 0.0f;
  tnext[2] = 0.0f;
  return !(rhi <= rlo);
}

// Loop-head visit (ShellAccel.h:163-172): the smallest tnext >= t, and the
// majorant of the cell wrapped into the grid by a floored modulo.
__device__ __forceinline__ float shell_visit(const ParityParams& p,
                                             const int cell[3],
                                             const float tnext[3], float t,
                                             float& m) {
  int w[3];
  float t1 = kFltMax;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w[k] = ((cell[k] % p.dims[k]) + p.dims[k]) % p.dims[k];
    t1 = fminf(t1, tnext[k] >= t ? tnext[k] : kFltMax);
  }
  m = __ldg(p.majors + linear_index(w, p.dims));
  return t1;
}

// SPHERE: the spherical-shell DDA (traverse.py:212-341).
template <int SAMPLER>
__device__ void track_sphere(const ParityParams& p, const Shell& sh, Ray& R,
                             float ud, float tmin) {
  float ts1, ts4, ts2, ts3;
  const float r_in = __ldg(p.acc_lo), r_out = __ldg(p.acc_hi);
  const bool hit1 = intersect_sphere(R, r_out, ts1, ts4);
  const bool hit2 = intersect_sphere(R, r_in, ts2, ts3);
  if ((!hit1 && !hit2) || ts4 < tmin) return;
  // segment table (ShellAccel.h:94-111)
  const bool outer_only = hit1 && !hit2;
  const bool front = tmin < ts2;
  const float r_lo[2] = {(outer_only || front) ? ts1 : ts3,
                         outer_only ? kFltMax : (front ? ts3 : kFltMax)};
  const float r_hi[2] = {outer_only ? ts4 : (front ? ts2 : ts4),
                         outer_only ? -kFltMax : (front ? ts4 : -kFltMax)};
  const float eps = r_in * 1e-6f;
  int cell[3], step[3], stop[3];
  float tnext[3];
  if (!range_setup(p, R, r_lo[0], r_hi[0], eps, cell, step, stop, tnext))
    return;
  int si = 0;
  float t = r_lo[0];
  float m;
  float t1 = shell_visit(p, cell, tnext, t, m);
  float wt = t;
  while (R.it < p.max_iters) {
    ++R.it;
    bool collided;
    float rgba[4];
    const bool seg_over =
        woodcock_step<SAMPLER>(p, sh, R, ud, wt, t, t1, m, collided, rgba);
    if (collided) {
      record(R, rgba);
      return;
    }
    if (!seg_over) continue;
    // advance (ShellAccel.h:174-201), sequential with break on stop; the
    // radial tnext stays at the range end
    const float tc = min3(tnext);
    bool out = false;
    if (tnext[0] == tc) {
      cell[0] += step[0];
      out = cell[0] == stop[0];
    }
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      if (!out && tnext[k] == tc) {
        cell[k] += step[k];
        if (cell[k] == stop[k])
          out = true;
        else
          tnext[k] = 0.0f;     // the degenerate plane evaluated again
      }
    }
    float t_new = tc;
    if (out) {                 // the next range, or finished
      if (++si > 1) return;
      if (!range_setup(p, R, r_lo[1], r_hi[1], eps, cell, step, stop, tnext))
        return;
      t_new = r_lo[1];
    }
    t1 = shell_visit(p, cell, tnext, t_new, m);
    t = t_new;
    wt = t_new;
  }
}

// RAW: raw mode, an instantiation of its own so that the finalizing one
// compiles as it did without the raw branch
template <int RAYGEN, int SAMPLER, bool RAW>
__global__ void __launch_bounds__(128) parity_kernel(const ParityParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;
  const int pixel = p.pix ? p.pix[lane] : lane;
  const int x = pixel % p.width;
  const int y = pixel / p.width;
  const track::DeviceFrame F{p.frame};
  const int aid = F.accum_id();

  // seed and jittered pinhole ray (render.py:85-109)
  Ray R;
  R.rng = track::lcg_init(static_cast<uint32_t>(aid) *
                                  static_cast<uint32_t>(p.width * p.height) +
                              static_cast<uint32_t>(x),
                          static_cast<uint32_t>(y));
  const float jx = track::lcg_next(R.rng);
  const float jy = track::lcg_next(R.rng);
  const float u = static_cast<float>(x) + 0.5f + jx;
  const float v = static_cast<float>(y) + 0.5f + jy;
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = F[3 + k] + u * F[6 + k] + v * F[9 + k];
  const float n = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dk = d[k] / n;
    R.d[k] = fabsf(dk) < 1e-5f ? 1e-5f : dk;
    R.o[k] = F[k];
  }
  R.color[0] = R.color[1] = R.color[2] = 0.0f;
  R.alpha = 0.0f;
  R.it = 0;

  // box test against the volume bounds (vecmath.h:1926-1937)
  float t0 = 0.0f, t1 = 1e10f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = (__ldg(p.blo + k) - R.o[k]) / R.d[k];
    const float b = (__ldg(p.bhi + k) - R.o[k]) / R.d[k];
    t0 = fmaxf(t0, fminf(a, b));
    t1 = fminf(t1, fmaxf(a, b));
  }
  const bool wrote = t0 < t1;
  if (wrote) {
    const Shell sh{__ldg(p.shell + 2), __ldg(p.shell + 3)};
    const float ud = F.ud();
    if (RAYGEN == kAE)
      track_ae<SAMPLER>(p, sh, R, ud, t0, t1);
    else if (RAYGEN == kGrid)
      track_grid<SAMPLER>(p, sh, R, ud, t0, t1);
    else
      track_sphere<SAMPLER>(p, sh, R, ud, t0);
  }
  // the colour the finalize blends (render.py:120-121)
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    c[k] = R.color[k] * __ldg(p.frame.amb + k) * __ldg(p.frame.amb_rad);
  if (!RAW && wrote) {
    // finalize (render.py:127-139): running average, sRGB, RGBA8
    const float sc = 1.0f / (static_cast<float>(aid) + 1.0f);
    float* acc = p.accum + static_cast<size_t>(lane) * 4;
    float out[4];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = track::blend(sc, c[k], acc[k]);
    out[3] = track::blend(sc, R.alpha, acc[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = out[k];
    p.fb[lane] = static_cast<int32_t>(
        track::make_8bit(track::linear_to_srgb(out[0])) |
        (track::make_8bit(track::linear_to_srgb(out[1])) << 8) |
        (track::make_8bit(track::linear_to_srgb(out[2])) << 16) |
        (track::make_8bit(out[3]) << 24));
  }
  if (RAW) {
    // the sample itself, the colour the finalize blends; 0 where the ray
    // misses the box
    float* ca = p.raw_ca + static_cast<size_t>(lane) * 4;
#pragma unroll
    for (int k = 0; k < 3; ++k) ca[k] = wrote ? c[k] : 0.0f;
    ca[3] = wrote ? R.alpha : 0.0f;
    p.raw_wrote[lane] = wrote ? 1 : 0;
  }
  if (p.dbg) {
    p.dbg[lane * 2] = static_cast<int32_t>(R.rng);
    p.dbg[lane * 2 + 1] = R.it;
  }
}

template <int RAYGEN, int SAMPLER>
void launch(const ParityParams& p, cudaStream_t stream) {
  constexpr int kBlock = 128;
  const int grid = (p.n_lanes + kBlock - 1) / kBlock;
  if (p.raw_ca)
    parity_kernel<RAYGEN, SAMPLER, true><<<grid, kBlock, 0, stream>>>(p);
  else
    parity_kernel<RAYGEN, SAMPLER, false><<<grid, kBlock, 0, stream>>>(p);
}

template <int RAYGEN, int SAMPLER>
int occupancy(int* out) {
  return track::occupancy(parity_kernel<RAYGEN, SAMPLER, false>, 128, out);
}

template <int V>
using Mode = std::integral_constant<int, V>;

// f(Mode<RAYGEN>(), Mode<SAMPLER>()) for raygen (0 AE, 1 SPHERE, 2 GRID)
// and sampler (0 LOCATOR, 1 BRUTE, 2 WEDGE), or cudaErrorInvalidValue for
// an unknown mode: the one switch over the instances
template <class F>
int dispatch(int raygen, int sampler, F&& f) {
  if (sampler < 0 || sampler >= kSamplers)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int n = kSamplers;
  switch (raygen * n + sampler) {
    case kAE * n + kLocator: return f(Mode<kAE>(), Mode<kLocator>());
    case kAE * n + kBrute: return f(Mode<kAE>(), Mode<kBrute>());
    case kAE * n + kWedge: return f(Mode<kAE>(), Mode<kWedge>());
    case kSphere * n + kLocator: return f(Mode<kSphere>(), Mode<kLocator>());
    case kSphere * n + kBrute: return f(Mode<kSphere>(), Mode<kBrute>());
    case kSphere * n + kWedge: return f(Mode<kSphere>(), Mode<kWedge>());
    case kGrid * n + kLocator: return f(Mode<kGrid>(), Mode<kLocator>());
    case kGrid * n + kBrute: return f(Mode<kGrid>(), Mode<kBrute>());
    case kGrid * n + kWedge: return f(Mode<kGrid>(), Mode<kWedge>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches raygen (0 AE, 1 SPHERE, 2 GRID) with sampler (0 LOCATOR,
// 1 BRUTE, 2 WEDGE) on `stream` (PyTorch's current stream); allocates
// nothing, reads nothing back and does not synchronise.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown mode.
extern "C" int parity_launch(const ParityParams* params, int raygen,
                             int sampler, void* stream) {
  if (params->n_lanes <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = dispatch(raygen, sampler, [&](auto rg, auto sp) {
    launch<decltype(rg)::value, decltype(sp)::value>(*params, s);
    return 0;
  });
  return err ? err : static_cast<int>(cudaGetLastError());
}

// The finalizing kernel of raygen x sampler (as `parity_launch`): out[0]
// its resident 128-thread blocks an SM, out[1] its registers, out[2] its
// local (stack and spill) bytes a thread.  Returns the first CUDA error,
// or cudaErrorInvalidValue for an unknown mode.
extern "C" int parity_occupancy(int raygen, int sampler, int* out) {
  return dispatch(raygen, sampler, [&](auto rg, auto sp) {
    return occupancy<decltype(rg)::value, decltype(sp)::value>(out);
  });
}
