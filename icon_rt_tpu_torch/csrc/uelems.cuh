// The Newton intersectors of unstructured elements as device functions:
// pyramid (5 vertices), wedge (6) and hexahedron (8), over register arrays.
//
// The JAX package's icon_rt_tpu/ops/uelems.py `_newton` and its shape
// tables (ref: icon_rt/UElems.h:78-471).  Its plain-PyTorch version is
// ops/uelems.py `newton`; every expression here is that version's, in its
// order (sums in vertex order, one fixed determinant expression), so a
// kernel built with -fmad=false equals it bit for bit.  The loop leaves as
// soon as the point converges or fails: the plain version's masked
// iterations change nothing after that.
//
// What the loop keeps live: the element's vertices, the point, the
// pcoords and the pcoords before the last update (3 floats, not the NV
// weights of that iteration: the weights are evaluated from them once,
// after the loop, with the same expressions, so they are the same bits).
// The scalars S are read only for a point that is inside, so a caller
// passes a pointer and an element that does not contain its point costs
// no scalar read.
//
// Users: K9-n `uelems_points` (csrc/uelems.cu) and the wedge sampler of
// K8 (csrc/parity.cu `sample<kWedge>`, K9-p).
#pragma once

#include <cuda_runtime.h>

namespace uelems {

constexpr int kMaxIteration = 10;
// each tolerance rounded once from its double value, as the plain version's
constexpr float kConverged = static_cast<float>(1e-4);
constexpr float kDiverged = static_cast<float>(1e6);
constexpr float kTiny = static_cast<float>(1e-30);
constexpr float kTolScale = static_cast<float>(1e-6);
constexpr float kBoxLo = static_cast<float>(0.0 - 1e-6);
constexpr float kBoxHi = static_cast<float>(1.0 + 1e-6);

// Shape weights w and derivatives dr, ds, dt at parametric (r, s, t);
// kZeroR, kZeroS: the vertices whose r or s derivative is the constant 0,
// kOneT: those whose t derivative is the constant 1 (bit k: vertex k).
template <int NV>
struct Shape;

template <>
struct Shape<6> {    // wedge: v0..v2 the bottom face (t = 0), v3..v5 the top
  static constexpr unsigned kZeroR = 0x24, kZeroS = 0x12, kOneT = 0;
  static __device__ __forceinline__ void eval(float r, float s, float t,
                                              float w[6], float dr[6],
                                              float ds[6], float dt[6]) {
    const float rs = 1.0f - r - s;
    const float tm = 1.0f - t;
    w[0] = rs * tm; w[1] = r * tm; w[2] = s * tm;
    w[3] = rs * t;  w[4] = r * t;  w[5] = s * t;
    dr[0] = -1.0f + t; dr[1] = tm; dr[2] = 0.0f;
    dr[3] = -t;        dr[4] = t;  dr[5] = 0.0f;
    ds[0] = -1.0f + t; ds[1] = 0.0f; ds[2] = tm;
    ds[3] = -t;        ds[4] = 0.0f; ds[5] = t;
    dt[0] = -1.0f + r + s; dt[1] = -r; dt[2] = -s;
    dt[3] = rs;            dt[4] = r;  dt[5] = s;
  }
  static __device__ __forceinline__ bool extra(const float pc[3]) {
    return pc[0] + pc[1] <= kBoxHi;
  }
};

template <>
struct Shape<5> {    // pyramid
  static constexpr unsigned kZeroR = 0x10, kZeroS = 0x10, kOneT = 0x10;
  static __device__ __forceinline__ void eval(float r, float s, float t,
                                              float w[5], float dr[5],
                                              float ds[5], float dt[5]) {
    const float rm = 1.0f - r, sm = 1.0f - s, tm = 1.0f - t;
    w[0] = rm * sm * tm; w[1] = r * sm * tm; w[2] = r * s * tm;
    w[3] = rm * s * tm;  w[4] = t;
    dr[0] = -(s - 1.0f) * (t - 1.0f); dr[1] = (s - 1.0f) * (t - 1.0f);
    dr[2] = s - s * t; dr[3] = s * (t - 1.0f); dr[4] = 0.0f;
    ds[0] = -(r - 1.0f) * (t - 1.0f); ds[1] = r * (t - 1.0f);
    ds[2] = r - r * t; ds[3] = (r - 1.0f) * (t - 1.0f); ds[4] = 0.0f;
    dt[0] = -(r - 1.0f) * (s - 1.0f); dt[1] = r * (s - 1.0f);
    dt[2] = -r * s; dt[3] = (r - 1.0f) * s; dt[4] = 1.0f;
  }
  static __device__ __forceinline__ bool extra(const float*) { return true; }
};

template <>
struct Shape<8> {    // hexahedron
  static constexpr unsigned kZeroR = 0, kZeroS = 0, kOneT = 0;
  static __device__ __forceinline__ void eval(float r, float s, float t,
                                              float w[8], float dr[8],
                                              float ds[8], float dt[8]) {
    const float rm = 1.0f - r, sm = 1.0f - s, tm = 1.0f - t;
    w[0] = rm * sm * tm; w[1] = r * sm * tm; w[2] = r * s * tm;
    w[3] = rm * s * tm;  w[4] = rm * sm * t; w[5] = r * sm * t;
    w[6] = r * s * t;    w[7] = rm * s * t;
    dr[0] = -sm * tm; dr[1] = sm * tm; dr[2] = s * tm; dr[3] = -s * tm;
    dr[4] = -sm * t;  dr[5] = sm * t;  dr[6] = s * t;  dr[7] = -s * t;
    ds[0] = -rm * tm; ds[1] = -r * tm; ds[2] = r * tm; ds[3] = rm * tm;
    ds[4] = -rm * t;  ds[5] = -r * t;  ds[6] = r * t;  ds[7] = rm * t;
    dt[0] = -rm * sm; dt[1] = -r * sm; dt[2] = -r * s; dt[3] = -rm * s;
    dt[4] = rm * sm;  dt[5] = r * sm;  dt[6] = r * s;  dt[7] = rm * s;
  }
  static __device__ __forceinline__ bool extra(const float*) { return true; }
};

// a . (b x c), summed x, y, z in order (ops/uelems.py `_det3`).
__device__ __forceinline__ float det3(const float a[3], const float b[3],
                                      const float c[3]) {
  return a[0] * (b[1] * c[2] - b[2] * c[1]) +
         a[1] * (b[2] * c[0] - b[0] * c[2]) +
         a[2] * (b[0] * c[1] - b[1] * c[0]);
}

// sum_k V[k][j] * w[k] in vertex order, for j = 0..2, without the terms
// whose weight is the constant 0 (bit k of ZERO) and with V[k][j] itself
// where the weight is the constant 1 (bit k of ONE).  x + 0 * v is x and
// 1 * v is v for every x other than a zero (whose sign the left-out term
// could flip), so this is the full sum's value; the plain version leaves
// out the same terms (ops/uelems.py `_ZERO`, `_ONE`).
template <int NV, unsigned ZERO = 0, unsigned ONE = 0>
__device__ __forceinline__ void vsum(const float V[][3], const float w[NV],
                                     float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc = 0.0f;
    bool first = true;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((ZERO >> k) & 1u) continue;
      const float term = ((ONE >> k) & 1u) ? V[k][j] : w[k] * V[k][j];
      acc = first ? term : acc + term;
      first = false;
    }
    out[j] = acc;
  }
}

// Point P in the element V: true and the value interpolated from the
// scalars at S (nv floats, read only for a point inside) with the weights
// of the last executed iteration if the inversion converges inside the
// parametric box; else false and 0.
template <int NV>
__device__ __forceinline__ bool newton(float px, float py, float pz,
                                       const float V[][3], const float* S,
                                       float& value) {
  float bbox[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float lo = V[0][j], hi = V[0][j];
#pragma unroll
    for (int k = 1; k < NV; ++k) {
      lo = fminf(lo, V[k][j]);
      hi = fmaxf(hi, V[k][j]);
    }
    bbox[j] = hi - lo;
  }
  const float tol =
      (bbox[0] * bbox[0] + bbox[1] * bbox[1] + bbox[2] * bbox[2]) * kTolScale;
  const float P[3] = {px, py, pz};
  float pc[3] = {0.5f, 0.5f, 0.5f}, last[3];
  value = 0.0f;
  bool converged = false;
  for (int it = 0; it < kMaxIteration; ++it) {
    float w[NV], dr[NV], ds[NV], dt[NV];
    Shape<NV>::eval(pc[0], pc[1], pc[2], w, dr, ds, dt);
    float fcol[3], rcol[3], scol[3], tcol[3];
    vsum<NV>(V, w, fcol);
    fcol[0] = fcol[0] - P[0];
    fcol[1] = fcol[1] - P[1];
    fcol[2] = fcol[2] - P[2];
    vsum<NV, Shape<NV>::kZeroR>(V, dr, rcol);
    vsum<NV, Shape<NV>::kZeroS>(V, ds, scol);
    vsum<NV, 0, Shape<NV>::kOneT>(V, dt, tcol);
    const float d = det3(rcol, scol, tcol);
    if (fabsf(d) < tol) return false;  // a singular Jacobian: failed
    const float d_safe = fabsf(d) < kTiny ? 1.0f : d;
    const float step[3] = {det3(fcol, scol, tcol) / d_safe,
                           det3(rcol, fcol, tcol) / d_safe,
                           det3(rcol, scol, fcol) / d_safe};
    bool conv = true, div = false;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      last[j] = pc[j];
      pc[j] = pc[j] - step[j];
      conv = conv && fabsf(step[j]) < kConverged;
      div = div || fabsf(pc[j]) > kDiverged;
    }
    if (conv) {
      converged = true;
      break;
    }
    if (div) return false;             // diverged
  }
  bool inside = converged && Shape<NV>::extra(pc);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    inside = inside && pc[j] >= kBoxLo && pc[j] <= kBoxHi;
  if (!inside) return false;
  float w[NV], dr[NV], ds[NV], dt[NV];
  Shape<NV>::eval(last[0], last[1], last[2], w, dr, ds, dt);
  float v = w[0] * __ldg(S);
#pragma unroll
  for (int k = 1; k < NV; ++k) v = v + w[k] * __ldg(S + k);
  value = v;
  return true;
}

}  // namespace uelems
