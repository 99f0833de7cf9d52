// K7-scene `synth_quantized_device`: the procedural quantized scene built on
// the card, one thread per cell, in three launches.
//
// Replaces the XLA-fused icon_rt_tpu/data/device_scene.py `_cell_corners`,
// `_orient_ccw`, `_default_field_jnp` and the two `lax.map` passes of
// `synth_quantized_device`.  Its plain-PyTorch version is
// `_scene_ancestors_torch`, `_scene_pass1_torch` and `_scene_pass2_torch`
// in data/device_scene.py.
//
// Cell i of a subdivision-s icosphere is base face i % 20, refined along the
// base-4 digits of i // 20 (least significant digit first); every step
// renormalises all three corners.  The corners are then oriented CCW seen
// from outside (corners 1 and 2 swap where the triangle is clockwise).
// Cell i's depth-d ancestor is cell i % (20 * 4**d) of the subdivision-d
// icosphere: the same face and the first d digits, so cell i's corners are
// that ancestor's walked corners refined along the remaining s - d digits.
// A step depends only on its input bits, so resuming from a stored ancestor
// gives the bits of the walk from the face.
//
//   0. `scene_ancestors`: the walked (unoriented) corners of every cell of
//      depth d = max(s - ANCESTOR_STEPS, 0), (20 * 4**d, 9) f32 (47 MB at
//      R2B9): contiguous cells read contiguous, L2-resident ancestors.
//   1. `scene_pass1`: each cell's walk (from its ancestor), orientation and
//      corner lat/lon, once: its test12 row (three side normals
//      cross(b - a, c - a), then h_bot, h_top, num_layers), optionally its
//      corner lat/lon, and its field -- the field term w (lod 0) into the
//      first 4 bytes of its own value_q row, or the pooled per-layer values
//      (lod > 0) into an (n, num_layers) f32 scratch; and the 7 aggregates:
//      the field's min and max over all cells and layers, min |mean
//      corner|, the corners' lat/lon min and max.  Each block reduces its
//      threads (min and max are exact in any order) and folds its partials
//      into 7 order-preserving u32 words with atomicMin/Max.
//   2. `scene_pass2`: a pass over bytes, the only one that needs pass 1's
//      value range: each cell's u8 value row clip(rint((v - lo) * scale),
//      0, 255) zero-padded to lm, v = clip(w * layer_f[j], 0, 1) or the
//      pooled value, and the per-layer u8 min/max (warp, then block, then
//      one atomic per layer and block).  It consumes the w stash.
//
// The plain version takes an index window [start, start + count), and so
// does this kernel: the scene is procedural, so any window of it can be
// checked without the rest.
//
// With lod > 0 (`field_lod`, the value-space mip tier; the reference's
// `field_chunk` :179-191 and `_field_of_tri` :171) pass 1 replaces the
// cell's own field by the mean of the clipped per-layer field over its
// 4**lod descendants at subdivision s + lod, fine = idx + m * n_cells for
// m = 0 .. 4**lod - 1 (data/lod.py's index rule).  Descendant m's walk is
// the cell's own s steps and then the lod base-4 digits of m, least
// significant first, so the descendants form a tree below the cell: it is
// walked depth first over its first T = min(lod, 3) levels (4 + 16 + 64 =
// 84 steps at lod 3, where a walk per descendant takes 192), each leaf
// walking the last lod - T digits of its own, and each leaf's field term
// goes into the thread's column of a shared-memory buffer at its index m.
// The layer sums then run over m in order, as the reference's do, and are
// multiplied by f32(1 / 4**lod).  The descendants' corners are not
// oriented: the reference skips `_orient_ccw` there, and with f32 the
// corner order moves the centroid by an ULP.  Geometry, lat/lon and the
// pass-1 bounds stay those of the subdivision-s cell.  The pooled kernels
// are a template instance of their own (kPooled, 128-thread blocks for the
// 32 KB buffer), so the lod-0 instances keep their code and registers.
//
// What bounds it: the tables it writes, 48 + lm (+ 24) bytes per cell (5.4
// GB at subdiv 11 x 16: 1.6 ms at 3.35 TB/s), and the arithmetic of each
// cell's walk (3 IEEE square roots and 9 IEEE divisions a step) and ~20
// transcendentals.  The parent design walked every cell's 11 steps in both
// passes; here the walk is done once, and only its last ANCESTOR_STEPS
// steps per cell.  A pooled cell adds the tree's steps and 4**lod centroid
// fields and writes only the coarse tables, so the mip tier is bound by
// its arithmetic.  The field's per-cell terms (sin 3 lon * cos 2 lat, cos 7
// lat) are evaluated once per cell (per descendant), then scaled per
// layer.  Built with -fmad=false and __fdiv_rn/__fsqrt_rn: every operation
// rounds as the plain version's eager ops do.
#include <cstdint>
#include <cuda_runtime.h>

// Mirror of `_SceneParams` in data/device_scene.py (same field order).
struct SceneParams {
  float base[180];          // (20, 3, 3) unit corners of the base faces
  float layer_f[32];        // per-layer factor 1 - 0.5 * (j + 0.5) / nl
  float* anc;               // (n_anc, 9) walked corners of the depth-
                            // anc_depth cells: out (ancestors), in (pass 1)
  float* test12;            // (count, 12) out (pass 1)
  uint8_t* value_q;         // (count, lm): w stash (pass 1), levels (pass 2)
  float* field;             // (count, num_layers) pooled values (lod > 0)
  float* lat;               // (count, 3) out (pass 1), or null
  float* lon;               // (count, 3) out (pass 1), or null
  unsigned int* agg;        // pass 1: 7 words; pass 2: 2 * num_layers words
  float h_bot, h_top, nl_f, lo, scale;
  long long start, count;
  long long n_cells;        // cells of the subdivision-s scene
  long long n_anc;          // 20 * 4**anc_depth
  int subdivisions, num_layers, lm;
  int lod;                  // field_lod: 4**lod descendants pooled per cell
  int anc_depth;
};

namespace {

constexpr int kBlock = 256;
constexpr int kPooledBlock = 128;
constexpr int kTreeLevels = 3;               // the pooled tree's depth cap
constexpr int kLeaves = 1 << (2 * kTreeLevels);

// f32 <-> u32 keys whose unsigned order is the float order.
__device__ __forceinline__ unsigned int key_of(float f) {
  const unsigned int b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

struct Tri {
  float v[3][3];   // corner, xyz
};

__device__ __forceinline__ void normalize(float* v) {
  const float s = __fsqrt_rn(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  v[0] = __fdiv_rn(v[0], s);
  v[1] = __fdiv_rn(v[1], s);
  v[2] = __fdiv_rn(v[2], s);
}

// One subdivision step: the child `d` (0..3) of triangle t, each corner
// renormalised.
__device__ __forceinline__ void refine(Tri& t, int d) {
  float n[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = t.v[0][c], b = t.v[1][c], cc = t.v[2][c];
    const float ab = a + b, bc = b + cc, ca = cc + a;
    n[0][c] = d == 0 ? a : (d == 2 ? ca : ab);
    n[1][c] = d == 0 ? ab : (d == 1 ? b : bc);
    n[2][c] = d == 2 ? cc : (d == 1 ? bc : ca);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    normalize(n[k]);
#pragma unroll
    for (int c = 0; c < 3; ++c) t.v[k][c] = n[k][c];
  }
}

// t refined along the base-4 digits of `digits` from step `from` to step
// `to` (exclusive), least significant first.
__device__ __forceinline__ void walk_digits(Tri& t, long long digits,
                                            int from, int to) {
  for (int s = from; s < to; ++s)
    refine(t, static_cast<int>((digits >> (2 * s)) & 3));
}

// The walked (unoriented) corners of cell `idx` of the subdivision-
// `subdivisions` icosphere: its depth-anc_depth ancestor's stored corners
// refined along the remaining digits.
__device__ __forceinline__ Tri walk(const SceneParams& p, long long idx) {
  Tri t;
  const float* a = p.anc + (idx % p.n_anc) * 9;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) t.v[k][c] = __ldg(a + k * 3 + c);
  walk_digits(t, idx / 20, p.anc_depth, p.subdivisions);
  return t;
}

// The walked corners t oriented CCW: corners 1 and 2 swap where
// cross(t1 - t0, t2 - t0) points away from the corners' mean.
__device__ Tri orient(Tri t) {
  float e1[3], e2[3], m[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e1[c] = t.v[1][c] - t.v[0][c];
    e2[c] = t.v[2][c] - t.v[0][c];
    m[c] = __fdiv_rn(t.v[0][c] + t.v[1][c] + t.v[2][c], 3.0f);
  }
  const float nx = e1[1] * e2[2] - e1[2] * e2[1];
  const float ny = e1[2] * e2[0] - e1[0] * e2[2];
  const float nz = e1[0] * e2[1] - e1[1] * e2[0];
  if (nx * m[0] + ny * m[1] + nz * m[2] < 0.0f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float tmp = t.v[1][c];
      t.v[1][c] = t.v[2][c];
      t.v[2][c] = tmp;
    }
  }
  return t;
}

// Corner latitudes and longitudes of an oriented triangle.
__device__ __forceinline__ void lat_lon(const Tri& t, float* lat, float* lon) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lat[k] = asinf(fminf(fmaxf(t.v[k][2], -1.0f), 1.0f));
    lon[k] = atan2f(t.v[k][1], t.v[k][0]);
  }
}

// The banded-wave field at the column centroid before the height factor:
// 0.5 + 0.35 sin(3 clon) cos(2 clat) + 0.15 cos(7 clat).
__device__ __forceinline__ float field_base(const float* lat,
                                            const float* lon) {
  const float clat = __fdiv_rn(lat[0] + lat[1] + lat[2], 3.0f);
  const float sm = __fdiv_rn(sinf(lon[0]) + sinf(lon[1]) + sinf(lon[2]), 3.0f);
  const float cm = __fdiv_rn(cosf(lon[0]) + cosf(lon[1]) + cosf(lon[2]), 3.0f);
  const float clon = atan2f(sm, cm);
  return 0.5f + 0.35f * sinf(3.0f * clon) * cosf(2.0f * clat) +
         0.15f * cosf(7.0f * clat);
}

__device__ __forceinline__ float layer_value(const SceneParams& p, float w,
                                             int j) {
  return fminf(fmaxf(w * p.layer_f[j], 0.0f), 1.0f);
}

// The leaves of the K-level subtree below t: leaf m + stride * (its digits)
// walks the `rest` further digits of `hi` (from step 0) and stores its
// field term at sw[m * kPooledBlock] (sw: the thread's buffer column).
template <int K>
__device__ __forceinline__ void descend(const Tri& t, int m, int stride,
                                        long long hi, int rest, float* sw) {
  if constexpr (K == 0) {
    Tri c = t;
    walk_digits(c, hi, 0, rest);
    float la[3], lo[3];
    lat_lon(c, la, lo);
    sw[m * kPooledBlock] = field_base(la, lo);
  } else {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) {
      Tri c = t;
      refine(c, d);
      descend<K - 1>(c, m + d * stride, stride * 4, hi, rest, sw);
    }
  }
}

// v[j], j < num_layers: the mean of the clipped field over the 4**lod
// descendants of a cell whose walked (unoriented) corners are `parent`.
// Descendant m = lo + 4**T * hi (lo < 4**T, T = min(lod, kTreeLevels))
// walks lo's T digits, then hi's lod - T digits: for each hi in order the
// T-level tree is walked depth first into the buffer, and its 4**T leaves
// are summed in order of lo, so the sum runs over m in order.  Every index
// into v is a constant after unrolling, so v stays in registers.
__device__ __forceinline__ void pooled_field(const SceneParams& p,
                                             const Tri& parent, float* sw,
                                             float* v) {
  const int levels = min(p.lod, kTreeLevels);
  const int rest = p.lod - levels;
  const int leaves = 1 << (2 * levels);
  const long long his = 1ll << (2 * rest);
  for (long long hi = 0; hi < his; ++hi) {
    if (levels == 1)
      descend<1>(parent, 0, 1, hi, rest, sw);
    else if (levels == 2)
      descend<2>(parent, 0, 1, hi, rest, sw);
    else
      descend<3>(parent, 0, 1, hi, rest, sw);
    for (int lo = 0; lo < leaves; ++lo) {
      const float w = sw[lo * kPooledBlock];
      const bool first = hi == 0 && lo == 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j < p.num_layers) {
          const float x = layer_value(p, w, j);
          v[j] = first ? x : v[j] + x;
        }
      }
    }
  }
  const float inv = 1.0f / static_cast<float>(leaves * his);  // a power of 2
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (j < p.num_layers) v[j] = v[j] * inv;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The walked corners of the n_anc cells of depth anc_depth.
__global__ void __launch_bounds__(kBlock) scene_ancestors_kernel(
    const SceneParams p) {
  const long long a =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (a >= p.n_anc) return;
  Tri t;
  const int face = static_cast<int>(a % 20);
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) t.v[k][c] = p.base[face * 9 + k * 3 + c];
  walk_digits(t, a / 20, 0, p.anc_depth);
  float* out = p.anc + a * 9;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[k * 3 + c] = t.v[k][c];
}

// agg: [v_min, v_max, m_min, lat_min, lat_max, lon_min, lon_max] as keys;
// the wrapper initialises the min words to 0xffffffff and the max words
// to 0.
template <bool kPooled>
__global__ void __launch_bounds__(kPooled ? kPooledBlock : kBlock)
    scene_pass1_kernel(const SceneParams p) {
  constexpr int B = kPooled ? kPooledBlock : kBlock;
  const long long i = static_cast<long long>(blockIdx.x) * B + threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  float r[7] = {inf, -inf, inf, inf, -inf, inf, -inf};
  if (i < p.count) {
    const Tri walked = walk(p, p.start + i);
    const Tri t = orient(walked);
    float lat[3], lon[3];
    lat_lon(t, lat, lon);
    if (p.lat != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p.lat[i * 3 + k] = lat[k];
        p.lon[i * 3 + k] = lon[k];
      }
    }
    // the test12 row: three side normals, h_bot, h_top, num_layers
    float row[12];
    constexpr int kEdge[3][2] = {{0, 1}, {1, 2}, {2, 0}};
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      float u[3], v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float a = t.v[kEdge[e][0]][c] * p.h_bot;
        const float b = t.v[kEdge[e][1]][c] * p.h_bot;
        const float cc = t.v[kEdge[e][1]][c] * p.h_top;
        u[c] = b - a;
        v[c] = cc - a;
      }
      row[3 * e + 0] = u[1] * v[2] - u[2] * v[1];
      row[3 * e + 1] = u[2] * v[0] - u[0] * v[2];
      row[3 * e + 2] = u[0] * v[1] - u[1] * v[0];
    }
    row[9] = p.h_bot;
    row[10] = p.h_top;
    row[11] = p.nl_f;
    float4* out = reinterpret_cast<float4*>(p.test12 + i * 12);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[k] = make_float4(row[4 * k], row[4 * k + 1], row[4 * k + 2],
                           row[4 * k + 3]);
    if constexpr (kPooled) {
      __shared__ float s_w[kLeaves * kPooledBlock];
      float val[32];
      pooled_field(p, walked, s_w + threadIdx.x, val);
      float* f = p.field + i * p.num_layers;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j < p.num_layers) {
          f[j] = val[j];
          r[0] = fminf(r[0], val[j]);
          r[1] = fmaxf(r[1], val[j]);
        }
      }
    } else {
      const float w = field_base(lat, lon);
      *reinterpret_cast<float*>(p.value_q + i * p.lm) = w;   // the stash
      for (int j = 0; j < p.num_layers; ++j) {
        const float v = layer_value(p, w, j);
        r[0] = fminf(r[0], v);
        r[1] = fmaxf(r[1], v);
      }
    }
    float m[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      m[c] = __fdiv_rn(t.v[0][c] + t.v[1][c] + t.v[2][c], 3.0f);
    r[2] = __fsqrt_rn(m[0] * m[0] + m[1] * m[1] + m[2] * m[2]);
    r[3] = fminf(fminf(lat[0], lat[1]), lat[2]);
    r[4] = fmaxf(fmaxf(lat[0], lat[1]), lat[2]);
    r[5] = fminf(fminf(lon[0], lon[1]), lon[2]);
    r[6] = fmaxf(fmaxf(lon[0], lon[1]), lon[2]);
  }
  __shared__ float part[B / 32][7];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const bool is_max = (k == 1 || k == 4 || k == 6);
    const float v = is_max ? warp_max(r[k]) : warp_min(r[k]);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 7) {
    const int k = threadIdx.x;
    const bool is_max = (k == 1 || k == 4 || k == 6);
    float v = part[0][k];
    for (int w = 1; w < B / 32; ++w)
      v = is_max ? fmaxf(v, part[w][k]) : fminf(v, part[w][k]);
    if (is_max)
      atomicMax(p.agg + k, key_of(v));
    else
      atomicMin(p.agg + k, key_of(v));
  }
}

// Layer j's u8 level of value v into byte b of `word`, and into the block's
// per-layer u8 min/max (warp, then one shared atomic per warp); layers past
// num_layers keep 0 (uniform across the warp).
__device__ __forceinline__ void store_level(const SceneParams& p, bool real,
                                            int lane, int j, int b, float v,
                                            uint32_t& word,
                                            unsigned int* s_min,
                                            unsigned int* s_max) {
  if (j >= p.num_layers) return;
  unsigned int q = 0;
  if (real) {
    q = static_cast<unsigned int>(
        fminf(fmaxf(rintf((v - p.lo) * p.scale), 0.0f), 255.0f));
    word |= q << (8 * b);
  }
  const unsigned int qmin = __reduce_min_sync(0xffffffffu, real ? q : 255u);
  const unsigned int qmax = __reduce_max_sync(0xffffffffu, real ? q : 0u);
  if (lane == 0) {
    atomicMin(s_min + j, qmin);
    atomicMax(s_max + j, qmax);
  }
}

// agg: [qmin of layer 0..nl-1, qmax of layer 0..nl-1] as plain u32; the
// wrapper initialises qmin to 255 and qmax to 0.
template <bool kPooled>
__global__ void __launch_bounds__(kBlock) scene_pass2_kernel(
    const SceneParams p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const bool real = i < p.count;
  __shared__ unsigned int s_min[32], s_max[32];
  if (threadIdx.x < 32) {
    s_min[threadIdx.x] = 255u;
    s_max[threadIdx.x] = 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // value row, 4 levels per u32 word (lm is a multiple of 8, so each row
  // starts on an 8-byte boundary)
  uint32_t* vrow = reinterpret_cast<uint32_t*>(p.value_q + i * p.lm);
  if constexpr (kPooled) {
    float val[32];   // unrolled, so that val[j] is a register
    const float* f = p.field + i * p.num_layers;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      val[j] = (real && j < p.num_layers) ? f[j] : 0.0f;
#pragma unroll
    for (int w4 = 0; w4 < 8; ++w4) {
      if (4 * w4 >= p.lm) break;         // uniform across the block
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        store_level(p, real, lane, 4 * w4 + b, b, val[4 * w4 + b], word,
                    s_min, s_max);
      if (real) vrow[w4] = word;
    }
  } else {
    // the cell's field term, stashed by pass 1 in its row's first word
    const float w = real ? __uint_as_float(vrow[0]) : 0.0f;
    for (int w4 = 0; w4 < p.lm / 4; ++w4) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * w4 + b;
        store_level(p, real, lane, j, b,
                    j < p.num_layers ? layer_value(p, w, j) : 0.0f, word,
                    s_min, s_max);
      }
      if (real) vrow[w4] = word;
    }
  }
  __syncthreads();
  if (threadIdx.x < p.num_layers) {
    atomicMin(p.agg + threadIdx.x, s_min[threadIdx.x]);
    atomicMax(p.agg + p.num_layers + threadIdx.x, s_max[threadIdx.x]);
  }
}

unsigned int blocks(long long count, int block) {
  return static_cast<unsigned int>((count + block - 1) / block);
}

}  // namespace

// Each launches one kernel on `stream` (PyTorch's current stream); they
// allocate nothing and do not synchronise.  Return cudaGetLastError().
extern "C" int scene_ancestors_launch(const SceneParams* params,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  scene_ancestors_kernel<<<blocks(params->n_anc, kBlock), kBlock, 0, s>>>(
      *params);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scene_pass1_launch(const SceneParams* params, void* stream) {
  if (params->count <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params->lod > 0)
    scene_pass1_kernel<true>
        <<<blocks(params->count, kPooledBlock), kPooledBlock, 0, s>>>(
            *params);
  else
    scene_pass1_kernel<false><<<blocks(params->count, kBlock), kBlock, 0, s>>>(
        *params);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scene_pass2_launch(const SceneParams* params, void* stream) {
  if (params->count <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params->lod > 0)
    scene_pass2_kernel<true><<<blocks(params->count, kBlock), kBlock, 0, s>>>(
        *params);
  else
    scene_pass2_kernel<false><<<blocks(params->count, kBlock), kBlock, 0, s>>>(
        *params);
  return static_cast<int>(cudaGetLastError());
}
