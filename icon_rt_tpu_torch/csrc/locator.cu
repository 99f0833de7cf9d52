// K7-loc `locator_bins`: the quantized tier's dense grid-of-lists locator
// binned on the card from the cells' corner lat/lon, in three steps.
//
// The JAX package bins on the host (icon_rt_tpu/models/locator.py
// `_edge_extrema`, `_range_records`, `_bbox_entries`, `build_locator_csr`,
// `densify_csr`, with the native/ C++ mirror of `_edge_extrema`); this is
// the same function on the card.  Its plain-PyTorch version is
// `_locator_bins_torch` in models/locator.py, in f64 tensors.
//
//   1. `locator_count`, one thread per cell: the cell's latitude extent and
//      extra longitudes including the great-circle edge bulges, its pole
//      flag, and its 1-2 bin rectangles (pole rows reach the window's
//      latitude edge and span every longitude bin; a dateline straddler
//      splits into two wrapped longitude ranges), all in f64 with the
//      formula order of the host oracle.  The rectangles go to `rect` and
//      each covered bin's count is raised by one (atomicAdd); a cell of
//      more than kBig bins is listed instead, and a second launch shares
//      each listed cell's bins out over the whole grid.
//   2. `locator_fill`, the same walk: the cell's id into each covered bin,
//      at a slot taken with atomicAdd on the bin's cursor.
//   3. `locator_sort_rows`, one thread per bin: an insertion sort of the
//      bin's <= k_cap ids, so every row is in ascending cell id and the
//      table does not depend on the order the atomics ran in.
//
// Between 1 and 2 the wrapper reads k_cap = max(counts) (the one host read)
// and allocates the -1 filled (n_bins, k_cap) table.
//
// What bounds it: the table's writes (n_bins * k_cap * 4 bytes, 3.0 GB at
// subdiv 11) and the scattered atomics (one per covered bin, twice); the
// f64 extrema are ~300 operations per cell.  Built with -fmad=false: the
// f64 arithmetic rounds as the host oracle's and the plain version's.
#include <cstdint>
#include <cuda_runtime.h>

// Mirror of `_LocatorParams` in models/locator.py (same field order).
struct LocatorParams {
  const float* lat;     // (n, 3) corner latitudes
  const float* lon;     // (n, 3) corner longitudes
  int32_t* rect;        // (n, 8): la0, la1, lb0, lb1 of one or two ranges
                        // (the second -1 when absent)
  int32_t* counts;      // (n_bins,) entries per bin
  int32_t* cursor;      // (n_bins,) fill cursor, zeroed
  int32_t* bins;        // (n_bins, k_cap) table, -1 filled
  int32_t* big;         // (n,) scratch: ids of the cells of > kBig bins
  int32_t* n_big;       // (1,) their count, zeroed
  double lat_lo, lat_hi, lon_lo, lon_hi;
  long long n;
  int n_lat, n_lon, k_cap;
};

namespace {

constexpr int kBlock = 256;
constexpr double kPi = 3.141592653589793;
// A cell whose rectangles cover more bins than this is listed in `big` and
// its bins are shared out over the whole grid by locator_big_kernel: polar
// cells span thousands of longitude bins, and the two cells the oracle's
// pole test flags with the opposite pole span every bin of the grid (42M
// at subdiv 11), which one thread would walk for seconds.
constexpr long long kBig = 1024;
constexpr int kBigBlocks = 1024;

__device__ __forceinline__ int bin_of(double v, double lo, double hi, int n) {
  const double x = (v - lo) / (hi - lo) * static_cast<double>(n);
  // numpy's astype(int64) truncates toward zero; then the clip
  const long long b = static_cast<long long>(x);
  return static_cast<int>(b < 0 ? 0 : (b > n - 1 ? n - 1 : b));
}

// The cell's 1-2 bin rectangles (icon_rt_tpu/models/locator.py
// `_edge_extrema` and `_range_records`, the native mirror's formula order).
__device__ void rectangles(const LocatorParams& p, long long c, int* r) {
  const float* la32 = p.lat + c * 3;
  const float* lo32 = p.lon + c * 3;
  double lo_v = static_cast<double>(fminf(la32[0], fminf(la32[1], la32[2])));
  double hi_v = static_cast<double>(fmaxf(la32[0], fmaxf(la32[1], la32[2])));
  double u[3][3], mm[3][3], lon_ext[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double la = static_cast<double>(la32[k]);
    const double lo = static_cast<double>(lo32[k]);
    const double cl = cos(la);
    u[k][0] = cl * cos(lo);
    u[k][1] = cl * sin(lo);
    u[k][2] = sin(la);
    lon_ext[k] = static_cast<double>(lo32[0]);   // vertex-0 lon by default
  }
  bool all_le = true, all_ge = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int j = (e + 1) % 3;
    mm[e][0] = u[e][1] * u[j][2] - u[e][2] * u[j][1];
    mm[e][1] = u[e][2] * u[j][0] - u[e][0] * u[j][2];
    mm[e][2] = u[e][0] * u[j][1] - u[e][1] * u[j][0];
    all_le &= (mm[e][2] <= 0.0);
    all_ge &= (mm[e][2] >= 0.0);
  }
  const int pole = all_le ? 1 : (all_ge ? -1 : 0);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int i = e, j = (e + 1) % 3;
    const double* m3 = mm[e];
    const double nrm = sqrt(m3[0] * m3[0] + m3[1] * m3[1] + m3[2] * m3[2]);
    const double dn = fmax(nrm, 1e-300);
    const double mz = m3[2] / dn;
    const double zml = sqrt(fmax(1.0 - mz * mz, 0.0));
    const double ex = -mz * m3[0] / dn, ey = -mz * m3[1] / dn;
    const double ez = zml * zml;
    const double den = fmax(zml, 1e-300);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const double sign = s ? -1.0 : 1.0;
      const double px = sign * ex / den, py = sign * ey / den,
                   pz = sign * ez / den;
      // interior test: cross(u_i, p).m3 > 0 and cross(p, u_j).m3 > 0
      const double c1 = (u[i][1] * pz - u[i][2] * py) * m3[0] +
                        (u[i][2] * px - u[i][0] * pz) * m3[1] +
                        (u[i][0] * py - u[i][1] * px) * m3[2];
      const double c2 = (py * u[j][2] - pz * u[j][1]) * m3[0] +
                        (pz * u[j][0] - px * u[j][2]) * m3[1] +
                        (px * u[j][1] - py * u[j][0]) * m3[2];
      if (c1 > 0.0 && c2 > 0.0 && zml > 1e-12) {
        const double plat = asin(fmin(1.0, fmax(-1.0, pz)));
        lo_v = fmin(lo_v, plat);
        hi_v = fmax(hi_v, plat);
        lon_ext[e] = atan2(py, px);
      }
    }
  }
  // the hull of vertices and bulges; pole rows reach the window's lat edge
  // (the oracle overwrites its lat_max column, or its lat_min column)
  double la_all[5] = {static_cast<double>(la32[0]),
                      static_cast<double>(la32[1]),
                      static_cast<double>(la32[2]), lo_v, hi_v};
  if (pole > 0) la_all[4] = p.lat_hi;
  if (pole < 0) la_all[3] = p.lat_lo;
  double lat_mn = la_all[0], lat_mx = la_all[0];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    lat_mn = fmin(lat_mn, la_all[k]);
    lat_mx = fmax(lat_mx, la_all[k]);
  }
  const int la0 = bin_of(lat_mn, p.lat_lo, p.lat_hi, p.n_lat);
  const int la1 = bin_of(lat_mx, p.lat_lo, p.lat_hi, p.n_lat);
  const double all[6] = {static_cast<double>(lo32[0]),
                         static_cast<double>(lo32[1]),
                         static_cast<double>(lo32[2]), lon_ext[0],
                         lon_ext[1], lon_ext[2]};
  double lo_min = all[0], lo_max = all[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    lo_min = fmin(lo_min, all[k]);
    lo_max = fmax(lo_max, all[k]);
  }
  if (pole != 0) {
    lo_min = p.lon_lo;
    lo_max = p.lon_hi;
  }
  r[0] = r[4] = la0;
  r[1] = r[5] = la1;
  if ((lo_max - lo_min) > kPi && pole == 0) {
    // dateline straddler: [min of the positive lons, last bin] and
    // [first bin, max of the negative lons]
    const double inf = __longlong_as_double(0x7ff0000000000000ll);
    double pos_min = inf, neg_max = -inf;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (all[k] > 0.0) pos_min = fmin(pos_min, all[k]);
      if (all[k] < 0.0) neg_max = fmax(neg_max, all[k]);
    }
    r[2] = bin_of(pos_min, p.lon_lo, p.lon_hi, p.n_lon);
    r[3] = p.n_lon - 1;
    r[6] = 0;
    r[7] = bin_of(neg_max, p.lon_lo, p.lon_hi, p.n_lon);
  } else {
    r[2] = bin_of(lo_min, p.lon_lo, p.lon_hi, p.n_lon);
    r[3] = bin_of(lo_max, p.lon_lo, p.lon_hi, p.n_lon);
    r[4] = r[5] = r[6] = r[7] = -1;
  }
}

__device__ __forceinline__ long long area(const int* q) {
  return q[0] < 0 ? 0
                  : static_cast<long long>(q[1] - q[0] + 1) * (q[3] - q[2] + 1);
}

// Bin `t` (row-major) of range q, t < area(q).
__device__ __forceinline__ long long bin_at(const LocatorParams& p,
                                            const int* q, long long t) {
  const int w = q[3] - q[2] + 1;
  return static_cast<long long>(q[0] + t / w) * p.n_lon + q[2] + t % w;
}

// Count (fill == false) or fill one covered bin of cell c.
__device__ __forceinline__ void visit(const LocatorParams& p, long long b,
                                      long long c, bool fill) {
  if (!fill) {
    atomicAdd(p.counts + b, 1);
    return;
  }
  const int slot = atomicAdd(p.cursor + b, 1);
  if (slot < p.k_cap) p.bins[b * p.k_cap + slot] = static_cast<int32_t>(c);
}

__global__ void __launch_bounds__(kBlock) locator_count_kernel(
    const LocatorParams p) {
  const long long c = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (c >= p.n) return;
  int r[8];
  rectangles(p, c, r);
#pragma unroll
  for (int k = 0; k < 8; ++k) p.rect[c * 8 + k] = r[k];
  if (area(r) + area(r + 4) > kBig) {
    p.big[atomicAdd(p.n_big, 1)] = static_cast<int32_t>(c);
    return;
  }
  for (int g = 0; g < 2; ++g)
    for (long long t = 0; t < area(r + 4 * g); ++t)
      visit(p, bin_at(p, r + 4 * g, t), c, false);
}

__global__ void __launch_bounds__(kBlock) locator_fill_kernel(
    const LocatorParams p) {
  const long long c = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (c >= p.n) return;
  int r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = p.rect[c * 8 + k];
  if (area(r) + area(r + 4) > kBig) return;   // locator_big_kernel's
  for (int g = 0; g < 2; ++g)
    for (long long t = 0; t < area(r + 4 * g); ++t)
      visit(p, bin_at(p, r + 4 * g, t), c, true);
}

// The listed cells' bins, each cell's shared out over all threads of the
// grid.
__global__ void __launch_bounds__(kBlock) locator_big_kernel(
    const LocatorParams p, bool fill) {
  const int m = *p.n_big;
  const long long tid = static_cast<long long>(blockIdx.x) * kBlock +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (int j = 0; j < m; ++j) {
    const long long c = p.big[j];
    int r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = __ldg(p.rect + c * 8 + k);
    for (int g = 0; g < 2; ++g)
      for (long long t = tid; t < area(r + 4 * g); t += stride)
        visit(p, bin_at(p, r + 4 * g, t), c, fill);
  }
}

__global__ void __launch_bounds__(kBlock) locator_sort_kernel(
    const LocatorParams p) {
  const long long b = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  if (b >= static_cast<long long>(p.n_lat) * p.n_lon) return;
  int32_t* row = p.bins + b * p.k_cap;
  const int m = min(p.counts[b], p.k_cap);
  for (int i = 1; i < m; ++i) {
    const int32_t v = row[i];
    int j = i - 1;
    while (j >= 0 && row[j] > v) {
      row[j + 1] = row[j];
      --j;
    }
    row[j + 1] = v;
  }
}

unsigned int blocks(long long n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

}  // namespace

// Each launches one pass on `stream` (PyTorch's current stream); they
// allocate nothing and do not synchronise.  Return cudaGetLastError().
extern "C" int locator_count_launch(const LocatorParams* p, void* stream) {
  if (p->n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  locator_count_kernel<<<blocks(p->n), kBlock, 0, s>>>(*p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  locator_big_kernel<<<kBigBlocks, kBlock, 0, s>>>(*p, false);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int locator_fill_launch(const LocatorParams* p, void* stream) {
  if (p->n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  locator_fill_kernel<<<blocks(p->n), kBlock, 0, s>>>(*p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  locator_big_kernel<<<kBigBlocks, kBlock, 0, s>>>(*p, true);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int locator_sort_launch(const LocatorParams* p, void* stream) {
  const long long n_bins = static_cast<long long>(p->n_lat) * p->n_lon;
  if (n_bins <= 0) return 0;
  locator_sort_kernel<<<blocks(n_bins), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}
