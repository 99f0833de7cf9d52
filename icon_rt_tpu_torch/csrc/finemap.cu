// K7-fm `build_finemap`: the fine primary-candidate map of the two-stage
// locate, built on the card in two launches.
//
// Replaces the XLA-fused icon_rt_tpu/models/finemap.py `_centers_c0`,
// `_second_candidates`, `_first_distinct4` and the slab body of
// `build_finemap`.  Its plain-PyTorch version is `_build_finemap_torch` in
// models/finemap.py.
//
//   1. `centers_c0`, one thread per sub-bin center of the (2 F_lat, 2 F_lon)
//      sub grid (F = factor x the coarse locator's dims): the unit-sphere
//      point of the center, then the first candidate of its coarse bin (the
//      integer-divided parent, in row order) whose three side planes
//      contain it laterally (the planes pass through the origin, so the test
//      holds for every radius); -1 where none does.
//   2. `select_slots`, one thread per fine bin: for each of its 2x2
//      sub-centers the second candidate c1 -- the first neighbour in the
//      order E, W, S, N, then the diagonals, whose c0 differs and is >= 0
//      (longitude wraps, latitude clamps); the 8-pool (c0 of the 4
//      sub-centers, then their c1, in (dl, do) order); its first 4 distinct
//      entries; each encoded as its first slot in the coarse row of the
//      fine bin's parent bin, 255 if absent or empty.
//
// The TPU build ran in latitude slabs with a one-row halo to bound HBM
// temporaries; its result equals this whole-image computation (the halo
// rows make every interior neighbour read exact, and the edge rows clamp).
// On the H100 the sub-center image is 4 bytes per sub-bin (42 MB at subdiv
// 8), so it is one buffer.
//
// What bounds it: launch 1 reads, per sub-center, one coarse row and up to
// k_cap 36-byte plane rows (L2-resident: neighbouring sub-centers share
// bins), so it is bound by those dependent reads; launch 2 reads 36 c0
// words (L1/L2) and writes 4 bytes per bin.  Built with -fmad=false: the
// plane tests and the center coordinates round as the plain version's
// eager ops do.
#include <cstdint>
#include <cuda_runtime.h>

// Mirror of `_FinemapParams` in models/finemap.py (same field order).
struct FinemapParams {
  const int32_t* bins;    // (n_lat * n_lon, k_cap) coarse locator, -1 padded
  const float* test12;    // (N, 12); columns 0..8 (normals) are read
  int32_t* c0;            // (s_lat * s_lon,) scratch: container of each center
  uint8_t* slots;         // (f_lat * f_lon, 4) out
  float lat_lo, lat_hi, lon_lo, lon_hi;
  int n_lat, n_lon, k_cap, factor;
};

namespace {

constexpr int kCand = 4;

__global__ void __launch_bounds__(256)
centers_c0_kernel(const FinemapParams p) {
  const int s_lat = 2 * p.factor * p.n_lat;
  const int s_lon = 2 * p.factor * p.n_lon;
  // 64-bit: the sub grid has 4 f^2 n_lat n_lon entries (671M at subdiv 11
  // with factor 2; past 2^31 at factor 4)
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(s_lat) * s_lon) return;
  const int sl = static_cast<int>(i / s_lon);
  const int so = static_cast<int>(i % s_lon);
  const float lat = p.lat_lo + (static_cast<float>(sl) + 0.5f) *
                                   ((p.lat_hi - p.lat_lo) /
                                    static_cast<float>(s_lat));
  const float lon = p.lon_lo + (static_cast<float>(so) + 0.5f) *
                                   ((p.lon_hi - p.lon_lo) /
                                    static_cast<float>(s_lon));
  const float cl = cosf(lat);
  const float px = cl * cosf(lon);
  const float py = cl * sinf(lon);
  const float pz = sinf(lat);
  const int fs = 2 * p.factor;   // the sub grid is an exact refinement
  const int32_t* cand =
      p.bins + static_cast<size_t>((sl / fs) * p.n_lon + so / fs) * p.k_cap;
  int out = -1;
  for (int k = 0; k < p.k_cap; ++k) {
    const int c = __ldg(cand + k);
    if (c < 0) continue;
    const float* t = p.test12 + static_cast<size_t>(c) * 12;
    const float ev1 = __ldg(t + 0) * px + __ldg(t + 1) * py + __ldg(t + 2) * pz;
    const float ev2 = __ldg(t + 3) * px + __ldg(t + 4) * py + __ldg(t + 5) * pz;
    const float ev3 = __ldg(t + 6) * px + __ldg(t + 7) * py + __ldg(t + 8) * pz;
    if (ev1 <= 0.0f && ev2 <= 0.0f && ev3 <= 0.0f) {
      out = c;
      break;
    }
  }
  p.c0[i] = out;
}

// c1 of sub-center (sl, so): the first neighbour whose c0 differs.
__device__ __forceinline__ int second_candidate(const int32_t* c0, int s_lat,
                                                int s_lon, int sl, int so) {
  constexpr int kDl[8] = {0, 0, 1, -1, 1, 1, -1, -1};
  constexpr int kDo[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  const int base = c0[static_cast<size_t>(sl) * s_lon + so];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int nl = min(max(sl + kDl[j], 0), s_lat - 1);
    const int no = (so + kDo[j] + s_lon) % s_lon;
    const int v = c0[static_cast<size_t>(nl) * s_lon + no];
    if (v != base && v >= 0) return v;
  }
  return -1;
}

__global__ void __launch_bounds__(256)
select_slots_kernel(const FinemapParams p) {
  const int f_lat = p.factor * p.n_lat;
  const int f_lon = p.factor * p.n_lon;
  const int s_lat = 2 * f_lat, s_lon = 2 * f_lon;
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= static_cast<long long>(f_lat) * f_lon) return;
  const int fl = static_cast<int>(b / f_lon);
  const int fo = static_cast<int>(b % f_lon);
  int pool[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int sl = 2 * fl + k / 2, so = 2 * fo + k % 2;
    pool[k] = p.c0[static_cast<size_t>(sl) * s_lon + so];
    pool[4 + k] = second_candidate(p.c0, s_lat, s_lon, sl, so);
  }
  int sel[kCand] = {-1, -1, -1, -1};
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int v = pool[j];
    bool dup = false;
#pragma unroll
    for (int k = 0; k < kCand; ++k) dup = dup || (sel[k] == v);
    if (!dup && v >= 0 && cnt < kCand) {
#pragma unroll
      for (int k = 0; k < kCand; ++k)
        if (k == cnt) sel[k] = v;
      ++cnt;
    }
  }
  const int32_t* row = p.bins + static_cast<size_t>(
      (fl / p.factor) * p.n_lon + fo / p.factor) * p.k_cap;
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    int slot = 255;
    if (sel[k] >= 0) {
      for (int j = 0; j < p.k_cap; ++j) {
        if (__ldg(row + j) == sel[k]) {
          slot = j;
          break;
        }
      }
    }
    p.slots[static_cast<size_t>(b) * kCand + k] = static_cast<uint8_t>(slot);
  }
}

}  // namespace

// Launches both kernels on `stream` (PyTorch's current stream); allocates
// nothing and does not synchronise.  Returns cudaGetLastError().
extern "C" int finemap_launch(const FinemapParams* params, void* stream) {
  const FinemapParams& p = *params;
  const long long n_fine = static_cast<long long>(p.factor) * p.factor *
                           p.n_lat * p.n_lon;
  const long long n_sub = 4 * n_fine;
  if (n_fine <= 0) return 0;
  constexpr int kBlock = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  centers_c0_kernel<<<static_cast<unsigned int>((n_sub + kBlock - 1) / kBlock),
                      kBlock, 0, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  select_slots_kernel<<<static_cast<unsigned int>((n_fine + kBlock - 1) /
                                                  kBlock),
                        kBlock, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
