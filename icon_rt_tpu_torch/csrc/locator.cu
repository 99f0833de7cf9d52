// K7-loc `locator_bins`: the quantized tier's dense grid-of-lists locator
// binned on the card from the cells' corner lat/lon.
//
// The JAX package bins on the host (icon_rt_tpu/models/locator.py
// `_edge_extrema`, `_range_records`, `_bbox_entries`, `build_locator_csr`,
// `densify_csr`, with the native/ C++ mirror of `_edge_extrema`); this is
// the same function on the card.  Its plain-PyTorch version is
// `_locator_bins_torch` in models/locator.py, in f64 tensors.  Each bin's
// row lists the ids of the cells whose bin rectangles cover it, ascending,
// -1 padded to k_cap = the largest count.  `locator_window_launch` finds
// the corners' extremes (the bins' window) in one read of lat and lon.
//
// The bins are built tile by tile: a tile is kTile x kTile bins, and one
// block owns it, so no bin is touched by more than one block and every
// row is written once, whole and in order.  Three steps, with a host read
// after each of the first two:
//   1. `locator_rects_launch`, one thread per cell: the cell's latitude
//      extent and extra longitudes including the great-circle edge
//      bulges, its pole flag and its 1-2 bin rectangles ("records"; pole
//      rows reach the window's latitude edge and span every longitude bin,
//      a dateline straddler splits into two wrapped longitude ranges), all
//      in f64 with the formula order of the host oracle, into `rect`.  The
//      warp counts the tiles each record touches, one atomicAdd a distinct
//      tile a warp (__match_any_sync); a cell of more than kBigTiles tiles
//      is listed in `big` instead, and a grid-wide launch counts its tiles.
//      The wrapper scans the tile counts into list starts and reads the
//      lists' length and the number of big cells.
//   2. `locator_lists_launch`: the same walk writes an 8-byte entry for
//      each (record, tile) into the tile's list, the cell id and the bins
//      of the tile the record covers, a warp's entries for one tile at
//      consecutive slots; then one block a tile counts its bins' entries
//      in shared memory and writes `counts` and the tile's largest count.
//      The wrapper reads k_cap.
//   3. `locator_rows_launch`, one block a tile: each entry's bins get its
//      cell id at a slot taken in shared memory, each thread sorts one
//      bin's row (insertion, in shared memory), and the block writes the
//      tile's rows, -1 padded, as contiguous runs of the table.  A row too
//      wide for shared memory (k_cap > kRowsMax) is filled, sorted and
//      padded in the table itself, by the same block.
//
// What bounds it: the table's writes (n_bins * k_cap * 4 bytes, 3.0 GB at
// subdiv 11) and the corner reads, 1.55 ms at 3.35 TB/s; the f64 extrema
// are ~300 operations a cell (0.74 ms at 34 TFLOP/s).  The design keeps
// the bins' 429M entries out of global atomics: the atomics count tiles
// (1.14 tile entries a cell at subdiv 8), a bin's entries meet in shared
// memory, and the table is written once, coalesced.  The tile passes read
// only their lists: an entry carries its span, so no pass gathers the
// rectangles by cell (a 32-byte sector an entry, twice, when it did).  On
// the H100 at R2B9 the whole takes 17.6 ms, the f64 rectangles 6.9 and the
// lists 4.8 of it (the design it replaced, per-bin atomics and a sort in
// global memory: 75.7 ms; scripts/time_locator.py, PERF.md §6).  Built
// with -fmad=false: the f64 arithmetic rounds as the host oracle's and
// the plain version's.
#include <cstdint>
#include <cuda_runtime.h>

// Mirror of `_LocatorParams` in models/locator.py (same field order).
struct LocatorParams {
  const float* lat;              // (n, 3) corner latitudes
  const float* lon;              // (n, 3) corner longitudes
  int32_t* rect;                 // (n, 8): la0, la1, lb0, lb1 of one or two
                                 // records (the second -1 when absent)
  int32_t* tile_count;           // (n_tiles,) entries a tile, zeroed
  int32_t* tile_fill;            // (n_tiles,) the lists' cursors, zeroed
  const long long* tile_start;   // (n_tiles,) where each tile's list starts
  uint64_t* entries;             // the tiles' lists: cell | span << 32
  int32_t* big;                  // (big_cap,) cells of > kBigTiles tiles
  int32_t* n_big;                // (1,) how many (may pass big_cap), zeroed
  int32_t* k_max;                // (1,) the largest count, zeroed
  int32_t* counts;               // (n_bins,) entries a bin
  int32_t* bins;                 // (n_bins, k_cap) the table
  double lat_lo, lat_hi, lon_lo, lon_hi;
  long long n;
  int n_lat, n_lon, k_cap, big_cap;
};

namespace {

constexpr int kBlock = 256;
constexpr double kPi = 3.141592653589793;
// A tile is kTile x kTile bins: one bin a thread of its block.
constexpr int kTile = 16;
static_assert(kTile * kTile == kBlock, "one thread a bin of the tile");
static_assert(kTile <= 16, "an entry holds its span in 4-bit fields");
// A cell whose records touch more tiles than this is listed in `big` and
// its tiles are shared out over the whole grid: polar cells span thousands
// of longitude bins, and the two cells the oracle's pole test flags with
// the opposite pole span every bin of the grid (42M at subdiv 11, 164K
// tiles), which one thread would walk for milliseconds.
constexpr int kBigTiles = 8;
constexpr int kBigBlocks = 264;
// The widest row (k_cap) kept in shared memory: kTile^2 rows of an odd
// stride (k_cap | 1, so a thread's row starts in its own bank) within 40 KB.
constexpr int kRowsMax = 39;
// An entry covering more bins of a tile than this is walked by the block.
constexpr int kSmallSpan = 16;

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
    // The two antipodal extremum points sign * (ex, ey, ez) / den.  Every
    // operation below is exact under negation ((-x) / d == -(x / d), and
    // each product, difference and sum flips its sign alone), so the -1
    // point's coordinates are the +1 point's negated and its interior
    // sums c1, c2 are the +1 point's negated: one set serves both.
    const double qx = ex / den, qy = ey / den, qz = ez / den;
    // interior test: cross(u_i, p).m3 > 0 and cross(p, u_j).m3 > 0
    const double c1 = (u[i][1] * qz - u[i][2] * qy) * m3[0] +
                      (u[i][2] * qx - u[i][0] * qz) * m3[1] +
                      (u[i][0] * qy - u[i][1] * qx) * m3[2];
    const double c2 = (qy * u[j][2] - qz * u[j][1]) * m3[0] +
                      (qz * u[j][0] - qx * u[j][2]) * m3[1] +
                      (qx * u[j][1] - qy * u[j][0]) * m3[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const bool inner = s ? (-c1 > 0.0 && -c2 > 0.0)
                           : (c1 > 0.0 && c2 > 0.0);
      if (inner && zml > 1e-12) {
        const double px = s ? -qx : qx, py = s ? -qy : qy,
                     pz = s ? -qz : qz;
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

// Tiles of record q (la0, la1, lb0, lb1; none when la0 < 0).
__device__ __forceinline__ int rec_tiles(const int* q) {
  return q[0] < 0 ? 0
                  : (q[1] / kTile - q[0] / kTile + 1) *
                        (q[3] / kTile - q[2] / kTile + 1);
}

__device__ __forceinline__ int tiles_lon(const LocatorParams& p) {
  return (p.n_lon + kTile - 1) / kTile;
}

// The k-th tile (row-major) that record q touches: its row ti, column tj.
__device__ __forceinline__ void rec_tile(const int* q, int k, int& ti,
                                         int& tj) {
  const int w = q[3] / kTile - q[2] / kTile + 1;
  ti = q[0] / kTile + k / w;
  tj = q[2] / kTile + k % w;
}

// A tile's list entry: the cell, and in bits 32-47 the bins of its tile
// (ti, tj) that record q covers, in tile coordinates: a0, a1, b0, b1 (4
// bits each; q touches the tile, so neither range is empty).
__device__ __forceinline__ uint64_t entry_of(long long c, const int* q,
                                             int ti, int tj) {
  const int lat0 = ti * kTile, lon0 = tj * kTile;
  const unsigned span =
      static_cast<unsigned>(max(q[0], lat0) - lat0) |
      static_cast<unsigned>(min(q[1], lat0 + kTile - 1) - lat0) << 4 |
      static_cast<unsigned>(max(q[2], lon0) - lon0) << 8 |
      static_cast<unsigned>(min(q[3], lon0 + kTile - 1) - lon0) << 12;
  return static_cast<uint64_t>(static_cast<uint32_t>(c)) |
         static_cast<uint64_t>(span) << 32;
}

// The nt tiles of cell c's records r (the first record's, then the
// second's), counted (kFill false) or listed.  Called by whole warps: the
// lanes that touch the same tile in a round take one atomic between them.
template <bool kFill>
__device__ __forceinline__ void walk_tiles(const LocatorParams& p,
                                           const int* r, int nt,
                                           long long c) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const int n0 = rec_tiles(r);
  for (int k = 0;; ++k) {
    const bool has = k < nt;
    const unsigned mask = __ballot_sync(0xffffffffu, has);
    if (mask == 0) break;
    if (!has) continue;
    const int g = k < n0 ? 0 : 1;
    int ti, tj;
    rec_tile(r + 4 * g, k - g * n0, ti, tj);
    const int t = ti * tiles_lon(p) + tj;
    const unsigned peers = __match_any_sync(mask, t);
    const int rank = __popc(peers & below);
    if (!kFill) {
      if (rank == 0) atomicAdd(p.tile_count + t, __popc(peers));
      continue;
    }
    const long long start = p.tile_start[t];
    int base = 0;
    if (rank == 0) base = atomicAdd(p.tile_fill + t, __popc(peers));
    base = __shfl_sync(peers, base, __ffs(peers) - 1);
    p.entries[start + base + rank] = entry_of(c, r + 4 * g, ti, tj);
  }
}

__device__ __forceinline__ void load_rect(const LocatorParams& p,
                                          long long c, int* r) {
  const int4* q = reinterpret_cast<const int4*>(p.rect) + 2 * c;
  const int4 a = q[0], b = q[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// At most 64 registers (4 blocks an SM): the f64 work runs faster at that
// occupancy than at 82 registers without spills (6.87 against 8.98 ms at
// R2B9 on the H100, scripts/time_locator.py).
__global__ void __launch_bounds__(kBlock, 4) locator_rects_kernel(
    const LocatorParams p) {
  const long long c = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  int r[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
  if (c < p.n) {
    rectangles(p, c, r);
    int4* q = reinterpret_cast<int4*>(p.rect) + 2 * c;
    q[0] = make_int4(r[0], r[1], r[2], r[3]);
    q[1] = make_int4(r[4], r[5], r[6], r[7]);
  }
  const int nt = rec_tiles(r) + rec_tiles(r + 4);
  if (nt > kBigTiles) {
    const int slot = atomicAdd(p.n_big, 1);
    if (slot < p.big_cap) p.big[slot] = static_cast<int32_t>(c);
  }
  walk_tiles<false>(p, r, nt > kBigTiles ? 0 : nt, c);
}

__global__ void __launch_bounds__(kBlock) locator_lists_kernel(
    const LocatorParams p) {
  const long long c = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  int r[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
  if (c < p.n) load_rect(p, c, r);
  const int nt = rec_tiles(r) + rec_tiles(r + 4);
  walk_tiles<true>(p, r, nt > kBigTiles ? 0 : nt, c);
}

// The listed big cells' tiles, counted (kFill false) or listed: the list
// in chunks of kBlock cells, each chunk's (cell, tile) pairs shared out
// over all threads of the grid (every block scans the chunk's tile counts
// in shared memory, so a pair finds its cell by a binary search).
template <bool kFill>
__global__ void __launch_bounds__(kBlock) locator_big_kernel(
    const LocatorParams p) {
  __shared__ int rq[kBlock][8];          // the chunk's cells' records
  __shared__ long long pre[kBlock];      // inclusive sums of their tiles
  __shared__ int32_t cell[kBlock];
  const int m = min(*p.n_big, p.big_cap);
  const int tid = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (int j0 = 0; j0 < m; j0 += kBlock) {
    long long nt = 0;
    if (j0 + tid < m) {
      const long long c = p.big[j0 + tid];
      cell[tid] = static_cast<int32_t>(c);
      load_rect(p, c, rq[tid]);
      nt = rec_tiles(rq[tid]) + rec_tiles(rq[tid] + 4);
    }
    pre[tid] = nt;
    __syncthreads();
    for (int o = 1; o < kBlock; o <<= 1) {
      const long long v = tid >= o ? pre[tid - o] : 0;
      __syncthreads();
      pre[tid] += v;
      __syncthreads();
    }
    const long long total = pre[kBlock - 1];
    for (long long w = static_cast<long long>(blockIdx.x) * kBlock + tid;
         w < total; w += stride) {
      int lo = 0, hi = kBlock - 1;       // the first cell with pre > w
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] > w) hi = mid; else lo = mid + 1;
      }
      const int* r = rq[lo];
      const int k = static_cast<int>(w - (lo ? pre[lo - 1] : 0));
      const int n0 = rec_tiles(r), g = k < n0 ? 0 : 1;
      int ti, tj;
      rec_tile(r + 4 * g, k - g * n0, ti, tj);
      const int t = ti * tiles_lon(p) + tj;
      if (!kFill) {
        atomicAdd(p.tile_count + t, 1);
      } else {
        const int slot = atomicAdd(p.tile_fill + t, 1);
        p.entries[p.tile_start[t] + slot] =
            entry_of(cell[lo], r + 4 * g, ti, tj);
      }
    }
    __syncthreads();        // before the next chunk overwrites rq and pre
  }
}

// visit(l, cell) for every bin l (a * kTile + b in the tile) of every
// entry of tile t.  An entry of at most kSmallSpan bins is walked by one
// thread; a larger one (the cells that cover every bin, the polar rows) by
// the whole block, so no thread walks a whole tile while the others wait.
// Called by the whole block.
template <typename Visit>
__device__ __forceinline__ void tile_entries(const LocatorParams& p, int t,
                                             Visit visit) {
  __shared__ uint64_t large[kBlock];
  __shared__ int n_large;
  const long long start = p.tile_start[t];
  const int m = p.tile_count[t];
  for (int e0 = 0; e0 < m; e0 += kBlock) {
    if (threadIdx.x == 0) n_large = 0;
    __syncthreads();
    if (e0 + static_cast<int>(threadIdx.x) < m) {
      const uint64_t u = p.entries[start + e0 + threadIdx.x];
      const unsigned s = static_cast<unsigned>(u >> 32);
      const int a0 = s & 15, a1 = s >> 4 & 15, b0 = s >> 8 & 15,
                b1 = s >> 12 & 15;
      if ((a1 - a0 + 1) * (b1 - b0 + 1) > kSmallSpan) {
        large[atomicAdd(&n_large, 1)] = u;
      } else {
        for (int a = a0; a <= a1; ++a)
          for (int b = b0; b <= b1; ++b)
            visit(a * kTile + b, static_cast<int32_t>(u));
      }
    }
    __syncthreads();
    for (int i = 0; i < n_large; ++i) {
      const uint64_t u = large[i];
      const unsigned s = static_cast<unsigned>(u >> 32);
      const int a0 = s & 15, b0 = s >> 8 & 15;
      const int wb = (s >> 12 & 15) - b0 + 1;
      const int area = ((s >> 4 & 15) - a0 + 1) * wb;
      for (int w = threadIdx.x; w < area; w += kBlock)
        visit((a0 + w / wb) * kTile + b0 + w % wb, static_cast<int32_t>(u));
    }
    __syncthreads();          // before the next chunk resets the list
  }
}

// One block a tile: its bins' counts (shared-memory atomics) into
// `counts`, and the tile's largest count into k_max.
__global__ void __launch_bounds__(kBlock) locator_counts_kernel(
    const LocatorParams p) {
  __shared__ int cnt[kBlock];
  __shared__ int wmax[kBlock / 32];
  const int t = blockIdx.x, tl = tiles_lon(p);
  const int lat0 = (t / tl) * kTile, lon0 = (t % tl) * kTile;
  cnt[threadIdx.x] = 0;
  tile_entries(p, t, [&](int l, int32_t) { atomicAdd(&cnt[l], 1); });
  const int a = threadIdx.x / kTile, b = threadIdx.x % kTile;
  int v = cnt[threadIdx.x];
  if (lat0 + a < p.n_lat && lon0 + b < p.n_lon)
    p.counts[static_cast<long long>(lat0 + a) * p.n_lon + lon0 + b] = v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int mx = 0;
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) mx = max(mx, wmax[w]);
    if (mx > 0) atomicMax(p.k_max, mx);
  }
}

__device__ __forceinline__ void insertion_sort(int32_t* row, int m) {
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

// One block a tile: its bins' rows, ascending and -1 padded.  kShared: the
// rows meet in shared memory (k_cap <= kRowsMax) and leave as contiguous
// runs of the table; else in the table's rows, sorted and padded there.
template <bool kShared>
__global__ void __launch_bounds__(kBlock) locator_rows_kernel(
    const LocatorParams p) {
  extern __shared__ int32_t rows[];       // kShared: kBlock rows of ks
  __shared__ int cur[kBlock];
  const int t = blockIdx.x, tl = tiles_lon(p);
  const int lat0 = (t / tl) * kTile, lon0 = (t % tl) * kTile;
  const int k_cap = p.k_cap, ks = k_cap | 1;
  cur[threadIdx.x] = 0;
  tile_entries(p, t, [&](int l, int32_t c) {
    const int slot = atomicAdd(&cur[l], 1);
    if (kShared)
      rows[l * ks + slot] = c;
    else
      p.bins[(static_cast<long long>(lat0 + l / kTile) * p.n_lon + lon0 +
              l % kTile) * k_cap + slot] = c;
  });
  const int l = threadIdx.x, a = l / kTile, b = l % kTile;
  const bool in_grid = lat0 + a < p.n_lat && lon0 + b < p.n_lon;
  if (!kShared) {
    if (!in_grid) return;
    int32_t* row = p.bins +
                   (static_cast<long long>(lat0 + a) * p.n_lon + lon0 + b) *
                       k_cap;
    insertion_sort(row, cur[l]);
    for (int s = cur[l]; s < k_cap; ++s) row[s] = -1;
    return;
  }
  insertion_sort(rows + l * ks, cur[l]);
  __syncthreads();
  // each lat row of the tile is one contiguous run of the table; thread
  // j writes slot s of bin lb (j = lb * k_cap + s), stepping both on
  const int nla = min(kTile, p.n_lat - lat0), nlo = min(kTile, p.n_lon - lon0);
  const int len = nlo * k_cap;
  const int lb0 = threadIdx.x / k_cap, s0 = threadIdx.x - lb0 * k_cap;
  const int dlb = kBlock / k_cap, ds = kBlock - dlb * k_cap;
  for (int ar = 0; ar < nla; ++ar) {
    int32_t* run = p.bins +
                   (static_cast<long long>(lat0 + ar) * p.n_lon + lon0) * k_cap;
    int lb = lb0, s = s0;
    for (int j = threadIdx.x; j < len; j += kBlock) {
      const int lr = ar * kTile + lb;
      run[j] = s < cur[lr] ? rows[lr * ks + s] : -1;
      lb += dlb;
      s += ds;
      if (s >= k_cap) {
        s -= k_cap;
        ++lb;
      }
    }
  }
}

// The window's extremes: the least and largest corner latitude and
// longitude as order-preserving int keys (out[0..3]: lat min, lat max, lon
// min, lon max) and a NaN flag each for lat and lon (out[4], out[5]): as
// torch's min and max, a NaN anywhere makes the extreme NaN.  One read of
// both arrays; a warp's extremes go to `out` by atomics.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__global__ void __launch_bounds__(kBlock) locator_window_kernel(
    const float* lat, const float* lon, long long n3, int* out) {
  int lo[2] = {0x7fffffff, 0x7fffffff}, hi[2] = {-0x7fffffff - 1,
                                                 -0x7fffffff - 1};
  int nan[2] = {0, 0};
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock +
                     threadIdx.x;
       i < n3; i += stride) {
    const float v[2] = {__ldg(lat + i), __ldg(lon + i)};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (v[a] != v[a]) {
        nan[a] = 1;
      } else {
        const int k = order_key(v[a]);
        lo[a] = min(lo[a], k);
        hi[a] = max(hi[a], k);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = min(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
      hi[a] = max(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
      nan[a] |= __shfl_xor_sync(0xffffffffu, nan[a], o);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicMin(out + 2 * a, lo[a]);
      atomicMax(out + 2 * a + 1, hi[a]);
      if (nan[a]) atomicOr(out + 4 + a, 1);
    }
  }
}

unsigned int blocks(long long n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

// At most 8 blocks an SM (2048 threads), for grid-stride loops.
unsigned int resident_blocks(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long need = (n + kBlock - 1) / kBlock, cap = 8ll * sms;
  return static_cast<unsigned int>(need < cap ? need : cap);
}

unsigned int n_tiles(const LocatorParams* p) {
  return static_cast<unsigned int>((p->n_lat + kTile - 1) / kTile) *
         static_cast<unsigned int>((p->n_lon + kTile - 1) / kTile);
}

}  // namespace

// Bins a side of a tile (the wrapper sizes the tile arrays with it).
extern "C" int locator_tile() { return kTile; }

// The window's extremes of n3 = 3 N corner lat/lon values into `out` (6
// ints: INT_MAX, INT_MIN, INT_MAX, INT_MIN, 0, 0 to begin with).
extern "C" int locator_window_launch(const float* lat, const float* lon,
                                     long long n3, int* out, void* stream) {
  if (n3 <= 0) return 0;
  locator_window_kernel<<<resident_blocks(n3), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(lat, lon, n3,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}

// Each launches its step's kernels on `stream` (PyTorch's current stream);
// they allocate nothing and do not synchronise.  Return cudaGetLastError().
extern "C" int locator_rects_launch(const LocatorParams* p, void* stream) {
  if (p->n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  locator_rects_kernel<<<blocks(p->n), kBlock, 0, s>>>(*p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  locator_big_kernel<false><<<kBigBlocks, kBlock, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int locator_lists_launch(const LocatorParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->n > 0) {
    locator_lists_kernel<<<blocks(p->n), kBlock, 0, s>>>(*p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    locator_big_kernel<true><<<kBigBlocks, kBlock, 0, s>>>(*p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  locator_counts_kernel<<<n_tiles(p), kBlock, 0, s>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int locator_rows_launch(const LocatorParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->k_cap <= kRowsMax) {
    const size_t bytes = sizeof(int32_t) * kBlock * (p->k_cap | 1);
    locator_rows_kernel<true><<<n_tiles(p), kBlock, bytes, s>>>(*p);
  } else {
    locator_rows_kernel<false><<<n_tiles(p), kBlock, 0, s>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}
