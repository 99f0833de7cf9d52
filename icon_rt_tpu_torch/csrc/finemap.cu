// K7-fm `build_finemap`: the fine primary-candidate map of the two-stage
// locate, built on the card in one tiled launch.
//
// Replaces the XLA-fused icon_rt_tpu/models/finemap.py `_centers_c0`,
// `_second_candidates`, `_first_distinct4` and the slab body of
// `build_finemap`.  Its plain-PyTorch version is `_build_finemap_torch` in
// models/finemap.py.
//
// The map is computed on the (2 F_lat, 2 F_lon) sub grid of sub-bin
// centers (F = factor x the coarse locator's dims):
//   c0  the first candidate of a center's coarse bin (the integer-divided
//       parent, in row order) whose three side planes contain the center's
//       unit-sphere point laterally (the planes pass through the origin, so
//       the test holds for every radius); -1 where none does;
//   c1  the first neighbour in the order E, W, S, N, then the diagonals,
//       whose c0 differs and is >= 0 (longitude wraps, latitude clamps);
//   and per fine bin the 8-pool (c0 of its 4 sub-centers, then their c1, in
//   (dl, do) order), its first 4 distinct entries, each encoded as its first
//   slot in the coarse row of the fine bin's parent bin, 255 if absent or
//   empty.
//
// One block owns a tile of fine bins (`tile_lat` x `tile_lon`; the edge
// tiles are cut at the grid's dims) and keeps everything between its reads
// and its writes in shared memory, as the TPU build's latitude slabs kept
// theirs in VMEM with a one-row halo:
//   1. it stages the coarse rows of every parent bin of its sub-centers and
//      of a one-sub-center halo ring around them (the ring wraps in
//      longitude and clamps in latitude, the grid's own rule; kBatch loads
//      in flight a thread), each row's length up to its last id, and
//      cos/sin of the tile's distinct sub-row latitudes and sub-column
//      longitudes, each computed once (the same f32 expressions as per
//      center, so no bit moves);
//   2. c0 of the tile's sub-centers into shared memory, a warp a 4 x 8
//      patch of them (at factor 2 its lanes share two coarse rows, so a
//      candidate's plane loads touch few lines), then c0 of the halo ring;
//   3. per fine bin c1, the first 4 distinct and the slot search against
//      the staged parent row, and one 32-bit store of the 4 u8 slots (slot k
//      in byte k: the (n_fine, 4) u8 layout's byte order).
// No sub-center image exists in global memory.
//
// What bounds it: the containment tests, at the rate the SM can keep
// them in flight.  Each center walks its staged coarse row and, per
// live candidate, reads its 36-byte plane row through L1 (neighbouring
// centers share cells), runs 9 multiplies and 6 adds and branches; at
// R2B9 a center tests ~5.6 candidates and a warp runs ~10 steps a center
// (its lanes stop at different slots).  The launch bounds hold the kernel
// to 32 registers, so 8 blocks (64 warps) share an SM to hide the loads'
// latency.  Global traffic is the coarse rows (read once a tile, plus the
// ring), the candidates' plane rows and 4 bytes a fine bin.  Built with
// -fmad=false: the plane tests and the center coordinates round as the
// plain version's eager ops do.
#include <cstdint>
#include <cuda_runtime.h>

// Mirror of `_FinemapParams` in models/finemap.py (same field order).
struct FinemapParams {
  const int32_t* bins;    // (n_lat * n_lon, k_cap) coarse locator, -1 padded
  const float* test12;    // (N, 12); columns 0..8 (normals) are read
  uint32_t* slots;        // (f_lat * f_lon,) out: 4 u8 slots a fine bin
  float lat_lo, lat_hi, lon_lo, lon_hi;
  int n_lat, n_lon, k_cap, factor;
  int tile_lat, tile_lon;   // fine bins a block (the launcher may shrink it)
};

namespace {

constexpr int kCand = 4;
constexpr int kBlock = 256;
constexpr int kBatch = 8;       // staged loads in flight a thread
constexpr int kSmemMax = 48 * 1024;   // dynamic shared memory without opt-in

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__host__ __device__ __forceinline__ int wrap(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Shared memory of a block, in 4-byte words, for the tile of `p`: the
// staged coarse rows (at most `rows_cap` x `cols_cap` parents: a span of L
// consecutive sub rows has at most ceil(L / fs) + 1 parents), their
// lengths, the halo's c0 image, the halo rows' and columns' cos/sin and
// their staged parent's row offset and column.
struct Layout {
  int rows_cap, cols_cap, lens, c0, trig, index, words;
};

__host__ __device__ __forceinline__ Layout layout(const FinemapParams& p) {
  const int fs = 2 * p.factor;
  const int hr = 2 * p.tile_lat + 2, hc = 2 * p.tile_lon + 2;
  Layout l;
  l.rows_cap = (hr + fs - 1) / fs + 1;
  l.cols_cap = (hc + fs - 1) / fs + 1;
  l.lens = l.rows_cap * l.cols_cap * p.k_cap;   // the rows come first
  l.c0 = l.lens + l.rows_cap * l.cols_cap;
  l.trig = l.c0 + hr * hc;
  l.index = l.trig + 2 * (hr + hc);
  l.words = l.index + hr + hc;
  return l;
}

__global__ void __launch_bounds__(kBlock, 8)
finemap_kernel(const FinemapParams p, int tiles_lon) {
  extern __shared__ int32_t smem[];
  const Layout lay = layout(p);
  const int fs = 2 * p.factor;
  const int f_lat = p.factor * p.n_lat, f_lon = p.factor * p.n_lon;
  const int s_lat = 2 * f_lat, s_lon = 2 * f_lon;
  const int fl0 = static_cast<int>(blockIdx.x / tiles_lon) * p.tile_lat;
  const int fo0 = static_cast<int>(blockIdx.x % tiles_lon) * p.tile_lon;
  const int nr = min(p.tile_lat, f_lat - fl0);
  const int nc = min(p.tile_lon, f_lon - fo0);
  // the halo image: sub rows 2 fl0 - 1 .. 2 (fl0 + nr), clamped; sub
  // columns 2 fo0 - 1 .. 2 (fo0 + nc), wrapped
  const int hr = 2 * nr + 2, hc = 2 * nc + 2;
  const int sl0 = 2 * fl0 - 1, so0 = 2 * fo0 - 1;
  // the staged parents: rows pr0.. (clamped sub rows divide monotonically),
  // columns pc0.. unwrapped (column pc0 + c is global (pc0 + c) mod n_lon)
  const int pr0 = max(sl0, 0) / fs;
  const int sr = min(sl0 + hr - 1, s_lat - 1) / fs - pr0 + 1;
  const int pc0 = floor_div(so0, fs);
  const int sc = floor_div(so0 + hc - 1, fs) - pc0 + 1;
  const int k_cap = p.k_cap;
  int32_t* rows = smem;
  int32_t* lens = smem + lay.lens;
  int32_t* c0 = smem + lay.c0;
  float* cos_lat = reinterpret_cast<float*>(smem + lay.trig);
  float* sin_lat = cos_lat + hr;
  float* cos_lon = sin_lat + hr;
  float* sin_lon = cos_lon + hc;
  int32_t* row_off = smem + lay.index;   // halo row -> r * sc
  int32_t* col_of = row_off + hr;        // halo column -> c

  // 1. coarse rows: staged row r is the contiguous run of sc * k_cap ints
  //    from (pr0 + r, pc0) unless the tile's columns wrap (the first and
  //    last column of tiles); the halo's cos/sin and parents
  const int run = sc * k_cap;
  const bool wraps = pc0 < 0 || pc0 + sc > p.n_lon;
  const int total = sr * run;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * kBlock) {
    int32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kBlock;
      if (e < total) {
        const int r = e / run, x = e - r * run;
        const size_t base = static_cast<size_t>(pr0 + r) * p.n_lon;
        if (!wraps) {
          v[u] = __ldg(p.bins + (base + pc0) * k_cap + x);
        } else {
          const int c = x / k_cap;
          v[u] = __ldg(p.bins + (base + wrap(pc0 + c, p.n_lon)) * k_cap +
                       (x - c * k_cap));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kBlock;
      if (e < total) rows[e] = v[u];
    }
  }
  const float d_lat = (p.lat_hi - p.lat_lo) / static_cast<float>(s_lat);
  const float d_lon = (p.lon_hi - p.lon_lo) / static_cast<float>(s_lon);
  for (int i = threadIdx.x; i < hr + hc; i += kBlock) {
    if (i < hr) {
      const int sl = min(max(sl0 + i, 0), s_lat - 1);
      const float lat = p.lat_lo + (static_cast<float>(sl) + 0.5f) * d_lat;
      cos_lat[i] = cosf(lat);
      sin_lat[i] = sinf(lat);
      row_off[i] = (sl / fs - pr0) * sc;
    } else {
      const int j = i - hr;
      const int so = wrap(so0 + j, s_lon);
      const float lon = p.lon_lo + (static_cast<float>(so) + 0.5f) * d_lon;
      cos_lon[j] = cosf(lon);
      sin_lon[j] = sinf(lon);
      col_of[j] = floor_div(so0 + j, fs) - pc0;
    }
  }
  __syncthreads();
  // a row's length: past its last id (rows are -1 padded at the tail; an
  // inner -1 is skipped, as the plain version skips it)
  for (int rc = threadIdx.x; rc < sr * sc; rc += kBlock) {
    int n = k_cap;
    while (n > 0 && rows[rc * k_cap + n - 1] < 0) --n;
    lens[rc] = n;
  }
  __syncthreads();

  // 2. c0 of the halo image: the interior in 4 x 8 patches, one a warp,
  //    so that a warp's lanes share few coarse bins (two at factor 2),
  //    then the ring
  const auto center = [&](int i, int j) {
    const int rc = row_off[i] + col_of[j];
    const float cl = cos_lat[i];
    const float px = cl * cos_lon[j];
    const float py = cl * sin_lon[j];
    const float pz = sin_lat[i];
    const int32_t* cand = rows + rc * k_cap;
    const int n = lens[rc];
    int out = -1;
    for (int k = 0; k < n; ++k) {
      const int id = cand[k];
      if (id < 0) continue;
      const float4* t = reinterpret_cast<const float4*>(
          p.test12 + static_cast<size_t>(id) * 12);
      const float4 a = __ldg(t), b = __ldg(t + 1), q = __ldg(t + 2);
      const float ev1 = a.x * px + a.y * py + a.z * pz;
      const float ev2 = a.w * px + b.x * py + b.y * pz;
      const float ev3 = b.z * px + b.w * py + q.x * pz;
      if (ev1 <= 0.0f && ev2 <= 0.0f && ev3 <= 0.0f) {
        out = id;
        break;
      }
    }
    c0[i * hc + j] = out;
  };
  const int p_cols = (2 * nc + 7) / 8;
  const int patches = (2 * nr + 3) / 4 * p_cols;
  const int lane = threadIdx.x % 32;
  for (int w = threadIdx.x / 32; w < patches; w += kBlock / 32) {
    const int i = 1 + 4 * (w / p_cols) + lane / 8;
    const int j = 1 + 8 * (w % p_cols) + lane % 8;
    if (i <= 2 * nr && j <= 2 * nc) center(i, j);
  }
  for (int e = threadIdx.x; e < 2 * (hr + hc) - 4; e += kBlock) {
    if (e < 2 * hc) {
      center(e < hc ? 0 : hr - 1, e % hc);
    } else {
      const int m = e - 2 * hc;          // rows 1 .. hr - 2 of each side
      center(1 + m / 2, m % 2 ? hc - 1 : 0);
    }
  }
  __syncthreads();

  // 3. per fine bin: c1 of its 4 sub-centers, the first 4 distinct of the
  //    8-pool, the slots in the parent row, one store
  constexpr int kDl[8] = {0, 0, 1, -1, 1, 1, -1, -1};
  constexpr int kDo[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  for (int e = threadIdx.x; e < nr * nc; e += kBlock) {
    const int a = e / nc, b = e - a * nc;
    int pool[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 1 + 2 * a + k / 2, j = 1 + 2 * b + k % 2;
      const int base = c0[i * hc + j];
      int c1 = -1;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int v = c0[(i + kDl[m]) * hc + j + kDo[m]];
        if (c1 < 0 && v != base && v >= 0) c1 = v;
      }
      pool[k] = base;
      pool[4 + k] = c1;
    }
    int sel[kCand] = {-1, -1, -1, -1};
    int cnt = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int v = pool[m];
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
    const int rc = row_off[1 + 2 * a] + col_of[1 + 2 * b];
    const int32_t* row = rows + rc * k_cap;
    const int n = lens[rc];
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < kCand; ++k) {
      uint32_t slot = 255;
      if (sel[k] >= 0) {
        for (int m = 0; m < n; ++m) {
          if (row[m] == sel[k]) {
            slot = m;
            break;
          }
        }
      }
      word |= slot << (8 * k);
    }
    p.slots[static_cast<size_t>(fl0 + a) * f_lon + fo0 + b] = word;
  }
}

// The tile of `p` halved, the longer side first, until its shared memory
// fits 48 KB (a 1 x 1 tile needs at most 3 x 3 coarse rows and a 4 x 4
// halo at factor 1: 9.2 KB at k_cap 254).
FinemapParams fitted(FinemapParams p) {
  while (layout(p).words * 4 > kSmemMax && (p.tile_lat > 1 || p.tile_lon > 1)) {
    if (p.tile_lon >= p.tile_lat) p.tile_lon = (p.tile_lon + 1) / 2;
    else p.tile_lat = (p.tile_lat + 1) / 2;
  }
  return p;
}

}  // namespace

// Launches the kernel on `stream` (PyTorch's current stream) over the
// fitted tile; allocates nothing and does not synchronise.  Returns
// cudaGetLastError().
extern "C" int finemap_launch(const FinemapParams* params, void* stream) {
  const FinemapParams p = fitted(*params);
  const long long f_lat = static_cast<long long>(p.factor) * p.n_lat;
  const long long f_lon = static_cast<long long>(p.factor) * p.n_lon;
  if (f_lat * f_lon <= 0) return 0;
  const int bytes = layout(p).words * 4;
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_lat = (f_lat + p.tile_lat - 1) / p.tile_lat;
  const long long tiles_lon = (f_lon + p.tile_lon - 1) / p.tile_lon;
  finemap_kernel<<<static_cast<unsigned int>(tiles_lat * tiles_lon), kBlock,
                   bytes, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<int>(tiles_lon));
  return static_cast<int>(cudaGetLastError());
}
