// K5b `max_opacity`: per-bin majorants from the transfer function, the
// reference's computeMaxOpacities (icon_rt/hostCode.cu:362-434).
//
// Replaces the XLA-fused icon_rt_tpu/models/accel.py `compute_max_opacities`
// and `_lut_sparse_table`: each bin's value range (lo, hi) maps to the LUT
// index range [ilo, ihi] and its majorant is the largest alpha over that
// range, 0 for an empty bin (hi < lo).  The plain-PyTorch version is
// `compute_max_opacities_torch` in models/accel.py; this kernel computes
// the same function in the same order:
//   ilo = clamp(int(((lo - v0) / span) * (S - 1)), 0, S - 1)
//   ihi = clamp(int(((hi - v0) / span) * (S - 1)) + 1, 0, S - 1)
//   k   = floor(log2(ihi - ilo + 1))        (0 for an inverted range)
//   mo  = max(T[k][ilo], T[k][max(ihi - 2^k + 1, 0)])
// with T the sparse table T[0] = alpha, T[k][i] = max(T[k-1][i],
// T[k-1][min(i + 2^(k-1), S - 1)]), S = the LUT's size.
//
// What bounds it on the H100: bytes (8 read and 4 written a bin; 16.8M bins
// of the grid accel are 0.060 ms at 3.35 TB/s).  Each block builds the
// whole table in shared memory (floor(log2 S) + 1 levels of S floats: 10.8
// KB at S = 300), then its threads stride over the bins, one gather of two
// table entries a bin; no bin compares the whole LUT.  A table larger than
// kSharedBytes is built once in global memory (one short launch a level)
// and read from there.  Built with -fmad=false (utils/cuda_build.py): the
// divide and the multiply round on their own, as eager PyTorch does; the
// float -> int conversions truncate and saturate (cvt.rzi) as the card's
// `.to(torch.int32)`, and `max` is torch.maximum's (NaN-propagating).
#include <cstdint>
#include <cuda_runtime.h>

// Mirror of `_MajorantParams` in models/accel.py (same field order).
struct MajorantParams {
  const float* ranges;    // (m, 2) value ranges (lo, hi)
  const float* lut;       // (s, 4) RGBA LUT; alpha is column 3
  const float* tf_range;  // (2,) the TF's value range
  float* table;           // (levels, s) scratch of the global-table path
  float* out;             // (m,) majorants
  long long m;
  int s, levels;
};

namespace {

constexpr int kBlock = 256;
constexpr int kBlocksPerSM = 8;          // 2048 threads an SM
// the largest table a block builds in shared memory: the default 48 KB a
// block may use without opting in (S <= 1117 at 11 levels)
constexpr int kSharedBytes = 48 * 1024;

// torch.maximum: NaN if either is NaN, else std::max
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? b : a));
}

// T[k][i] from level k - 1 (k >= 1), the neighbour clamped at s - 1
__device__ __forceinline__ float level_entry(const float* tab, int s, int k,
                                             int i) {
  const float* prev = tab + static_cast<long long>(k - 1) * s;
  return tmax(prev[i], prev[min(i + (1 << (k - 1)), s - 1)]);
}

// The majorants of the bins this thread strides over, from table `tab`.
__device__ __forceinline__ void rows(const MajorantParams& p,
                                     const float* tab) {
  const float v0 = p.tf_range[0];
  const float span = __fsub_rn(p.tf_range[1], v0);
  const float s_m1 = static_cast<float>(p.s - 1);
  const int s = p.s;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock +
                     threadIdx.x;
       i < p.m; i += stride) {
    const float lo = __ldg(p.ranges + 2 * i);
    const float hi = __ldg(p.ranges + 2 * i + 1);
    const float lo_n = __fdiv_rn(__fsub_rn(lo, v0), span);
    const float hi_n = __fdiv_rn(__fsub_rn(hi, v0), span);
    const int ilo = min(max(__float2int_rz(__fmul_rn(lo_n, s_m1)), 0), s - 1);
    // int32 + 1 wraps as the tensor's add does
    const int ihi = min(max(static_cast<int>(static_cast<unsigned>(
                                __float2int_rz(__fmul_rn(hi_n, s_m1))) + 1u),
                            0),
                        s - 1);
    const int len = ihi - ilo + 1;
    const int k = len >= 1 ? min(31 - __clz(len), p.levels - 1) : 0;
    const float* tk = tab + static_cast<long long>(k) * s;
    const float mo = tmax(tk[ilo], tk[max(ihi - (1 << k) + 1, 0)]);
    p.out[i] = hi < lo ? 0.0f : mo;
  }
}

__global__ void __launch_bounds__(kBlock)
majorant_shared_kernel(const MajorantParams p) {
  extern __shared__ float tab[];
  const int s = p.s;
  for (int i = threadIdx.x; i < s; i += kBlock) tab[i] = __ldg(p.lut + 4 * i + 3);
  for (int k = 1; k < p.levels; ++k) {
    __syncthreads();
    for (int i = threadIdx.x; i < s; i += kBlock)
      tab[k * s + i] = level_entry(tab, s, k, i);
  }
  __syncthreads();
  rows(p, tab);
}

// Level k of the global table (k = 0: the alpha column).
__global__ void __launch_bounds__(kBlock)
majorant_level_kernel(const MajorantParams p, int k) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.s) return;
  p.table[static_cast<long long>(k) * p.s + i] =
      k == 0 ? p.lut[4 * i + 3] : level_entry(p.table, p.s, k, i);
}

__global__ void __launch_bounds__(kBlock)
majorant_global_kernel(const MajorantParams p) {
  rows(p, p.table);
}

unsigned int row_blocks(long long m) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long need = (m + kBlock - 1) / kBlock;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSM;
  return static_cast<unsigned int>(need < cap ? need : cap);
}

}  // namespace

// The largest (levels, s) f32 table kept in shared memory; a larger one
// lives in p->table, which the wrapper allocates.
extern "C" int majorant_shared_limit() { return kSharedBytes; }

// One K5b pass on `stream` (PyTorch's current stream); allocates nothing
// and does not synchronise.  Returns cudaGetLastError().
extern "C" int max_opacity_launch(const MajorantParams* p, void* stream) {
  if (p->m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long bytes = 4ll * p->s * p->levels;
  if (bytes <= kSharedBytes) {
    majorant_shared_kernel<<<row_blocks(p->m), kBlock,
                             static_cast<size_t>(bytes), st>>>(*p);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned int lb = static_cast<unsigned int>((p->s + kBlock - 1) /
                                                    kBlock);
  for (int k = 0; k < p->levels; ++k) {
    majorant_level_kernel<<<lb, kBlock, 0, st>>>(*p, k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  majorant_global_kernel<<<row_blocks(p->m), kBlock, 0, st>>>(*p);
  return static_cast<int>(cudaGetLastError());
}
