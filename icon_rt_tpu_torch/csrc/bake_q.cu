// K5c-q: the TF-edit bake of the quantized tier, alpha_q (N, Lm) u8 from
// the value levels value_q (N, Lm) u8 and a 256-entry table of normalized
// alphas (models/qcells.py `bake_alpha_q`): out = tab[vq].
//
// Replaces the XLA-fused loops of icon_rt_tpu/models/qcells.py
// `_bake_lookup` (:266; out = tab[vq]) and `_bake_patch` (:298; out =
// new[j] where vq == lev[j], else the old table), which avoid a gather with
// 256- or 32-way compare-select reduces because a TPU gather from a small
// table lowers to scalar loads.  The patch is this lookup of the edited
// table: alpha_q == alpha_tab[value_q] holds for every baked table, so the
// old table patched at the changed levels equals the new table looked up.
// The plain-PyTorch version is `_bake_lookup_torch` in models/qcells.py.
//
// What bounds it on the H100: bytes.  At R2B9 (83,886,080 columns x 16
// layers) the tables hold 1.34e9 entries; the kernel reads vq and writes
// out whole, 2n bytes, and the 256-byte table sits in shared memory.  A
// thread moves one 16-byte vector (the last n % 16 bytes go one a thread),
// and the grid covers every vector.  Measured on the H100 at R2B9 and not
// kept (scripts/time_bake_q.py --variants; PERF.md §6): a grid sized to the
// SMs striding with 4 vectors a thread, 2 or 4 vectors a thread over the
// whole grid, the table read through L1 or from 32 lane copies without bank
// conflicts, streaming hints on the loads and stores; and an
// in-place patch through a 256-entry level map (reads vq, writes back only
// the vectors that hold a changed level), faster than this lookup only for
// edits of rare levels (under ~10M of the 1.34e9 entries), which no edit of
// the app makes.  vq and out start on a 16-byte boundary (the wrapper
// checks).
#include <cstdint>
#include <cuda_runtime.h>

// Mirror of `_BakeParams` in models/qcells.py (same field order).
struct BakeParams {
  const uint8_t* vq;    // (n,) value levels
  const uint8_t* tab;   // (256,) the table
  uint8_t* out;         // (n,) written whole
  long long n;
};

namespace {

constexpr int kThreads = 256;   // == the table's entries: one a thread

// The four table bytes of the levels packed in w.
__device__ __forceinline__ uint32_t lookup4(const uint8_t* t, uint32_t w) {
  return uint32_t(t[w & 0xffu]) | uint32_t(t[(w >> 8) & 0xffu]) << 8 |
         uint32_t(t[(w >> 16) & 0xffu]) << 16 | uint32_t(t[w >> 24]) << 24;
}

__global__ void __launch_bounds__(kThreads)
bake_lookup_kernel(const BakeParams p) {
  __shared__ uint8_t tab[256];
  tab[threadIdx.x] = p.tab[threadIdx.x];
  __syncthreads();
  const long long nv = p.n >> 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < nv) {
    const uint4 v = reinterpret_cast<const uint4*>(p.vq)[i];
    reinterpret_cast<uint4*>(p.out)[i] =
        make_uint4(lookup4(tab, v.x), lookup4(tab, v.y), lookup4(tab, v.z),
                   lookup4(tab, v.w));
  }
  const long long j = (nv << 4) + i;
  if (j < p.n) p.out[j] = tab[p.vq[j]];
}

}  // namespace

// Launch the lookup: a block 256 vectors.
extern "C" int bake_lookup_launch(const BakeParams* p, void* stream) {
  const long long blocks = ((p->n >> 4) + kThreads - 1) / kThreads;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  void* args[] = {const_cast<BakeParams*>(p)};
  cudaLaunchKernel(reinterpret_cast<const void*>(bake_lookup_kernel),
                   dim3(blocks < 1 ? 1 : unsigned(blocks)), dim3(kThreads),
                   args, 0, static_cast<cudaStream_t>(stream));
  return cudaGetLastError();
}

// {resident blocks an SM, registers, local bytes} of the lookup at
// kThreads threads.
extern "C" int bake_q_occupancy(int* out) {
  const void* k = reinterpret_cast<const void*>(bake_lookup_kernel);
  cudaFuncAttributes a;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k, kThreads, 0);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return err;
  out[1] = a.numRegs;
  out[2] = int(a.localSizeBytes);
  return cudaSuccess;
}
