// K6b `refine_keys`: the keys of the measured-cost re-sort, key[i] =
// cost_nat[perm[i]] for the covered prefix i < n_active.
//
// Replaces the XLA-fused gather in icon_rt_tpu/ops/order.py
// `refine_order_device` (the `cost_nat[head]` before its stable argsort).
// Its plain-PyTorch version is `_refine_keys_torch` in ops/order.py.
//
// What bounds it: bytes, 12 a key (perm read, one gathered cost, the key
// written; 14.3 MB at 1080p's 1,193,007 covered lanes, 4.3 us at
// 3.35 TB/s) -- and, at that size, the launch itself.  Each thread takes 4
// consecutive keys: one 16-byte load of perm, four independent gathers in
// flight, one 16-byte store; the last thread of a ragged prefix takes the
// tail one key at a time.  The launch path is a plain C entry point called
// through ctypes, so the wrapper's host work is one check, one allocation
// and this call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
refine_keys_kernel(const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ cost,
                   int32_t* __restrict__ out, long long n) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i + 4 <= n) {
    const int4 p = __ldg(reinterpret_cast<const int4*>(perm + i));
    int4 k;
    k.x = __ldg(cost + p.x);
    k.y = __ldg(cost + p.y);
    k.z = __ldg(cost + p.z);
    k.w = __ldg(cost + p.w);
    *reinterpret_cast<int4*>(out + i) = k;
  } else {
    for (long long j = i; j < n; ++j) out[j] = __ldg(cost + __ldg(perm + j));
  }
}

}  // namespace

// Launches the kernel on `stream` (PyTorch's current stream) for n > 0
// keys; perm and out must be 16-byte aligned.  Allocates nothing, does not
// synchronise.  Returns cudaGetLastError().
extern "C" int refine_keys_launch(const int32_t* perm, const int32_t* cost,
                                  int32_t* out, long long n, void* stream) {
  const long long threads = (n + 3) / 4;
  refine_keys_kernel<<<static_cast<unsigned int>(
                           (threads + kBlock - 1) / kBlock),
                       kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      perm, cost, out, n);
  return static_cast<int>(cudaGetLastError());
}
