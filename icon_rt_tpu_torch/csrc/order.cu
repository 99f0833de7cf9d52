// The ray-ordering kernels: K6 `chord_keys` (the camera move's sort keys
// and covered count) and K6b's `refine_keys` and `refine_perm` (the
// measured-cost re-sort).  Their plain-PyTorch versions are
// `_chord_keys_torch`, `_refine_keys_torch` and `_refine_perm_torch` in
// ops/order.py.  Each kernel takes 4 consecutive elements a thread with
// one 16-byte store; the last thread of a ragged range takes its tail one
// element at a time.  The launch path is a plain C entry point called
// through ctypes, so a wrapper's host work is one check, its outputs'
// allocation and this call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

// K6 `chord_keys`: replaces the XLA-fused icon_rt_tpu/ops/order.py
// `_chord_keys` and the `np.isfinite(keys).sum()` of its `pixel_order`.
// key = in-shell chord length of the pixel's central ray, +inf where the
// ray misses the outer shell inflated by a few pixel footprints.
//
// What bounds it: its bound is the 4-byte key a pixel (8.3 MB at 1080p,
// 2.5 us at 3.35 TB/s), but the IEEE square roots and reciprocal, each a
// sequence of instructions, make it issue-bound.  So a pixel takes a root
// only where the plain version's result uses it: a covered test with
// od < 0 (-od > 0, so -od + root > 0 whatever the root) takes none, a
// miss of the outer or the inner shell none for that shell; the block's
// camera terms (|o|^2 and the pixel footprint) are computed once, into
// shared memory beside the 12 camera floats, and a thread divides once
// for its 4 pixels' coordinates.  Every operation rounds on its own, as in
// the eager plain version (the build's -fmad=false, __fsqrt_rn, and
// __frcp_rn, which rounds 1/x as PyTorch's reciprocal does), so the keys
// equal it bit for bit.  The covered count is taken in the same pass: a
// warp ballot and popcount a key, the warps' sums in shared memory, one
// atomicAdd a block into the int the entry point zeroed.
__device__ __forceinline__ float chord_key(const float* c, float r_in,
                                           float r_out, unsigned x,
                                           unsigned y) {
  const float u = static_cast<float>(x) + 1.0f;
  const float v = static_cast<float>(y) + 1.0f;
  float dx = c[3] + u * c[6] + v * c[9];
  float dy = c[4] + u * c[7] + v * c[10];
  float dz = c[5] + u * c[8] + v * c[11];
  const float inv = __frcp_rn(__fsqrt_rn(dx * dx + dy * dy + dz * dz));
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
  const float od = c[0] * dx + c[1] * dy + c[2] * dz;
  const float base = od * od - c[12];
  const float rm = r_out + 4.0f * c[13] * fabsf(od);
  const float disc_m = base + rm * rm;
  if (!(disc_m > 0.0f && (od < 0.0f || -od + __fsqrt_rn(disc_m) > 0.0f)))
    return __int_as_float(0x7f800000);
  const float disc_o = base + r_out * r_out;
  if (!(disc_o > 0.0f)) return 0.0f;
  const float sq_o = __fsqrt_rn(disc_o);
  if (!(-od + sq_o > 0.0f)) return 0.0f;
  const float disc_i = base + r_in * r_in;
  if (disc_i > 0.0f) {
    const float sq_i = __fsqrt_rn(disc_i);
    if (-od + sq_i > 0.0f) return 2.0f * sq_o - 2.0f * sq_i;
  }
  return 2.0f * sq_o - 0.0f;
}

__global__ void __launch_bounds__(kBlock)
chord_keys_kernel(const float* __restrict__ org,
                  const float* __restrict__ dir00,
                  const float* __restrict__ du, const float* __restrict__ dv,
                  float r_in, float r_out, unsigned width, unsigned total,
                  float* __restrict__ keys, int* __restrict__ covered) {
  // the camera's org | dir00 | du | dv, then |org|^2 and the footprint
  __shared__ float c[14];
  __shared__ int warp_sums[kWarps];
  if (threadIdx.x < 12) {
    const float* v = threadIdx.x < 3   ? org
                     : threadIdx.x < 6 ? dir00
                     : threadIdx.x < 9 ? du
                                       : dv;
    c[threadIdx.x] = v[threadIdx.x % 3];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    c[12] = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    c[13] = __fsqrt_rn(c[6] * c[6] + c[7] * c[7] + c[8] * c[8]) +
            __fsqrt_rn(c[9] * c[9] + c[10] * c[10] + c[11] * c[11]);
  }
  __syncthreads();
  const unsigned i = (blockIdx.x * kBlock + threadIdx.x) * 4u;
  unsigned y = i / width, x = i - y * width;
  float k[4];
  int n = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = i + j < total;
    k[j] = in ? chord_key(c, r_in, r_out, x, y) : 0.0f;
    n += __popc(__ballot_sync(0xffffffffu, in && isfinite(k[j])));
    if (++x == width) x = 0, ++y;
  }
  if (i + 4 <= total) {
    *reinterpret_cast<float4*>(keys + i) = make_float4(k[0], k[1], k[2], k[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < total) keys[i + j] = k[j];
  }
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_sums[w];
    if (sum) atomicAdd(covered, sum);
  }
}

// K6b `refine_keys`: the keys of the measured-cost re-sort, key[i] =
// cost_nat[perm[i]] for the covered prefix i < n_active.  Replaces the
// XLA-fused gather in icon_rt_tpu/ops/order.py `refine_order_device` (the
// `cost_nat[head]` before its stable argsort).
//
// What bounds it: bytes, 12 a key (perm read, one gathered cost, the key
// written; 14.3 MB at 1080p's 1,193,007 covered lanes, 4.3 us at
// 3.35 TB/s) -- and, at that size, the launch itself.  One 16-byte load
// of perm, four independent gathers in flight, one 16-byte store.
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

// Four sort indices from 16-byte aligned `order + i`: one 16-byte load of
// int32 indices, two of int64 ones (torch.sort's own dtype).
__device__ __forceinline__ void load4(const int32_t* order, long long i,
                                      long long o[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(order + i));
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}

__device__ __forceinline__ void load4(const long long* order, long long i,
                                      long long o[4]) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(order + i));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(order + i + 2));
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}

// K6b `refine_perm`: the re-sorted permutation, out[i] = perm[order[i]]
// for i < n_active and perm[i] past it.  Replaces the gather and
// concatenate of icon_rt_tpu/ops/order.py `refine_order_device`
// (`jnp.concatenate([head[order], perm[n_active:]])`).
//
// What bounds it: bytes, 8 an index of `order` (int64, as torch.sort
// returns it; 4 for int32) and 8 a lane (perm read, out written); 26.1 MB
// at 1080p's 1,193,007 covered of 2,073,600 lanes, 7.8 us at 3.35 TB/s.
// A head vector: one vector load of order, four independent gathers, one
// 16-byte store; a tail vector: a 16-byte copy; the vector that straddles
// n_active or ends the range: one lane at a time.
template <typename Index>
__global__ void __launch_bounds__(kBlock)
refine_perm_kernel(const int32_t* __restrict__ perm,
                   const Index* __restrict__ order,
                   int32_t* __restrict__ out, long long n_active,
                   long long total) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i + 4 <= n_active) {
    long long o[4];
    load4(order, i, o);
    int4 v;
    v.x = __ldg(perm + o[0]);
    v.y = __ldg(perm + o[1]);
    v.z = __ldg(perm + o[2]);
    v.w = __ldg(perm + o[3]);
    *reinterpret_cast<int4*>(out + i) = v;
  } else if (i >= n_active && i + 4 <= total) {
    *reinterpret_cast<int4*>(out + i) =
        __ldg(reinterpret_cast<const int4*>(perm + i));
  } else {
    for (long long j = i; j < i + 4 && j < total; ++j)
      out[j] = __ldg(perm + (j < n_active
                                 ? static_cast<long long>(__ldg(order + j))
                                 : j));
  }
}

unsigned int grid_of(long long n) {
  return static_cast<unsigned int>(((n + 3) / 4 + kBlock - 1) / kBlock);
}

}  // namespace

// Zeroes *covered, then launches K6 on `stream` (PyTorch's current stream)
// for total = width * height > 0 pixels, 0 < total < 2^31; keys must be
// 16-byte aligned, the four camera vectors (3,) floats each.  Allocates
// nothing, does not synchronise.  Returns the memset's error or
// cudaGetLastError().
extern "C" int chord_keys_launch(const float* org, const float* dir00,
                                 const float* du, const float* dv, float r_in,
                                 float r_out, int width, long long total,
                                 float* keys, int* covered, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(covered, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  chord_keys_kernel<<<grid_of(total), kBlock, 0, s>>>(
      org, dir00, du, dv, r_in, r_out, static_cast<unsigned>(width),
      static_cast<unsigned>(total), keys, covered);
  return static_cast<int>(cudaGetLastError());
}

// Launches refine_keys on `stream` for n > 0 keys; perm and out must be
// 16-byte aligned.  Allocates nothing, does not synchronise.  Returns
// cudaGetLastError().
extern "C" int refine_keys_launch(const int32_t* perm, const int32_t* cost,
                                  int32_t* out, long long n, void* stream) {
  refine_keys_kernel<<<grid_of(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(perm, cost, out,
                                                            n);
  return static_cast<int>(cudaGetLastError());
}

// Launches refine_perm on `stream` for total > 0 lanes; `order` holds
// n_active int64 indices where order_64 is non-zero, else int32 ones.
// perm, order and out must be 16-byte aligned.  Allocates nothing, does
// not synchronise.  Returns cudaGetLastError().
extern "C" int refine_perm_launch(const int32_t* perm, const void* order,
                                  int order_64, int32_t* out,
                                  long long n_active, long long total,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order_64)
    refine_perm_kernel<<<grid_of(total), kBlock, 0, s>>>(
        perm, static_cast<const long long*>(order), out, n_active, total);
  else
    refine_perm_kernel<<<grid_of(total), kBlock, 0, s>>>(
        perm, static_cast<const int32_t*>(order), out, n_active, total);
  return static_cast<int>(cudaGetLastError());
}
