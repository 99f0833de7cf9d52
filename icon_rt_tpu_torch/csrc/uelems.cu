// K9-n `uelems_points`: the Newton intersectors of unstructured elements
// (pyramid, wedge, hexahedron) on a batch of points, one thread per point.
//
// Replaces the XLA-fused icon_rt_tpu/ops/uelems.py `intersect_wedge` :126,
// `intersect_pyramid` :133 and `intersect_hex` :138 (vmapped over points).
// Its plain-PyTorch version is ops/uelems.py `newton`.  The arithmetic is
// csrc/uelems.cuh `newton`, shared with the wedge sampler of K8
// (csrc/parity.cu); this kernel exists so that all three element types
// are held against the plain version on the card.  No render path
// launches it.
//
// What bounds it on the H100: a point reads P and its element's vertices
// (12 + 12 nv bytes), writes a bool and a float (5), and reads its nv
// scalars (4 nv) only if it is inside; its operations are the Newton's,
// ~200 f32 operations an iteration for the wedge (chip_smoke.py
// NEWTON_OPS), 4-6 iterations a point on average.  The bytes bound it on
// paper; on the card it is issue-bound: the Newton runs unfused
// (-fmad=false, three IEEE divisions an iteration), and a warp runs its
// slowest lane's iterations.  Block size measured (scripts/time_uelems.py
// --variants, PERF.md §6).
#include <cuda_runtime.h>

#include "uelems.cuh"

namespace {

constexpr int kBlock = 128;

template <int NV>
__global__ void __launch_bounds__(kBlock)
uelems_kernel(const float* __restrict__ P, const float* __restrict__ V,
              const float* __restrict__ S, bool* __restrict__ inside,
              float* __restrict__ value, int m) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= m) return;
  const float* row = V + static_cast<size_t>(i) * NV * 3;
  float v[NV][3];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[k][j] = __ldg(row + k * 3 + j);
  const float* p = P + static_cast<size_t>(i) * 3;
  float val;
  inside[i] = uelems::newton<NV>(__ldg(p), __ldg(p + 1), __ldg(p + 2), v,
                                 S + static_cast<size_t>(i) * NV, val);
  value[i] = val;
}

template <int NV>
void launch(const float* P, const float* V, const float* S, bool* inside,
            float* value, int m, cudaStream_t stream) {
  uelems_kernel<NV><<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      P, V, S, inside, value, m);
}

template <int NV>
int occupancy(int* out) {
  cudaFuncAttributes a;
  int err = static_cast<int>(cudaFuncGetAttributes(&a, uelems_kernel<NV>));
  if (err) return err;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = kBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, uelems_kernel<NV>, kBlock, 0));
}

}  // namespace

// Launches the intersector of `nv` vertices (5, 6 or 8) on m points, on
// `stream` (PyTorch's current stream); allocates nothing and does not
// synchronise.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another nv.
extern "C" int uelems_points_launch(const float* P, const float* V,
                                    const float* S, bool* inside,
                                    float* value, int m, int nv,
                                    void* stream) {
  if (m <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 5: launch<5>(P, V, S, inside, value, m, s); break;
    case 6: launch<6>(P, V, S, inside, value, m, s); break;
    case 8: launch<8>(P, V, S, inside, value, m, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel of `nv` vertices: its resident blocks an SM, registers and
// local bytes a thread, and its block size (out[0..3]).
extern "C" int uelems_occupancy(int nv, int* out) {
  switch (nv) {
    case 5: return occupancy<5>(out);
    case 6: return occupancy<6>(out);
    case 8: return occupancy<8>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
