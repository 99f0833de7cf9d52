// K9-n `uelems_points`: the Newton intersectors of unstructured elements
// (pyramid, wedge, hexahedron) on a batch of points, one thread per point.
//
// Replaces the XLA-fused icon_rt_tpu/ops/uelems.py `intersect_wedge` :126,
// `intersect_pyramid` :133 and `intersect_hex` :138 (vmapped over points).
// Its plain-PyTorch version is ops/uelems.py `newton`.  The arithmetic is
// csrc/uelems.cuh, shared with the wedge sampler of K8 (csrc/parity.cu);
// this kernel exists so that all three element types are held against the
// plain version on the card.  No render path launches it.
//
// What bounds it on the H100: arithmetic, up to 10 iterations of ~230 f32
// operations per point with the element in registers; the reads (P, V, S)
// and writes are 4 * (3 + 4 * nv) + 5 bytes per point.
#include <cstdint>
#include <cuda_runtime.h>

#include "uelems.cuh"

namespace {

template <int NV>
__global__ void __launch_bounds__(128)
uelems_kernel(const float* P, const float* V, const float* S,
              uint8_t* inside, float* value, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float v[NV][3], s[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      v[k][j] = __ldg(V + (static_cast<size_t>(i) * NV + k) * 3 + j);
    s[k] = __ldg(S + static_cast<size_t>(i) * NV + k);
  }
  float val;
  int iters;
  const bool in = uelems::newton<NV>(__ldg(P + 3 * static_cast<size_t>(i)),
                                     __ldg(P + 3 * static_cast<size_t>(i) + 1),
                                     __ldg(P + 3 * static_cast<size_t>(i) + 2),
                                     v, s, val, iters);
  inside[i] = in ? 1 : 0;
  value[i] = val;
}

template <int NV>
void launch(const float* P, const float* V, const float* S, uint8_t* inside,
            float* value, int m, cudaStream_t stream) {
  constexpr int kBlock = 128;
  uelems_kernel<NV><<<(m + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      P, V, S, inside, value, m);
}

}  // namespace

// Launches the intersector of `nv` vertices (5, 6 or 8) on m points, on
// `stream` (PyTorch's current stream); allocates nothing and does not
// synchronise.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another nv.
extern "C" int uelems_points_launch(const float* P, const float* V,
                                    const float* S, uint8_t* inside,
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
