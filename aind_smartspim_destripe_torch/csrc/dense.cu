// Matrix products of the destripe step's dense wavelet levels, for NVIDIA
// Hopper (sm_90a).
//
// Stands in for the einsums of the dense levels in
// aind_smartspim_destripe_tpu/ops/filter.py (analysis 892-896, synthesis
// 1011-1019), which XLA runs; there is no Pallas kernel for them.
//
// c[z] = a[z] @ b[z] in float32, every entry's terms added in k order, one
// FMA per term, from 0. The order is the tile's, not the shape's: cuBLAS
// chooses its kernel by the problem's shape, and with it the order of the
// sums, so a plane's dense-level coefficients (and the Otsu and stripe-mask
// decisions taken on them) depended on how many planes its batch held. With
// one fixed order a plane gives the same bits in any batch. The order is
// the one cuBLAS's own kernels take at the row counts of a 64-plane batch
// (scripts/batch_stages.py compares them), so those batches keep their bits.
//
// The tile is gemm_f32.cuh's at 64 x 64 (64 threads: at the dense levels'
// short K, four times as many blocks as the 128 x 128 tile, which
// notch_select runs at its long K); its note has the design and the order
// contract; bound by its FP32 operations. Operands are read through element
// strides, so a transposed or sliced operator and a batch stride of 0 (one
// operator for every plane) need no copy. The wrapper (ops/cuda_dense.py)
// folds the batch into the rows where the planes are stacked evenly and the
// operator is shared (planes @ operator^T: M = B * m, as cuBLAS does), keeps
// a z grid otherwise (operator @ planes), and picks the copy widths.
//
// The entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "gemm_f32.cuh"

namespace {

constexpr int kEdge = 64;  // the output tile's edge
using Tile = gemm_f32::Tile<kEdge, kEdge>;

// c[z, r, j] = sum_k a[z*sab + r*sam + k*sak] * b[z*sbb + k*sbk + j*sbn];
// c is (batch, m, n) row-major.
template <int VA, bool kBUnitN, int VB>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    dense_matmul_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ c,
                        int m, int n, int K, long long sab, long long sam,
                        long long sak, long long sbb, long long sbk,
                        long long sbn) {
  const long long z = blockIdx.z;
  gemm_f32::tile_product<kEdge, kEdge, VA, kBUnitN, VB>(
      a + z * sab, sam, sak, b + z * sbb, sbk, sbn, c + z * m * n, n, m, n,
      K, blockIdx.y * kEdge, blockIdx.x * kEdge);
}

template <int VA, bool kBUnitN, int VB>
void launch(const float* a, const float* b, float* c, int batch, int m, int n,
            int K, long long sab, long long sam, long long sak, long long sbb,
            long long sbk, long long sbn, cudaStream_t stream) {
  const dim3 grid((n + kEdge - 1) / kEdge, (m + kEdge - 1) / kEdge, batch);
  dense_matmul_kernel<VA, kBUnitN, VB><<<grid, Tile::kThreads, 0, stream>>>(
      a, b, c, m, n, K, sab, sam, sak, sbb, sbk, sbn);
}

template <int VA>
void launch_b(const float* a, const float* b, float* c, int batch, int m,
              int n, int K, long long sab, long long sam, long long sak,
              long long sbb, long long sbk, long long sbn, int vb,
              cudaStream_t stream) {
  if (sbn != 1) {
    launch<VA, false, 1>(a, b, c, batch, m, n, K, sab, sam, sak, sbb, sbk,
                         sbn, stream);
  } else if (vb == 2) {
    launch<VA, true, 2>(a, b, c, batch, m, n, K, sab, sam, sak, sbb, sbk,
                        sbn, stream);
  } else {
    launch<VA, true, 1>(a, b, c, batch, m, n, K, sab, sam, sak, sbb, sbk,
                        sbn, stream);
  }
}

}  // namespace

extern "C" {

// a, b f32 through element strides (a batch stride of 0 repeats an
// operand for every z) -> c (batch, m, n) f32; va, vb 1 or 2, the floats
// per load along a's k and along b's columns (2: unit stride there, 8-byte
// aligned base and even other strides); batch and ceil(m / 64) at most
// 65535.
int destripe_dense_matmul(const float* a, const float* b, float* c, int batch,
                          int m, int n, int K, long long sab, long long sam,
                          long long sak, long long sbb, long long sbk,
                          long long sbn, int va, int vb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((va != 1 && va != 2) || (vb != 1 && vb != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (va == 2 ? launch_b<2> : launch_b<1>)(a, b, c, batch, m, n, K, sab, sam,
                                        sak, sbb, sbk, sbn, vb, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
