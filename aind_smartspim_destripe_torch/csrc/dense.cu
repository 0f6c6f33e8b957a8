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
// Operands are read through element strides, so a transposed or sliced
// operator and a batch stride of 0 (one operator for every plane) need no
// copy. The tile is the notch GEMM's (csrc/notch.cu): a block of 256
// threads computes a 128 x 64 output tile, each thread 8 rows x 4 columns,
// over K-steps of 16 staged in shared memory; each operand's tile is loaded
// along its unit-stride axis when it has one, so a warp's loads coalesce.
//
// The entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);

// c[z, r, j] = sum_k a[z*sab + r*sam + k*sak] * b[z*sbb + k*sbk + j*sbn];
// c is (batch, m, n) row-major.
__global__ void __launch_bounds__(kThreads, 3)
    dense_matmul_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ c,
                        int m, int n, int K, long long sab, long long sam,
                        long long sak, long long sbb, long long sbk,
                        long long sbn) {
  __shared__ __align__(16) float As[BK][BM + 4];  // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];
  const int z = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const float* az = a + z * sab;
  const float* bz = b + z * sbb;
  const bool a_rows = sak == 1;  // load A along k, else along its rows
  const bool b_cols = sbn == 1;  // load B along its columns, else along k

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BM * BK / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int mm = a_rows ? idx / BK : idx % BM;
      const int kk = a_rows ? idx % BK : idx / BM;
      const int r = row0 + mm, k = k0 + kk;
      As[kk][mm] = (r < m && k < K) ? az[r * sam + k * sak] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < BN * BK / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int kk = b_cols ? idx / BN : idx % BK;
      const int nn = b_cols ? idx % BN : idx / BK;
      const int k = k0 + kk, j = col0 + nn;
      Bs[kk][nn] = (k < K && j < n) ? bz[k * sbk + j * sbn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* cz = c + (size_t)z * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col < n) cz[(size_t)r * n + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// a, b f32 through element strides (a batch stride of 0 repeats an
// operand for every z) -> c (batch, m, n) f32; batch and ceil(m / 128) at
// most 65535.
int destripe_dense_matmul(const float* a, const float* b, float* c, int batch,
                          int m, int n, int K, long long sab, long long sam,
                          long long sak, long long sbb, long long sbk,
                          long long sbn, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  dense_matmul_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, n, K, sab, sam, sak, sbb, sbk, sbn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
