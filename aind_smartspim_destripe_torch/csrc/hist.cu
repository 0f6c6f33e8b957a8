// Per-plane fixed-bin histograms for the Otsu threshold, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   destripe_hist <- aind_smartspim_destripe_tpu/ops/pallas_hist.py:histogram256_batch
//
// The TPU kernel counts through a 16x16 one-hot outer product on the MXU.
// Here counting is what the card does natively: integer atomic increments,
// first into per-warp copies of the histogram in shared memory (so the warps
// of a block do not contend on the few crowded low bins of a squared band),
// then one atomic add per non-empty bin into the plane's global counts.
// Integer sums do not depend on their order, so counts are exact and repeat
// bit for bit.
//
// The bin index is the JAX package's and the plain twin's, operation for
// operation in IEEE float32: floor((x - lo) / span * nbins), clipped to
// [0, nbins - 1], with x squared first when `square` is set. NaN inputs
// count nowhere (the TPU kernel's self-masking). The caller zeroes `counts`.
//
// A row bound (the TPU kernel's dynamic `row_bound`) limits each plane to its
// first `rows_valid` rows of `row_len` values: the row-sharded route passes
// a shard's own rows and excludes the rows that pad it to the mesh multiple.
// The plane stride stays `n`; only the first n_valid = rows_valid * row_len
// values of each plane are read.
//
// The entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T>
__device__ __forceinline__ float hist_load(const T* p) {
  return static_cast<float>(*p);
}

template <typename T, bool kSquare>
__global__ void hist_kernel(const T* __restrict__ x,
                            const float* __restrict__ lo,
                            const float* __restrict__ span,
                            unsigned int* __restrict__ counts, long long n,
                            long long n_valid, int nbins) {
  extern __shared__ unsigned int hist_smem[];  // (warps, nbins)
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warps = blockDim.x / 32;
  for (int i = tid; i < warps * nbins; i += blockDim.x) hist_smem[i] = 0u;
  __syncthreads();

  unsigned int* mine = hist_smem + (tid / 32) * nbins;
  const float l = lo[b], s = span[b], fb = static_cast<float>(nbins);
  const T* plane = x + (size_t)b * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + tid; i < n_valid;
       i += stride) {
    float v = hist_load(plane + i);
    if (kSquare) v = __fmul_rn(v, v);
    float t = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(v, l), s), fb));
    if (t != t) continue;  // NaN: counted nowhere
    t = fminf(fmaxf(t, 0.0f), fb - 1.0f);
    atomicAdd(mine + static_cast<int>(t), 1u);
  }
  __syncthreads();

  for (int k = tid; k < nbins; k += blockDim.x) {
    unsigned int c = 0u;
    for (int w = 0; w < warps; ++w) c += hist_smem[w * nbins + k];
    if (c) atomicAdd(counts + (size_t)b * nbins + k, c);
  }
}

template <typename T>
void launch_hist(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                 const void* x, const float* lo, const float* span,
                 unsigned int* counts, long long n, long long n_valid,
                 int nbins, bool square) {
  const T* xt = static_cast<const T*>(x);
  if (square) {
    hist_kernel<T, true><<<grid, block, smem, s>>>(xt, lo, span, counts, n,
                                                   n_valid, nbins);
  } else {
    hist_kernel<T, false><<<grid, block, smem, s>>>(xt, lo, span, counts, n,
                                                    n_valid, nbins);
  }
}

}  // namespace

extern "C" {

// x (B, n) uint16 (x_u16=1) or f32; lo, span (B,) f32 (span > 0); counts
// (B, nbins) uint32, zeroed. Each plane counts its first rows_valid rows of
// row_len values (rows_valid * row_len <= n). threads a multiple of 32;
// blocks per plane >= 1.
int destripe_hist(const void* x, int x_u16, const float* lo, const float* span,
                  unsigned int* counts, int B, long long n, int rows_valid,
                  long long row_len, int nbins, int square, int threads,
                  int blocks, void* stream) {
  const long long n_valid = (long long)rows_valid * row_len;
  const dim3 grid(blocks, B);
  const size_t smem = (size_t)(threads / 32) * nbins * sizeof(unsigned int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_u16) {
    launch_hist<unsigned short>(grid, dim3(threads), smem, s, x, lo, span,
                                counts, n, n_valid, nbins, square != 0);
  } else {
    launch_hist<float>(grid, dim3(threads), smem, s, x, lo, span, counts, n,
                       n_valid, nbins, square != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
