// Per-level notch tail of the destripe step, and exact row medians, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   destripe_row_median   <- aind_smartspim_destripe_tpu/ops/pallas_median.py:row_median_masked
//   destripe_row_median_batch
//                         <- aind_smartspim_destripe_tpu/ops/pallas_median.py:row_median_batch
//   destripe_notch        <- aind_smartspim_destripe_tpu/ops/pallas_notch.py:notch_delta
//   destripe_notch_select <- aind_smartspim_destripe_tpu/ops/pallas_notch.py:notch_select_chunked
//
// notch_delta computes, per plane b with threshold t = thr[b]:
//   stripes   = sqrt(ch * ch) > t           (the rounded sqrt-of-square)
//   med       = median of the row of where(stripes, 0, ch)
//   inpainted = where(stripes, med, ch)
//   delta     = where(stripes, 0, inpainted @ op[sel[b]] - ch)
// The TPU kernel selects the median in VMEM and runs the product as bf16x3
// MXU dots. Here it is two launches: destripe_row_median writes the (B, h)
// medians (the TPU kernel's own two-kernel split, med_raw), and
// destripe_notch is a tiled f32 GEMM whose A-tile loader applies the mask
// and the inpainting, and whose epilogue applies the mask and subtracts ch.
// The operator is chosen per plane (a column offset into the (w, 2w)
// [cells | no-cells] bank), so each plane multiplies only its own operator
// and neither the inpainted band nor the product is stored.
//
// Both take an output batch n_out that is a multiple of the band's batch
// n_in: output plane b reads band plane b % n_in, with thr[b] and sel[b] of
// its own (the dual-band form, k = 2: one band, two thresholds and notch
// operators, without a concatenated copy of the band). The median is taken
// per output plane, since its mask depends on thr[b].
//
// notch_select is the product alone, out[b] = x[b] @ op[:, sel[b]*w:(sel[b]+1)*w],
// for the row-sharded route, where the mask, the inpainting and the delta
// run around it as tensor code (the JAX package's halo tier keeps them in
// XLA too). The TPU kernel streams a bf16 hi/lo operator bank through VMEM
// in column chunks, since a halo-width bank does not fit there. Here the
// operator is the same f32 (w, 2w) [cells | no-cells] layout as the notch
// tail's, read tile by tile from device memory, so no chunking is needed.
// It is bound by its operations (2 h w^2 per plane, FP32 FMAs) and runs
// gemm_f32.cuh's pipelined tile, the one dense.cu runs, under the same order
// contract (each output summed in k order by one thread, one fmaf per term
// from 0); the notch tail keeps its own 128 x 64 tile and register count,
// which set its blocks per SM.
//
// The median is exact: a radix select over the bits of the float (4 passes
// of 8 bits, counts in a shared-memory histogram with integer atomics),
// once for odd rows and twice for even rows, whose two middle values are
// averaged as (v1 + v2) * 0.5 in f32, as the plain twin and numpy do.
// The select is templated on the mask, as the TPU kernel's _make_kernel is:
// destripe_row_median_batch runs its unmasked instance, which reads no
// threshold and makes no stripe compare, one block per row of the flattened
// (rows, n) input with the rows on grid.x (grid.y stops at 65535 blocks).
// Keys are the float's bits in IEEE order, so NaN sorts above +inf and -0.0
// below +0.0 (equal values, distinct keys). Both medians are bound by their
// bytes (each value read once, one float written per row); the select reads
// the row once per 8-bit pass (4 or 8 passes), from L2 for rows of this
// size, which a later PR can keep in shared memory instead.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "gemm_f32.cuh"

namespace {

// IEEE order as unsigned order: flip all bits of negatives, the sign bit of
// positives.
__device__ __forceinline__ unsigned int sort_key(float v) {
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ bool stripe(float v, float t) {
  return __fsqrt_rn(__fmul_rn(v, v)) > t;
}

// Key of the k-th smallest (0-based) of the row's w values, with kMasked
// the ones over t read as 0. Every thread of the block calls it and gets the
// result.
template <bool kMasked>
__device__ unsigned int select_kth(const float* __restrict__ row, int w,
                                   float t, unsigned int k,
                                   unsigned int* hist, unsigned int* pick) {
  const int tid = threadIdx.x;
  unsigned int prefix = 0u, pmask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
    for (int i = tid; i < w; i += blockDim.x) {
      float v = row[i];
      if constexpr (kMasked) {
        if (stripe(v, t)) v = 0.0f;
      }
      const unsigned int key = sort_key(v);
      if ((key & pmask) == prefix) {
        atomicAdd(hist + ((key >> shift) & 255u), 1u);
      }
    }
    __syncthreads();
    if (tid < 32) {  // warp 0 finds the digit: lane l scans bins 8l..8l+7
      unsigned int local[8], sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        local[j] = hist[tid * 8 + j];
        sum += local[j];
      }
      unsigned int inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int n = __shfl_up_sync(0xFFFFFFFFu, inc, o);
        if (tid >= o) inc += n;
      }
      unsigned int c = inc - sum;
      if (c <= k && k < inc) {
        for (int j = 0; j < 8; ++j) {
          if (k < c + local[j]) {
            pick[0] = tid * 8 + j;
            pick[1] = k - c;
            break;
          }
          c += local[j];
        }
      }
    }
    __syncthreads();
    prefix |= pick[0] << shift;
    pmask |= 255u << shift;
    k = pick[1];
  }
  return prefix;
}

// med[b, r] = median of row r of band plane b % n_in, masked against
// thr[b].
__global__ void row_median_kernel(const float* __restrict__ x,
                                  const float* __restrict__ thr,
                                  float* __restrict__ med, int n_in, int h,
                                  int w) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned int pick[2];
  const int b = blockIdx.y, r = blockIdx.x;
  const float* row = x + ((size_t)(b % n_in) * h + r) * w;
  const float t = thr[b];
  const unsigned int k1 = (w - 1) / 2, k2 = w / 2;
  const float v1 = key_float(select_kth<true>(row, w, t, k1, hist, pick));
  float m = v1;
  if (k2 != k1) {
    const float v2 =
        key_float(select_kth<true>(row, w, t, k2, hist, pick));
    m = __fmul_rn(__fadd_rn(v1, v2), 0.5f);
  }
  if (threadIdx.x == 0) med[(size_t)b * h + r] = m;
}

// med[r] = median of row r of the (rows, n) input, unmasked.
__global__ void row_median_batch_kernel(const float* __restrict__ x,
                                        float* __restrict__ med, int n) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned int pick[2];
  const size_t r = blockIdx.x;
  const float* row = x + r * n;
  const unsigned int k1 = (n - 1) / 2, k2 = n / 2;
  const float v1 =
      key_float(select_kth<false>(row, n, 0.0f, k1, hist, pick));
  float m = v1;
  if (k2 != k1) {
    const float v2 =
        key_float(select_kth<false>(row, n, 0.0f, k2, hist, pick));
    m = __fmul_rn(__fadd_rn(v1, v2), 0.5f);
  }
  if (threadIdx.x == 0) med[r] = m;
}

// Tile shape of the notch GEMM: a block of 256 threads computes a 128 x 64
// output tile, each thread 8 rows x 4 columns, over K-steps of 16.
constexpr int BM = 128, BN = 64, BK = 16, TM = 8, TN = 4;
constexpr int kNotchThreads = (BM / TM) * (BN / TN);

// out[b, r, c] = stripes ? 0 : sum_k inpainted[b, r, k] * op[k, sel*w + c]
//                                - x[b % n_in, r, c]; op is (w, 2w)
// row-major. Three blocks per SM (at most 80 registers per thread). The
// wrapped form (kWrapped, n_out > n_in) keeps a second plane base live
// through the K loop and spills a few bytes at that cap; the unwrapped form
// shares one base between x and out and spills nothing.
template <bool kWrapped>
__global__ void __launch_bounds__(kNotchThreads, 3)
    notch_kernel(const float* __restrict__ x, const float* __restrict__ med,
                 const float* __restrict__ thr, const int* __restrict__ sel,
                 const float* __restrict__ op, float* __restrict__ out,
                 int n_in, int h, int w) {
  __shared__ __align__(16) float As[BK][BM + 4];  // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const float t = thr[b];
  const size_t ldo = 2 * (size_t)w;
  const float* bop = op + (size_t)sel[b] * w;
  const float* xb = x + (size_t)(kWrapped ? b % n_in : b) * h * w;
  const float* mb = med + (size_t)b * h;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < w; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BM * BK / kNotchThreads; ++e) {
      const int idx = tid + e * kNotchThreads;
      const int m = idx / BK, kk = idx % BK;
      const int r = row0 + m, k = k0 + kk;
      float v = 0.0f;
      if (r < h && k < w) {
        v = xb[(size_t)r * w + k];
        if (stripe(v, t)) v = mb[r];
      }
      As[kk][m] = v;
    }
#pragma unroll
    for (int e = 0; e < BN * BK / kNotchThreads; ++e) {
      const int idx = tid + e * kNotchThreads;
      const int kk = idx / BN, n = idx % BN;
      const int k = k0 + kk, c = col0 + n;
      Bs[kk][n] = (k < w && c < w) ? bop[(size_t)k * ldo + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= h) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= w) continue;
      const size_t o = (size_t)r * w + c;
      const float xv = xb[o];
      out[(size_t)b * h * w + o] =
          stripe(xv, t) ? 0.0f : __fsub_rn(acc[i][j], xv);
    }
  }
}

// out[b, r, c] = sum_k x[b, r, k] * op[k, sel[b]*w + c]; op is (w, 2w)
// row-major. gemm_f32.cuh's 128 x 128 tile (K = w runs long on the route,
// where the larger tile wins), V floats per load along the rows of x and
// of the bank.
constexpr int kSelectTile = 128;

template <int V>
__global__ void __launch_bounds__(
    gemm_f32::Tile<kSelectTile, kSelectTile>::kThreads,
    gemm_f32::Tile<kSelectTile, kSelectTile>::kMinBlocks)
    notch_select_kernel(const float* __restrict__ x,
                        const int* __restrict__ sel,
                        const float* __restrict__ op, float* __restrict__ out,
                        int h, int w) {
  const size_t plane = (size_t)blockIdx.z * h * w;
  gemm_f32::tile_product<kSelectTile, kSelectTile, V, true, V>(
      x + plane, w, 1, op + (size_t)sel[blockIdx.z] * w, 2 * (long long)w, 1,
      out + plane, w, h, w, w, blockIdx.y * kSelectTile,
      blockIdx.x * kSelectTile);
}

}  // namespace

extern "C" {

// x (n_in, h, w) f32, thr (n_out,) f32 -> med (n_out, h) f32, the median of
// each row of plane b % n_in with the values over thr[b] read as 0; n_out a
// multiple of n_in. threads a multiple of 32.
int destripe_row_median(const float* x, const float* thr, float* med,
                        int n_out, int n_in, int h, int w, int threads,
                        void* stream) {
  row_median_kernel<<<dim3(h, n_out), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, thr, med, n_in,
                                                           h, w);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, n) f32 -> med (rows,) f32, the median of each row; rows >= 1,
// n >= 1, threads a multiple of 32.
int destripe_row_median_batch(const float* x, float* med, int rows, int n,
                              int threads, void* stream) {
  row_median_batch_kernel<<<rows, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, med, n);
  return static_cast<int>(cudaGetLastError());
}

// x (n_in, h, w) f32, med (n_out, h) f32, thr (n_out,) f32, sel (n_out,)
// int32 in {0, 1}, op (w, 2w) f32 -> out (n_out, h, w) f32.
int destripe_notch(const float* x, const float* med, const float* thr,
                   const int* sel, const float* op, float* out, int n_out,
                   int n_in, int h, int w, void* stream) {
  const dim3 grid((w + BN - 1) / BN, (h + BM - 1) / BM, n_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out == n_in) {
    notch_kernel<false><<<grid, kNotchThreads, 0, s>>>(x, med, thr, sel, op,
                                                       out, n_in, h, w);
  } else {
    notch_kernel<true><<<grid, kNotchThreads, 0, s>>>(x, med, thr, sel, op,
                                                      out, n_in, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (B, h, w) f32, sel (B,) int32 in {0, 1}, op (w, 2w) f32 -> out
// (B, h, w) f32; v 1 or 2, the floats per load along x's rows and the
// bank's (2: w even and both bases 8-byte aligned); B and ceil(h / 128) at
// most 65535.
int destripe_notch_select(const float* x, const int* sel, const float* op,
                          float* out, int B, int h, int w, int v,
                          void* stream) {
  const dim3 grid((w + kSelectTile - 1) / kSelectTile,
                  (h + kSelectTile - 1) / kSelectTile, B);
  const int threads = gemm_f32::Tile<kSelectTile, kSelectTile>::kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v == 2) {
    notch_select_kernel<2><<<grid, threads, 0, s>>>(x, sel, op, out, h, w);
  } else if (v == 1) {
    notch_select_kernel<1><<<grid, threads, 0, s>>>(x, sel, op, out, h, w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
