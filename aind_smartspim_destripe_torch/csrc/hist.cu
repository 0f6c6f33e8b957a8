// Per-plane fixed-bin histograms for the Otsu threshold, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   destripe_hist <- aind_smartspim_destripe_tpu/ops/pallas_hist.py:histogram256_batch
//
// The TPU kernel counts through a 16x16 one-hot outer product on the MXU.
// Here counting is what the card does natively: integer atomic increments
// into shared memory, then one atomic add per non-empty bin and block into
// the plane's global counts. Integer sums do not depend on their order, so
// counts are exact and repeat bit for bit.
//
// What bounds it: the bytes for the squared f32 bands (each value read
// once); for the 2-byte raw planes, the shared atomics and the per-value
// instructions (the IEEE division above all), which hold it near half its
// byte rate (PERF.md). The design:
// - The counts live in 32 lane-striped copies: bin k of copy c at word
//   k * 32 + c, a thread using copy lane % 32, so the lanes of a warp never
//   increment one word and never share a bank, however the values crowd
//   into the low bins of a squared band (the first port's per-warp copies
//   kept warps apart, not lanes). Warps of a block share the copies. At the
//   end each bin's copies are summed with a rotated index (no bank
//   conflict) and added to the plane's counts.
// - The grid is sized on the host from the planes, their values and the
//   card's SM count (so a single plane of a row shard fills the card),
//   blocks of 256 threads each taking a grid-stride share of the plane.
// - The plane is read with 16-byte loads (4 floats or 8 uint16 values),
//   four in flight per thread, from its first 16-byte boundary; the
//   elements before it and after the last whole vector are counted one by
//   one, so any base address and any plane length is read exactly once.
// Counting in per-lane byte counters with plain loads and stores instead
// of atomics was measured slower for every form: each count then waits on
// its shared load (PERF.md).
//
// The bin index is the JAX package's and the plain twin's, operation for
// operation in IEEE float32: floor((x - lo) / span * nbins), clipped to
// [0, nbins - 1], with x squared first when `square` is set; the division
// stays an IEEE division. NaN inputs count nowhere (the TPU kernel's
// self-masking). The caller zeroes `counts`.
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
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the host's _THREADS
constexpr int kCopies = 32;  // lane-striped copies of the counts
constexpr int kMaxBins = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

__device__ __forceinline__ unsigned int word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Element e of a 16-byte vector of T, as float.
template <typename T>
__device__ __forceinline__ float element(const uint4& q, int e);

template <>
__device__ __forceinline__ float element<float>(const uint4& q, int e) {
  return __uint_as_float(word(q, e));
}

template <>
__device__ __forceinline__ float element<unsigned short>(const uint4& q,
                                                         int e) {
  return static_cast<float>((word(q, e >> 1) >> (16 * (e & 1))) & 0xFFFFu);
}

// counts[b, :] += the histogram of the first n_valid values of plane b (x +
// b * n); grid (blocks per plane, B).
template <typename T, bool kSquare>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const T* __restrict__ x, const float* __restrict__ lo,
                const float* __restrict__ span,
                unsigned int* __restrict__ counts, long long n,
                long long n_valid, int nbins) {
  __shared__ __align__(16) unsigned int copies[kMaxBins * kCopies];
  const int tid = threadIdx.x;
  uint4* c4 = reinterpret_cast<uint4*>(copies);
  for (int i = tid; i < nbins * kCopies / 4; i += kThreads) {
    c4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int b = blockIdx.y;
  const float l = lo[b], s = span[b], fb = static_cast<float>(nbins);
  unsigned int* mine = copies + (tid & (kCopies - 1));
  auto count = [&](float v) {
    if (kSquare) v = __fmul_rn(v, v);
    const float t = __fmul_rn(__fdiv_rn(__fsub_rn(v, l), s), fb);
    if (t != t) return;  // NaN: counted nowhere
    // floor, then the clip: the same bin as floorf and fminf / fmaxf
    const int bin = min(max(__float2int_rd(t), 0), nbins - 1);
    atomicAdd(mine + bin * kCopies, 1u);
  };

  const T* plane = x + (size_t)b * n;
  constexpr int V = 16 / sizeof(T);
  const long long head = min(
      (long long)(((16u - (reinterpret_cast<uintptr_t>(plane) & 15u)) & 15u) /
                  sizeof(T)),
      n_valid);
  const long long nvec = (n_valid - head) / V;
  const long long tail = head + nvec * V;  // the first value after them
  const long long g = (long long)blockIdx.x * kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  if (g < head) count(static_cast<float>(plane[g]));
  if (g < n_valid - tail) count(static_cast<float>(plane[tail + g]));
  const uint4* body = reinterpret_cast<const uint4*>(plane + head);
  long long i = g;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = __ldg(body + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < V; ++e) count(element<T>(q[u], e));
    }
  }
  for (; i < nvec; i += stride) {
    const uint4 q = __ldg(body + i);
#pragma unroll
    for (int e = 0; e < V; ++e) count(element<T>(q, e));
  }
  __syncthreads();

  for (int k = tid; k < nbins; k += kThreads) {
    unsigned int c = 0u;
    for (int j = 0; j < kCopies; ++j) {
      c += copies[k * kCopies + ((j + k) & (kCopies - 1))];
    }
    if (c) atomicAdd(counts + (size_t)b * nbins + k, c);
  }
}

template <typename T>
void launch_hist(dim3 grid, cudaStream_t s, const void* x, const float* lo,
                 const float* span, unsigned int* counts, long long n,
                 long long n_valid, int nbins, bool square) {
  const T* xt = static_cast<const T*>(x);
  if (square) {
    hist_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, lo, span, counts, n,
                                                   n_valid, nbins);
  } else {
    hist_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, lo, span, counts, n,
                                                    n_valid, nbins);
  }
}

}  // namespace

extern "C" {

// x (B, n) uint16 (x_u16=1) or f32, its base aligned to its element; lo,
// span (B,) f32 (span > 0); counts (B, nbins) uint32, zeroed. Each plane
// counts its first rows_valid rows of row_len values (rows_valid * row_len
// <= n). 1 <= nbins <= kMaxBins; 1 <= B <= 65535; blocks per plane >= 1.
int destripe_hist(const void* x, int x_u16, const float* lo, const float* span,
                  unsigned int* counts, int B, long long n, int rows_valid,
                  long long row_len, int nbins, int square, int blocks,
                  void* stream) {
  const long long n_valid = (long long)rows_valid * row_len;
  if (nbins < 1 || nbins > kMaxBins || B < 1 || B > 65535 || blocks < 1 ||
      n_valid > n || n_valid < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_u16) {
    launch_hist<unsigned short>(grid, s, x, lo, span, counts, n, n_valid,
                                nbins, square != 0);
  } else {
    launch_hist<float>(grid, s, x, lo, span, counts, n, n_valid, nbins,
                       square != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
