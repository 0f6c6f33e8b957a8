// Per-level notch tail of the destripe step, and exact row medians, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   destripe_row_median   <- aind_smartspim_destripe_tpu/ops/pallas_median.py:row_median_masked
//   destripe_row_median_batch
//                         <- aind_smartspim_destripe_tpu/ops/pallas_median.py:row_median_batch
//   destripe_notch        <- aind_smartspim_destripe_tpu/ops/pallas_notch.py:notch_delta
//   destripe_notch_select <- aind_smartspim_destripe_tpu/ops/pallas_notch.py:notch_select_chunked
// and adds destripe_notch_project / destripe_notch_synth, the notch tail at
// its exact rank, and destripe_notch_fft, the notch tail by chirp-z
// transforms (below).
//
// notch_delta computes, per plane b with threshold t = thr[b]:
//   stripes   = sqrt(ch * ch) > t           (the rounded sqrt-of-square)
//   med       = median of the row of where(stripes, 0, ch)
//   inpainted = where(stripes, med, ch)
//   delta     = where(stripes, 0, inpainted @ op[sel[b]] - ch)
// The TPU kernel selects the median in VMEM and runs the product as bf16x3
// MXU dots. Here it is two launches: destripe_row_median writes the (B, h)
// medians (the TPU kernel's own two-kernel split, med_raw), and
// destripe_notch runs gemm_f32.cuh's pipelined f32 tile with its two hooks:
// the A-element transform applies the mask and the inpainting as the band
// is loaded (each thread holds the medians of its rows in registers), the
// epilogue applies the mask and subtracts ch. The operator is chosen per
// plane (a column offset into the (w, 2w) [cells | no-cells] bank), so each
// plane multiplies only its own operator and neither the inpainted band nor
// the product is stored. It is bound by its operations (2 h w^2 per output
// plane, FP32 FMAs) and runs a 64 x 128 tile (measured faster than
// 128 x 128 at the plane path's levels 0 and 1); the order contract (each
// output summed by one thread, in k order, one fmaf per term from 0) keeps
// the bits of the 128 x 64 tile it replaces. The stripe test is one compare of
// the square against a per-plane cut (stripe_cut), the same decision as the
// rounded square root's.
//
// destripe_notch_project and destripe_notch_synth (no TPU kernel: the
// JAX package runs every level's notch dense) compute the same delta from
// the factors of op - I (ops/fft_notch.py notch_factors: the packed
// analysis rows p of the r frequencies whose float64 gain is not 1.0, and
// their synthesis rows ds scaled by g - 1). Where a value is not a stripe
// the inpainted band equals ch, so inpainted @ op - ch there is
// inpainted @ (op - I) = (inpainted @ p) @ ds: 4 h w r operations a plane
// in place of 2 h w^2, the terms whose gain is exactly 1.0 left out. The
// projection runs the tile with the same A-element transform (K = w, N =
// r, blocks past the plane's own rank exit), the synthesis with a masked
// store (K = r); each is bound by its operations, and each output is
// summed by one thread in k order, one fmaf per term from 0. The host
// takes this route where 2 r <= w / 2 (the fused plane's levels: 2 r / w
// 0.12-0.18); at the tile's (1.11-1.12), destripe_notch_fft where the
// width passes its crossover against notch_delta, notch_delta below it.
//
// The masked median and the notch tails take an output batch n_out that is
// a multiple of the band's batch n_in: output plane b reads band plane
// b % n_in, with thr[b] and sel[b] of its own (the dual-band form, k = 2:
// one band, two thresholds and notch operators, without a concatenated
// copy of the band). The median is taken per output plane, since its mask
// depends on thr[b].
//
// notch_select is the product alone, out[b] = x[b] @ op[:, sel[b]*w:(sel[b]+1)*w],
// for the row-sharded route, where the mask, the inpainting and the delta
// run around it as tensor code (the JAX package's halo tier keeps them in
// XLA too). The TPU kernel streams a bf16 hi/lo operator bank through VMEM
// in column chunks, since a halo-width bank does not fit there. Here the
// operator is the same f32 (w, 2w) [cells | no-cells] layout as the notch
// tail's, read tile by tile from device memory, so no chunking is needed.
// It is bound by its operations (2 h w^2 per plane, FP32 FMAs) and runs
// gemm_f32.cuh's pipelined tile, the one dense.cu and the notch tail run,
// under the same order contract (each output summed in k order by one
// thread, one fmaf per term from 0).
//
// The median is exact. Keys are the float's bits in IEEE order, so NaN
// sorts above +inf and -0.0 below +0.0 (equal values, distinct keys); even
// rows average their two middle values as (v1 + v2) * 0.5 in f32, as the
// plain twin and numpy do. Both medians are bound by their bytes (each
// value read once, one float written per row) in principle; in practice by
// the select's instructions and shared-memory atomics after the loads.
//
// The unmasked median (destripe_row_median_batch): a row of up to
// kShortMax values (BaSiC's stack of tiles) takes one thread, which holds
// its keys in registers and ranks each by counting the keys below it: many
// rows per block, no shared memory, no barrier, read in place at any
// strides. A longer row takes a block (64 threads up to 2048 values, where
// fewer threads per row and more rows per SM measured faster, 256 above:
// the host picks), which stages its keys in shared memory once (up to
// kStageCap; wider rows read device memory at every pass) and runs a radix
// select over them (4 passes of 8 bits, counts in a shared-memory histogram
// with integer atomics) for the lower middle value; an even row's upper
// middle value is found in one more pass, as the TPU kernel finds it. The
// rows are on grid.x (grid.y stops at 65535 blocks).
//
// The masked median (destripe_row_median) of a row of up to kWarpMax
// values (every level of the plane step) takes one warp per output row,
// the row's keys in registers (at most 32 per lane), the mask applied as a
// compare of the square against the plane's stripe_cut. A block per row
// spent its time in barriers and in the first radix pass, whose bins the
// keys crowd (one sign and a few exponents); the warp instead makes one
// pass of counts and extremes: a rank that falls among the +0.0 keys (the
// masked values, which sit at the middle of a row's order) is +0.0 itself,
// and settles the row; any other rank is selected within its side's key
// range [min, max], whose 8-bit bins split the side's binades finely, so
// the atomics spread and one pass usually leaves at most 32 candidates,
// ranked directly from a gather in shared memory. __syncwarp only: no
// block barrier. Longer rows (the row-sharded route's shards) keep the
// block select of the unmasked median, masked as the keys are read.
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

// The unmasked median's short rows (n <= kShortMax) take a thread each,
// their keys in registers; the masked median's rows of up to kWarpMax
// values a warp each (at most 32 keys per lane, in registers), kWarpRows
// warps per block; longer rows a block each, their keys staged in shared
// memory up to kStageCap (44 KiB of the 48 KiB a block gets without opting
// in), read from device memory (L2) at every pass above it.
constexpr int kShortMax = 32;
constexpr int kWarpMax = 1024;
constexpr int kWarpRows = 4;
constexpr int kStageCap = 11264;
constexpr unsigned int kAll = 0xFFFFFFFFu;

// The stripe test of a plane as one compare of the square: the largest
// float y with __fsqrt_rn(y) <= t, so that (__fsqrt_rn(v * v) > t) ==
// (__fmul_rn(v, v) > stripe_cut(t)) for every v (the rounded square root
// is monotone; a NaN square compares false both ways). A negative t cuts
// at -inf (every square but NaN is a stripe), a NaN or +inf t at +inf.
__device__ __forceinline__ float stripe_cut(float t) {
  if (!(t >= 0.0f)) return t < 0.0f ? -INFINITY : INFINITY;
  if (isinf(t)) return INFINITY;
  float y = __fmul_rn(t, t);
  while (__fsqrt_rn(y) > t) y = nextafterf(y, -INFINITY);
  for (float up = nextafterf(y, INFINITY); __fsqrt_rn(up) <= t;
       up = nextafterf(y, INFINITY)) {
    y = up;
  }
  return y;
}

// The key of v with the stripe mask of cut applied: a stripe reads as +0.0.
__device__ __forceinline__ unsigned int masked_key(float v, float cut) {
  return __fmul_rn(v, v) > cut ? 0x80000000u : sort_key(v);
}

// Key of the k-th smallest (0-based) of the n keys key_of(0..n-1). Every
// thread of the block calls it and gets the result. Each 8-bit pass counts
// the keys under the prefix found so far into a 256-bin shared histogram
// with integer atomics.
template <class Keys>
__device__ unsigned int select_kth(const Keys& key_of, int n, unsigned int k,
                                   unsigned int* hist, unsigned int* pick) {
  const int tid = threadIdx.x;
  unsigned int prefix = 0u, pmask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0u;
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) {
      const unsigned int key = key_of(i);
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
        const unsigned int up = __shfl_up_sync(0xFFFFFFFFu, inc, o);
        if (tid >= o) inc += up;
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

// The median of the n keys key_of(0..n-1), valid in thread 0: the
// (n - 1) / 2-th key by select_kth, averaged for even n with the n / 2-th,
// found in one more pass, as the TPU kernel does: the same key where more
// than n / 2 keys are at most it, else the least key above it.
template <class Keys>
__device__ float median_of(const Keys& key_of, int n, unsigned int* hist,
                           unsigned int* pick) {
  const unsigned int k1 = (n - 1) / 2, k2 = n / 2;
  const unsigned int v1 = select_kth(key_of, n, k1, hist, pick);
  const float m1 = key_float(v1);
  if (k2 == k1) return m1;
  unsigned int le = 0u, above = 0xFFFFFFFFu;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned int key = key_of(i);
    le += key <= v1 ? 1u : 0u;
    if (key > v1) above = min(above, key);
  }
  le = __reduce_add_sync(0xFFFFFFFFu, le);
  above = __reduce_min_sync(0xFFFFFFFFu, above);
  // hist is free again: warp w's pair in hist[2w], hist[2w + 1]
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    hist[2 * warp] = le;
    hist[2 * warp + 1] = above;
  }
  __syncthreads();
  if (threadIdx.x != 0) return m1;
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
    le += hist[2 * w];
    above = min(above, hist[2 * w + 1]);
  }
  const unsigned int v2 = le > k2 ? v1 : above;
  return __fmul_rn(__fadd_rn(m1, key_float(v2)), 0.5f);
}

// Keys of a row of floats, read from device memory at every call, with
// kMasked the values whose square is over cut (stripe_cut) read as 0.
template <bool kMasked>
struct RowKeys {
  const float* __restrict__ row;
  long long step;
  float cut;
  __device__ __forceinline__ unsigned int operator()(int i) const {
    const float v = row[i * step];
    if constexpr (kMasked) return masked_key(v, cut);
    return sort_key(v);
  }
};

struct StagedKeys {
  const unsigned int* keys;
  __device__ __forceinline__ unsigned int operator()(int i) const {
    return keys[i];
  }
};

// The median of one row in thread 0: with kStaged the row's keys are staged
// in dynamic shared memory once, so that the passes read them there.
template <bool kStaged, bool kMasked>
__device__ float row_median_of(RowKeys<kMasked> src, int n) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned int pick[2];
  if constexpr (kStaged) {
    extern __shared__ unsigned int staged[];
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) staged[i] = src(i);
    __syncthreads();
    return median_of(StagedKeys{staged}, n, hist, pick);
  } else {
    return median_of(src, n, hist, pick);
  }
}

// The masked median's block route (rows over kWarpMax values: the
// row-sharded route's shards): med[b, r] = median of row r of band plane
// b % n_in, masked against thr[b], one block per output row.
template <bool kStaged>
__global__ void row_median_kernel(const float* __restrict__ x,
                                  const float* __restrict__ thr,
                                  float* __restrict__ med, int n_in, int h,
                                  int w) {
  const int b = blockIdx.y, r = blockIdx.x;
  const float* row = x + ((size_t)(b % n_in) * h + r) * w;
  const float m = row_median_of<kStaged>(
      RowKeys<true>{row, 1, stripe_cut(thr[b])}, w);
  if (threadIdx.x == 0) med[(size_t)b * h + r] = m;
}

// med[r] = median of row r of the (rows, n) input (row r at x + r * sr, its
// elements sr apart), unmasked, one block per row.
template <bool kStaged>
__global__ void row_median_batch_kernel(const float* __restrict__ x,
                                        float* __restrict__ med, int n,
                                        long long sr, long long se) {
  const long long r = blockIdx.x;
  const float m =
      row_median_of<kStaged>(RowKeys<false>{x + r * sr, se, 0.0f}, n);
  if (threadIdx.x == 0) med[r] = m;
}

// med[r] = median of row r of the (rows, n) input, n <= kShortMax, one
// thread per row: the row's keys in registers, each ranked by counting the
// keys below it (ties broken by index, so the ranks are a permutation of
// 0..n-1), no shared memory and no barrier. Reads any strides in place
// (BaSiC's stack with its axis moved last: sr = 1, se = h * w, so the
// threads of a warp read consecutive addresses).
__global__ void __launch_bounds__(256)
    row_median_short_kernel(const float* __restrict__ x,
                            float* __restrict__ med, long long rows, int n,
                            long long sr, long long se) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* row = x + r * sr;
  unsigned int key[kShortMax];
#pragma unroll
  for (int i = 0; i < kShortMax; ++i) {
    key[i] = i < n ? sort_key(__ldg(row + i * se)) : 0u;
  }
  const int k1 = (n - 1) / 2, k2 = n / 2;
  unsigned int v1 = 0u, v2 = 0u;
#pragma unroll
  for (int i = 0; i < kShortMax; ++i) {
    if (i >= n) break;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < i; ++j) rank += key[j] <= key[i] ? 1 : 0;
#pragma unroll
    for (int j = i + 1; j < kShortMax; ++j) {
      if (j >= n) break;
      rank += key[j] < key[i] ? 1 : 0;
    }
    if (rank == k1) v1 = key[i];
    if (rank == k2) v2 = key[i];
  }
  const float m1 = key_float(v1);
  med[r] = k1 == k2 ? m1 : __fmul_rn(__fadd_rn(m1, key_float(v2)), 0.5f);
}

// The key of +0.0: what a masked value reads as.
constexpr unsigned int kZeroKey = 0x80000000u;

// The k-th smallest (0-based, k < count) of the count <= 32 candidates of
// a warp's row, the valid keys in [lo, lo + width] (key_of(j): the key of
// the lane's slot j, element j * 32 + lane, valid below n): gathered into
// hist[0..count) in lane order, each ranked against the others (ties
// broken by position, so the ranks are a permutation), the one of rank k
// broadcast to every lane.
template <int KPL, class Keys>
__device__ __forceinline__ unsigned int warp_rank(
    const Keys& key_of, int n, unsigned int lo, unsigned int width,
    unsigned int k, unsigned int count, unsigned int* hist, int lane) {
  unsigned int take = 0u;  // bit j: slot j is a candidate
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    take |= j * 32 + lane < n && key_of(j) - lo <= width ? 1u << j : 0u;
  }
  const unsigned int mine = __popc(take);
  unsigned int pos = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int up = __shfl_up_sync(kAll, pos, o);
    if (lane >= o) pos += up;
  }
  pos -= mine;
  __syncwarp();  // every lane is done with hist
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    if (take & (1u << j)) hist[pos++] = key_of(j);
  }
  __syncwarp();
  unsigned int v = 0u;
  bool hit = false;
  if (lane < static_cast<int>(count)) {
    v = hist[lane];
    unsigned int below = 0u;
    for (int i = 0; i < static_cast<int>(count); ++i) {
      const unsigned int o = hist[i];
      below += (o < v || (o == v && i < lane)) ? 1u : 0u;
    }
    hit = below == k;
  }
  return __shfl_sync(kAll, v, __ffs(__ballot_sync(kAll, hit)) - 1);
}

// The k-th smallest (0-based) of the count candidates of a warp's row, the
// valid keys in [lo, lo + width] (see warp_rank), in the warp's own 256-bin
// histogram `hist` (16-byte aligned). While more than 32 candidates span
// more than one key, a pass counts them by the 8 bits of (key - lo) below
// the width's top bit with shared atomics (the range is one sign's, so the
// bins split its binades finely instead of crowding into the few of a top
// byte), and the warp finds the bin of rank k by an inclusive scan of its
// lanes' 8 bins each (shuffles) and a ballot; the range shrinks to that bin
// (by 8 bits or more a pass). 32 candidates or fewer are ranked directly.
// __syncwarp only: no block barrier.
template <int KPL, class Keys>
__device__ __forceinline__ unsigned int warp_select(
    const Keys& key_of, int n, unsigned int lo, unsigned int width,
    unsigned int k, unsigned int count, unsigned int* hist, int lane) {
  uint4* h4 = reinterpret_cast<uint4*>(hist);
#pragma unroll 1
  while (count > 32u && width != 0u) {
    const int s = max(0, 24 - __clz(width));  // (width >> s) < 256
    __syncwarp();  // every lane is done with hist
    h4[lane] = make_uint4(0u, 0u, 0u, 0u);
    h4[lane + 32] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const unsigned int off = key_of(j) - lo;
      if (j * 32 + lane < n && off <= width) {
        atomicAdd(hist + (off >> s), 1u);
      }
    }
    __syncwarp();
    const uint4 a = h4[2 * lane], b = h4[2 * lane + 1];
    const unsigned int bins[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    unsigned int sum = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += bins[i];
    unsigned int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int up = __shfl_up_sync(kAll, inc, o);
      if (lane >= o) inc += up;
    }
    unsigned int c = inc - sum;
    // the one lane whose bins hold rank k finds its bin
    const bool here = c <= k && k < inc;
    unsigned int digit = 0u, rest = 0u, cnt = 0u;
    bool found = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (here && !found && k < c + bins[i]) {
        found = true;
        digit = lane * 8 + i;
        rest = k - c;
        cnt = bins[i];
      }
      c += bins[i];
    }
    const int src = __ffs(__ballot_sync(kAll, here)) - 1;
    const unsigned int start = __shfl_sync(kAll, digit, src) << s;
    lo += start;
    width = min(width - start, (1u << s) - 1u);
    k = __shfl_sync(kAll, rest, src);
    count = __shfl_sync(kAll, cnt, src);
  }
  if (width == 0u) return lo;
  return warp_rank<KPL>(key_of, n, lo, width, k, count, hist, lane);
}

// The median of a warp's row of n keys (key_of(j): slot j's key, element
// j * 32 + lane, kAll past n), in every lane. One pass over the keys counts
// those below +0.0's key and equal to it (the masked values) and finds the
// extremes of either side; a rank among the +0.0 keys is +0.0 itself, which
// settles most masked rows (the zeros sit at the middle of the row's
// order), and any other rank is selected by warp_select within its side's
// key range. An even row averages the (n - 1) / 2-th and n / 2-th keys as
// (v1 + v2) * 0.5 in f32; v2 is found as median_of finds it where the
// counts do not give it.
template <int KPL, class Keys>
__device__ __forceinline__ float warp_median(const Keys& key_of, int n,
                                             unsigned int* hist, int lane) {
  unsigned int below = 0u, zeros = 0u, gmin = kAll, gmax = 0u, negmax = 0u,
               posmin = kAll;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const unsigned int v = key_of(j);  // kAll past n: above every side
    below += v < kZeroKey ? 1u : 0u;
    zeros += v == kZeroKey ? 1u : 0u;
    gmin = min(gmin, v);
    if (j * 32 + lane < n) gmax = max(gmax, v);
    if (v < kZeroKey) negmax = max(negmax, v);
    if (v > kZeroKey) posmin = min(posmin, v);
  }
  below = __reduce_add_sync(kAll, below);
  zeros = __reduce_add_sync(kAll, zeros);
  gmin = __reduce_min_sync(kAll, gmin);
  gmax = __reduce_max_sync(kAll, gmax);
  negmax = __reduce_max_sync(kAll, negmax);
  posmin = __reduce_min_sync(kAll, posmin);
  const unsigned int top = below + zeros;  // ranks below top: <= +0.0
  const unsigned int k1 = (n - 1) / 2, k2 = n / 2;
  unsigned int v1 = kZeroKey;
  if (k1 < below || k1 >= top) {  // one side's range: one select inlined
    const bool neg = k1 < below;
    v1 = warp_select<KPL>(key_of, n, neg ? gmin : posmin,
                          neg ? negmax - gmin : gmax - posmin,
                          neg ? k1 : k1 - top,
                          neg ? below : static_cast<unsigned int>(n) - top,
                          hist, lane);
  }
  const float m1 = key_float(v1);
  if (k2 == k1) return m1;
  unsigned int v2;
  if (k2 >= below && k2 < top) {
    v2 = kZeroKey;
  } else if (k2 == top) {
    v2 = posmin;
  } else {
    unsigned int le = 0u, above = kAll;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const unsigned int v = key_of(j);
      le += v <= v1 ? 1u : 0u;  // a pad only when v1 is the largest key
      if (v > v1) above = min(above, v);
    }
    le = __reduce_add_sync(kAll, le);
    above = __reduce_min_sync(kAll, above);
    v2 = le > k2 ? v1 : above;
  }
  return __fmul_rn(__fadd_rn(m1, key_float(v2)), 0.5f);
}

// The masked median's warp route (n <= KPL * 32 <= kWarpMax): one warp per
// output row, kWarpRows warps per block; warp w takes band row w / k_out
// of the (n_in * h, n) band and its output o = w % k_out, plane b = row / h
// + o * n_in, so the k_out warps of one band row are neighbours and the
// dual form's second read of a row hits L2 (a warp that read the row once
// for both outputs held more registers and lost). Lane l loads elements
// j * 32 + l (coalesced), makes their keys under the mask of thr[b] once,
// and warp_median writes the median. The warp's rows are not chunked:
// warps that prefetched their next row, in registers or in shared memory,
// held more registers, fitted fewer warps on an SM and lost.
template <int KPL>
__global__ void __launch_bounds__(kWarpRows * 32)
    row_median_masked_warp_kernel(const float* __restrict__ x,
                                  const float* __restrict__ thr,
                                  float* __restrict__ med, int n_in, int h,
                                  int n, int k_out) {
  __shared__ __align__(16) unsigned int hist[kWarpRows][256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarpRows + warp;
  const long long r = w / k_out;
  if (r >= (long long)n_in * h) return;  // the whole warp
  const int o = static_cast<int>(w - r * k_out);
  const int bi = static_cast<int>(r / h);
  const int b = bi + o * n_in;
  const float* row = x + r * n;
  const float cut = stripe_cut(thr[b]);
  unsigned int key[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    key[j] = j * 32 + lane < n ? masked_key(__ldg(row + j * 32 + lane), cut)
                               : kAll;
  }
  const float m = warp_median<KPL>([&](int j) { return key[j]; }, n,
                                   hist[warp], lane);
  if (lane == 0) med[(size_t)b * h + (r - (long long)bi * h)] = m;
}

// The notch tail's hooks into gemm_f32.cuh's tile; a stripe is a value v
// with sqrt(v * v) > t. Inpaint, the A-element transform, maps v ->
// stripe ? med[row] : v, the row being the thread's line of the load (fixed
// across K-steps); it reads the medians of the thread's lines once per
// block, into registers where a thread has two lines (8-byte loads), else
// into shared memory for the tile's BM rows (at 4-byte loads a thread has
// four, and four registers more spill under the tile's 128-register cap).
// DeltaStore, the epilogue, writes stripe ? 0 : acc - x for each output.
// Both test the stripe as v * v > cut, cut = stripe_cut(t), the same
// decision as the rounded square root's.
template <int BM, class Loader>
struct Inpaint {
  static constexpr bool kInRegisters = Loader::kLoads <= 2;
  const float* __restrict__ med;  // the plane's (h,) row medians
  float cut;
  float m[Loader::kLoads];
  const float* rows;  // in shared memory: the thread's first line on

  __device__ __forceinline__ void prepare(const Loader& ld, int line0,
                                          int nlines) {
    if constexpr (kInRegisters) {
#pragma unroll
      for (int e = 0; e < Loader::kLoads; ++e) {
        m[e] = med[ld.line_of(e, line0, nlines)];
      }
    } else {
      __shared__ float staged[BM];
      for (int i = threadIdx.x; i < BM; i += blockDim.x) {
        staged[i] = med[min(line0 + i, nlines - 1)];  // the loader's clamp
      }
      __syncthreads();
      rows = staged + ld.line;
    }
  }
  __device__ __forceinline__ float operator()(int e, float v) const {
    if constexpr (kInRegisters) {
      return __fmul_rn(v, v) > cut ? m[e] : v;
    } else {
      return __fmul_rn(v, v) > cut ? rows[e * Loader::kLineStep] : v;
    }
  }
};

struct DeltaStore {
  const float* __restrict__ x;  // the band plane, row pitch = ldc
  float cut;

  __device__ __forceinline__ void operator()(float* c, long long ldc, int r,
                                             int col, float acc) const {
    const long long o = r * ldc + col;
    const float xv = x[o];
    c[o] = __fmul_rn(xv, xv) > cut ? 0.0f : __fsub_rn(acc, xv);
  }
};

// out[b, r, c] = stripes ? 0 : sum_k inpainted[b, r, k] * op[k, sel*w + c]
//                              - x[b % n_in, r, c]; op is (w, 2w)
// row-major. gemm_f32.cuh's 64 x 128 tile (faster than 128 x 128 at the
// plane path's levels 0 and 1), V floats per load along the rows of x and
// of the bank.
constexpr int kNotchRows = 64;

template <int V>
__global__ void __launch_bounds__(gemm_f32::Tile<kNotchRows, 128>::kThreads,
                                  gemm_f32::Tile<kNotchRows, 128>::kMinBlocks)
    notch_delta_kernel(const float* __restrict__ x,
                       const float* __restrict__ med,
                       const float* __restrict__ thr,
                       const int* __restrict__ sel,
                       const float* __restrict__ op, float* __restrict__ out,
                       int n_in, int h, int w) {
  using Loader = gemm_f32::KMajorLoader<
      kNotchRows, gemm_f32::Tile<kNotchRows, 128>::kThreads, V>;
  const int b = blockIdx.z;
  const float cut = stripe_cut(thr[b]);
  const float* xb = x + (size_t)(b % n_in) * h * w;
  Inpaint<kNotchRows, Loader> inpaint;
  inpaint.med = med + (size_t)b * h;
  inpaint.cut = cut;
  gemm_f32::tile_product<kNotchRows, 128, V, true, V>(
      xb, w, 1, op + (size_t)sel[b] * w, 2 * (long long)w, 1,
      out + (size_t)b * h * w, w, h, w, w, blockIdx.y * kNotchRows,
      blockIdx.x * 128, inpaint, DeltaStore{xb, cut});
}

// The exact-rank notch tail (notch_delta_lowrank), two GEMMs on the same
// 64 x 128 tile. The projection y[b] = inpaint(x[b % n_in]) @ p[:, :r]
// (h x r, row pitch rp), r = r1 if sel[b] else r0, with notch_delta's
// A-element transform; blocks whose columns start past the plane's rank
// exit. K = w runs long and N = r is narrow, but the A operand, loaded
// through registers and the transform, is the costly one, so the tile
// that loads the fewest A values per product is best: on an H100 (4
// planes, one of them cells), 64 x 128 ran the 16384 x 18000 plan's
// level 0 in 10.2 ms, 128 x 64 in 11.9 and 64 x 64 in 12.1 (level 1: 3.0,
// 4.6, 4.5 ms).
template <int V>
__global__ void __launch_bounds__(gemm_f32::Tile<kNotchRows, 128>::kThreads,
                                  gemm_f32::Tile<kNotchRows, 128>::kMinBlocks)
    notch_project_kernel(const float* __restrict__ x,
                         const float* __restrict__ med,
                         const float* __restrict__ thr,
                         const int* __restrict__ sel,
                         const float* __restrict__ p, float* __restrict__ y,
                         int n_in, int h, int w, int rp, int r0, int r1) {
  using Loader = gemm_f32::KMajorLoader<
      kNotchRows, gemm_f32::Tile<kNotchRows, 128>::kThreads, V>;
  const int b = blockIdx.z;
  const int r = sel[b] ? r1 : r0;
  const int col0 = blockIdx.x * 128;
  if (col0 >= r) return;  // the whole block: past this plane's rank
  const float* xb = x + (size_t)(b % n_in) * h * w;
  Inpaint<kNotchRows, Loader> inpaint;
  inpaint.med = med + (size_t)b * h;
  inpaint.cut = stripe_cut(thr[b]);
  gemm_f32::tile_product<kNotchRows, 128, V, true, V>(
      xb, w, 1, p, rp, 1, y + (size_t)b * h * rp, rp, h, r, w,
      blockIdx.y * kNotchRows, col0, inpaint);
}

// The synthesis's epilogue: stripe ? 0 : acc (the projection left out the
// identity, so nothing is subtracted).
struct MaskedStore {
  const float* __restrict__ x;  // the band plane, row pitch = ldc
  float cut;

  __device__ __forceinline__ void operator()(float* c, long long ldc, int r,
                                             int col, float acc) const {
    const long long o = r * ldc + col;
    const float xv = x[o];
    c[o] = __fmul_rn(xv, xv) > cut ? 0.0f : acc;
  }
};

// The synthesis out[b] = stripes ? 0 : y[b][:, :r] @ ds[s rp : s rp + r]
// (h x w), s = sel[b]: K = r runs short; 64 x 128 ran level 0 in 7.4 ms
// on the same card, 128 x 128 in 7.6. y is read 8 bytes at a time (rp
// even), ds V floats.
template <int V>
__global__ void __launch_bounds__(gemm_f32::Tile<kNotchRows, 128>::kThreads,
                                  gemm_f32::Tile<kNotchRows, 128>::kMinBlocks)
    notch_synth_kernel(const float* __restrict__ x,
                       const float* __restrict__ thr,
                       const int* __restrict__ sel,
                       const float* __restrict__ y,
                       const float* __restrict__ ds, float* __restrict__ out,
                       int n_in, int h, int w, int rp, int r0, int r1) {
  const int b = blockIdx.z;
  const int s = sel[b];
  const float* xb = x + (size_t)(b % n_in) * h * w;
  gemm_f32::tile_product<kNotchRows, 128, 2, true, V>(
      y + (size_t)b * h * rp, rp, 1, ds + (size_t)s * rp * w, w, 1,
      out + (size_t)b * h * w, w, h, w, s ? r1 : r0,
      blockIdx.y * kNotchRows, blockIdx.x * 128, gemm_f32::AIdentity(),
      MaskedStore{xb, stripe_cut(thr[b])});
}

// The chirp-z notch tail (notch_delta_fft; no TPU kernel: the JAX package
// runs every level's notch dense). The notch minus the identity only moves
// the frequencies k <= K whose packed gains are not 1.0, so the delta is
// irfft((g - 1) . rfft(inpainted)) over those, which equals inpainted @ op
// - ch wherever ch is not a stripe (the identity notch_project uses). A
// DFT of length n is a circular convolution with the chirp w_j = exp(-i pi
// j^2 / n) (Bluestein): the analysis Z_k = w_k sum_j (z_j w_j) conj(w_{k-j})
// for k = -K..K, the synthesis y_j = conj(w_j) sum_k (E_k conj(w_k))
// w_{j-k}, each run as power-of-two FFTs of M >= n + 2K points with the
// chirp filter's transform (ops/fft_notch.py notch_chirp builds the tables
// in float64: chirp, the two filters' FFTs over M, the twiddles, each
// configuration's packed gains minus 1 over 2n). Two real rows ride in one
// complex sequence z = x1 + i x2 (single band: rows 2p and 2p + 1 of a
// plane, an odd last row paired with zeros; dual: the two outputs of one
// band row, so the band is read once for both), split after the analysis
// as 2 X1 = Z_k + conj(Z_-k), 2i X2 = Z_k - conj(Z_-k), each spectrum
// scaled by its own output's gains and recombined for one synthesis. So a
// pair takes four FFTs of M points: O(M log M) work in place of the dense
// tail's 2 n^2 a row (at the tile's level 0, n = 1002 and M = 2048: ~9x
// fewer operations).
//
// A block of M / 8 threads runs one pair. Each thread holds kP = 8 complex
// values in registers, those of indices t + q M / 8: the Stockham FFT's
// first pass (radix 8) reads them and its last pass (radix 8) writes them,
// so the four FFTs, the pointwise products between them, the load of the
// band and the store of the delta all stay in the same registers; the
// passes between exchange through M complex values of shared memory
// (padded one slot in 8, which spreads a pass's strided stores over the
// banks), the middle passes of radix 8, then one of radix 4 or 2. The
// inverse FFTs are forward ones between conjugations, folded into the
// products around them. Only the split of the spectra exchanges once more
// (each k needs -k). The mask and the inpainting are applied as the band
// is loaded, the stripes kept as bits until the masked store. Bound by the
// butterflies' FP32 operations and the exchanges' shared-memory traffic;
// each band row is read from device memory once and each output row
// written once. In practice it is bound by latency: a thread holds 128
// registers (its 8 values, a pass's twiddles, the DFT's temporaries), so
// an SM runs two blocks of M = 2048; fewer registers spilled and ran
// slower. On an H100, 4 values a thread (more exchanges, more warps) ran
// level 0 of the tile 1.7x slower, and 16 (fewer exchanges, fewer warps)
// no faster over levels 0-2. A pass loads the twiddles of the powers of
// two and forms the others as products, which held fewer registers and
// ran ~9% faster than loading all seven. Every value of a pair is
// computed in one fixed order, whatever the batch: a plane's rows come out
// the same at any B.
namespace fftz {

// Complex values a thread holds: the radix of the first and last passes.
constexpr int kP = 8;

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}
// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

__device__ __forceinline__ void dft2(float2& a0, float2& a1) {
  const float2 t = a0;
  a0 = add(t, a1);
  a1 = sub(t, a1);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 s0 = add(a0, a2), d0 = sub(a0, a2);
  const float2 s1 = add(a1, a3), d1 = mul_mi(sub(a1, a3));
  a0 = add(s0, s1);
  a2 = sub(s0, s1);
  a1 = add(d0, d1);
  a3 = sub(d0, d1);
}

__device__ __forceinline__ void dft8(float2& a0, float2& a1, float2& a2,
                                     float2& a3, float2& a4, float2& a5,
                                     float2& a6, float2& a7) {
  constexpr float kR = 0.70710678118654752440f;  // 1 / sqrt(2)
  dft4(a0, a2, a4, a6);
  dft4(a1, a3, a5, a7);
  // the odd half times exp(-2 pi i k / 8), k = 0..3
  a3 = make_float2((a3.x + a3.y) * kR, (a3.y - a3.x) * kR);
  a5 = mul_mi(a5);
  a7 = make_float2((a7.y - a7.x) * kR, -(a7.x + a7.y) * kR);
  // output k is E_k + O_k, output k + 4 is E_k - O_k (E_k in a_2k, O_k in
  // a_2k+1)
  const float2 y0 = add(a0, a1), y4 = sub(a0, a1);
  const float2 y1 = add(a2, a3), y5 = sub(a2, a3);
  const float2 y2 = add(a4, a5), y6 = sub(a4, a5);
  const float2 y3 = add(a6, a7), y7 = sub(a6, a7);
  a0 = y0; a1 = y1; a2 = y2; a3 = y3;
  a4 = y4; a5 = y5; a6 = y6; a7 = y7;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// One Stockham pass of radix R over M points at input stride NS (the
// product of the radices before it): the thread's B = kP / R butterflies
// jb = t + c M / kP take v[c + B r], r < R (indices jb + r M / R), times the
// twiddles exp(-2 pi i (jb mod NS) r / (NS R)), through a DFT of R points.
template <int M, int R, int NS>
__device__ __forceinline__ void twiddle_dft(float2 (&v)[kP],
                                            const float2* __restrict__ tw,
                                            int t) {
  constexpr int T = M / kP, B = kP / R;
#pragma unroll
  for (int c = 0; c < B; ++c) {
    if constexpr (NS > 1) {
      // the twiddles of the powers of two from the table, the others as
      // products of two (w_r = w_hi w_lo, lo the lowest set bit of r)
      const int k = (t + c * T) & (NS - 1);
      float2 wr[R];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int lo = r & -r;
        wr[r] = lo == r ? __ldg(tw + k * r * (M / (NS * R)))
                        : mul(wr[r - lo], wr[lo]);
        v[c + B * r] = mul(v[c + B * r], wr[r]);
      }
    }
    if constexpr (R == 8) {
      dft8(v[c], v[c + B], v[c + 2 * B], v[c + 3 * B], v[c + 4 * B],
           v[c + 5 * B], v[c + 6 * B], v[c + 7 * B]);
    } else if constexpr (R == 4) {
      dft4(v[c], v[c + B], v[c + 2 * B], v[c + 3 * B]);
    } else {
      dft2(v[c], v[c + B]);
    }
  }
}

// The exchange after a pass: output r of butterfly jb goes to index
// (jb / NS) NS R + jb mod NS + r NS; then each thread reads back the
// indices t + q M / kP for the next pass. The leading barrier keeps the
// stores behind every read of the previous exchange. (Two buffers in
// turn, with one barrier an exchange, measured no faster.)
template <int M, int R, int NS>
__device__ __forceinline__ void exchange(float2 (&v)[kP], float2* s,
                                         int t) {
  constexpr int T = M / kP, B = kP / R;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < B; ++c) {
    const int jb = t + c * T;
    const int base = (jb / NS) * NS * R + (jb & (NS - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) s[pad(base + r * NS)] = v[c + B * r];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kP; ++q) v[q] = s[pad(t + q * T)];
}

// The forward FFT of M points from the pass at input stride NS on: radix
// kP first and last, kP between while kP^2 or more points remain, then
// the rest. In and out, v[q] holds index t + q M / kP (natural order).
template <int M, int NS = 1>
__device__ __forceinline__ void fft(float2 (&v)[kP], float2* s,
                                    const float2* __restrict__ tw, int t) {
  constexpr int REST = M / NS;
  if constexpr (REST == kP) {
    twiddle_dft<M, kP, NS>(v, tw, t);
  } else {
    constexpr int R = NS == 1 || REST >= kP * kP ? kP : REST / kP;
    twiddle_dft<M, R, NS>(v, tw, t);
    exchange<M, R, NS>(v, s, t);
    fft<M, NS * R>(v, s, tw, t);
  }
}

}  // namespace fftz

// out[b] = stripes ? 0 : the chirp-z notch delta of where(stripes, med, x)
// for the output rows of one pair (blockIdx.x) of planes blockIdx.y: k_out
// 1, rows 2p and 2p + 1 of plane b (the second only below h); k_out 2, row
// p of band plane b for outputs b and b + n_in. chirp (w), filt (2, M),
// tw (M) complex; gains (2, K + 1) complex: (a - 1, b - 1) / 2n of each
// configuration.
template <int M>
__global__ void __launch_bounds__(M / fftz::kP, 4096 / M)
    notch_fft_kernel(const float* __restrict__ x,
                     const float* __restrict__ med,
                     const float* __restrict__ thr,
                     const int* __restrict__ sel,
                     const float2* __restrict__ chirp,
                     const float2* __restrict__ filt,
                     const float2* __restrict__ tw,
                     const float2* __restrict__ gains,
                     float* __restrict__ out, int n_in, int h, int w,
                     int k_out, int K) {
  using namespace fftz;
  constexpr int T = M / kP;
  __shared__ float2 s[M + M / 8];
  const int t = threadIdx.x;
  int b1, r1, b2, r2;
  if (k_out == 1) {
    b1 = b2 = blockIdx.y;
    r1 = 2 * blockIdx.x;
    r2 = r1 + 1;
  } else {
    b1 = blockIdx.y;
    b2 = b1 + n_in;
    r1 = r2 = blockIdx.x;
  }
  const bool two = r2 < h;
  const float* x1 = x + ((size_t)(b1 % n_in) * h + r1) * w;
  const float* x2 = x + ((size_t)(b2 % n_in) * h + (two ? r2 : r1)) * w;
  const float cut1 = stripe_cut(thr[b1]);
  const float cut2 = two ? stripe_cut(thr[b2]) : INFINITY;
  const float m1 = med[(size_t)b1 * h + r1];
  const float m2 = two ? med[(size_t)b2 * h + r2] : 0.0f;

  // load, mask, inpaint, times the chirp; zero past the row
  float2 v[kP];
  unsigned int stripes = 0u;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int j = t + q * T;
    v[q] = make_float2(0.0f, 0.0f);
    if (j < w) {
      const float a = __ldg(x1 + j);
      const float c = two ? __ldg(x2 + j) : 0.0f;
      const bool s1 = __fmul_rn(a, a) > cut1, s2 = __fmul_rn(c, c) > cut2;
      stripes |= (s1 ? 1u : 0u) << q | (s2 ? 1u : 0u) << (q + 8);
      v[q] = mul(make_float2(s1 ? m1 : a, s2 ? m2 : c), __ldg(chirp + j));
    }
  }
  // analysis: conj(FFT(conj(FFT(v) H_an))) is the convolution
  fft<M>(v, s, tw, t);
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    v[q] = cconj(mul(v[q], __ldg(filt + t + q * T)));
  }
  fft<M>(v, s, tw, t);
  // Z_k = conj(v) w_|k| at k = -K..K (index k mod M); split, gains, E_k
  // conj(w_|k|) for the synthesis, zero elsewhere
  const float2* g1 = gains + (size_t)sel[b1] * (K + 1);
  const float2* g2 = gains + (size_t)sel[two ? b2 : b1] * (K + 1);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int i = t + q * T;
    const bool kept = i <= K || i >= M - K;
    const int ka = i <= K ? i : M - i;
    if (kept) {
      v[q] = mul(cconj(v[q]), __ldg(chirp + ka));
      s[pad(i)] = v[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int i = t + q * T;
    const bool kept = i <= K || i >= M - K;
    const int ka = i <= K ? i : M - i;
    if (kept) {
      const float2 zm = cconj(s[pad((M - i) & (M - 1))]);
      const float2 sum = add(v[q], zm), dif = sub(v[q], zm);
      const float2 ga = __ldg(g1 + ka), gb = __ldg(g2 + ka);
      const float2 e = make_float2(fmaf(ga.x, sum.x, gb.y * dif.x),
                                   fmaf(ga.y, sum.y, gb.x * dif.y));
      v[q] = mul(e, cconj(__ldg(chirp + ka)));
    } else {
      v[q] = make_float2(0.0f, 0.0f);
    }
  }
  // synthesis: conj(FFT(conj(FFT(v) H_syn))) is the convolution
  fft<M>(v, s, tw, t);
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    v[q] = cconj(mul(v[q], __ldg(filt + M + t + q * T)));
  }
  fft<M>(v, s, tw, t);
  // the convolution is conj(v), so y_j = conj(w_j) conj(v_j) = conj(w_j
  // v_j): row 1 its real part, row 2 its imaginary part; 0 at stripes
  float* o1 = out + ((size_t)b1 * h + r1) * w;
  float* o2 = out + ((size_t)b2 * h + r2) * w;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int j = t + q * T;
    if (j < w) {
      const float2 y = mul(__ldg(chirp + j), v[q]);
      o1[j] = (stripes >> q) & 1u ? 0.0f : y.x;
      if (two) o2[j] = (stripes >> (q + 8)) & 1u ? 0.0f : -y.y;
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
// each row of plane b % n_in with the values whose square is over
// stripe_cut(thr[b]) read as +0.0; n_out a multiple of n_in, w >= 1. route
// 3: a warp per output row, `param` keys per lane (1, 2, 4, ..., 32; w <=
// param * 32), kWarpRows warps per block, a band row's outputs on
// neighbouring warps; 1: a block of `param` threads (a multiple of 32) per
// output row, its keys staged in shared memory (w <= kStageCap); 2: the
// same, read from device memory at every pass.
int destripe_row_median(const float* x, const float* thr, float* med,
                        int n_out, int n_in, int h, int w, int route,
                        int param, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w < 1 || n_in < 1 || h < 1 || n_out % n_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_out = n_out / n_in;
  if (route == 3) {
    const long long blocks =
        ((long long)n_out * h + kWarpRows - 1) / kWarpRows;
    if (w > param * 32 || w > kWarpMax || blocks > 0x7FFFFFFFll) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const unsigned int grid = static_cast<unsigned int>(blocks);
    const int threads = kWarpRows * 32;
#define DESTRIPE_WARP_MEDIAN(KPL)                                          \
  case KPL:                                                                \
    row_median_masked_warp_kernel<KPL>                                     \
        <<<grid, threads, 0, s>>>(x, thr, med, n_in, h, w, k_out);         \
    break;
    switch (param) {
      DESTRIPE_WARP_MEDIAN(1)
      DESTRIPE_WARP_MEDIAN(2)
      DESTRIPE_WARP_MEDIAN(4)
      DESTRIPE_WARP_MEDIAN(8)
      DESTRIPE_WARP_MEDIAN(16)
      DESTRIPE_WARP_MEDIAN(32)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef DESTRIPE_WARP_MEDIAN
  } else if (route == 1 || route == 2) {
    if (n_out > 65535 || (route == 1 && w > kStageCap) || param % 32 ||
        param < 32 || param > 1024) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(h, n_out);
    if (route == 1) {
      row_median_kernel<true><<<grid, param, w * sizeof(unsigned int), s>>>(
          x, thr, med, n_in, h, w);
    } else {
      row_median_kernel<false><<<grid, param, 0, s>>>(x, thr, med, n_in, h,
                                                      w);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (rows, n) f32, row r at x + r * sr with its elements se apart -> med
// (rows,) f32, the median of each row; rows >= 1, n >= 1. route 0: a
// thread per row (n <= kShortMax), blocks of threads rows; 1: a block of
// threads per row, its keys in shared memory (n <= kStageCap); 2: a block
// per row, read from device memory at every pass. threads a multiple of 32.
int destripe_row_median_batch(const float* x, float* med, long long rows,
                              int n, long long sr, long long se, int route,
                              int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (n > kShortMax || threads > 256) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long blocks = (rows + threads - 1) / threads;
    if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
    row_median_short_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                              s>>>(x, med, rows, n, sr, se);
  } else if (route == 1 || route == 2) {
    if (rows > 0x7FFFFFFFll || (route == 1 && n > kStageCap)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned int>(rows));
    if (route == 1) {
      row_median_batch_kernel<true>
          <<<grid, threads, n * sizeof(unsigned int), s>>>(x, med, n, sr, se);
    } else {
      row_median_batch_kernel<false><<<grid, threads, 0, s>>>(x, med, n, sr,
                                                              se);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (n_in, h, w) f32, med (n_out, h) f32, thr (n_out,) f32, sel (n_out,)
// int32 in {0, 1}, op (w, 2w) f32 -> out (n_out, h, w) f32; v 1 or 2, the
// floats per load along x's rows and the bank's (2: w even and both bases
// 8-byte aligned); n_out and ceil(h / 64) at most 65535.
int destripe_notch(const float* x, const float* med, const float* thr,
                   const int* sel, const float* op, float* out, int n_out,
                   int n_in, int h, int w, int v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + 127) / 128, (h + kNotchRows - 1) / kNotchRows, n_out);
  const int threads = gemm_f32::Tile<kNotchRows, 128>::kThreads;
  if (v == 2) {
    notch_delta_kernel<2><<<grid, threads, 0, s>>>(x, med, thr, sel, op, out,
                                                   n_in, h, w);
  } else if (v == 1) {
    notch_delta_kernel<1><<<grid, threads, 0, s>>>(x, med, thr, sel, op, out,
                                                   n_in, h, w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (n_in, h, w) f32, med (n_out, h) f32, thr (n_out,) f32, sel (n_out,)
// int32 in {0, 1}, p (w, rp) f32 -> y (n_out, h, rp) f32, columns r0 (sel
// 0) or r1 (sel 1) of each plane written; 1 <= r0, r1 <= rp; v 1 or 2, the
// floats per load along x's rows and p's (2: w and rp even, both bases
// 8-byte aligned); n_out and ceil(h / 64) at most 65535.
int destripe_notch_project(const float* x, const float* med,
                           const float* thr, const int* sel, const float* p,
                           float* y, int n_out, int n_in, int h, int w,
                           int rp, int r0, int r1, int v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_in < 1 || n_out % n_in || r0 < 1 || r1 < 1 || r0 > rp || r1 > rp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int r = r0 > r1 ? r0 : r1;
  const dim3 grid((r + 127) / 128, (h + kNotchRows - 1) / kNotchRows, n_out);
  const int threads = gemm_f32::Tile<kNotchRows, 128>::kThreads;
  if (v == 2) {
    notch_project_kernel<2><<<grid, threads, 0, s>>>(x, med, thr, sel, p, y,
                                                     n_in, h, w, rp, r0, r1);
  } else if (v == 1) {
    notch_project_kernel<1><<<grid, threads, 0, s>>>(x, med, thr, sel, p, y,
                                                     n_in, h, w, rp, r0, r1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (n_in, h, w) f32, thr (n_out,) f32, sel (n_out,) int32 in {0, 1}, y
// (n_out, h, rp) f32, ds (2 rp, w) f32 -> out (n_out, h, w) f32: the sum
// over the first r0 (sel 0) or r1 (sel 1) rows of the plane's half of ds,
// 0 at stripes; rp even, 1 <= r0, r1 <= rp; v 1 or 2, the floats per load
// along ds's rows (2: w even and ds 8-byte aligned); n_out and
// ceil(h / 64) at most 65535.
int destripe_notch_synth(const float* x, const float* thr, const int* sel,
                         const float* y, const float* ds, float* out,
                         int n_out, int n_in, int h, int w, int rp, int r0,
                         int r1, int v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_in < 1 || n_out % n_in || r0 < 1 || r1 < 1 || r0 > rp || r1 > rp ||
      rp % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((w + 127) / 128, (h + kNotchRows - 1) / kNotchRows, n_out);
  const int threads = gemm_f32::Tile<kNotchRows, 128>::kThreads;
  if (v == 2) {
    notch_synth_kernel<2><<<grid, threads, 0, s>>>(x, thr, sel, y, ds, out,
                                                   n_in, h, w, rp, r0, r1);
  } else if (v == 1) {
    notch_synth_kernel<1><<<grid, threads, 0, s>>>(x, thr, sel, y, ds, out,
                                                   n_in, h, w, rp, r0, r1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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

// x (n_in, h, w) f32, med (n_out, h) f32, thr (n_out,) f32, sel (n_out,)
// int32 in {0, 1}, the chirp-z tables of ops/fft_notch.py notch_chirp
// (chirp (w, 2), filters (2, m, 2), twiddle (m, 2), gains (2, k + 1, 2)
// f32) -> out (n_out, h, w) f32; n_out = n_in (pairs of rows of a plane)
// or 2 n_in (the two outputs of a band row); m in 256..4096 a power of two,
// 2k < w, w + 2k <= m; n_out (n_in for 2 n_in) at most 65535.
int destripe_notch_fft(const float* x, const float* med, const float* thr,
                       const int* sel, const float* chirp,
                       const float* filters, const float* twiddle,
                       const float* gains, float* out, int n_out, int n_in,
                       int h, int w, int m, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_in < 1 || h < 1 || w < 1 || k < 0 || 2 * k >= w || w + 2 * k > m ||
      (n_out != n_in && n_out != 2 * n_in)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k_out = n_out / n_in;
  const dim3 grid(k_out == 1 ? (h + 1) / 2 : h, n_in);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float2* c2 = reinterpret_cast<const float2*>(chirp);
  const float2* f2 = reinterpret_cast<const float2*>(filters);
  const float2* t2 = reinterpret_cast<const float2*>(twiddle);
  const float2* g2 = reinterpret_cast<const float2*>(gains);
#define DESTRIPE_NOTCH_FFT(M)                                              \
  case M:                                                                  \
    notch_fft_kernel<M><<<grid, M / fftz::kP, 0, s>>>(                    \
        x, med, thr, sel, c2, f2, t2, g2, out, n_in, h, w, k_out, k);      \
    break;
  switch (m) {
    DESTRIPE_NOTCH_FFT(256)
    DESTRIPE_NOTCH_FFT(512)
    DESTRIPE_NOTCH_FFT(1024)
    DESTRIPE_NOTCH_FFT(2048)
    DESTRIPE_NOTCH_FFT(4096)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DESTRIPE_NOTCH_FFT
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
