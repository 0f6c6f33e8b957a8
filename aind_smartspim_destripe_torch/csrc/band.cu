// Banded DWT passes of the destripe step (K1-K4) for NVIDIA Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package:
//   destripe_k1 <- aind_smartspim_destripe_tpu/ops/pallas_band.py:an_x_lowpass_log1p
//   destripe_k2 <- aind_smartspim_destripe_tpu/ops/pallas_band.py:an_y_pass
//   destripe_k3 <- aind_smartspim_destripe_tpu/ops/pallas_band.py:syn_y_pass
//   destripe_k4 <- aind_smartspim_destripe_tpu/ops/pallas_band.py:syn_x_exp
//
// The TPU kernels multiply 128-lane operator windows on the MXU. Here every
// output is a direct stencil of K taps: the host derives, from the
// wavelet's taps, a first source index start[i] and K coefficients
// coef[i, 0:K] per output (K = 6 for db3 analysis, 3 for synthesis), the
// band form of the dense operator the plain twins read
// (aind_smartspim_destripe_torch/ops/cuda_band.py:band_form_taps). Sums are
// f32 FMAs, as f32 as the plain PyTorch twins.
//
// What bounds them: all four move ~8 bytes per output and do 2K flops, so
// they are bound by device memory. The design keeps each pass to one read
// of its input and one write of its output, with the side channels fused:
// K1 reads raw uint16 and fuses log(1+x) and the classifier's sums, K2
// emits the per-plane |cH| range, K4 fuses exp(.)+1 and the flat-field or
// wrap epilogue (epilogue.cuh, which the blend shares) into the uint16
// store. Neighbouring threads touch neighbouring addresses. K1 stages each
// row segment once in shared memory (16-byte loads; log(1+x) once per
// input rather than once per tap) and computes its outputs from there,
// each output's band read once for all the block's rows. K4's epilogue
// (IEEE logf, expf and division, no fast math) takes more issue time than
// its bytes take to move; K4 runs persistent blocks that walk many row
// segments with their next items' copies in flight in a ring in shared
// memory, four consecutive outputs per thread with vector stores, and
// takes log(1 + pixel) once for every correction of the pixel.
// K2 and K3 stage the span of input rows a run of output rows reads, each
// thread its own columns, with asynchronous copies (all in flight at once,
// 16-, 8- or 4-byte as the row pitch allows), and the run's band once, and
// sum every output of the run from shared memory. Every output of K1-K4 is
// its taps' sum in k order from 0, one fmaf per term (K3: the cH-delta
// half, then the cA-correction half), so tile and vector width move no
// bit. Float reductions write per-block partials (no float atomics): K1's
// float64 sums by fixed trees in shared memory, K2's |cH| range by warp
// shuffles (min and max, exact in any order); K1's uint16 classifier sums
// are integers, added with integer atomics, exact in any order; so runs
// repeat bit for bit.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "epilogue.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  return static_cast<float>(v);
}

// In-place tree reduction of `n` lanes per thread-slot; nthreads is a power
// of two. smem holds n arrays of nthreads values.
template <typename V, int N, typename Op>
__device__ void block_reduce(V* smem, int tid, int nthreads, Op op) {
  for (int stride = nthreads / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (tid < stride) {
#pragma unroll
      for (int q = 0; q < N; ++q) {
        smem[q * nthreads + tid] =
            op(smem[q * nthreads + tid], smem[q * nthreads + tid + stride]);
      }
    }
  }
  __syncthreads();
}

struct SumOp {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a + b; }
};

// K1 geometry: a block of kK1Threads computes kK1Seg consecutive outputs
// (kK1Outs per thread) of kK1Rows rows of one plane, from the segment of
// each row they read, which it stages in shared memory once.
constexpr int kK1Threads = 256;
constexpr int kK1Outs = 4;
constexpr int kK1Seg = kK1Threads * kK1Outs;
constexpr int kK1Rows = 4;
// Floats of a row segment's inputs: the analysis band form's starts step
// by 0-2 per output (the host checks it, cuda_band.check_k1_band), so a
// segment reads at most 2 (kK1Seg - 1) + K inputs, 3 more for alignment.
constexpr int kK1Cap = 2 * kK1Seg + 64;

// The 16-byte vector of T: kVec values, unpacked in address order.
template <typename T>
struct Vec16;
template <>
struct Vec16<unsigned short> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(uint4 q, unsigned short* v) {
    const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = static_cast<unsigned short>(w[i] & 0xFFFFu);
      v[2 * i + 1] = static_cast<unsigned short>(w[i] >> 16);
    }
  }
};
template <>
struct Vec16<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(uint4 q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
};

// The classifier's uint16 sums of one thread: fg/bg counts and sums of the
// raw values against cut, in integers (exact in any order).
struct U16Sums {
  unsigned long long q[4] = {0ull, 0ull, 0ull, 0ull};
  __device__ __forceinline__ void add(unsigned short raw, float cut) {
    const bool fg = to_f32(raw) >= cut;
    q[0] += fg ? 1ull : 0ull;
    q[1] += fg ? 0ull : 1ull;
    q[2] += fg ? raw : 0u;
    q[3] += fg ? 0u : raw;
  }
};

// K1: out[b, h, j] = sum_k coef[j, k] * f(x[b, h, start[j] + k]),
// f = log(1 + x) (level 0) or identity (level 1), summed in k order, one
// fmaf per term from 0. Block (s, hq, b) reads the inputs of outputs
// [s kK1Seg, (s + 1) kK1Seg) of rows [hq kK1Rows, (hq + 1) kK1Rows) once,
// 16 bytes per load where they are aligned (a scalar head and tail around
// them), applies f once per input into shared memory, and computes each
// output from there; each output's band (start, coef) is read once for all
// the block's rows.
// With kStats the block also sums the classifier's fg/bg counts and sums
// of the raw values against `cut` over the columns each row's segment owns,
// [2 j0, 2 j1) (the last segment: up to W), so every pixel is counted once:
// - uint16 input: in integers, exact in any order, reduced with warp
//   shuffles and added to the plane's four totals `sums` (B, 4) with one
//   64-bit integer atomic each;
// - float32 input: in float64, per row and group of 256 outputs, thread t
//   of group G owning columns 2 (256 G + t) and +1 and the group summed by
//   the shared-memory tree of block_reduce, one partial per group in
//   `partials` (B, H, ceil(L / 256), 4): the layout and order of sums of
//   the float64 partials of earlier kernels, so the plane's sums of them
//   come out the same.
template <typename T, bool kLog1p, bool kStats>
__global__ void __launch_bounds__(kK1Threads)
    k1_kernel(const T* __restrict__ x, float* __restrict__ out,
              unsigned long long* __restrict__ sums,
              double* __restrict__ partials, const int* __restrict__ start,
              const float* __restrict__ coef, int K, int H, int W, int L,
              float cut) {
  __shared__ __align__(16) float v[kK1Rows][kK1Cap];
  constexpr int kVec = Vec16<T>::kVec;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int h0 = blockIdx.y * kK1Rows;
  const int rows = min(kK1Rows, H - h0);
  const int j0 = blockIdx.x * kK1Seg;
  const int j1 = min(j0 + kK1Seg, L);
  const int in0 = start[j0], in1 = start[j1 - 1] + K;
  const int own0 = 2 * j0, own1 = j1 == L ? W : min(2 * j1, W);
  const T* plane = x + (size_t)b * H * W;
  auto f = [](T raw) {
    const float u = to_f32(raw);
    return kLog1p ? logf(1.0f + u) : u;
  };
  U16Sums acc16;
  auto count = [&](int e, T raw) {
    if constexpr (kStats && sizeof(T) == 2) {
      if (e >= own0 && e < own1) acc16.add(raw, cut);
    }
  };

  // per row: inputs [a0, a1) in 16-byte loads; v[r][e - o] holds input e,
  // with a0 - o a multiple of 4 floats, so those loads' values go in
  // 16-byte stores
  int a0[kK1Rows], a1[kK1Rows], o[kK1Rows];
#pragma unroll
  for (int r = 0; r < kK1Rows; ++r) {
    const T* row = plane + (size_t)(h0 + min(r, rows - 1)) * W;
    const int mis = static_cast<int>(
        (reinterpret_cast<size_t>(row + in0) & 15) / sizeof(T));
    a0[r] = min(in0 + (mis ? kVec - mis : 0), in1);
    a1[r] = a0[r] + (in1 - a0[r]) / kVec * kVec;
    o[r] = a0[r] - ((a0[r] - in0 + 3) & ~3);
  }
  if (in1 - in0 + 3 > kK1Cap) __trap();  // a band form the host refuses

  // the first 16-byte load of every row, all in flight at once
  uint4 q0[kK1Rows];
#pragma unroll
  for (int r = 0; r < kK1Rows; ++r) {
    const int e = a0[r] + tid * kVec;
    if (r < rows && e < a1[r]) {
      q0[r] = __ldg(reinterpret_cast<const uint4*>(
          plane + (size_t)(h0 + r) * W + e));
    }
  }
#pragma unroll
  for (int r = 0; r < kK1Rows; ++r) {
    if (r >= rows) break;
    const T* row = plane + (size_t)(h0 + r) * W;
    float* vr = v[r];
    for (int e = in0 + tid; e < a0[r]; e += kK1Threads) {
      vr[e - o[r]] = f(row[e]);
      count(e, row[e]);
    }
    for (int e = a1[r] + tid; e < in1; e += kK1Threads) {
      vr[e - o[r]] = f(row[e]);
      count(e, row[e]);
    }
    for (int e = a0[r] + tid * kVec; e < a1[r]; e += kK1Threads * kVec) {
      T raw[kVec];
      Vec16<T>::unpack(e == a0[r] + tid * kVec
                           ? q0[r]
                           : __ldg(reinterpret_cast<const uint4*>(row + e)),
                       raw);
      float y[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        y[i] = f(raw[i]);
        count(e + i, raw[i]);
      }
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(vr + (e - o[r]) + i) =
            make_float4(y[i], y[i + 1], y[i + 2], y[i + 3]);
      }
    }
    if constexpr (kStats && sizeof(T) == 2) {
      // owned columns outside the staged inputs (none for the analysis
      // band)
      for (int e = own0 + tid; e < own1; e += kK1Threads) {
        if (e < in0 || e >= in1) count(e, row[e]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int t = 0; t < kK1Outs; ++t) {
    const int j = j0 + t * kK1Threads + tid;
    if (j >= j1) break;
    const float* c = coef + (size_t)j * K;
    const int s = start[j];
    float acc[kK1Rows];
#pragma unroll
    for (int r = 0; r < kK1Rows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float ck = c[k];
#pragma unroll
      for (int r = 0; r < kK1Rows; ++r) {
        acc[r] = fmaf(ck, v[r][s - o[r] + k], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kK1Rows; ++r) {
      if (r < rows) out[((size_t)b * H + h0 + r) * L + j] = acc[r];
    }
  }

  if constexpr (kStats && sizeof(T) == 2) {
    __shared__ unsigned long long warp_q[kK1Threads / 32][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned long long q = acc16.q[i];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) q += __shfl_down_sync(0xFFFFFFFFu, q, d);
      if ((tid & 31) == 0) warp_q[tid >> 5][i] = q;
    }
    __syncthreads();
    if (tid < 4) {
      unsigned long long total = 0ull;
      for (int w = 0; w < kK1Threads / 32; ++w) total += warp_q[w][tid];
      atomicAdd(sums + (size_t)b * 4 + tid, total);
    }
  } else if constexpr (kStats) {
    __shared__ double tree[4 * kK1Threads];
    const int gx = (L + kK1Threads - 1) / kK1Threads;
    const int g1 = min(j0 / kK1Threads + kK1Outs, gx);
    for (int r = 0; r < rows; ++r) {
      const T* row = plane + (size_t)(h0 + r) * W;
      for (int g = j0 / kK1Threads; g < g1; ++g) {
        const int j = g * kK1Threads + tid;
        double dfc = 0.0, dbc = 0.0, dfs = 0.0, dbs = 0.0;
        for (int c = 2 * j; c < min(2 * j + 2, W); ++c) {
          const float u = to_f32(row[c]);
          if (u >= cut) {
            dfc += 1.0;
            dfs += u;
          } else {
            dbc += 1.0;
            dbs += u;
          }
        }
        tree[tid] = dfc;
        tree[kK1Threads + tid] = dbc;
        tree[2 * kK1Threads + tid] = dfs;
        tree[3 * kK1Threads + tid] = dbs;
        block_reduce<double, 4>(tree, tid, kK1Threads, SumOp());
        if (tid < 4) {
          const size_t p = ((size_t)b * H + h0 + r) * gx + g;
          partials[p * 4 + tid] = tree[tid * kK1Threads];
        }
        __syncthreads();  // the tree is reused by the next group
      }
    }
  }
}

// The vector of kBytes bytes: 4, 8 or 16.
template <int kBytes>
struct VecOf;
template <>
struct VecOf<4> {
  using type = unsigned int;
};
template <>
struct VecOf<8> {
  using type = uint2;
};
template <>
struct VecOf<16> {
  using type = uint4;
};

// N consecutive values of T at p (n of them valid, n <= N; full: all N) as
// F: one load of N values where all are valid and p is aligned to
// them, else n scalar loads. (full is its own argument: sm_90a code that
// read n == N off the predicate of n's clamp, max(0, min(N, .)), stored
// all N of a ragged thread's outputs.)
template <int N, typename T, typename F>
__device__ __forceinline__ void loadv(const T* p, int n, bool full, F* f) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  using V = typename VecOf<kBytes>::type;
  if (full && (reinterpret_cast<size_t>(p) & (kBytes - 1)) == 0) {
    union {
      V q;
      T v[N];
    } u;
    u.q = __ldg(reinterpret_cast<const V*>(p));
#pragma unroll
    for (int t = 0; t < N; ++t) f[t] = static_cast<F>(u.v[t]);
    return;
  }
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (t < n) f[t] = static_cast<F>(p[t]);
  }
}

// M consecutive floats at p, in the widest aligned vectors.
template <int M>
__device__ __forceinline__ void load_run(const float* p, float* f) {
  const size_t a = reinterpret_cast<size_t>(p);
  if (M % 4 == 0 && (a & 15) == 0) {
#pragma unroll
    for (int i = 0; i < M; i += 4) loadv<4>(p + i, 4, true, f + i);
  } else if (M % 2 == 0 && (a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < M; i += 2) loadv<2>(p + i, 2, true, f + i);
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) f[i] = p[i];
  }
}

// Store N consecutive outputs at p (n of them valid), as loadv reads.
template <int N, typename T>
__device__ __forceinline__ void storev(T* p, int n, bool full, const T* v) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  using V = typename VecOf<kBytes>::type;
  if (full && (reinterpret_cast<size_t>(p) & (kBytes - 1)) == 0) {
    union {
      V q;
      T v[N];
    } u;
#pragma unroll
    for (int t = 0; t < N; ++t) u.v[t] = v[t];
    *reinterpret_cast<V*>(p) = u.q;
    return;
  }
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (t < n) p[t] = v[t];
  }
}

// K2 and K3 geometry: a block owns kBandCols consecutive columns of one
// plane (a thread V consecutive ones, V = 4, 2 or 1 as the row pitch and
// the base pointers allow 16-, 8- or 4-byte accesses; kBandCols / V
// threads) and a run of consecutive output rows (kK2Rows, kK3Rows). The
// run's starts step by 0-2 (K2) or 0-1 (K3) per output, so it reads a
// contiguous span of input rows, at most 2 (kK2Rows - 1) + K for K2 and,
// the host checks, kK3Rows / 2 + K for K3 (cuda_band.check_k2_band,
// check_k3_band); K is at most kBandMaxK.
constexpr int kBandCols = 256;
constexpr int kK2Rows = 8;
constexpr int kK3Rows = 16;
constexpr int kBandMaxK = 64;

__host__ __device__ constexpr int k2_span_cap(int K) {
  return 2 * (kK2Rows - 1) + K;
}
__host__ __device__ constexpr int k3_span_cap(int K) {
  return kK3Rows / 2 + K;
}
// Floats of the band staged ahead of the rows: R starts (as ints) and two
// R x K tap arrays, rounded up to 16 bytes.
__host__ __device__ constexpr int band_floats(int R, int K) {
  return (2 * R * K + R + 3) / 4 * 4;
}

// One 4 V-byte copy from device to shared memory, asynchronous (cp.async,
// cached in L1 and L2); dst and src aligned to 4 V bytes.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(4 * V)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The thread's n input rows of its V columns from src (row pitch Wc) into
// rows (pitch kBandCols), all copies in flight at once.
template <int V>
__device__ __forceinline__ void stage_rows(float* rows, const float* src,
                                           int n, int Wc) {
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    cp_async<V>(rows + t * kBandCols, src + (size_t)t * Wc);
  }
}

// V floats of shared memory at p (aligned to 4 V bytes).
template <int V>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// K2: lo[b, i, c] = sum_k clo[i, k] * x[b, start[i] + k, c] and hi with
// chi, each summed in k order, one fmaf per term from 0, and the block's
// min and max of |hi| in mm (one partial per block; a thread without
// columns holds +inf / -inf). Block (run, strip, b) copies the span of
// input rows its run reads, its columns of each, into shared memory once
// (cp.async, 4 V bytes per copy, every copy of the thread in flight at
// once), and the run's band (starts and both tap arrays) once; each
// thread then sums its V columns of every output row of the run from
// there, reading only the rows it copied itself, and stores them as
// V-wide vectors. Only the K - 2 halo rows between two runs are read from
// device memory twice. What bounds it: bytes (2K flops per 8 bytes moved).
// KT > 0: K = KT, the taps unrolled (db3's 6); KT = 0: K at run time.
// (The launch bounds ask for at least one resident block per SM: with the
// block size alone ptxas held k2_kernel<1, 6> to 32 registers and spilled.)
template <int V, int KT>
__global__ void __launch_bounds__(kBandCols / V, 1)
    k2_kernel(const float* __restrict__ x, float* __restrict__ lo,
              float* __restrict__ hi, float* __restrict__ mm,
              const int* __restrict__ start, const float* __restrict__ clo,
              const float* __restrict__ chi, int Kr, int H, int Wc, int L) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][kBandCols / 32];
  const int K = KT > 0 ? KT : Kr;
  const int tid = threadIdx.x, b = blockIdx.z;
  const int i0 = blockIdx.x * kK2Rows;
  const int n_out = min(kK2Rows, L - i0);
  const int c = blockIdx.y * kBandCols + tid * V;
  const bool active = c < Wc;  // Wc % V == 0: all V columns or none
  const int s0 = start[i0];
  const int span = start[i0 + n_out - 1] + K - s0;
  if (span > k2_span_cap(K)) __trap();  // a band form the host refuses
  float* taps = smem;  // [2][kK2Rows][K]: lo, then hi
  int* off = reinterpret_cast<int*>(smem + 2 * kK2Rows * K);
  float* rows = smem + band_floats(kK2Rows, K);  // [span][kBandCols]

  if (active) {
    stage_rows<V>(rows + tid * V, x + ((size_t)b * H + s0) * Wc + c, span,
                  Wc);
  }
  for (int e = tid; e < n_out * K; e += kBandCols / V) {
    taps[e] = clo[(size_t)i0 * K + e];
    taps[kK2Rows * K + e] = chi[(size_t)i0 * K + e];
  }
  for (int e = tid; e < n_out; e += kBandCols / V) {
    off[e] = start[i0 + e] - s0;
  }
  cp_async_wait_all();
  __syncthreads();

  float mn = INFINITY, mx = -INFINITY;
  if (active) {
    const float* col = rows + tid * V;
    for (int r = 0; r < n_out; ++r) {
      const float* in = col + off[r] * kBandCols;
      const float* tl = taps + r * K;
      const float* th = tl + kK2Rows * K;
      float al[V], ah[V];
#pragma unroll
      for (int j = 0; j < V; ++j) al[j] = ah[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float v[V];
        lds<V>(in + k * kBandCols, v);
        const float cl = tl[k], ch = th[k];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          al[j] = fmaf(cl, v[j], al[j]);
          ah[j] = fmaf(ch, v[j], ah[j]);
        }
      }
      const size_t o = ((size_t)b * L + i0 + r) * Wc + c;
      storev<V>(lo + o, V, true, al);
      storev<V>(hi + o, V, true, ah);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mn = fminf(mn, fabsf(ah[j]));
        mx = fmaxf(mx, fabsf(ah[j]));
      }
    }
  }
  // the block's |hi| range: per warp by shuffles, then across the warps
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, d));
    mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, d));
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = mn;
    red[1][tid >> 5] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kBandCols / V / 32; ++w) {
      mn = fminf(mn, red[0][w]);
      mx = fmaxf(mx, red[1][w]);
    }
    const size_t p =
        ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    mm[p * 2] = mn;
    mm[p * 2 + 1] = mx;
  }
}

// K3: out[b, i, c] = sum_k chi[i, k] * delta[b, start[i] + k, c]
//                  + sum_k clo[i, k] * corr[b, start[i] + k, c]  (kCorr),
// one accumulator from 0, one fmaf per term: the delta half in k order,
// then the corr half in k order. Block (run, strip, b) stages the span of
// delta (and corr) rows its run reads, and the run's band, as K2 does;
// each thread sums its V columns of every output row of the run from
// there and stores them as V-wide vectors. Only the K - 1 halo rows
// between two runs are read twice. What bounds it: bytes.
// KT > 0: K = KT, the taps unrolled (db3's 3); KT = 0: K at run time.
template <int V, int KT, bool kCorr>
__global__ void __launch_bounds__(kBandCols / V, 1)
    k3_kernel(const float* __restrict__ corr, const float* __restrict__ delta,
              float* __restrict__ out, const int* __restrict__ start,
              const float* __restrict__ clo, const float* __restrict__ chi,
              int Kr, int L, int Wc, int Ho) {
  extern __shared__ __align__(16) float smem[];
  const int K = KT > 0 ? KT : Kr;
  const int tid = threadIdx.x, b = blockIdx.z;
  const int i0 = blockIdx.x * kK3Rows;
  const int n_out = min(kK3Rows, Ho - i0);
  const int c = blockIdx.y * kBandCols + tid * V;
  const bool active = c < Wc;
  const int s0 = start[i0];
  const int span = start[i0 + n_out - 1] + K - s0;
  const int cap = k3_span_cap(K);
  if (span > cap) __trap();  // a band form the host refuses
  float* taps = smem;  // [2][kK3Rows][K]: hi (delta), then lo (corr)
  int* off = reinterpret_cast<int*>(smem + 2 * kK3Rows * K);
  float* rows_d = smem + band_floats(kK3Rows, K);  // [cap][kBandCols]
  float* rows_c = rows_d + cap * kBandCols;

  if (active) {
    const size_t src = ((size_t)b * L + s0) * Wc + c;
    stage_rows<V>(rows_d + tid * V, delta + src, span, Wc);
    if constexpr (kCorr) {
      stage_rows<V>(rows_c + tid * V, corr + src, span, Wc);
    }
  }
  for (int e = tid; e < n_out * K; e += kBandCols / V) {
    taps[e] = chi[(size_t)i0 * K + e];
    if constexpr (kCorr) taps[kK3Rows * K + e] = clo[(size_t)i0 * K + e];
  }
  for (int e = tid; e < n_out; e += kBandCols / V) {
    off[e] = start[i0 + e] - s0;
  }
  cp_async_wait_all();
  __syncthreads();
  if (!active) return;

  for (int r = 0; r < n_out; ++r) {
    const int o_in = off[r] * kBandCols + tid * V;
    const float* t = taps + r * K;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int h = 0; h < (kCorr ? 2 : 1); ++h) {
      const float* in = (h == 0 ? rows_d : rows_c) + o_in;
      const float* th = t + h * kK3Rows * K;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float v[V];
        lds<V>(in + k * kBandCols, v);
        const float ck = th[k];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(ck, v[j], acc[j]);
      }
    }
    storev<V>(out + ((size_t)b * Ho + i0 + r) * Wc + c, V, true, acc);
  }
}

enum K4Mode { kBare = 0, kExp = 1, kFlat = 2, kWrap = 3 };

// K4 geometry. A block of kK4Threads threads, kK4Outs consecutive outputs
// a thread, walks a run of items; an item is kK4Rows rows of one output
// plane and one column segment of at most kK4Seg outputs. The host splits
// the width into segments of near-equal width (a multiple of kK4Outs),
// sizes the ring of stages from the shared-memory budget of
// kK4BlocksPerSM blocks an SM and launches that many blocks an SM
// (cuda_band.k4_geometry).
constexpr int kK4Threads = 256;
constexpr int kK4Outs = 4;
constexpr int kK4Seg = kK4Threads * kK4Outs;
constexpr int kK4Rows = 2;
constexpr int kK4BlocksPerSM = 3;
constexpr int kK4MaxStages = 4;
// Taps per output held in registers (db1-db3's synthesis bands); wider
// bands read theirs from device memory.
constexpr int kK4Taps = 3;

// A ring slot of K4, in floats: the item's kK4Rows st rows of `cap`
// floats, then (kExp, kFlat, kWrap) its pixel rows of kK4Seg TI and
// (kFlat) its flat and dark rows of kK4Seg floats each, every region
// 16-byte aligned (cap is a multiple of 4).
template <typename TI, int kMode>
struct K4Slot {
  static constexpr int kPx =
      kMode == kBare ? 0 : kK4Rows * kK4Seg * static_cast<int>(sizeof(TI)) / 4;
  static constexpr int kFields = kMode == kFlat ? 2 * kK4Rows * kK4Seg : 0;
  static __host__ __device__ int floats(int cap) {
    return kK4Rows * cap + kPx + kFields;
  }
};

// Wait until at most n (0 <= n <= kK4MaxStages - 2) of this thread's
// committed cp.async groups are still in flight.
__device__ __forceinline__ void k4_wait_pending(int n) {
  static_assert(kK4MaxStages == 4, "one case per pending count");
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

__device__ __forceinline__ void k4_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A thread's kK4Outs values of T at src (n of them valid; full: all) into
// its own place dst in shared memory: one cp.async where all are valid and
// src is aligned to them, else n plain copies.
template <typename T>
__device__ __forceinline__ void k4_stage_own(T* dst, const T* src, int n,
                                             bool full) {
  constexpr int kBytes = kK4Outs * static_cast<int>(sizeof(T));
  if (full && (reinterpret_cast<size_t>(src) & (kBytes - 1)) == 0) {
    cp_async<kBytes / 4>(reinterpret_cast<float*>(dst),
                         reinterpret_cast<const float*>(src));
    return;
  }
#pragma unroll
  for (int t = 0; t < kK4Outs; ++t) {
    if (t < n) dst[t] = src[t];
  }
}

// A thread's kK4Outs values of T from its own place in shared memory
// (aligned to all of them), in one vector load.
template <typename T>
__device__ __forceinline__ void lds_own(const T* p, T* v) {
  using V = typename VecOf<kK4Outs * sizeof(T)>::type;
  union {
    V q;
    T v[kK4Outs];
  } u;
  u.q = *reinterpret_cast<const V*>(p);
#pragma unroll
  for (int t = 0; t < kK4Outs; ++t) v[t] = u.v[t];
}

// A K4 item: correction q of image plane z (output plane z + q P), row
// group hq (rows [hq kK4Rows, (hq + 1) kK4Rows)) and segment sg. Items are
// numbered with q fastest, then z, hq and sg, so a run of items takes
// every correction of a pixel before the next plane, and every plane of a
// row group before the next row group.
struct K4Item {
  int q, z, hq, sg;
  __device__ __forceinline__ void advance(int nb, int P, int nhq) {
    if (++q < nb) return;
    q = 0;
    if (++z < P) return;
    z = 0;
    if (++hq < nhq) return;
    hq = 0;
    ++sg;
  }
};

// The inputs [in0, in1) of one correction row as the ring holds them:
// [a0, a1) is the run's 16-byte aligned interior, a multiple of 4 floats,
// and input e sits at row[e - o] of the slot, a0 - o being 0 or 4 floats,
// so the interior lands 16-byte aligned in shared memory.
struct K4Run {
  int a0, a1, o;
  __device__ __forceinline__ K4Run(const float* row, int in0, int in1) {
    const int mis =
        static_cast<int>((reinterpret_cast<size_t>(row + in0) & 15) / 4);
    a0 = min(in0 + (mis ? 4 - mis : 0), in1);
    a1 = a0 + (in1 - a0) / 4 * 4;
    o = a0 - ((a0 - in0 + 3) & ~3);
  }
};

// A thread's outputs in segment sg: from column j, n of them valid (full:
// all kK4Outs).
struct K4Cols {
  int j, n;
  bool full;
  __device__ __forceinline__ K4Cols(int sg, int seg, int W) {
    const int j1 = min((sg + 1) * seg, W);
    j = sg * seg + threadIdx.x * kK4Outs;
    full = j + kK4Outs <= j1;
    n = full ? kK4Outs : (j < j1 ? j1 - j : 0);
  }
};

// K4: corr[b, h, j] = sum_k coef[j, k] * st[b, h, start[j] + k], summed in
// k order, one fmaf per term from 0, then
// kBare: corr; kExp: exp(log(1 + img) + corr) + 1; kFlat: that, dark
// subtracted (clamped at 0), divided by flat, clipped to [0, 65535] and
// truncated to uint16; kWrap: that, truncated to int32, modulo 2^16.
// img holds P planes (P divides B) and output plane b reads image plane
// b % P (the dual-band form: two corrections per raw plane).
//
// Persistent and pipelined. The grid fills the card (kK4BlocksPerSM blocks
// an SM), and block g walks the items [N g / G, N (g + 1) / G) of the N in
// order. Everything an item reads goes through a ring of `stages` slots
// in shared memory by cp.async, one commit group an item: its st rows,
// the run [start[j0], start[j1 - 1] + K) of its segment (16 bytes where
// aligned, a 4-byte head and tail around them), and each thread's own
// pixels (at a plane's first correction), flat and dark values (8- or
// 16-byte copies where aligned, plain copies where not). While the block
// computes item i, the copies of items i + 1 ... i + stages - 1 are in
// flight, and the slot of item i - 1 is refilled once every thread has
// passed the barrier that opens item i. log(1 + pixel) is taken once, at
// a plane's first correction, for all its corrections. Each thread holds
// its outputs' band (start, and up to kK4Taps coef each) in registers for
// as long as its segment lasts, sums each output's taps from the ring, and
// stores its outputs as 8- or 16-byte vectors where aligned (scalar where
// a row of W % 4 != 0 columns is not).
//
// What bounds it: the epilogue (IEEE logf, expf and division, no fast
// math) issues more instructions an output than the card takes to move
// the kernel's 6 bytes an output, and each output's division ends in a
// branch (its slow path) that the compiler does not schedule across, so
// its chains want many warps. The ring hides the loads behind that issue:
// the next items' copies are in flight during each item's taps and
// epilogue, so no block waits at its barrier for data it has only just
// asked for. The data in flight sits in shared memory, not registers, so
// that three blocks fit an SM (80 registers) and 24 warps hide the
// chains' latency: with the next item's pixels and fields in registers
// only two fitted, and the epilogue forms ran slower than one-shot blocks
// at three. Each thread sums the taps of both rows of an item at once,
// then runs a row's four expf chains before its divisions. On an H100
// (700 W, 64 planes of 1600 x 2000) the flat-field form runs 0.96 ms
// against a 0.37 ms byte bound and the bare form, bound by bytes, 0.50 ms
// against 0.37 (PERF.md).
template <typename TI, int kMode>
__global__ void __launch_bounds__(kK4Threads, kK4BlocksPerSM)
    k4_kernel(const float* __restrict__ st, const TI* __restrict__ img,
              const float* __restrict__ flat, const float* __restrict__ dark,
              void* __restrict__ out, const int* __restrict__ start,
              const float* __restrict__ coef, int K, int B, int P, int H,
              int L, int W, int seg, int cap, int stages) {
  using TO = typename std::conditional<kMode == kFlat || kMode == kWrap,
                                       unsigned short, float>::type;
  using Slot = K4Slot<TI, kMode>;
  extern __shared__ __align__(16) float ring[];  // stages slots
  const int tid = threadIdx.x;
  const int nb = B / P, nhq = (H + kK4Rows - 1) / kK4Rows;
  const int slot_floats = Slot::floats(cap);
  const long long n_items =
      static_cast<long long>((W + seg - 1) / seg) * nhq * B;
  const int i0 = static_cast<int>(n_items * blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(n_items * (blockIdx.x + 1) / gridDim.x);
  if (i0 >= i1) return;

  // the st row r of an item, and the inputs its segment reads
  auto st_row = [&](const K4Item& it, int r) {
    return st + ((size_t)(it.z + it.q * P) * H + it.hq * kK4Rows + r) * L;
  };
  auto inputs = [&](int sg, int& in0, int& in1) {
    const int j0 = sg * seg, j1 = min(j0 + seg, W);
    in0 = start[j0];
    in1 = start[j1 - 1] + K;
    if (in1 - in0 + 3 > cap) __trap();  // a band form the host refuses
  };
  // a slot's regions: pixels, flat and dark rows (kK4Seg each)
  auto px_of = [&](float* s) {
    return reinterpret_cast<TI*>(s + kK4Rows * cap);
  };
  auto fl_of = [&](float* s) { return s + kK4Rows * cap + Slot::kPx; };

  // the copies of an item into a slot: st rows, and its pixels (at a
  // plane's first correction, or the block's first item) and fields
  auto stage = [&](const K4Item& it, int in0, int in1, bool pixels,
                   float* s) {
    const int h0 = it.hq * kK4Rows, rows = min(kK4Rows, H - h0);
#pragma unroll
    for (int r = 0; r < kK4Rows; ++r) {
      if (r >= rows) break;
      const float* row = st_row(it, r);
      const K4Run run(row, in0, in1);
      float* v = s + r * cap - run.o;
      for (int e = run.a0 + 4 * tid; e < run.a1; e += 4 * kK4Threads) {
        cp_async<4>(v + e, row + e);
      }
      if (in0 + tid < run.a0) cp_async<1>(v + in0 + tid, row + in0 + tid);
      if (run.a1 + tid < in1) {
        cp_async<1>(v + run.a1 + tid, row + run.a1 + tid);
      }
    }
    if constexpr (kMode != kBare) {
      const K4Cols c(it.sg, seg, W);
      const int own = tid * kK4Outs;
#pragma unroll
      for (int r = 0; r < kK4Rows; ++r) {
        if (r >= rows) break;
        const size_t pix = (size_t)(h0 + r) * W + c.j;
        if (pixels) {
          k4_stage_own(px_of(s) + r * kK4Seg + own,
                       img + (size_t)it.z * H * W + pix, c.n, c.full);
        }
        if constexpr (kMode == kFlat) {
          k4_stage_own(fl_of(s) + r * kK4Seg + own, flat + pix, c.n, c.full);
          k4_stage_own(fl_of(s) + (kK4Rows + r) * kK4Seg + own, dark + pix,
                       c.n, c.full);
        }
      }
    }
  };

  K4Item at;  // the item to stage next
  {
    int i = i0;
    at.q = i % nb;
    i /= nb;
    at.z = i % P;
    i /= P;
    at.hq = i % nhq;
    at.sg = i / nhq;
  }
  K4Item it = at;  // the item to compute
  int at_sg = -1, at_in0 = 0, at_in1 = 0;
  auto stage_next = [&](int slot, bool first) {
    if (at.sg != at_sg) {
      at_sg = at.sg;
      inputs(at_sg, at_in0, at_in1);
    }
    stage(at, at_in0, at_in1, first || at.q == 0, ring + slot * slot_floats);
    at.advance(nb, P, nhq);
  };
  for (int k = 0; k < stages - 1; ++k) {
    if (i0 + k < i1) stage_next(k, k == 0);
    k4_commit();
  }

  int sg = -1, in0 = 0, in1 = 0;
  K4Cols c(it.sg, seg, W);
  int s[kK4Outs];
  float cr[kK4Outs][kK4Taps];
  const bool taps_in_regs = K <= kK4Taps;
  float px[kK4Rows][kK4Outs];
  int slot = 0;
  for (int i = i0; i < i1; ++i) {
    k4_wait_pending(stages - 2);  // this thread's copies of item i landed
    __syncthreads();  // everyone's; and nobody reads item i - 1's slot
    if (i + stages - 1 < i1) {
      stage_next(slot == 0 ? stages - 1 : slot - 1, false);
    }
    k4_commit();

    if (it.sg != sg) {
      // a new segment: its inputs, the thread's outputs and their band,
      // once for all the segment's items (an idle output reads input in0)
      sg = it.sg;
      inputs(sg, in0, in1);
      c = K4Cols(sg, seg, W);
      if (c.full) {
        loadv<kK4Outs>(start + c.j, kK4Outs, true, s);
      } else {
#pragma unroll
        for (int t = 0; t < kK4Outs; ++t) {
          s[t] = t < c.n ? start[c.j + t] : in0;
        }
      }
      if (c.full && K == kK4Taps) {
        float cf[kK4Outs * kK4Taps];
        load_run<kK4Outs * kK4Taps>(coef + (size_t)c.j * K, cf);
#pragma unroll
        for (int t = 0; t < kK4Outs; ++t) {
#pragma unroll
          for (int k = 0; k < kK4Taps; ++k) cr[t][k] = cf[t * kK4Taps + k];
        }
      } else {
#pragma unroll
        for (int t = 0; t < kK4Outs; ++t) {
#pragma unroll
          for (int k = 0; k < kK4Taps; ++k) {
            cr[t][k] = t < c.n && k < K ? coef[(size_t)(c.j + t) * K + k]
                                        : 0.0f;
          }
        }
      }
    }

    // item i from its slot, both rows at once (a row past H or an idle
    // thread computes from stale slot values and stores nothing), so that
    // the chains of all the thread's outputs interleave
    float* sl = ring + slot * slot_floats;
    const int h0 = it.hq * kK4Rows, rows = min(kK4Rows, H - h0);
    const int own = tid * kK4Outs;
    if constexpr (kMode != kBare) {
      if (i == i0 || it.q == 0) {
        // a plane's first correction: log(1 + pixel) for all of them
#pragma unroll
        for (int r = 0; r < kK4Rows; ++r) {
          TI raw[kK4Outs];
          lds_own(px_of(sl) + r * kK4Seg + own, raw);
#pragma unroll
          for (int t = 0; t < kK4Outs; ++t) {
            px[r][t] = logf(1.0f + to_f32(raw[t]));
          }
        }
      }
    }
    float acc[kK4Rows][kK4Outs];
#pragma unroll
    for (int r = 0; r < kK4Rows; ++r) {
      const K4Run run(st_row(it, r), in0, in1);
      const float* v = sl + r * cap - run.o;
      if (taps_in_regs) {
#pragma unroll
        for (int t = 0; t < kK4Outs; ++t) {
          acc[r][t] = 0.0f;
#pragma unroll
          for (int k = 0; k < kK4Taps; ++k) {
            if (k < K) acc[r][t] = fmaf(cr[t][k], v[s[t] + k], acc[r][t]);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < kK4Outs; ++t) {
          acc[r][t] = 0.0f;
          const float* cf = coef + (size_t)min(c.j + t, W - 1) * K;
          for (int k = 0; k < K; ++k) {
            acc[r][t] = fmaf(cf[k], v[s[t] + k], acc[r][t]);
          }
        }
      }
    }
    const int b = it.z + it.q * P;
#pragma unroll
    for (int r = 0; r < kK4Rows; ++r) {
      TO y[kK4Outs];
      if constexpr (kMode == kBare) {
#pragma unroll
        for (int t = 0; t < kK4Outs; ++t) y[t] = acc[r][t];
      } else {
        float e[kK4Outs];
#pragma unroll
        for (int t = 0; t < kK4Outs; ++t) {
          e[t] = expf(px[r][t] + acc[r][t]) + 1.0f;
        }
        if constexpr (kMode == kExp) {
#pragma unroll
          for (int t = 0; t < kK4Outs; ++t) y[t] = e[t];
        } else if constexpr (kMode == kFlat) {
          float fl[kK4Outs], dk[kK4Outs];
          lds_own(fl_of(sl) + r * kK4Seg + own, fl);
          lds_own(fl_of(sl) + (kK4Rows + r) * kK4Seg + own, dk);
#pragma unroll
          for (int t = 0; t < kK4Outs; ++t) {
            y[t] = destripe::epi_flat(e[t], dk[t], fl[t]);
          }
        } else {
#pragma unroll
          for (int t = 0; t < kK4Outs; ++t) y[t] = destripe::epi_wrap(e[t]);
        }
      }
      if (r < rows && c.n > 0) {
        storev<kK4Outs>(static_cast<TO*>(out) +
                            ((size_t)b * H + h0 + r) * W + c.j,
                        c.n, c.full, y);
      }
    }
    it.advance(nb, P, nhq);
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
}


// The widest V of 4, 2, 1 floats that divides the row pitch Wc and to
// whose 4 V bytes every given base pointer (null: none) is aligned.
int vec_width(int Wc, const void* a, const void* b, const void* c) {
  const void* ptrs[3] = {a, b, c};
  for (int v = 4; v > 1; v >>= 1) {
    bool ok = Wc % v == 0;
    for (const void* p : ptrs) {
      ok = ok && (reinterpret_cast<size_t>(p) % (4 * v) == 0);
    }
    if (ok) return v;
  }
  return 1;
}

// Launch a K2/K3/K4 instance with smem bytes of dynamic shared memory,
// raising the instance's limit first where it is above the default 48 KB
// (K2/K3: wide bands under the run-time K instances; K4: a ring of slots
// with the flat and dark rows).
template <typename... P, typename... A>
cudaError_t launch_band(void (*kern)(P...), dim3 grid, int threads,
                        size_t smem, cudaStream_t s, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_k2(dim3 grid, size_t smem, cudaStream_t s, const float* x,
                      float* lo, float* hi, float* mm, const int* start,
                      const float* clo, const float* chi, int K, int H,
                      int Wc, int L) {
  auto kern = K == 6 ? k2_kernel<V, 6> : k2_kernel<V, 0>;
  return launch_band(kern, grid, kBandCols / V, smem, s, x, lo, hi, mm,
                     start, clo, chi, K, H, Wc, L);
}

template <int V>
cudaError_t launch_k3(dim3 grid, size_t smem, cudaStream_t s,
                      const float* corr, const float* delta, float* out,
                      const int* start, const float* clo, const float* chi,
                      int K, int L, int Wc, int Ho) {
  auto kern = corr ? (K == 3 ? k3_kernel<V, 3, true> : k3_kernel<V, 0, true>)
                   : (K == 3 ? k3_kernel<V, 3, false>
                             : k3_kernel<V, 0, false>);
  return launch_band(kern, grid, kBandCols / V, smem, s, corr, delta, out,
                     start, clo, chi, K, L, Wc, Ho);
}

template <typename TI>
cudaError_t launch_k4(int grid, cudaStream_t s, const float* st,
                      const void* img, const float* flat, const float* dark,
                      void* out, const int* start, const float* coef, int K,
                      int B, int P, int H, int L, int W, int seg, int cap,
                      int stages, int mode) {
  const TI* im = static_cast<const TI*>(img);
  auto kern = mode == kBare  ? k4_kernel<TI, kBare>
              : mode == kExp ? k4_kernel<TI, kExp>
              : mode == kFlat ? k4_kernel<TI, kFlat>
                              : k4_kernel<TI, kWrap>;
  const int slot = mode == kBare  ? K4Slot<TI, kBare>::floats(cap)
                   : mode == kExp ? K4Slot<TI, kExp>::floats(cap)
                   : mode == kFlat ? K4Slot<TI, kFlat>::floats(cap)
                                   : K4Slot<TI, kWrap>::floats(cap);
  const size_t smem = sizeof(float) * stages * slot;
  return launch_band(kern, dim3(grid), kK4Threads, smem, s, st, im, flat,
                     dark, out, start, coef, K, B, P, H, L, W, seg, cap,
                     stages);
}

template <typename T>
void launch_k1(dim3 grid, cudaStream_t s, const void* x, float* out,
               unsigned long long* sums, double* partials, const int* start,
               const float* coef, int K, int H, int W, int L, bool log1p,
               float cut) {
  const T* xt = static_cast<const T*>(x);
  const bool stats = sums != nullptr || partials != nullptr;
  if (log1p && stats) {
    k1_kernel<T, true, true><<<grid, kK1Threads, 0, s>>>(
        xt, out, sums, partials, start, coef, K, H, W, L, cut);
  } else if (log1p) {
    k1_kernel<T, true, false><<<grid, kK1Threads, 0, s>>>(
        xt, out, sums, partials, start, coef, K, H, W, L, cut);
  } else if (stats) {
    k1_kernel<T, false, true><<<grid, kK1Threads, 0, s>>>(
        xt, out, sums, partials, start, coef, K, H, W, L, cut);
  } else {
    k1_kernel<T, false, false><<<grid, kK1Threads, 0, s>>>(
        xt, out, sums, partials, start, coef, K, H, W, L, cut);
  }
}

}  // namespace

extern "C" {

const char* destripe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, W) uint16 (x_u16=1) or f32 -> out (B, H, L) f32. Classifier
// sums (or neither, for none): sums (B, 4) uint64, zeroed by the caller,
// for uint16 input; partials (B, H, ceil(L / 256), 4) f64 for f32 input.
// start steps by 0 or 2 per output.
int destripe_k1(const void* x, int x_u16, float* out, unsigned long long* sums,
                double* partials, const int* start, const float* coef, int K,
                int B, int H, int W, int L, int log1p, float cut,
                void* stream) {
  const dim3 grid((L + kK1Seg - 1) / kK1Seg, (H + kK1Rows - 1) / kK1Rows, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_u16) {
    if (partials) return static_cast<int>(cudaErrorInvalidValue);
    launch_k1<unsigned short>(grid, s, x, out, sums, partials, start, coef,
                              K, H, W, L, log1p != 0, cut);
  } else {
    if (sums) return static_cast<int>(cudaErrorInvalidValue);
    launch_k1<float>(grid, s, x, out, sums, partials, start, coef, K, H, W,
                     L, log1p != 0, cut);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (B, H, Wc) f32 -> lo, hi (B, L, Wc) f32 and mm (B, gy, gx, 2) f32,
// gx = ceil(Wc / kBandCols), gy = ceil(L / kK2Rows). start steps by 0-2
// per output; 1 <= K <= kBandMaxK.
int destripe_k2(const float* x, float* lo, float* hi, float* mm,
                const int* start, const float* clo, const float* chi, int K,
                int B, int H, int Wc, int L, void* stream) {
  if (K < 1 || K > kBandMaxK || mm == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((L + kK2Rows - 1) / kK2Rows,
                  (Wc + kBandCols - 1) / kBandCols, B);
  const size_t smem =
      sizeof(float) * (band_floats(kK2Rows, K) + k2_span_cap(K) * kBandCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = vec_width(Wc, x, lo, hi);
  cudaError_t e;
  if (V == 4) {
    e = launch_k2<4>(grid, smem, s, x, lo, hi, mm, start, clo, chi, K, H, Wc,
                     L);
  } else if (V == 2) {
    e = launch_k2<2>(grid, smem, s, x, lo, hi, mm, start, clo, chi, K, H, Wc,
                     L);
  } else {
    e = launch_k2<1>(grid, smem, s, x, lo, hi, mm, start, clo, chi, K, H, Wc,
                     L);
  }
  return static_cast<int>(e);
}

// corr (B, L, Wc) f32 or null, delta (B, L, Wc) f32 -> out (B, Ho, Wc) f32.
// start steps by 0-1 per output, at most kK3Rows / 2 times in each run of
// kK3Rows outputs; 1 <= K <= kBandMaxK.
int destripe_k3(const float* corr, const float* delta, float* out,
                const int* start, const float* clo, const float* chi, int K,
                int B, int L, int Wc, int Ho, void* stream) {
  if (K < 1 || K > kBandMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Ho + kK3Rows - 1) / kK3Rows,
                  (Wc + kBandCols - 1) / kBandCols, B);
  const size_t smem =
      sizeof(float) * (band_floats(kK3Rows, K) +
                       (corr ? 2 : 1) * k3_span_cap(K) * kBandCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = vec_width(Wc, corr, delta, out);
  cudaError_t e;
  if (V == 4) {
    e = launch_k3<4>(grid, smem, s, corr, delta, out, start, clo, chi, K, L,
                     Wc, Ho);
  } else if (V == 2) {
    e = launch_k3<2>(grid, smem, s, corr, delta, out, start, clo, chi, K, L,
                     Wc, Ho);
  } else {
    e = launch_k3<1>(grid, smem, s, corr, delta, out, start, clo, chi, K, L,
                     Wc, Ho);
  }
  return static_cast<int>(e);
}

// st (B, H, L) f32 -> out (B, H, W): f32 for modes 0-1, uint16 for 2-3.
// img (img_planes, H, W) uint16 (img_u16=1) or f32 with B a multiple of
// img_planes (= B in mode 0), null in mode 0; flat, dark (H, W) f32, read in
// mode 2 only. start steps by 0 or 1 per output. The launch geometry comes
// from the host (cuda_band.k4_geometry): segments of `seg` columns (a
// multiple of kK4Outs, at most kK4Seg), ring rows of `cap` floats (at
// least seg + K + 2, a multiple of 4), `stages` slots (2 to kK4MaxStages)
// and `grid` blocks.
int destripe_k4(const float* st, const void* img, int img_u16,
                const float* flat, const float* dark, void* out,
                const int* start, const float* coef, int K, int B,
                int img_planes, int H, int L, int W, int mode, int seg,
                int cap, int stages, int grid, void* stream) {
  if (seg < kK4Outs || seg > kK4Seg || seg % kK4Outs || cap % 4 ||
      cap < seg + K + 2 || stages < 2 || stages > kK4MaxStages || grid < 1 ||
      img_planes < 1 || B % img_planes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (img_u16) {
    e = launch_k4<unsigned short>(grid, s, st, img, flat, dark, out,
                                  start, coef, K, B, img_planes, H, L, W, seg,
                                  cap, stages, mode);
  } else {
    e = launch_k4<float>(grid, s, st, img, flat, dark, out, start, coef,
                         K, B, img_planes, H, L, W, seg, cap, stages, mode);
  }
  return static_cast<int>(e);
}

}  // extern "C"
