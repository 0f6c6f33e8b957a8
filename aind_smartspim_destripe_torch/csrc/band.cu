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
// store. Neighbouring threads touch neighbouring addresses. K1 and K4
// stage each row segment once in shared memory (16-byte loads; K1 takes
// log(1+x) once per input rather than once per tap) and compute their
// outputs from there, each output's band read
// once for all the block's rows. K4's epilogue (IEEE logf, expf and
// division, no fast math) takes more issue time than its bytes take to
// move; K4 runs four consecutive outputs per thread with vector loads and
// stores and takes log(1 + pixel) once for every correction of the pixel.
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

// K4 geometry: a block of kK4Threads computes kK4Seg consecutive outputs
// (kK4Outs consecutive ones per thread) of kK4Rows rows of one image plane,
// for every correction of that plane, from the segment of each correction
// row it reads, which it stages in shared memory once.
constexpr int kK4Threads = 256;
constexpr int kK4Outs = 4;
constexpr int kK4Seg = kK4Threads * kK4Outs;
constexpr int kK4Rows = 2;
// Taps per output held in registers (db1-db3's synthesis bands); wider
// bands read theirs from device memory.
constexpr int kK4Taps = 3;
// Floats of a row segment's inputs: the synthesis band form's starts step
// by 0-1 per output (the host checks it, cuda_band.check_k4_band), so a
// segment reads at most (kK4Seg - 1) + K inputs, 3 more for alignment.
constexpr int kK4Cap = kK4Seg + 64;

// K4: corr[b, h, j] = sum_k coef[j, k] * st[b, h, start[j] + k], summed in
// k order, one fmaf per term from 0, then
// kBare: corr; kExp: exp(log(1 + img) + corr) + 1; kFlat: that, dark
// subtracted (clamped at 0), divided by flat, clipped to [0, 65535] and
// truncated to uint16; kWrap: that, truncated to int32, modulo 2^16.
// img holds P planes (P divides B) and output plane b reads image plane
// b % P (the dual-band form: two corrections per raw plane).
// Block (z, hq, s) owns outputs [s kK4Seg, (s + 1) kK4Seg) of rows
// [hq kK4Rows, (hq + 1) kK4Rows) of image plane z and of every correction
// b = z, z + P, ... < B: thread t the kK4Outs consecutive outputs from
// s kK4Seg + kK4Outs t, whose band (start, and up to kK4Taps coef each) it
// reads once into registers for all the block's rows and corrections. It
// reads each pixel, flat and dark value once (8-byte uint16 or 16-byte
// float loads where aligned), takes log(1 + pixel) once for all the
// corrections, and for each correction stages the run of st its outputs
// read, [start[j0], start[j1 - 1] + K), of each row in shared memory once
// (16-byte loads where aligned, a scalar head and tail around them), then
// sums each output's taps from there and stores its outputs as 8- or
// 16-byte vectors where aligned (scalar where a row of W % 4 != 0 columns
// is not). The planes of one row group are neighbours on grid.x, so they
// share its flat and dark rows in L2. Two rows per block and at most 80
// registers keep three blocks on an SM: the epilogue's IEEE logf, expf and
// division take most of the time (PERF.md), and fewer resident warps hide
// less of their latency.
template <typename TI, int kMode>
__global__ void __launch_bounds__(kK4Threads, 3)
    k4_kernel(const float* __restrict__ st, const TI* __restrict__ img,
              const float* __restrict__ flat, const float* __restrict__ dark,
              void* __restrict__ out, const int* __restrict__ start,
              const float* __restrict__ coef, int K, int B, int H, int L,
              int W) {
  using TO = typename std::conditional<kMode == kFlat || kMode == kWrap,
                                       unsigned short, float>::type;
  __shared__ __align__(16) float v[kK4Rows][kK4Cap];
  const int P = gridDim.x, z = blockIdx.x, tid = threadIdx.x;
  const int h0 = blockIdx.y * kK4Rows;
  const int rows = min(kK4Rows, H - h0);
  const int j0 = blockIdx.z * kK4Seg;
  const int j1 = min(j0 + kK4Seg, W);
  const int in0 = start[j0], in1 = start[j1 - 1] + K;
  if (in1 - in0 + 3 > kK4Cap) __trap();  // a band form the host refuses
  const int j = j0 + tid * kK4Outs;
  const bool full = j + kK4Outs <= j1;  // this thread's outputs: n, all?
  const int n = full ? kK4Outs : (j < j1 ? j1 - j : 0);

  // the band of the thread's outputs, once for all rows and corrections:
  // starts (an idle output reads input in0), and up to kK4Taps taps each
  // in registers (wider bands read theirs from device memory)
  int s[kK4Outs];
  float cr[kK4Outs][kK4Taps];
  const bool taps_in_regs = K <= kK4Taps;
  if (full) {
    loadv<kK4Outs>(start + j, kK4Outs, true, s);
  } else {
#pragma unroll
    for (int t = 0; t < kK4Outs; ++t) s[t] = t < n ? start[j + t] : in0;
  }
  if (full && K == kK4Taps) {
    float c[kK4Outs * kK4Taps];
    load_run<kK4Outs * kK4Taps>(coef + (size_t)j * K, c);
#pragma unroll
    for (int t = 0; t < kK4Outs; ++t) {
#pragma unroll
      for (int k = 0; k < kK4Taps; ++k) cr[t][k] = c[t * kK4Taps + k];
    }
  } else {
#pragma unroll
    for (int t = 0; t < kK4Outs; ++t) {
#pragma unroll
      for (int k = 0; k < kK4Taps; ++k) {
        cr[t][k] = t < n && k < K ? coef[(size_t)(j + t) * K + k] : 0.0f;
      }
    }
  }

  // the pixels (and flat, dark), loaded before the first staging, and the
  // pixels' logs taken after it, so the loads overlap
  float px[kK4Rows][kK4Outs], fl[kK4Rows][kK4Outs], dk[kK4Rows][kK4Outs];
  if constexpr (kMode != kBare) {
#pragma unroll
    for (int r = 0; r < kK4Rows; ++r) {
      if (r < rows) {
        const size_t pix = (size_t)(h0 + r) * W + j;
        loadv<kK4Outs>(img + (size_t)z * H * W + pix, n, full, px[r]);
        if constexpr (kMode == kFlat) {
          loadv<kK4Outs>(flat + pix, n, full, fl[r]);
          loadv<kK4Outs>(dark + pix, n, full, dk[r]);
        }
      }
    }
  }

  for (int b = z; b < B; b += P) {
    if (b != z) __syncthreads();  // the last correction's reads are done
    const float* plane = st + (size_t)b * H * L;
    // per row: inputs [a0, a1) in 16-byte loads; v[r][e - o] holds input
    // e, with a0 - o a multiple of 4 floats; the first 16-byte load of
    // every row issued before any is stored, so they are all in flight
    int a0[kK4Rows], a1[kK4Rows], o[kK4Rows];
    float4 q[kK4Rows];
#pragma unroll
    for (int r = 0; r < kK4Rows; ++r) {
      const float* row = plane + (size_t)(h0 + min(r, rows - 1)) * L;
      const int mis =
          static_cast<int>((reinterpret_cast<size_t>(row + in0) & 15) / 4);
      a0[r] = min(in0 + (mis ? 4 - mis : 0), in1);
      a1[r] = a0[r] + (in1 - a0[r]) / 4 * 4;
      o[r] = a0[r] - ((a0[r] - in0 + 3) & ~3);
      const int e = a0[r] + tid * 4;
      if (r < rows && e < a1[r]) {
        q[r] = __ldg(reinterpret_cast<const float4*>(row + e));
      }
    }
#pragma unroll
    for (int r = 0; r < kK4Rows; ++r) {
      if (r < rows) {
        const float* row = plane + (size_t)(h0 + r) * L;
        float* vr = v[r] - o[r];  // vr[e] holds input e
        for (int e = in0 + tid; e < a0[r]; e += kK4Threads) vr[e] = row[e];
        for (int e = a1[r] + tid; e < in1; e += kK4Threads) vr[e] = row[e];
        int e = a0[r] + tid * 4;
        if (e < a1[r]) {
          *reinterpret_cast<float4*>(vr + e) = q[r];
          for (e += kK4Threads * 4; e < a1[r]; e += kK4Threads * 4) {
            *reinterpret_cast<float4*>(vr + e) =
                __ldg(reinterpret_cast<const float4*>(row + e));
          }
        }
      }
    }
    if constexpr (kMode != kBare) {
      if (b == z) {
#pragma unroll
        for (int r = 0; r < kK4Rows; ++r) {
#pragma unroll
          for (int t = 0; t < kK4Outs; ++t) {
            if (r < rows && t < n) px[r][t] = logf(1.0f + px[r][t]);
          }
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kK4Rows; ++r) {
      if (r < rows && n > 0) {
        const float* vr = v[r] - o[r];
        float acc[kK4Outs];
        if (taps_in_regs) {
#pragma unroll
          for (int t = 0; t < kK4Outs; ++t) {
            acc[t] = 0.0f;
#pragma unroll
            for (int k = 0; k < kK4Taps; ++k) {
              if (k < K) acc[t] = fmaf(cr[t][k], vr[s[t] + k], acc[t]);
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < kK4Outs; ++t) {
            acc[t] = 0.0f;
            const float* c = coef + (size_t)(j + t) * K;
            for (int k = 0; k < K && t < n; ++k) {
              acc[t] = fmaf(c[k], vr[s[t] + k], acc[t]);
            }
          }
        }
        const size_t pix = (size_t)(h0 + r) * W + j;
        TO y[kK4Outs];
#pragma unroll
        for (int t = 0; t < kK4Outs; ++t) {
          if constexpr (kMode == kBare) {
            y[t] = acc[t];
          } else {
            const float e = expf(px[r][t] + acc[t]) + 1.0f;
            if constexpr (kMode == kExp) {
              y[t] = e;
            } else if constexpr (kMode == kFlat) {
              y[t] = destripe::epi_flat(e, dk[r][t], fl[r][t]);
            } else {
              y[t] = destripe::epi_wrap(e);
            }
          }
        }
        storev<kK4Outs>(static_cast<TO*>(out) + (size_t)b * H * W + pix, n, full, y);
      }
    }
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

// Launch a K2/K3 instance with smem bytes of dynamic shared memory,
// raising the instance's limit first where it is above the default 48 KB
// (wide bands under the run-time K instances).
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
void launch_k4(dim3 grid, cudaStream_t s, const float* st, const void* img,
               const float* flat, const float* dark, void* out,
               const int* start, const float* coef, int K, int B, int H,
               int L, int W, int mode) {
  const TI* im = static_cast<const TI*>(img);
  switch (mode) {
    case kBare:
      k4_kernel<TI, kBare><<<grid, kK4Threads, 0, s>>>(
          st, im, flat, dark, out, start, coef, K, B, H, L, W);
      break;
    case kExp:
      k4_kernel<TI, kExp><<<grid, kK4Threads, 0, s>>>(
          st, im, flat, dark, out, start, coef, K, B, H, L, W);
      break;
    case kFlat:
      k4_kernel<TI, kFlat><<<grid, kK4Threads, 0, s>>>(
          st, im, flat, dark, out, start, coef, K, B, H, L, W);
      break;
    default:
      k4_kernel<TI, kWrap><<<grid, kK4Threads, 0, s>>>(
          st, im, flat, dark, out, start, coef, K, B, H, L, W);
      break;
  }
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
// mode 2 only. start steps by 0 or 1 per output.
int destripe_k4(const float* st, const void* img, int img_u16,
                const float* flat, const float* dark, void* out,
                const int* start, const float* coef, int K, int B,
                int img_planes, int H, int L, int W, int mode,
                void* stream) {
  const dim3 grid(img_planes, (H + kK4Rows - 1) / kK4Rows,
                  (W + kK4Seg - 1) / kK4Seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_u16) {
    launch_k4<unsigned short>(grid, s, st, img, flat, dark, out, start, coef,
                              K, B, H, L, W, mode);
  } else {
    launch_k4<float>(grid, s, st, img, flat, dark, out, start, coef, K, B,
                     H, L, W, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
