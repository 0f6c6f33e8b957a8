// Banded DWT passes of the destripe step (K1-K4) for NVIDIA Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package:
//   destripe_k1 <- aind_smartspim_destripe_tpu/ops/pallas_band.py:an_x_lowpass_log1p
//   destripe_k2 <- aind_smartspim_destripe_tpu/ops/pallas_band.py:an_y_pass
//   destripe_k3 <- aind_smartspim_destripe_tpu/ops/pallas_band.py:syn_y_pass
//   destripe_k4 <- aind_smartspim_destripe_tpu/ops/pallas_band.py:syn_x_exp
//
// The TPU kernels multiply 128-lane operator windows on the MXU. Here every
// output is a direct stencil of K taps: the host derives, from the same
// dense operator the plan builds, a first source index start[i] and K
// coefficients coef[i, 0:K] per output (K = 6 for db3 analysis, 3 for
// synthesis), and checks that the band form rebuilds the operator exactly
// (aind_smartspim_destripe_torch/ops/cuda_band.py:band_form). Sums are f32
// FMAs, as f32 as the plain PyTorch twins.
//
// What bounds them: all four move ~8 bytes per output and do 2K flops, so
// they are bound by device memory. The design keeps each pass to one read
// of its input and one write of its output, with the side channels fused:
// K1 reads raw uint16 and fuses log(1+x) and the classifier's sums, K2
// emits the per-plane |cH| range, K4 fuses exp(.)+1 and the flat-field or
// wrap epilogue into the uint16 store. Neighbouring threads touch
// neighbouring addresses. K1 and K4 stage each row segment once in shared
// memory (16-byte loads; K1 takes log(1+x) once per input rather than once
// per tap) and compute their outputs from there, each output's band read
// once for all the block's rows. K4's epilogue (IEEE logf, expf and
// division, no fast math) takes more issue time than its bytes take to
// move; K4 runs four consecutive outputs per thread with vector loads and
// stores and takes log(1 + pixel) once for every correction of the pixel.
// Float reductions are fixed trees in
// shared memory that write per-block partials (no float atomics); K1's
// uint16 classifier sums are integers, added with integer atomics, exact in
// any order; so runs repeat bit for bit.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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

struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// K2: lo[b, i, c] / hi[b, i, c] = sum_k clo/chi[i, k] * x[b, start[i] + k, c]
// along rows, threads along columns. With stats, per-block min and max of
// |hi| (invalid slots hold +inf / -inf).
__global__ void k2_kernel(const float* __restrict__ x, float* __restrict__ lo,
                          float* __restrict__ hi, float* __restrict__ mm,
                          const int* __restrict__ start,
                          const float* __restrict__ clo,
                          const float* __restrict__ chi, int K, int H, int Wc,
                          int L) {
  extern __shared__ float k2_smem[];
  const int b = blockIdx.z;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const bool valid = c < Wc && i < L;
  float a_hi = 0.0f;
  if (valid) {
    const int s = start[i];
    const float* xs = x + ((size_t)b * H + s) * Wc + c;
    float a_lo = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float v = xs[(size_t)k * Wc];
      a_lo = fmaf(clo[(size_t)i * K + k], v, a_lo);
      a_hi = fmaf(chi[(size_t)i * K + k], v, a_hi);
    }
    const size_t o = ((size_t)b * L + i) * Wc + c;
    lo[o] = a_lo;
    hi[o] = a_hi;
  }
  if (mm != nullptr) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y;
    const float a = fabsf(a_hi);
    k2_smem[tid] = valid ? a : INFINITY;
    k2_smem[nthreads + tid] = valid ? a : -INFINITY;
    block_reduce<float, 1>(k2_smem, tid, nthreads, MinOp());
    block_reduce<float, 1>(k2_smem + nthreads, tid, nthreads, MaxOp());
    if (tid == 0) {
      const size_t p =
          ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      mm[p * 2] = k2_smem[0];
      mm[p * 2 + 1] = k2_smem[nthreads];
    }
  }
}

// K3: out[b, i, c] = sum_k chi[i, k] * delta[b, start[i] + k, c]
//                  + sum_k clo[i, k] * corr[b, start[i] + k, c]  (kCorr)
template <bool kCorr>
__global__ void k3_kernel(const float* __restrict__ corr,
                          const float* __restrict__ delta,
                          float* __restrict__ out,
                          const int* __restrict__ start,
                          const float* __restrict__ clo,
                          const float* __restrict__ chi, int K, int L, int Wc,
                          int Ho) {
  const int b = blockIdx.z;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= Wc || i >= Ho) return;
  const int s = start[i];
  const size_t base = ((size_t)b * L + s) * Wc + c;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    acc = fmaf(chi[(size_t)i * K + k], delta[base + (size_t)k * Wc], acc);
  }
  if (kCorr) {
    for (int k = 0; k < K; ++k) {
      acc = fmaf(clo[(size_t)i * K + k], corr[base + (size_t)k * Wc], acc);
    }
  }
  out[((size_t)b * Ho + i) * Wc + c] = acc;
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
              float u = (e <= dk[r][t]) ? 0.0f : e - dk[r][t];
              u = u / fl[r][t];
              u = fminf(fmaxf(u, 0.0f), 65535.0f);
              y[t] = (unsigned short)__float2int_rz(u);
            } else {
              int m = __float2int_rz(e) % 65536;
              if (m < 0) m += 65536;
              y[t] = (unsigned short)m;
            }
          }
        }
        storev<kK4Outs>(static_cast<TO*>(out) + (size_t)b * H * W + pix, n, full, y);
      }
    }
  }
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

// x (B, H, Wc) f32 -> lo, hi (B, L, Wc) f32; mm (B, gy, gx, 2) f32 or null
// with gx = ceil(Wc / cols), gy = ceil(L / rows); cols * rows a power of 2.
int destripe_k2(const float* x, float* lo, float* hi, float* mm,
                const int* start, const float* clo, const float* chi, int K,
                int B, int H, int Wc, int L, int cols, int rows,
                void* stream) {
  const dim3 block(cols, rows);
  const dim3 grid((Wc + cols - 1) / cols, (L + rows - 1) / rows, B);
  const size_t smem = mm ? 2 * cols * rows * sizeof(float) : 0;
  k2_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, mm, start, clo, chi, K, H, Wc, L);
  return static_cast<int>(cudaGetLastError());
}

// corr (B, L, Wc) f32 or null, delta (B, L, Wc) f32 -> out (B, Ho, Wc) f32.
int destripe_k3(const float* corr, const float* delta, float* out,
                const int* start, const float* clo, const float* chi, int K,
                int B, int L, int Wc, int Ho, int cols, int rows,
                void* stream) {
  const dim3 block(cols, rows);
  const dim3 grid((Wc + cols - 1) / cols, (Ho + rows - 1) / rows, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (corr) {
    k3_kernel<true><<<grid, block, 0, s>>>(corr, delta, out, start, clo, chi,
                                           K, L, Wc, Ho);
  } else {
    k3_kernel<false><<<grid, block, 0, s>>>(corr, delta, out, start, clo,
                                            chi, K, L, Wc, Ho);
  }
  return static_cast<int>(cudaGetLastError());
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
