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
// neighbouring addresses. K1 stages each row segment once in shared memory
// (16-byte loads, log(1+x) once per input rather than once per tap) and
// computes its outputs from there. Float reductions are fixed trees in
// shared memory that write per-block partials (no float atomics); K1's
// uint16 classifier sums are integers, added with integer atomics, exact in
// any order; so runs repeat bit for bit.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

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

// K4: corr[b, h, j] = sum_k coef[j, k] * st[b, h, start[j] + k], then
// kBare: corr; kExp: exp(log(1 + img) + corr) + 1; kFlat: that, dark
// subtracted (clamped at 0), divided by flat, clipped to [0, 65535] and
// truncated to uint16; kWrap: that, truncated to int32, modulo 2^16.
// img holds P planes (P divides B) and output plane b reads image plane
// b % P (the dual-band form: two corrections per raw plane). Block z is an
// image plane: its threads read the pixel once, then run the corrections
// b = z, z + P, ... < B. The pixel's load is issued before the loop and
// its log taken inside, so the load overlaps the taps' loads.
template <typename TI, int kMode>
__global__ void k4_kernel(const float* __restrict__ st,
                          const TI* __restrict__ img,
                          const float* __restrict__ flat,
                          const float* __restrict__ dark, void* __restrict__ out,
                          const int* __restrict__ start,
                          const float* __restrict__ coef, int K, int B, int H,
                          int L, int W) {
  const int P = gridDim.z, h = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  const int s = start[j];
  float v = 0.0f;
  if (kMode != kBare) v = to_f32(img[((size_t)blockIdx.z * H + h) * W + j]);
  for (int b = blockIdx.z; b < B; b += P) {
    const float* row = st + ((size_t)b * H + h) * L;
    float corr = 0.0f;
    for (int k = 0; k < K; ++k) {
      corr = fmaf(coef[(size_t)j * K + k], row[s + k], corr);
    }
    const size_t o = ((size_t)b * H + h) * W + j;
    if (kMode == kBare) {
      static_cast<float*>(out)[o] = corr;
      continue;
    }
    float y = expf(logf(1.0f + v) + corr) + 1.0f;
    if (kMode == kExp) {
      static_cast<float*>(out)[o] = y;
    } else if (kMode == kFlat) {
      const float d = dark[(size_t)h * W + j];
      y = (y <= d) ? 0.0f : y - d;
      y = y / flat[(size_t)h * W + j];
      y = fminf(fmaxf(y, 0.0f), 65535.0f);
      static_cast<unsigned short*>(out)[o] =
          (unsigned short)__float2int_rz(y);
    } else {
      int m = __float2int_rz(y) % 65536;
      if (m < 0) m += 65536;
      static_cast<unsigned short*>(out)[o] = (unsigned short)m;
    }
  }
}

template <typename TI>
void launch_k4(dim3 grid, dim3 block, cudaStream_t s, const float* st,
               const void* img, const float* flat, const float* dark,
               void* out, const int* start, const float* coef, int K, int B,
               int H, int L, int W, int mode) {
  const TI* im = static_cast<const TI*>(img);
  switch (mode) {
    case kBare:
      k4_kernel<TI, kBare><<<grid, block, 0, s>>>(
          st, im, flat, dark, out, start, coef, K, B, H, L, W);
      break;
    case kExp:
      k4_kernel<TI, kExp><<<grid, block, 0, s>>>(
          st, im, flat, dark, out, start, coef, K, B, H, L, W);
      break;
    case kFlat:
      k4_kernel<TI, kFlat><<<grid, block, 0, s>>>(
          st, im, flat, dark, out, start, coef, K, B, H, L, W);
      break;
    default:
      k4_kernel<TI, kWrap><<<grid, block, 0, s>>>(
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
// mode 2 only.
int destripe_k4(const float* st, const void* img, int img_u16,
                const float* flat, const float* dark, void* out,
                const int* start, const float* coef, int K, int B,
                int img_planes, int H, int L, int W, int mode, int threads,
                void* stream) {
  const dim3 grid((W + threads - 1) / threads, H, img_planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_u16) {
    launch_k4<unsigned short>(grid, dim3(threads), s, st, img, flat, dark,
                              out, start, coef, K, B, H, L, W, mode);
  } else {
    launch_k4<float>(grid, dim3(threads), s, st, img, flat, dark, out, start,
                     coef, K, B, H, L, W, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
