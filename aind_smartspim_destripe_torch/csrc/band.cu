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
// K1 reads raw uint16 and fuses log(1+x) and the classifier's partial sums,
// K2 emits the per-plane |cH| range, K4 fuses exp(.)+1 and the flat-field
// or wrap epilogue into the uint16 store. Neighbouring threads touch
// neighbouring addresses. Block reductions are fixed trees in shared memory
// and write per-block partials (no float atomics), so runs repeat bit for
// bit.
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

// K1: out[b, h, j] = sum_k coef[j, k] * f(x[b, h, start[j] + k]),
// f = log(1 + x) (level 0) or identity (level 1). With kStats the block
// also sums, over the raw values of its row segment, the classifier's
// fg/bg counts and sums against `cut`; thread j owns input columns 2j and
// 2j+1 so every pixel is counted once. Partials are doubles: for uint16
// input they are exact.
template <typename T, bool kLog1p, bool kStats>
__global__ void k1_kernel(const T* __restrict__ x, float* __restrict__ out,
                          double* __restrict__ partials,
                          const int* __restrict__ start,
                          const float* __restrict__ coef, int K, int H, int W,
                          int L, float cut) {
  extern __shared__ double k1_smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int j = blockIdx.x * nthreads + tid;
  const T* row = x + ((size_t)b * H + h) * W;
  if (j < L) {
    const int s = start[j];
    const float* c = coef + (size_t)j * K;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      float v = to_f32(row[s + k]);
      if (kLog1p) v = logf(1.0f + v);
      acc = fmaf(c[k], v, acc);
    }
    out[((size_t)b * H + h) * L + j] = acc;
  }
  if (kStats) {
    double fc = 0.0, bc = 0.0, fs = 0.0, bs = 0.0;
    const int c1 = min(2 * j + 2, W);
    for (int c = 2 * j; c < c1; ++c) {
      const float v = to_f32(row[c]);
      if (v >= cut) {
        fc += 1.0;
        fs += v;
      } else {
        bc += 1.0;
        bs += v;
      }
    }
    k1_smem[tid] = fc;
    k1_smem[nthreads + tid] = bc;
    k1_smem[2 * nthreads + tid] = fs;
    k1_smem[3 * nthreads + tid] = bs;
    block_reduce<double, 4>(k1_smem, tid, nthreads, SumOp());
    if (tid < 4) {
      const size_t p = ((size_t)b * H + h) * gridDim.x + blockIdx.x;
      partials[p * 4 + tid] = k1_smem[tid * nthreads];
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
void launch_k1(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
               const void* x, float* out, double* partials, const int* start,
               const float* coef, int K, int H, int W, int L, bool log1p,
               float cut) {
  const T* xt = static_cast<const T*>(x);
  const bool stats = partials != nullptr;
  if (log1p && stats) {
    k1_kernel<T, true, true><<<grid, block, smem, s>>>(
        xt, out, partials, start, coef, K, H, W, L, cut);
  } else if (log1p) {
    k1_kernel<T, true, false><<<grid, block, 0, s>>>(
        xt, out, partials, start, coef, K, H, W, L, cut);
  } else if (stats) {
    k1_kernel<T, false, true><<<grid, block, smem, s>>>(
        xt, out, partials, start, coef, K, H, W, L, cut);
  } else {
    k1_kernel<T, false, false><<<grid, block, 0, s>>>(
        xt, out, partials, start, coef, K, H, W, L, cut);
  }
}

}  // namespace

extern "C" {

const char* destripe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, W) uint16 (x_u16=1) or f32 -> out (B, H, L) f32; partials
// (B, H, gx, 4) f64 or null, gx = ceil(L / threads); threads a power of 2.
int destripe_k1(const void* x, int x_u16, float* out, double* partials,
                const int* start, const float* coef, int K, int B, int H,
                int W, int L, int log1p, float cut, int threads,
                void* stream) {
  const dim3 grid((L + threads - 1) / threads, H, B);
  const size_t smem = partials ? 4 * threads * sizeof(double) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_u16) {
    launch_k1<unsigned short>(grid, dim3(threads), smem, s, x, out, partials,
                              start, coef, K, H, W, L, log1p != 0, cut);
  } else {
    launch_k1<float>(grid, dim3(threads), smem, s, x, out, partials, start,
                     coef, K, H, W, L, log1p != 0, cut);
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
