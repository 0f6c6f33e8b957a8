// Dual-band blend of the destripe step for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   destripe_blend <- aind_smartspim_destripe_tpu/ops/pallas_blend.py:blend_smooth_mix
//
// Per plane b with centre c = centers[b]:
//   frac   = 1 / (1 + exp(-(x - c) / crossover))
//   smooth = box17_cols(box17_rows(frac) / 17) / 17   (edge-replicated)
//   out    = fore * smooth + back * (1 - smooth)
// fore is plane b and back plane b + B of the stacked (2B, H, W) band pair
// (or two separate (B, H, W) buffers: the wrapper passes both pointers).
// The output is float32, or uint16 through the step's flat-field or wrap
// epilogue (epilogue.cuh, shared with K4), fused into the store. A window
// of H rows (a row shard widened by its neighbours' halo rows) may emit
// only its rows [first, first + count): the box still clamps at the
// window's edges, as on the whole window.
//
// What bounds it: 14 bytes per output bare (uint16 x, the two f32 bands,
// the f32 output), 12 with a uint16 epilogue, against a sigmoid of two
// IEEE divisions and an expf, 2 x 16 adds of the box's taps and their two
// divisions by 17, the mix and the epilogue's division per output; each
// IEEE division ends a basic block (its slow path is a call), so a warp's
// chains interleave little, and the warps wait on latency more than on
// issue or bytes (scripts/kernel_ab.py probes, PERF.md). The design does
// each of those once per output, reads every byte once and keeps as many
// warps resident as it can (96 registers, five blocks an SM). The TPU
// kernel carries the row pass through a sequential grid in VMEM scratch;
// here a block owns a strip of output columns (4 consecutive ones per
// thread, up to 512 per block, so only 16 halo columns per strip are
// staged twice) and walks a run of up to 160 output rows down the plane,
// with only the 16 halo rows per run staged twice. Asynchronous copies (cp.async) bring each x row into
// shared memory three rows ahead, and the bands (and fields) of each
// output row two rows ahead, one copy group a row, so no register holds
// a load in flight. Each x row's sigmoid is taken once per pixel into a
// double-buffered shared row (one barrier per row), and each thread sums
// its 4 row-pass outputs from 5 16-byte shared loads. The thread keeps the
// last 17 row-pass values of its columns in registers, a ring whose slot
// is a switch case (so every index in it is static; the loop is not
// unrolled 17 times, which overflowed the instruction cache), sums the
// column pass from there, mixes with fore and back and stores 4 outputs
// at once. The planes of one strip and run are neighbours on grid.x, so
// they share the flat and dark rows in L2.
//
// Numerics follow the plain twin (ops/cuda_blend.py:blend_bands) operation
// for operation: IEEE division and round-to-nearest adds and multiplies
// (no FMA contraction), the taps summed from the left, two divisions by 17
// (the JAX package's XLA reference; the TPU kernel multiplies by 1/289).
// The division by 17 is div17's three-instruction sequence; a card check
// (destripe_div17_check) holds it bit-equal to IEEE division on every f32
// from +0 to 17.0, the range of a sum of 17 sigmoid values. Only expf may
// differ from the twin's exp, by an ulp.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int kRadius = 8;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kOuts = 4;       // consecutive output columns per thread
constexpr int kThreads = 128;  // most threads (column quads) per strip
constexpr int kSeg = kOuts * kThreads + 2 * kRadius;  // staged row elements
constexpr int kRunRows = 160;  // output rows per run, at most (the host)
// Copy steps in flight beyond the current row: step q copies x row
// q + kAhead + 1 and the bands of output row q - 16 + kAhead.
constexpr int kAhead = 2;

enum Mode { kBare = 0, kFlat = 1, kWrap = 2 };

// Blocks per SM the registers must allow (96 registers a thread): the
// kernel waits on latency, so more resident warps hide more of it.
constexpr int kMinBlocks = 5;

// s / 17 rounded to nearest: the product by RN(1/17), then one correction
// from its exact residual. destripe_div17_check holds it bit-equal to
// __fdiv_rn(s, 17.0f) on every float from +0 to 17.0.
__device__ __forceinline__ float div17(float s) {
  constexpr float kInv = 1.0f / 17.0f;
  const float q = __fmul_rn(s, kInv);
  const float e = __fmaf_rn(-q, 17.0f, s);
  return __fmaf_rn(e, kInv, q);
}

__device__ __forceinline__ float sigmoid(float v, float c, float crossover) {
  const float z = __fdiv_rn(-__fsub_rn(v, c), crossover);
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(z)));
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// n (<= 4) consecutive floats from src to shared dst (16-byte aligned),
// asynchronously (cp.async): one 16-byte copy where all four are valid and
// src is aligned, else one 4-byte copy each.
__device__ __forceinline__ void copy4_async(float* dst, const float* src,
                                            int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (n == kOuts && (reinterpret_cast<size_t>(src) & 15) == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
    return;
  }
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    if (i < n) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + 4 * i),
                   "l"(src + i));
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four x values at shared p (aligned to 4 elements) as floats, in one
// 8-byte (uint16) or 16-byte (f32) load.
__device__ __forceinline__ void load4_shared(const unsigned short* p,
                                             float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = static_cast<float>(q.x & 0xFFFFu);
  v[1] = static_cast<float>(q.x >> 16);
  v[2] = static_cast<float>(q.y & 0xFFFFu);
  v[3] = static_cast<float>(q.y >> 16);
}
__device__ __forceinline__ void load4_shared(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// x of columns col0 .. col0 + 3 of a row into shared dst (aligned to 4
// elements): one asynchronous 8-byte (uint16) or 16-byte (f32) copy where
// all four lie in [0, W) and the source is aligned; else each column in
// [0, W) by a plain load and store (the plane's edges at a width that is
// not a multiple of 4, or an unaligned row pitch).
template <typename TI>
__device__ __forceinline__ void copy_x4(TI* dst, const TI* row, int col0,
                                        int W) {
  constexpr int kBytes = kOuts * static_cast<int>(sizeof(TI));
  const TI* src = row + col0;
  if (col0 >= 0 && col0 + kOuts <= W &&
      (reinterpret_cast<size_t>(src) & (kBytes - 1)) == 0) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (kBytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                   "l"(src));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    if (col0 + i >= 0 && col0 + i < W) dst[i] = src[i];
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Store n (<= 4) consecutive outputs at p: one 16-byte (f32) or 8-byte
// (uint16) store where all four are valid and p is aligned.
__device__ __forceinline__ void store4(float* p, int n, const float* y) {
  if (n == kOuts && (reinterpret_cast<size_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    if (i < n) p[i] = y[i];
  }
}
__device__ __forceinline__ void store4(unsigned short* p, int n,
                                       const unsigned short* y) {
  if (n == kOuts && (reinterpret_cast<size_t>(p) & 7) == 0) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(y[0] | (static_cast<unsigned int>(y[1]) << 16),
                   y[2] | (static_cast<unsigned int>(y[3]) << 16));
    return;
  }
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    if (i < n) p[i] = y[i];
  }
}

// Row-pass values rp of one staged row into ring slot K; with emit, the
// column pass: each column's last 17 values summed from the oldest (slot
// K + 1) to the newest (slot K), not yet divided by 17.
template <int K>
__device__ __forceinline__ void ring_step(float (&ring)[kTaps][kOuts],
                                          const float* rp, bool emit,
                                          float* cs) {
#pragma unroll
  for (int q = 0; q < kOuts; ++q) ring[K][q] = rp[q];
  if (emit) {
#pragma unroll
    for (int q = 0; q < kOuts; ++q) {
      float v = ring[(K + 1) % kTaps][q];
#pragma unroll
      for (int k = 2; k <= kTaps; ++k) {
        v = __fadd_rn(v, ring[(K + k) % kTaps][q]);
      }
      cs[q] = v;
    }
  }
}

// Block (b, s, z): plane b, strip s of qs column quads (thread t owns
// output columns c0 + 4t .. c0 + 4t + 3, c0 = 4 qs s), run z of rows
// [first + z R, first + (z + 1) R) of the window. Iteration p stages x row
// r0 - 8 + p (clamped to the window): element e of the staged row is
// column c0 - 8 + e (clamped), e < 4 qs + 16; thread t copies and takes
// the sigmoid of e = 4t .. 4t + 3, threads 0-3 copy the 16 tail elements
// e >= 4 qs and threads 0-15 take their sigmoid. From p = 16 on it emits
// output row r0 + p - 16.
template <typename TI, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    blend_kernel(const TI* __restrict__ x, const float* __restrict__ fore,
                 const float* __restrict__ back,
                 const float* __restrict__ centers,
                 const float* __restrict__ flat,
                 const float* __restrict__ dark, void* __restrict__ out,
                 int H, int W, int first, int count, int qs, int R,
                 float crossover) {
  using TO = typename std::conditional<kMode == kBare, float,
                                       unsigned short>::type;
  // fore, back (and flat, dark) of an output row, one slot per row in
  // flight: thread t's 4 values of each at [slot][field][4t]; the x rows
  // in flight, element e of a slot holding column c0 - 8 + e
  constexpr int kFields = kMode == kFlat ? 4 : 2;
  constexpr int kSlots = kAhead + 1, kXSlots = kAhead + 2;
  __shared__ __align__(16) float bands[kSlots][kFields][kOuts * kThreads];
  __shared__ __align__(16) TI xs[kXSlots][kSeg];
  __shared__ __align__(16) float buf[2][kSeg];
  const int b = blockIdx.x, t = threadIdx.x;
  const int c0 = blockIdx.y * kOuts * qs;
  const int r0 = first + blockIdx.z * R;
  const int nr = min(R, first + count - r0);  // output rows of the run
  const int n_in = nr + 2 * kRadius;
  const int j = c0 + kOuts * t;  // this thread's first output column
  const int n = t < qs ? max(min(kOuts, W - j), 0) : 0;  // outputs owned
  const size_t plane = (size_t)b * H * W;
  const TI* xb = x + plane;
  const float c = centers[b];
  const int e0 = c0 - kRadius;  // the column of element 0
  const int e_tail = kOuts * qs + t;  // element of thread t < 16's tail

  // copy step q: x row q + kAhead + 1 (clamped to the window; threads
  // t < qs its quad 4t, threads 0-3 the tail quads) and the bands of
  // output row q - 16 + kAhead, as one group
  auto issue = [&](int q) {
    const int p = q + kAhead + 1;
    if (p < n_in) {
      const TI* row = xb + (size_t)clampi(r0 - kRadius + p, H - 1) * W;
      TI* dst = xs[p % kXSlots];
      if (t < qs) copy_x4(dst + kOuts * t, row, e0 + kOuts * t, W);
      if (t < 4) {
        copy_x4(dst + kOuts * (qs + t), row, e0 + kOuts * (qs + t), W);
      }
    }
    const int k = q - 2 * kRadius + kAhead;
    if (k >= 0 && k < nr && n > 0) {
      const int i = r0 + k;
      const size_t o = plane + (size_t)i * W + j;
      float* dst = bands[k % kSlots][0] + kOuts * t;
      copy4_async(dst, fore + o, n);
      copy4_async(dst + kOuts * kThreads, back + o, n);
      if constexpr (kMode == kFlat) {
        const size_t f = (size_t)(i - first) * W + j;
        copy4_async(dst + 2 * kOuts * kThreads, flat + f, n);
        copy4_async(dst + 3 * kOuts * kThreads, dark + f, n);
      }
    }
    cp_async_commit();
  };
  // x of element e of a staged x row, its column clamped to [0, W)
  auto xv = [&](const TI* row, int e) {
    return static_cast<float>(row[clampi(e0 + e, W - 1) - e0]);
  };

  // x rows 0 .. kAhead in flight, row 0 visible to every thread
#pragma unroll
  for (int q = -kAhead - 1; q < 0; ++q) issue(q);
  cp_async_wait<kAhead>();
  __syncthreads();

  float ring[kTaps][kOuts];
  int u = 0;  // the ring slot of row p: p % 17
  for (int p = 0; p < n_in; ++p) {
    const int k = p - 2 * kRadius;  // the output row of the run, if >= 0
    const bool emit = k >= 0 && n > 0;
    issue(p);
    // the sigmoid of staged row p
    const TI* xr = xs[p % kXSlots];
    float* sb = buf[p & 1];
    if (t < qs) {
      const int col = e0 + kOuts * t;
      float v[kOuts];
      if (col >= 0 && col + kOuts <= W) {
        load4_shared(xr + kOuts * t, v);
      } else {
#pragma unroll
        for (int i = 0; i < kOuts; ++i) v[i] = xv(xr, kOuts * t + i);
      }
      *reinterpret_cast<float4*>(sb + kOuts * t) = make_float4(
          sigmoid(v[0], c, crossover), sigmoid(v[1], c, crossover),
          sigmoid(v[2], c, crossover), sigmoid(v[3], c, crossover));
    }
    if (t < 2 * kRadius) {
      sb[e_tail] = sigmoid(xv(xr, e_tail), c, crossover);
    }
    // x row p + 1 and this row's bands landed (this thread's copies),
    // and visible to every thread after the barrier
    cp_async_wait<kAhead>();
    __syncthreads();

    if (n > 0) {
      // row pass: output q sums elements 4t + q .. 4t + q + 16 from the
      // left, streamed through 5 16-byte shared loads
      float rp[kOuts];
#pragma unroll
      for (int m = 0; m < (kOuts + kTaps - 1) / 4; ++m) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(sb + kOuts * t + 4 * m);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int e = 4 * m + h;
          const float v = comp(v4, h);
#pragma unroll
          for (int q = 0; q < kOuts; ++q) {
            if (e == q) rp[q] = v;
            if (e > q && e - q < kTaps) rp[q] = __fadd_rn(rp[q], v);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kOuts; ++q) rp[q] = div17(rp[q]);
      // into ring slot u, and the column pass over the ring, oldest row
      // first: one case per slot, so every ring index is static
      float cs[kOuts];
      switch (u) {
#define BLEND_SLOT(K)                             \
  case K:                                         \
    ring_step<K>(ring, rp, emit, cs);             \
    break;
        BLEND_SLOT(0) BLEND_SLOT(1) BLEND_SLOT(2) BLEND_SLOT(3) BLEND_SLOT(4)
        BLEND_SLOT(5) BLEND_SLOT(6) BLEND_SLOT(7) BLEND_SLOT(8) BLEND_SLOT(9)
        BLEND_SLOT(10) BLEND_SLOT(11) BLEND_SLOT(12) BLEND_SLOT(13)
        BLEND_SLOT(14) BLEND_SLOT(15) BLEND_SLOT(16)
#undef BLEND_SLOT
      }
      if (emit) {
        // the mix, the epilogue and the store, with the bands of this row
        // from its slot
        const float* sl = bands[k % kSlots][0] + kOuts * t;
        float y[kOuts];
#pragma unroll
        for (int q = 0; q < kOuts; ++q) {
          const float sm = div17(cs[q]);
          y[q] = __fadd_rn(__fmul_rn(sl[q], sm),
                           __fmul_rn(sl[kOuts * kThreads + q],
                                     __fsub_rn(1.0f, sm)));
        }
        TO* dst = static_cast<TO*>(out) +
                  ((size_t)b * count + (r0 + k - first)) * W + j;
        if constexpr (kMode == kBare) {
          store4(dst, n, y);
        } else {
          unsigned short v[kOuts];
#pragma unroll
          for (int q = 0; q < kOuts; ++q) {
            if constexpr (kMode == kFlat) {
              v[q] = destripe::epi_flat(y[q], sl[3 * kOuts * kThreads + q],
                                        sl[2 * kOuts * kThreads + q]);
            } else {
              v[q] = destripe::epi_wrap(y[q]);
            }
          }
          store4(dst, n, v);
        }
      }
    }
    u = u == kTaps - 1 ? 0 : u + 1;
  }
}

// Every float s from +0 to `last` (bit patterns): count where div17(s)
// and __fdiv_rn(s, 17) differ, and the first such pattern.
__global__ void div17_check_kernel(unsigned int last,
                                   unsigned long long* bad,
                                   unsigned int* first_bad) {
  unsigned long long nbad = 0;
  unsigned int fb = 0xFFFFFFFFu;
  const unsigned long long step =
      (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long u =
           (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       u <= last; u += step) {
    const float s = __uint_as_float(static_cast<unsigned int>(u));
    if (__float_as_uint(div17(s)) != __float_as_uint(__fdiv_rn(s, 17.0f))) {
      ++nbad;
      fb = min(fb, static_cast<unsigned int>(u));
    }
  }
  if (nbad) {
    atomicAdd(bad, nbad);
    atomicMin(first_bad, fb);
  }
}

template <typename TI>
cudaError_t launch_blend(dim3 grid, int threads, cudaStream_t s, int mode,
                         const TI* x, const float* fore, const float* back,
                         const float* centers, const float* flat,
                         const float* dark, void* out, int H, int W,
                         int first, int count, int qs, int R,
                         float crossover) {
  switch (mode) {
    case kBare:
      blend_kernel<TI, kBare><<<grid, threads, 0, s>>>(
          x, fore, back, centers, flat, dark, out, H, W, first, count, qs,
          R, crossover);
      break;
    case kFlat:
      blend_kernel<TI, kFlat><<<grid, threads, 0, s>>>(
          x, fore, back, centers, flat, dark, out, H, W, first, count, qs,
          R, crossover);
      break;
    case kWrap:
      blend_kernel<TI, kWrap><<<grid, threads, 0, s>>>(
          x, fore, back, centers, flat, dark, out, H, W, first, count, qs,
          R, crossover);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W) uint16 (x_u16=1) or f32; fore, back (B, H, W) f32 (planes of
// one stacked buffer or two buffers); centers (B,) f32; crossover > 0;
// radius must be 8. Emits window rows [first, first + count) into out
// (B, count, W): f32 (mode 0), or uint16 through the flat-field epilogue
// (mode 1; flat and dark (count, W) f32, the emitted rows' fields) or the
// wrap cast (mode 2). Returns cudaErrorInvalidValue for another radius or
// mode, or for rows outside the window.
int destripe_blend(const void* x, int x_u16, const float* fore,
                   const float* back, const float* centers, void* out,
                   const float* flat, const float* dark, int mode, int B,
                   int H, int W, int first, int count, float crossover,
                   int radius, void* stream) {
  if (radius != kRadius || B < 1 || W < 1 || count < 1 || first < 0 ||
      first + count > H || (mode == kFlat && !(flat && dark))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int quads = (W + kOuts - 1) / kOuts;
  const int strips = (quads + kThreads - 1) / kThreads;
  const int qs = (quads + strips - 1) / strips;
  const int runs = (count + kRunRows - 1) / kRunRows;
  const int R = (count + runs - 1) / runs;
  if (strips > 65535 || runs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(B, strips, runs);
  const int threads = (qs + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_u16 ? launch_blend(grid, threads, s, mode,
                           static_cast<const unsigned short*>(x), fore, back,
                           centers, flat, dark, out, H, W, first, count, qs,
                           R, crossover)
            : launch_blend(grid, threads, s, mode,
                           static_cast<const float*>(x), fore, back, centers,
                           flat, dark, out, H, W, first, count, qs, R,
                           crossover);
  return static_cast<int>(e);
}

// The check of div17 against IEEE division on every float bit pattern
// from 0 to `last`: bad (one unsigned long long, zeroed by the caller)
// gets the count of differing patterns, first_bad (one unsigned int, set
// to 0xFFFFFFFF by the caller) the lowest.
int destripe_div17_check(unsigned int last, unsigned long long* bad,
                         unsigned int* first_bad, void* stream) {
  div17_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      last, bad, first_bad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
