// GroupNorm forward, with an optional ReLU after it, for inference on
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA.  Added
// because aten's native_group_norm reduces each (sample, group) row's
// statistics in one block: the regularizer's GroupNorms (16 channels in 2
// groups, batch 1) ran on 2 of the card's 132 SMs, at ~0.2 % of the memory
// rate, a third of a dtu_eval map.  For x of (N, C, *) with G groups, row
// (n, g) holds the Cg = C / G channels of group g, Cg * HW contiguous
// values, and
//
//     y[n, c, p] = x[n, c, p] * a + b      (then max(y, 0) with the ReLU)
//     a = rsqrt(var + eps) * weight[c],  b = bias[c] - mean * a
//
// with the row's mean and biased variance in fp32, a and b in fp32 and y
// rounded once to x's dtype: the numerics of aten's GroupNorm
// (parallel/spatial.py:group_norm_rows describes them).  A ReLU after the
// rounding gives the same bits as one before it, so it is applied in fp32.
//
// Bound: device-memory bytes.  Three passes over x's bytes: a read for the
// moments, a read for the apply, a write of y (1x16x864x1152 bf16: 95.6 MB,
// 28.5 us at 3.35 TB/s).  A tensor that fits in the 50 MB L2 may serve the
// second read from there.  The arithmetic is a few operations a value.
//
// Design, two launches:
//
// - group_norm_moments_kernel, grid (P, rows): block p reduces a chunk of
//   `chunk` values of its row (the wrapper picks chunk so that the grid
//   holds at least ~4 blocks an SM, 8-32 K values a block).  Each thread
//   holds kUnroll 16-byte vectors at a time (coalesced across the block),
//   takes their mean and their centred sum of squares (M2) in registers,
//   and folds them into its running moments with Chan's pairwise update;
//   the block merges its threads' moments by warp shuffles and then over
//   its warps, and writes (mean, M2) of its chunk to an fp32 scratch of
//   (rows, P).  No atomics: every merge has a fixed order, so a map
//   repeats bit for bit.
// - group_norm_apply_kernel, grid (tiles, N * C): a block takes a tile of
//   one channel's plane, so its channel needs no division per value.  It
//   first merges its row's P partials (from L2: P is a few hundred) in a
//   fixed order, the same in every block of the row, then computes a and
//   b once and writes y with 16-byte stores.
//
// Vectors: 4 fp32 or 8 bf16 values a 16-byte access, where HW is a
// multiple of that width and x and y are 16-byte aligned (so every row and
// every plane starts on the grid); else both kernels run with one value an
// access.  Offsets inside a row are 32-bit (the wrapper raises for a row of
// 2^31 values or more); rows and planes past 65,535 loop over grid.y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // vectors a thread holds at once
// Every chunk is a multiple of this: a round of the widest block
// (kThreads * kUnroll * 8 bf16 values), so a chunk boundary never cuts a
// vector, whatever the vector width.
constexpr unsigned kChunkUnit = kThreads * kUnroll * 8;

template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (kVec == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = p[j];
  }
}

template <int kVec>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (kVec == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    // A bf16 is the top half of an fp32; the lower address is the low half.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __bfloat162float(p[j]);
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) p[j] = v[j];
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <int kVec>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (kVec == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) p[j] = __float2bfloat16(v[j]);
  }
}

// The moments of a set of values: its count, mean and sum of squared
// deviations from the mean.
struct Moments {
  float n, mean, m2;
};

// Chan, Golub and LeVeque's pairwise update; an empty side leaves the
// other as it is.
__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  if (b.n == 0.0f) return a;
  if (a.n == 0.0f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float w = b.n / n;
  return {n, a.mean + delta * w, a.m2 + b.m2 + delta * delta * a.n * w};
}

__device__ __forceinline__ Moments shfl_down(const Moments& m, int offset) {
  return {__shfl_down_sync(0xffffffffu, m.n, offset),
          __shfl_down_sync(0xffffffffu, m.mean, offset),
          __shfl_down_sync(0xffffffffu, m.m2, offset)};
}

// The block's moments, valid in thread 0, in a fixed order: each warp by
// shuffles, then warp 0 over the warps.  Every thread of the block calls it.
__device__ Moments block_merge(Moments m, Moments* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) m = merge(m, shfl_down(m, offset));
  if (lane == 0) smem[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? smem[lane] : Moments{0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int offset = kWarps / 2; offset > 0; offset >>= 1) m = merge(m, shfl_down(m, offset));
  }
  __syncthreads();  // smem is free for the next call
  return m;
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
group_norm_moments_kernel(const T* __restrict__ x, float2* __restrict__ partials,
                          int64_t rows, unsigned row_len, unsigned chunk) {
  __shared__ Moments smem[kWarps];
  constexpr unsigned kRound = kThreads * kUnroll * kVec;
  const unsigned begin = blockIdx.x * chunk;
  const unsigned end = min(begin + chunk, row_len);
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* row = x + r * row_len;
    Moments m{0.0f, 0.0f, 0.0f};
    for (unsigned base = begin; base < end; base += kRound) {
      // Vector j of this thread is valid when it starts before the end:
      // the valid ones are a prefix, and every one is whole.
      float v[kUnroll * kVec];
      int valid = 0;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const unsigned i = base + (j * kThreads + threadIdx.x) * kVec;
        if (i < end) {
          load_vec<kVec>(row + i, v + j * kVec);
          ++valid;
        }
      }
      if (valid == 0) continue;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < valid) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) sum += v[j * kVec + k];
        }
      }
      const float count = (float)(valid * kVec);
      const float mean = sum / count;
      float m2 = 0.0f;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < valid) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const float d = v[j * kVec + k] - mean;
            m2 += d * d;
          }
        }
      }
      m = merge(m, Moments{count, mean, m2});
    }
    m = block_merge(m, smem);
    if (threadIdx.x == 0) partials[r * gridDim.x + blockIdx.x] = make_float2(m.mean, m.m2);
  }
}

__device__ __forceinline__ float load_param(const void* p, unsigned c, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
group_norm_apply_kernel(const T* __restrict__ x, const float2* __restrict__ partials,
                        const void* __restrict__ weight, const void* __restrict__ bias,
                        int params_bf16, T* __restrict__ y, int64_t planes,
                        unsigned channels, unsigned group_channels, unsigned plane,
                        unsigned parts, unsigned chunk, float eps, int relu) {
  __shared__ Moments smem[kWarps];
  __shared__ float2 affine;
  constexpr unsigned kTile = kThreads * kUnroll * kVec;
  const unsigned row_len = group_channels * plane;
  const unsigned begin = blockIdx.x * kTile;
  for (int64_t q = blockIdx.y; q < planes; q += gridDim.y) {  // q = n * C + c
    const int64_t r = q / group_channels;                     // = n * G + g
    Moments m{0.0f, 0.0f, 0.0f};
    for (unsigned p = threadIdx.x; p < parts; p += kThreads) {
      const float2 part = partials[r * parts + p];
      m = merge(m, Moments{(float)min(chunk, row_len - p * chunk), part.x, part.y});
    }
    m = block_merge(m, smem);
    if (threadIdx.x == 0) {
      const unsigned c = (unsigned)(q % channels);
      const float a = rsqrtf(m.m2 / (float)row_len + eps) * load_param(weight, c, params_bf16);
      affine = make_float2(a, load_param(bias, c, params_bf16) - m.mean * a);
    }
    __syncthreads();
    const float a = affine.x, b = affine.y;
    const T* xq = x + q * plane;
    T* yq = y + q * plane;
    float v[kUnroll * kVec];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const unsigned i = begin + (j * kThreads + threadIdx.x) * kVec;
      if (i < plane) load_vec<kVec>(xq + i, v + j * kVec);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const unsigned i = begin + (j * kThreads + threadIdx.x) * kVec;
      if (i < plane) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float t = fmaf(v[j * kVec + k], a, b);
          v[j * kVec + k] = relu && t < 0.0f ? 0.0f : t;
        }
        store_vec<kVec>(yq + i, v + j * kVec);
      }
    }
    __syncthreads();  // affine is read before the next plane writes it
  }
}

struct Args {
  const void *x, *weight, *bias;
  void *y, *partials;
  int64_t batch, channels, groups, plane, chunk;
  float eps;
  int relu, params_bf16;
  cudaStream_t stream;
};

inline unsigned grid_y(int64_t n) { return (unsigned)(n < 65535 ? n : 65535); }

template <typename T, int kVec>
cudaError_t launch_as(const Args& a) {
  const int64_t group_channels = a.channels / a.groups;
  const int64_t row_len = group_channels * a.plane;
  const int64_t parts = (row_len + a.chunk - 1) / a.chunk;
  const int64_t rows = a.batch * a.groups, planes = a.batch * a.channels;
  const T* x = static_cast<const T*>(a.x);
  float2* partials = static_cast<float2*>(a.partials);
  group_norm_moments_kernel<T, kVec><<<dim3((unsigned)parts, grid_y(rows)), kThreads, 0,
                                       a.stream>>>(x, partials, rows, (unsigned)row_len,
                                                   (unsigned)a.chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int64_t tile = kThreads * kUnroll * kVec;
  group_norm_apply_kernel<T, kVec><<<dim3((unsigned)((a.plane + tile - 1) / tile),
                                          grid_y(planes)),
                                     kThreads, 0, a.stream>>>(
      x, partials, a.weight, a.bias, a.params_bf16, static_cast<T*>(a.y), planes,
      (unsigned)a.channels, (unsigned)group_channels, (unsigned)a.plane, (unsigned)parts,
      (unsigned)a.chunk, a.eps, a.relu);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch(const Args& a) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vectorizable = a.plane % kVec == 0 && aligned16(a.x) && aligned16(a.y);
  return vectorizable ? launch_as<T, kVec>(a) : launch_as<T, 1>(a);
}

}  // namespace

// dtype (of x and y) and params_dtype (of weight and bias): 0 = float32,
// 1 = bfloat16.  partials: an fp32 scratch of 2 * N * G * P values, P =
// ceil((C / G) * plane / chunk).  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int group_norm_forward(const void* x, const void* weight, const void* bias,
                                  void* y, void* partials, long long batch,
                                  long long channels, long long groups, long long plane,
                                  long long chunk, float eps, int relu, int dtype,
                                  int params_dtype, void* stream) {
  if (batch < 0 || channels <= 0 || groups <= 0 || channels % groups || plane < 0 ||
      chunk <= 0 || chunk % kChunkUnit || chunk >= (int64_t(1) << 31) ||
      (channels / groups) * plane >= (int64_t(1) << 31) || params_dtype < 0 ||
      params_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || plane == 0) return (int)cudaSuccess;
  const Args a{x, weight, bias, y, partials, batch, channels, groups, plane, chunk, eps,
               relu != 0, params_dtype, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch<float>(a);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
