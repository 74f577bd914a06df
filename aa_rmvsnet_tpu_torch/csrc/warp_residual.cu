// The sweep's unpacked warp with its squared residual, for inference on
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package warps through a 2x2 patch table
// (ops/patch_sample.py:build_patch_table) and one gather of whole table rows
// a sample, which suits a TPU, and leaves the blend and the residual to XLA.
// On this card that composition wrote and read back a (Db * H * W, 4C)
// gather, a product of the same size, a stack of the weights and a sum over
// the taps, then two more passes for the residual: ~20 GB of traffic a
// hypothesis at 1056x1920 with 6 sources.  For one source view and a block
// of Db hypotheses this kernel reads the feature map itself and writes
//
//     out[b, k, p, c] = (bilinear(src[b], x[b, k, p], y[b, k, p])[c] - ref[b, p, c])^2
//
// rounded as aten's composition rounds it (ops/warp.py describes the
// numerics): xb = clamp(floor(x), 0, W - 1), likewise yb; the texels (yb,
// xb), (yb, xb + 1), (yb + 1, xb), (yb + 1, xb + 1), zero past the last row
// or column; the tents max(0, 1 - |d|) and their four products in fp32, each
// product rounded to T; each tap's texel x weight rounded to T; the four
// taps summed in fp32 in that order and rounded once; the difference and its
// square each rounded to T.  Every operation is an _rn intrinsic or
// instruction, so nvcc contracts nothing into an FMA.
//
// Bound: device-memory bytes.  A launch at 1x4x1056x1920, C = 32, bf16
// writes 519 MB of residuals and reads 65 MB of coordinates, 130 MB of
// reference features and, at least once, the 130 MB source map: 844 MB,
// 0.25 ms at 3.35 TB/s.  A sample reads 4 texels of C values from L1/L2;
// neighbouring pixels' 2x2 footprints overlap, and the next image row's
// samples reread the lower texels from L2.
//
// Design, one launch: a thread takes kVec channels (one 16-byte vector) of
// one reference pixel, so C / kVec neighbouring threads cover the pixel's
// channels and a warp covers 32 / (C / kVec) neighbouring pixels of a row.
// It holds its reference vector in registers and loops over the Db
// hypotheses: it reads the two coordinates, the four texel vectors through
// the read-only path, and writes its 16-byte vector of the residual, so a
// warp's stores for one hypothesis are one contiguous run.  Vectors: 8 bf16
// or 4 fp32 values where C is a multiple of that width and every tensor is
// 16-byte aligned; else one value a thread.  In bf16 the first form, which
// rounded each of a value's 7 steps by a conversion, took 0.61 ms a launch
// at the size above (41 % of the bound; fp32, with no conversions, 0.63 ms
// at 77 % of its own): the card converts at a fraction of its arithmetic
// rate.  So the 16-byte bf16 form multiplies and subtracts packed pairs in
// bf16 (Lane<__nv_bfloat16, 8>), each rounded once as the conversion of
// the fp32 result would round it, and converts only the weights and the
// tap sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Blocks an SM holds at once: 64 registers a thread.  At 1x4x1056x1920 the
// bf16 form took 0.356 ms a launch with it and 0.389 ms at its own 80
// registers (3 blocks an SM), fp32 0.628 ms and 0.686 ms.
constexpr int kMinBlocks = 4;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (kVec == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __ldg(p + j);
  }
}

template <int kVec>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = bf16_bits_to_float(__ldg(q + j));
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

template <int kVec>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) p[j] = __float2bfloat16_rn(v[j]);
}

__device__ __forceinline__ float tent(float d) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

// One thread's kVec channels of the squared residual at one sample: the
// reference vector it holds, and the blend of the sample's four texels
// (row q, the texel (yb, xb); right and below say whether the +1 column and
// row lie in the map) with the tent weights w (fp32, unrounded).  This form
// computes in fp32 registers.
template <typename T, int kVec>
struct Lane {
  float r[kVec];

  __device__ __forceinline__ void load_ref(const T* p) { load_vec<kVec>(p, r); }

  __device__ __forceinline__ void residual(const T* q, bool right, bool below, int64_t row,
                                           int channels, const float (&w)[4], T* dst) const {
    float t00[kVec], t01[kVec], t10[kVec], t11[kVec];
    load_vec<kVec>(q, t00);
#pragma unroll
    for (int j = 0; j < kVec; ++j) t01[j] = t10[j] = t11[j] = 0.0f;
    if (right) load_vec<kVec>(q + channels, t01);
    if (below) load_vec<kVec>(q + row, t10);
    if (right && below) load_vec<kVec>(q + row + channels, t11);
    const float w00 = round_to<T>(w[0]), w01 = round_to<T>(w[1]);
    const float w10 = round_to<T>(w[2]), w11 = round_to<T>(w[3]);
    float o[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float p00 = round_to<T>(__fmul_rn(t00[j], w00));
      const float p01 = round_to<T>(__fmul_rn(t01[j], w01));
      const float p10 = round_to<T>(__fmul_rn(t10[j], w10));
      const float p11 = round_to<T>(__fmul_rn(t11[j], w11));
      const float warped = round_to<T>(__fadd_rn(__fadd_rn(__fadd_rn(p00, p01), p10), p11));
      const float d = round_to<T>(__fsub_rn(warped, r[j]));
      o[j] = round_to<T>(__fmul_rn(d, d));
    }
    store_vec<kVec>(dst, o);
  }
};

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 ldg_or_zero(const __nv_bfloat16* p, bool inside) {
  return inside ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

// The 16-byte bf16 form, on packed pairs: a bf16 product or difference
// rounded once (mul.rn / sub.rn.bf16x2) is the fp32 one rounded to bf16,
// since the fp32 product of two bf16 values and the fp32 difference of two
// are exact or rounded the same way, so the pairs give the fp32 form's bits
// with a fraction of its conversions.  The four taps are summed in fp32.
template <>
struct Lane<__nv_bfloat16, 8> {
  uint32_t r[4];

  __device__ __forceinline__ void load_ref(const __nv_bfloat16* p) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }

  __device__ __forceinline__ void residual(const __nv_bfloat16* q, bool right, bool below,
                                           int64_t row, int channels, const float (&w)[4],
                                           __nv_bfloat16* dst) const {
    const uint4 v00 = ldg_or_zero(q, true), v01 = ldg_or_zero(q + channels, right);
    const uint4 v10 = ldg_or_zero(q + row, below);
    const uint4 v11 = ldg_or_zero(q + row + channels, right && below);
    const uint32_t t00[4] = {v00.x, v00.y, v00.z, v00.w}, t01[4] = {v01.x, v01.y, v01.z, v01.w};
    const uint32_t t10[4] = {v10.x, v10.y, v10.z, v10.w}, t11[4] = {v11.x, v11.y, v11.z, v11.w};
    const uint32_t w00 = bf16x2(w[0], w[0]), w01 = bf16x2(w[1], w[1]);
    const uint32_t w10 = bf16x2(w[2], w[2]), w11 = bf16x2(w[3], w[3]);
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t p00 = mul_bf16x2(t00[j], w00), p01 = mul_bf16x2(t01[j], w01);
      const uint32_t p10 = mul_bf16x2(t10[j], w10), p11 = mul_bf16x2(t11[j], w11);
      // The lower address is the low half; a bf16 is the top half of an fp32.
      const float lo = __fadd_rn(__fadd_rn(__fadd_rn(bf16_bits_to_float(p00 & 0xffffu),
                                                     bf16_bits_to_float(p01 & 0xffffu)),
                                           bf16_bits_to_float(p10 & 0xffffu)),
                                 bf16_bits_to_float(p11 & 0xffffu));
      const float hi = __fadd_rn(__fadd_rn(__fadd_rn(__uint_as_float(p00 & 0xffff0000u),
                                                     __uint_as_float(p01 & 0xffff0000u)),
                                           __uint_as_float(p10 & 0xffff0000u)),
                                 __uint_as_float(p11 & 0xffff0000u));
      const uint32_t d = sub_bf16x2(bf16x2(lo, hi), r[j]);
      o[j] = mul_bf16x2(d, d);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// src: (B, Hs, Ws, C); x, y: (B, Db, P) fp32; ref: (B, P, C); out: (B, Db,
// P, C).  items = B * P * (C / kVec) threads' worth of work.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    warp_residual_kernel(const T* __restrict__ src, const float* __restrict__ xs,
                         const float* __restrict__ ys, const T* __restrict__ ref,
                         T* __restrict__ out, int64_t items, int64_t pixels, int slots,
                         int block, int src_height, int src_width, int channels) {
  const int64_t t = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (t >= items) return;
  const int slot = (int)(t % slots);
  const int64_t bp = t / slots;  // b * P + p
  const int64_t b = bp / pixels, p = bp - b * pixels;
  const int c0 = slot * kVec;
  Lane<T, kVec> lane;
  lane.load_ref(ref + bp * channels + c0);
  const T* plane = src + b * src_height * src_width * channels + c0;
  const float last_x = (float)(src_width - 1), last_y = (float)(src_height - 1);
  const int64_t row = (int64_t)src_width * channels;
#pragma unroll 4
  for (int k = 0; k < block; ++k) {
    const int64_t ci = (b * block + k) * pixels + p;
    const float x = __ldg(xs + ci), y = __ldg(ys + ci);
    const float xb = fminf(fmaxf(floorf(x), 0.0f), last_x);
    const float yb = fminf(fmaxf(floorf(y), 0.0f), last_y);
    const float tx0 = tent(__fsub_rn(x, xb)), tx1 = tent(__fsub_rn(x, __fadd_rn(xb, 1.0f)));
    const float ty0 = tent(__fsub_rn(y, yb)), ty1 = tent(__fsub_rn(y, __fadd_rn(yb, 1.0f)));
    const float w[4] = {__fmul_rn(ty0, tx0), __fmul_rn(ty0, tx1), __fmul_rn(ty1, tx0),
                        __fmul_rn(ty1, tx1)};
    const int ix = (int)xb, iy = (int)yb;
    lane.residual(plane + iy * row + (int64_t)ix * channels, ix + 1 < src_width,
                  iy + 1 < src_height, row, channels, w, out + ci * channels + c0);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int kVec>
cudaError_t launch_as(const void* src, const float* x, const float* y, const void* ref,
                      void* out, int64_t batch, int64_t block, int64_t pixels,
                      int64_t src_height, int64_t src_width, int64_t channels,
                      cudaStream_t stream) {
  const int slots = (int)(channels / kVec);
  const int64_t items = batch * pixels * slots;
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  warp_residual_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src), x, y, static_cast<const T*>(ref), static_cast<T*>(out),
      items, pixels, slots, (int)block, (int)src_height, (int)src_width, (int)channels);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* src, const float* x, const float* y, const void* ref,
                   void* out, int64_t batch, int64_t block, int64_t pixels,
                   int64_t src_height, int64_t src_width, int64_t channels,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vectorizable = channels % kVec == 0 && aligned16(src) && aligned16(ref) &&
                            aligned16(out);
  return vectorizable
             ? launch_as<T, kVec>(src, x, y, ref, out, batch, block, pixels, src_height,
                                  src_width, channels, stream)
             : launch_as<T, 1>(src, x, y, ref, out, batch, block, pixels, src_height,
                               src_width, channels, stream);
}

}  // namespace

// dtype (of src, ref and out): 0 = float32, 1 = bfloat16; x and y are
// float32.  Returns a cudaError_t: 0 on success, cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int warp_residual_forward(const void* src, const void* x, const void* y,
                                     const void* ref, void* out, long long batch,
                                     long long block, long long pixels, long long src_height,
                                     long long src_width, long long channels, int dtype,
                                     void* stream) {
  if (batch < 0 || block < 0 || pixels < 0 || src_height <= 0 || src_width <= 0 ||
      channels <= 0 || block >= (int64_t(1) << 31) || src_height >= (int64_t(1) << 24) ||
      src_width >= (int64_t(1) << 24) || channels >= (int64_t(1) << 31) ||
      src_height * src_width >= (int64_t(1) << 31) ||
      batch * pixels * channels >= (int64_t(1) << 31) * kThreads)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || block == 0 || pixels == 0) return (int)cudaSuccess;
  const float* xs = static_cast<const float*>(x);
  const float* ys = static_cast<const float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(src, xs, ys, ref, out, batch, block, pixels, src_height,
                              src_width, channels, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(src, xs, ys, ref, out, batch, block, pixels,
                                      src_height, src_width, channels, s);
  return (int)cudaErrorInvalidValue;
}
