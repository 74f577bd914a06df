// Fused ConvLSTM gate forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of aa_rmvsnet_tpu/ops/pallas/gates.py:
// _gate_kernel (forward) and _gate_bwd_kernel (backward).  Per element of
// the cell state c, with the gate-conv output z split into (i, f, o, g):
//
//     c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')
//
// and, given the cotangents dh of h' and dc' of c', the backward
// recomputes the activations from (z, c) instead of storing them:
//
//     dc_total = dc' + dh * o * (1 - tanh(c')^2)
//     do = dh * tanh(c') * o (1 - o)      df = dc_total * c * f (1 - f)
//     di = dc_total * g * i (1 - i)       dg = dc_total * i (1 - g^2)
//     dc = dc_total * f
//
// Bound: device-memory bytes.  In fp32 each element of c costs 28 B in the
// forward (five 4-byte reads: i, f, o, g, c; two writes: h', c') and 48 B
// in the backward (seven reads: i, f, o, g, c, dh, dc'; five writes: di,
// df, do, dg, dc); in bf16 half of that.  The math is a few dozen flops,
// far below the card's flop/byte balance.  The design therefore moves each
// byte once: z and dz are read and written in place, by channel offset, in
// the NCHW layout the gate conv writes and its backward reads (no split
// copies, no concat, and none of the TPU kernel's (rows, 128) padding), and
// all outputs of a direction come out of one pass.  Neighbouring threads
// touch neighbouring pixels, so every load and store is coalesced.  The
// math runs in fp32 whatever the storage type.
//
// At 14 B an element (the bf16 forward) the byte bound leaves the card's
// warp schedulers time for ~140 thread instructions an element at 1.98 GHz,
// and the accurate math alone takes ~130 (the SASS), so the instruction
// count matters as much as the bytes.  Both directions share one layout,
// laid out for Hopper:
//
// - No division, 32-bit offsets.  A 2D grid: blockIdx.y is the batch
//   (looping past 65,535) and blockIdx.x a tile of that batch's plane, so
//   no thread divides.  Each batch has one 64-bit base; offsets inside a
//   plane are 32-bit (the wrapper raises for a plane of 2^31 elements or
//   more).  A grid-stride loop over the flat index would pay an emulated
//   64-bit division per element to find the batch (PERF.md, Findings).
// - 16-byte accesses.  A thread takes kVec consecutive elements of each
//   stream (4 fp32 or 8 bf16: one float4 / uint4), issues every load
//   before any math, and writes one 16-byte store per output.  A plane
//   that is not a multiple of kVec (gates 1-3 of z then start off the
//   16-byte grid) or a pointer that is not 16-byte aligned (a contiguous
//   view at a storage offset) launches the same kernel with kVec = 1:
//   scalar accesses over the whole tensor.
// - Default cache policy.  Evict-first loads (__ldcs) of the single-use
//   inputs, two vectors a thread, 128- or 512-thread blocks, a 32-register
//   cap and a TMA bulk-copy ring in shared memory were each measured on the
//   backward (PERF.md, Findings) and were each as fast or slower.  Stores
//   keep the default policy in any case: the next cell's gate conv reads h'
//   and the next depth step reads c'; the gate conv's backward reads dz
//   and the previous step's backward reads dc.
// - Accurate activations, expf and tanhf, in both storage types (no
//   fast-math intrinsics: the fp32 bars are 1e-6 forward, 1e-5 backward).
//   The bf16 forward on tanh.approx.f32 was 6 % faster, and rounded 0.25 %
//   of its outputs one ulp away from the plain version's against 0.002 %;
//   the accurate build already reaches 78 % of its bound (PERF.md, Findings).
//
// Layout: z and dz are (B, 4*hidden, H, W) and c, h', c', dh, dc', dc are
// (B, hidden, H, W), all contiguous.  Gate k of batch b, channel ch, pixel
// p sits at z[b, k*hidden + ch, p], i.e. at
// b*4*hidden*HW + k*hidden*HW + (ch*HW + p).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// kVec consecutive elements at p as fp32: one 16-byte load for a whole
// vector, else kVec scalar loads.
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

constexpr int kThreads = 256;

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
lstm_gates_kernel(const T* __restrict__ z, const T* __restrict__ c,
                  T* __restrict__ h_out, T* __restrict__ c_out, int64_t batch,
                  unsigned plane)  // hidden * H * W < 2^31, a multiple of kVec
{
  const unsigned p = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (p >= plane) return;
  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    const int64_t cell = b * plane;
    const T* zi = z + 4 * cell + p;  // gate k at zi + k * plane
    float vi[kVec], vf[kVec], vo[kVec], vg[kVec], vc[kVec];
    load_vec<kVec>(zi, vi);
    load_vec<kVec>(zi + plane, vf);
    load_vec<kVec>(zi + 2 * (int64_t)plane, vo);
    load_vec<kVec>(zi + 3 * (int64_t)plane, vg);
    load_vec<kVec>(c + cell + p, vc);
    // Outputs overwrite the inputs they no longer need: h' -> vi, c' -> vc.
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float c_next = sigmoid_f32(vf[j]) * vc[j] + sigmoid_f32(vi[j]) * tanhf(vg[j]);
      vi[j] = sigmoid_f32(vo[j]) * tanhf(c_next);
      vc[j] = c_next;
    }
    store_vec<kVec>(h_out + cell + p, vi);
    store_vec<kVec>(c_out + cell + p, vc);
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
lstm_gates_bwd_kernel(const T* __restrict__ z, const T* __restrict__ c,
                      const T* __restrict__ dh, const T* __restrict__ dc_next,
                      T* __restrict__ dz, T* __restrict__ dc_out,
                      int64_t batch,
                      unsigned plane)  // hidden * H * W < 2^31, a multiple of kVec
{
  const unsigned p = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (p >= plane) return;
  for (int64_t b = blockIdx.y; b < batch; b += gridDim.y) {
    const int64_t cell = b * plane;
    const T* zi = z + 4 * cell + p;  // gate k at zi + k * plane
    T* dzi = dz + 4 * cell + p;
    float vi[kVec], vf[kVec], vo[kVec], vg[kVec], vc[kVec], vdh[kVec], vdc[kVec];
    load_vec<kVec>(zi, vi);
    load_vec<kVec>(zi + plane, vf);
    load_vec<kVec>(zi + 2 * (int64_t)plane, vo);
    load_vec<kVec>(zi + 3 * (int64_t)plane, vg);
    load_vec<kVec>(c + cell + p, vc);
    load_vec<kVec>(dh + cell + p, vdh);
    load_vec<kVec>(dc_next + cell + p, vdc);
    // Outputs overwrite the inputs they no longer need:
    // di -> vi, df -> vf, do -> vo, dg -> vg, dc -> vc.
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float i = sigmoid_f32(vi[j]);
      const float f = sigmoid_f32(vf[j]);
      const float o = sigmoid_f32(vo[j]);
      const float g = tanhf(vg[j]);
      const float cv = vc[j];
      const float tc = tanhf(f * cv + i * g);
      const float dhv = vdh[j];
      const float dct = vdc[j] + dhv * o * (1.0f - tc * tc);
      vi[j] = dct * g * i * (1.0f - i);
      vf[j] = dct * cv * f * (1.0f - f);
      vo[j] = dhv * tc * o * (1.0f - o);
      vg[j] = dct * i * (1.0f - g * g);
      vc[j] = dct * f;
    }
    store_vec<kVec>(dzi, vi);
    store_vec<kVec>(dzi + plane, vf);
    store_vec<kVec>(dzi + 2 * (int64_t)plane, vo);
    store_vec<kVec>(dzi + 3 * (int64_t)plane, vg);
    store_vec<kVec>(dc_out + cell + p, vc);
  }
}

// One launch's tensors.  The forward has no dh or dc' (null) and writes
// (out0, out1) = (h', c'); the backward writes (dz, dc).
struct Args {
  const void *z, *c, *dh, *dc_next;
  void *out0, *out1;
  int64_t batch, plane;
  cudaStream_t stream;
};

struct Forward {
  template <typename T, int kVec>
  static void run(dim3 grid, const Args& a) {
    lstm_gates_kernel<T, kVec><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.z), static_cast<const T*>(a.c),
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.batch,
        (unsigned)a.plane);
  }
};

struct Backward {
  template <typename T, int kVec>
  static void run(dim3 grid, const Args& a) {
    lstm_gates_bwd_kernel<T, kVec><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.z), static_cast<const T*>(a.c),
        static_cast<const T*>(a.dh), static_cast<const T*>(a.dc_next),
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.batch,
        (unsigned)a.plane);
  }
};

template <typename Direction, typename T, int kVec>
cudaError_t launch_as(const Args& a) {
  constexpr int64_t tile = kThreads * kVec;
  const dim3 grid((unsigned)((a.plane + tile - 1) / tile),
                  (unsigned)(a.batch < 65535 ? a.batch : 65535));
  Direction::template run<T, kVec>(grid, a);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte accesses where every stream allows them, else scalar ones.
template <typename Direction, typename T>
cudaError_t launch(const Args& a) {
  if (a.batch == 0 || a.plane == 0) return cudaSuccess;
  if (a.plane >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  const bool vectorizable = a.plane % kVec == 0 && aligned16(a.z) && aligned16(a.c) &&
                            aligned16(a.dh) && aligned16(a.dc_next) &&
                            aligned16(a.out0) && aligned16(a.out1);
  return vectorizable ? launch_as<Direction, T, kVec>(a)
                      : launch_as<Direction, T, 1>(a);
}

template <typename Direction>
int launch_dtype(const Args& a, int dtype) {
  if (dtype == 0) return (int)launch<Direction, float>(a);
  if (dtype == 1) return (int)launch<Direction, __nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Both entry points return a cudaError_t:
// 0 on success, cudaErrorInvalidValue for a plane of 2^31 elements or more.
extern "C" int lstm_gates_forward(const void* z, const void* c, void* h_out,
                                  void* c_out, long long batch,
                                  long long plane, int dtype, void* stream) {
  return launch_dtype<Forward>(
      Args{z, c, nullptr, nullptr, h_out, c_out, batch, plane,
           static_cast<cudaStream_t>(stream)},
      dtype);
}

extern "C" int lstm_gates_backward(const void* z, const void* c,
                                   const void* dh, const void* dc_next,
                                   void* dz, void* dc_out, long long batch,
                                   long long plane, int dtype, void* stream) {
  return launch_dtype<Backward>(
      Args{z, c, dh, dc_next, dz, dc_out, batch, plane,
           static_cast<cudaStream_t>(stream)},
      dtype);
}
