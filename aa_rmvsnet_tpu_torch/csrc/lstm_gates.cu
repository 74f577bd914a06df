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
// df, do, dg, dc); the math is a few dozen flops, far below the card's
// flop/byte balance.  The design therefore moves each byte once: z and dz
// are read and written in place, by channel offset, in the NCHW layout the
// gate conv writes and its backward reads (no split copies, no concat, and
// none of the TPU kernel's (rows, 128) padding), and all outputs of a
// direction come out of one pass.  Neighbouring threads touch neighbouring
// pixels, so every load and store is coalesced.  The math runs in fp32
// whatever the storage type, with the accurate expf/tanhf (no fast-math
// intrinsics: the fp32 bars are 1e-6 forward, 1e-5 backward).
//
// Layout: z and dz are (B, 4*hidden, H, W) and c, h', c', dh, dc', dc are
// (B, hidden, H, W), all contiguous.  Gate k of batch b, channel ch, pixel
// p sits at z[b, k*hidden + ch, p], i.e. at
// b*4*hidden*HW + k*hidden*HW + (ch*HW + p).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void lstm_gates_kernel(const T* __restrict__ z,
                                  const T* __restrict__ c,
                                  T* __restrict__ h_out,
                                  T* __restrict__ c_out,
                                  int64_t plane,  // hidden * H * W
                                  int64_t total)  // batch * plane
{
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t b = idx / plane;
    const T* zb = z + b * 4 * plane + (idx - b * plane);
    const float i = sigmoid_f32(load_f32(zb));
    const float f = sigmoid_f32(load_f32(zb + plane));
    const float o = sigmoid_f32(load_f32(zb + 2 * plane));
    const float g = tanhf(load_f32(zb + 3 * plane));
    const float c_next = f * load_f32(c + idx) + i * g;
    store_f32(h_out + idx, o * tanhf(c_next));
    store_f32(c_out + idx, c_next);
  }
}

template <typename T>
__global__ void lstm_gates_bwd_kernel(const T* __restrict__ z,
                                      const T* __restrict__ c,
                                      const T* __restrict__ dh,
                                      const T* __restrict__ dc_next,
                                      T* __restrict__ dz,
                                      T* __restrict__ dc_out,
                                      int64_t plane,  // hidden * H * W
                                      int64_t total)  // batch * plane
{
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t b = idx / plane;
    const int64_t offset = b * 4 * plane + (idx - b * plane);
    const T* zb = z + offset;
    const float i = sigmoid_f32(load_f32(zb));
    const float f = sigmoid_f32(load_f32(zb + plane));
    const float o = sigmoid_f32(load_f32(zb + 2 * plane));
    const float g = tanhf(load_f32(zb + 3 * plane));
    const float cv = load_f32(c + idx);
    const float tc = tanhf(f * cv + i * g);
    const float dhv = load_f32(dh + idx);
    const float dct = load_f32(dc_next + idx) + dhv * o * (1.0f - tc * tc);
    T* dzb = dz + offset;
    store_f32(dzb, dct * g * i * (1.0f - i));
    store_f32(dzb + plane, dct * cv * f * (1.0f - f));
    store_f32(dzb + 2 * plane, dhv * tc * o * (1.0f - o));
    store_f32(dzb + 3 * plane, dct * i * (1.0f - g * g));
    store_f32(dc_out + idx, dct * f);
  }
}

// One element per thread up to a grid of 64 blocks per SM; larger inputs
// loop (grid-stride) instead of launching more blocks.
inline unsigned grid_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  const int64_t cap = 132 * 64;
  return (unsigned)(blocks > cap ? cap : blocks);
}

constexpr int kThreads = 256;

template <typename T>
cudaError_t launch(const void* z, const void* c, void* h_out, void* c_out,
                   int64_t batch, int64_t plane, cudaStream_t stream) {
  const int64_t total = batch * plane;
  if (total == 0) return cudaSuccess;
  lstm_gates_kernel<T><<<grid_for(total, kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(c),
      static_cast<T*>(h_out), static_cast<T*>(c_out), plane, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* z, const void* c, const void* dh,
                       const void* dc_next, void* dz, void* dc_out,
                       int64_t batch, int64_t plane, cudaStream_t stream) {
  const int64_t total = batch * plane;
  if (total == 0) return cudaSuccess;
  lstm_gates_bwd_kernel<T><<<grid_for(total, kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(c),
      static_cast<const T*>(dh), static_cast<const T*>(dc_next),
      static_cast<T*>(dz), static_cast<T*>(dc_out), plane, total);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int lstm_gates_forward(const void* z, const void* c, void* h_out,
                                  void* c_out, long long batch,
                                  long long plane, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(z, c, h_out, c_out, batch, plane, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(z, c, h_out, c_out, batch, plane, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int lstm_gates_backward(const void* z, const void* c,
                                   const void* dh, const void* dc_next,
                                   void* dz, void* dc_out, long long batch,
                                   long long plane, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(z, c, dh, dc_next, dz, dc_out, batch, plane, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(z, c, dh, dc_next, dz, dc_out, batch,
                                          plane, s);
  return (int)cudaErrorInvalidValue;
}
