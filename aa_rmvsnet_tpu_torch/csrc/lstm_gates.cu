// Fused ConvLSTM gate forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel aa_rmvsnet_tpu/ops/pallas/gates.py:_gate_kernel.
// Per element of the cell state c, with the gate-conv output z split into
// (i, f, o, g):
//
//     c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')
//
// Bound: device-memory bytes.  In fp32 each element of c costs 28 B: five
// 4-byte reads (i, f, o, g, c) and two 4-byte writes (h', c'); the math is a
// few dozen flops, far below the card's flop/byte balance.  The design
// therefore moves each byte once: z is read in place, by channel offset, in
// the NCHW layout the gate conv writes (no split copies and none of the TPU
// kernel's (rows, 128) padding), and both outputs come out of the same pass.
// Neighbouring threads touch neighbouring pixels, so every load and store is
// coalesced.  The math runs in fp32 whatever the storage type, with the
// accurate expf/tanhf (no fast-math intrinsics: the fp32 bar is 1e-6).
//
// Layout: z is (B, 4*hidden, H, W) and c, h', c' are (B, hidden, H, W), all
// contiguous.  Gate k of batch b, channel ch, pixel p sits at
// z[b, k*hidden + ch, p], i.e. at b*4*hidden*HW + k*hidden*HW + (ch*HW + p).

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
cudaError_t launch(const void* z, const void* c, void* h_out, void* c_out,
                   int64_t batch, int64_t plane, cudaStream_t stream) {
  const int64_t total = batch * plane;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  // One element per thread up to a grid of 64 blocks per SM; larger inputs
  // loop (grid-stride) instead of launching more blocks.
  int64_t blocks = (total + threads - 1) / threads;
  const int64_t cap = 132 * 64;
  if (blocks > cap) blocks = cap;
  lstm_gates_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(c),
      static_cast<T*>(h_out), static_cast<T*>(c_out), plane, total);
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
