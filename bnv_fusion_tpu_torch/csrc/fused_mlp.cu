// Fused ReLU MLP: a whole din -> 64 -> 64 -> 64 -> dout stack (ReLU after
// each hidden layer, none after the last) in one kernel, one thread per row.
//
// Replaces the Pallas TPU kernel bnv_fusion_tpu/kernels/fused_mlp.py:79
// (fused_mlp_feature_major, body _mlp_kernel at :59-76).  The TPU kernel
// keeps activations feature-major ([d, M]) to dodge 128-lane padding of the
// narrow feature dims; that layout is a TPU workaround and does not carry
// over: this kernel takes and returns row-major x [M, din] -> y [M, dout],
// the API of FusedMLP / nn.mlp_apply.  Serves the tcnn topology of every
// MLP the package builds (n_neurons 64, 3 hidden layers): the encoder
// 6 -> 8 and the decoder 17 -> 1, generally din <= 32 and dout <= 16.
//
// What bounds it on this card: a row costs din*64 + 2*64*64 + 64*dout FMAs
// (9,088 for the encoder, 18,176 flop) against (din + dout) * 4 bytes of
// I/O (56 B for the encoder), so at the encoder's M = 2,457,600 rows the
// f32 FMA peak (67 TFLOP/s) gives 0.67 ms and device memory (3.35 TB/s)
// 0.04 ms: plain f32 FMAs (no tensor cores in this version) make it bound
// by the rate of FMA and shared-memory instructions, not by device memory.
// The plain version's cost is the device memory traffic of three [M, 64]
// intermediates, which this kernel never writes.  Design (that of
// csrc/fused_decode.cu):
//   * the ~11.5k packed weights (<= 46 KB) sit in shared memory; every
//     thread of a warp reads the same weight (a broadcast), four at a time;
//   * each thread keeps one 64-wide layer output in registers (the layer's
//     outputs unrolled, the loop over inputs not) and its activation column
//     in shared memory laid out [unit][thread], so a warp touches 32
//     consecutive banks.  A thread only reads and writes its own column, so
//     layers need no barrier;
//   * the block's [256, din] input tile is read coalesced into the column
//     layout, and the [256, dout] output tile written back coalesced from
//     it: device memory sees each input and output once.  Any M is taken;
//     the ragged edge is masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;          // hidden width (tcnn n_neurons)
constexpr int kThreads = 256;   // rows per block
constexpr int kMaxIn = 32;
constexpr int kMaxOut = 16;

// packed = w0 [din, 64], b0 [64], w1 [64, 64], b1, w2 [64, 64], b2,
// w_out [64, DP], b_out [DP] (DP = dout padded to 1, 4, 8 or 16 with zeros)
__host__ __device__ inline int off_w1(int din) { return din * kH + kH; }
__host__ __device__ inline int off_w2(int din) {
  return off_w1(din) + kH * kH + kH;
}
__host__ __device__ inline int off_wo(int din) {
  return off_w2(din) + kH * kH + kH;
}
__host__ __device__ inline int packed_total(int din, int dp) {
  return off_wo(din) + kH * dp + dp;
}
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// act[:, t] <- relu(W^T act[0:din, t] + b), W [din, kH] row-major in shared
__device__ __forceinline__ void dense_relu(float* __restrict__ act,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias,
                                           int din, int t) {
  float acc[kH];
#pragma unroll
  for (int o = 0; o < kH; ++o) acc[o] = bias[o];
#pragma unroll 2
  for (int i = 0; i < din; ++i) {
    const float xi = act[i * kThreads + t];
    const float4* w4 = reinterpret_cast<const float4*>(W + i * kH);
#pragma unroll
    for (int q = 0; q < kH / 4; ++q) {
      const float4 w = w4[q];
      acc[4 * q + 0] = fmaf(xi, w.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(xi, w.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(xi, w.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(xi, w.w, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int o = 0; o < kH; ++o) act[o * kThreads + t] = fmaxf(acc[o], 0.f);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_kernel(const float* __restrict__ x,
                 const float* __restrict__ packed, int din, int dout,
                 long long m, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const int total = packed_total(din, DP);
  float* act = sw + round4(total);
  for (int i = threadIdx.x; i < total; i += kThreads) sw[i] = packed[i];

  const long long row0 = (long long)blockIdx.x * kThreads;
  const int rows = (int)min((long long)kThreads, m - row0);
  const float* xb = x + row0 * din;
  for (int e = threadIdx.x; e < rows * din; e += kThreads) {
    const int r = e / din;
    act[(e - r * din) * kThreads + r] = xb[e];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    dense_relu(act, sw, sw + din * kH, din, t);
    dense_relu(act, sw + off_w1(din), sw + off_w1(din) + kH * kH, kH, t);
    dense_relu(act, sw + off_w2(din), sw + off_w2(din) + kH * kH, kH, t);
    const float* W = sw + off_wo(din);
    float acc[DP];
#pragma unroll
    for (int o = 0; o < DP; ++o) acc[o] = W[kH * DP + o];
#pragma unroll 4
    for (int i = 0; i < kH; ++i) {
      const float xi = act[i * kThreads + t];
#pragma unroll
      for (int o = 0; o < DP; ++o) acc[o] = fmaf(xi, W[i * DP + o], acc[o]);
    }
#pragma unroll
    for (int o = 0; o < DP; ++o) act[o * kThreads + t] = acc[o];
  }
  __syncthreads();

  float* ob = out + row0 * dout;
  for (int e = threadIdx.x; e < rows * dout; e += kThreads) {
    const int r = e / dout;
    ob[e] = act[(e - r * dout) * kThreads + r];
  }
}

template <int DP>
int launch(const float* x, const float* packed, int din, int dout,
           long long m, float* out, cudaStream_t s) {
  const size_t smem =
      (size_t)(round4(packed_total(din, DP)) + kH * kThreads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (m + kThreads - 1) / kThreads;
  fused_mlp_kernel<DP><<<(unsigned)blocks, kThreads, smem, s>>>(
      x, packed, din, dout, m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of floats of the packed weights for (din, dout): the wrapper packs
// to this layout (w_out and b_out zero-padded to the kernel's output width).
extern "C" int bnv_fused_mlp_packed_size(int din, int dout) {
  const int dp = dout <= 1 ? 1 : dout <= 4 ? 4 : dout <= 8 ? 8 : 16;
  return packed_total(din, dp);
}

// x [m, din] f32 row-major, packed weights (device memory, layout above),
// out [m, dout].  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// din outside [1, 32], dout outside [1, 16] or m >= 2^31 * 256.
extern "C" int bnv_fused_mlp(const float* x, const float* packed, int din,
                             int dout, long long m, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (din < 1 || din > kMaxIn || dout < 1 || dout > kMaxOut ||
      m >= (1LL << 31) * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  if (dout <= 1) return launch<1>(x, packed, din, dout, m, out, s);
  if (dout <= 4) return launch<4>(x, packed, din, dout, m, out, s);
  if (dout <= 8) return launch<8>(x, packed, din, dout, m, out, s);
  return launch<16>(x, packed, din, dout, m, out, s);
}
