// Fused SDF corner decode: positional encoding + 3-hidden-layer ReLU MLP +
// trilinear blend, one thread per sample point.
//
// Replaces the Pallas TPU kernel bnv_fusion_tpu/kernels/fused_decode.py
// (fused_corner_decode, body _kernel at :37-60).  Per point p and corner c:
//   x    = [l, sin l, cos l, feat_c]          (l = local offset, 9 + F)
//   a_c  = W_out relu(W2 relu(W1 relu(W0 x + b0) + b1) + b2) + b_out
//   out  = sum_c a_c * voxel_size * tw[p, c]
// Forward only: the optimization loss keeps the plain path for autograd.
//
// What bounds it on this card: each point costs 8 x (17x64 + 64x64 + 64x64
// + 64) ~ 75k FMAs against 384 bytes of input, so with plain f32 FMAs (no
// tensor cores in this version) the kernel is bound by FMA and shared-memory
// issue, not by device memory.  The plain version's cost is the device
// memory traffic of its [N, 8, 17] and [N, 8, 64] intermediates, which this
// kernel never writes.  Design:
//   * the decoder's ~9.5k weights (38 KB) sit in shared memory; every
//     thread of a warp reads the same weight (a broadcast), four at a time;
//   * each thread keeps one 64-wide layer output in registers and its
//     activation column in shared memory, laid out [unit][thread] so a warp
//     touches 32 consecutive banks.  A thread only reads and writes its own
//     column, so layers need no barrier;
//   * device memory sees the inputs once and one float per point.  Any N
//     is taken; the ragged edge is masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;          // hidden width of the tcnn decoder topology
constexpr int kThreads = 256;   // points per block

template <int F>
struct Layout {
  static constexpr int kDin = 9 + F;
  static constexpr int kW0 = 0;
  static constexpr int kB0 = kW0 + kDin * kH;
  static constexpr int kW1 = kB0 + kH;
  static constexpr int kB1 = kW1 + kH * kH;
  static constexpr int kW2 = kB1 + kH;
  static constexpr int kB2 = kW2 + kH * kH;
  static constexpr int kWo = kB2 + kH;
  static constexpr int kBo = kWo + kH;
  static constexpr int kTotal = kBo + 1;
  static constexpr int kAct = (kTotal + 3) / 4 * 4;   // 16-byte aligned
  static constexpr size_t kSmemBytes =
      (size_t)(kAct + kH * kThreads) * sizeof(float);
};

// act[:, t] <- relu(W^T act[0:DIN, t] + b), W [DIN, kH] row-major in shared
template <int DIN>
__device__ __forceinline__ void dense_relu(float* __restrict__ act,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias,
                                           int t) {
  float acc[kH];
#pragma unroll
  for (int o = 0; o < kH; ++o) acc[o] = bias[o];
#pragma unroll 2
  for (int i = 0; i < DIN; ++i) {
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

template <int F>
__global__ void __launch_bounds__(kThreads, 2)
fused_corner_decode_kernel(const float* __restrict__ local,
                           const float* __restrict__ feats,
                           const float* __restrict__ tw,
                           const float* __restrict__ packed, float voxel_size,
                           int n, float* __restrict__ out) {
  using L = Layout<F>;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* act = sw + L::kAct;
  for (int i = threadIdx.x; i < L::kTotal; i += kThreads) sw[i] = packed[i];
  __syncthreads();
  const int t = threadIdx.x;
  const int p = blockIdx.x * kThreads + t;
  if (p >= n) return;  // no barrier below this point

  float acc = 0.f;
  for (int c = 0; c < 8; ++c) {
    const size_t pc = (size_t)p * 8 + c;
    const float lx = local[pc * 3 + 0], ly = local[pc * 3 + 1],
                lz = local[pc * 3 + 2];
    act[0 * kThreads + t] = lx;
    act[1 * kThreads + t] = ly;
    act[2 * kThreads + t] = lz;
    act[3 * kThreads + t] = sinf(lx);
    act[4 * kThreads + t] = sinf(ly);
    act[5 * kThreads + t] = sinf(lz);
    act[6 * kThreads + t] = cosf(lx);
    act[7 * kThreads + t] = cosf(ly);
    act[8 * kThreads + t] = cosf(lz);
#pragma unroll
    for (int i = 0; i < F; ++i) act[(9 + i) * kThreads + t] = feats[pc * F + i];

    dense_relu<L::kDin>(act, sw + L::kW0, sw + L::kB0, t);
    dense_relu<kH>(act, sw + L::kW1, sw + L::kB1, t);
    dense_relu<kH>(act, sw + L::kW2, sw + L::kB2, t);
    float a = sw[L::kBo];
#pragma unroll 8
    for (int i = 0; i < kH; ++i) a = fmaf(act[i * kThreads + t], sw[L::kWo + i], a);
    acc += a * voxel_size * tw[pc];
  }
  out[p] = acc;
}

template <int F>
int launch(const float* local, const float* feats, const float* tw,
           const float* packed, float voxel_size, int n, float* out,
           cudaStream_t s) {
  const size_t smem = Layout<F>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_corner_decode_kernel<F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  fused_corner_decode_kernel<F><<<blocks, kThreads, smem, s>>>(
      local, feats, tw, packed, voxel_size, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// local [n, 8, 3], feats [n, 8, F], tw [n, 8] f32; packed = the decoder's
// w0 [9+F, 64], b0, w1 [64, 64], b1, w2 [64, 64], b2, w_out [64], b_out
// concatenated (device memory); out [n].  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a latent width other than 8 (the only one the
// repo's configs use, feature_vector_size: 8).
extern "C" int bnv_fused_corner_decode(const float* local, const float* feats,
                                       const float* tw, const float* packed,
                                       int F, float voxel_size, int n,
                                       float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (F != 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch<8>(local, feats, tw, packed, voxel_size, n, out, s);
}
