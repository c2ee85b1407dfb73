// Fused SDF corner decode: positional encoding + 3-hidden-layer ReLU MLP +
// trilinear blend, the hidden layers on the tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel bnv_fusion_tpu/kernels/fused_decode.py
// (fused_corner_decode, body _kernel at :37-60).  Per point p and corner c:
//   x    = [l, sin l, cos l, feat_c]          (l = local offset, 9 + F)
//   a_c  = W_out relu(W2 relu(W1 relu(W0 x + b0) + b1) + b2) + b_out
//   out  = sum_c a_c * voxel_size * tw[p, c]
// Forward only: the optimization loss keeps the plain path for autograd.
//
// What bounds it on this card: operations.  A point costs 8 corners x
// (17x64 + 64x64 + 64x64 + 64) ~ 75k multiply-adds against 384 bytes of
// input.  On f32 FMAs that is ~0.59 ms per 2^18 points at the 67 TFLOP/s
// f32 peak; the three hidden products are dense 64-wide matrix products,
// so here they run on the tensor cores (mma.sync.m16n8k8, TF32).  One TF32
// pass misses the 1e-4 x voxel bound, so every product is 3xTF32
// (mlp_tc.cuh): three TF32 products at 495 TFLOP/s, ~0.24 ms per 2^18
// points.  mma.sync needs no descriptors or swizzled layouts; wgmma is
// the route to the full rate (PERF.md).  Design:
//   * rows are (point, corner) pairs, point-major: a 16-row tile holds 2
//     points x 8 corners, row g the corner g of the first point and row
//     g+8 the corner g of the second (g = lane / 4).  Each warp keeps
//     MT = 2 such tiles (4 points) in registers from the inputs to the
//     output; activations never leave the registers (mlp_tc.cuh's note
//     gives the fragment mapping and the weight-row permutation that make
//     one layer's accumulators the next layer's A operand);
//   * layer 0's 17 inputs are padded to 24 (3 k-steps) in an order chosen
//     so that each of a row's 4 lanes computes its own columns: lane t
//     loads latents t and t+4 (k-step 0) and, for t < 3, offset l_t,
//     sin l_t (k-step 1) and cos l_t (k-step 2); lane 3 and the last 4
//     columns are zero, and the packed w0 (kernels/fused_decode.py) has its
//     rows in that order with zero rows for the padding;
//   * the packed weights (hi/lo split, permuted, in fragment order, ~77 KB)
//     are loaded into shared memory once per block; the grid is persistent
//     (one block per SM slot, warps stride over 4-point units) and each
//     warp loads the next unit's inputs before it computes the current one;
//   * the 64->1 output layer runs on FMAs over each lane's 16 columns, then
//     two shuffles sum a row's 4 lanes and three more blend the 8 corners
//     (lanes g = 0..7) into the point's value.  Device memory sees the
//     inputs once and one float per point.  Any N is taken; the ragged
//     edge is masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tc.cuh"

namespace {

// block shape, tuned on the H100 (PERF.md)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                 // 16-row tiles per warp
constexpr int kUnit = 2 * kMT;         // points per warp iteration

// packed layout, in floats (kernels/fused_decode.py pack_decoder_tc)
constexpr int kW0 = 0;                               // 3 k-steps
constexpr int kW1 = kW0 + 3 * 8 * 32 * 4;            // 8 k-steps
constexpr int kW2 = kW1 + 8 * 8 * 32 * 4;
constexpr int kB0 = kW2 + 8 * 8 * 32 * 4;
constexpr int kB1 = kB0 + 64;
constexpr int kB2 = kB1 + 64;
constexpr int kWo = kB2 + 64;
constexpr int kBo = kWo + 64;
constexpr int kTotal = (kBo + 1 + 3) / 4 * 4;
constexpr size_t kSmemBytes = (size_t)kTotal * sizeof(float);

// one warp's raw inputs for MT tiles: rows g (h = 0) and g + 8 (h = 1)
struct Inputs {
  float fa[kMT][2], fb[kMT][2], l[kMT][2], tw[kMT][2];
};

template <int F>
__device__ __forceinline__ void load_unit(const float* __restrict__ local,
                                          const float* __restrict__ feats,
                                          const float* __restrict__ tw,
                                          int p0, int n, int g, int t,
                                          Inputs& in) {
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 2 * m + h;
      const bool ok = p < n;
      const size_t pc = (size_t)(ok ? p : 0) * 8 + g;
      in.fa[m][h] = ok ? __ldg(feats + pc * F + t) : 0.f;
      in.fb[m][h] = ok ? __ldg(feats + pc * F + t + 4) : 0.f;
      in.l[m][h] = ok && t < 3 ? __ldg(local + pc * 3 + t) : 0.f;
      in.tw[m][h] = ok ? __ldg(tw + pc) : 0.f;
    }
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
fused_corner_decode_kernel(const float* __restrict__ local,
                           const float* __restrict__ feats,
                           const float* __restrict__ tw,
                           const float* __restrict__ packed, float voxel_size,
                           int n, float* __restrict__ out) {
  static_assert(F == 8, "layer 0's column order is built for 8 latents");
  extern __shared__ float4 smem4[];
  const float4* src = reinterpret_cast<const float4*>(packed);
  for (int i = threadIdx.x; i < kTotal / 4; i += kThreads) smem4[i] = src[i];
  __syncthreads();
  const float* sw = reinterpret_cast<const float*>(smem4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_units = (n + kUnit - 1) / kUnit;
  const int stride = gridDim.x * kWarps;
  int unit = blockIdx.x * kWarps + warp;
  Inputs next;
  if (unit < n_units) load_unit<F>(local, feats, tw, unit * kUnit, n, g, t,
                                   next);
  for (; unit < n_units; unit += stride) {
    const Inputs in = next;
    const int p0 = unit * kUnit;
    if (unit + stride < n_units)
      load_unit<F>(local, feats, tw, (unit + stride) * kUnit, n, g, t, next);

    float a[kMT][8][4], acc[kMT][8][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s, c;
        sincosf(in.l[m][h], &s, &c);
        const bool pe = t < 3;
        a[m][0][h] = in.fa[m][h];          // column t:      latent t
        a[m][0][2 + h] = in.fb[m][h];      // column t + 4:  latent t + 4
        a[m][1][h] = in.l[m][h];           // column 8 + t:  l_t
        a[m][1][2 + h] = pe ? s : 0.f;     // column 12 + t: sin l_t
        a[m][2][h] = pe ? c : 0.f;         // column 16 + t: cos l_t
        a[m][2][2 + h] = 0.f;              // column 20 + t: padding
      }
    mlp_tc::layer<3, kMT>(a, acc, smem4 + kW0 / 4, sw + kB0, lane);
    mlp_tc::relu_to_a<kMT>(acc, a);
    mlp_tc::layer<8, kMT>(a, acc, smem4 + kW1 / 4, sw + kB1, lane);
    mlp_tc::relu_to_a<kMT>(acc, a);
    mlp_tc::layer<8, kMT>(a, acc, smem4 + kW2 / 4, sw + kB2, lane);

    const float bo = sw[kBo];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      float s0 = 0.f, s1 = 0.f;      // rows g and g + 8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 wo =
            *reinterpret_cast<const float2*>(sw + kWo + 8 * j + 2 * t);
        s0 = fmaf(fmaxf(acc[m][j][0], 0.f), wo.x, s0);
        s0 = fmaf(fmaxf(acc[m][j][1], 0.f), wo.y, s0);
        s1 = fmaf(fmaxf(acc[m][j][2], 0.f), wo.x, s1);
        s1 = fmaf(fmaxf(acc[m][j][3], 0.f), wo.y, s1);
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      float v0 = (s0 + bo) * voxel_size * in.tw[m][0];
      float v1 = (s1 + bo) * voxel_size * in.tw[m][1];
#pragma unroll
      for (int d = 4; d < 32; d <<= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, d);
        v1 += __shfl_xor_sync(0xffffffffu, v1, d);
      }
      const int p = p0 + 2 * m;
      if (lane == 0 && p < n) out[p] = v0;
      if (lane == 0 && p + 1 < n) out[p + 1] = v1;
    }
  }
}

template <int F>
int launch(const float* local, const float* feats, const float* tw,
           const float* packed, float voxel_size, int n, float* out,
           cudaStream_t s) {
  auto kernel = fused_corner_decode_kernel<F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, kSmemBytes)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long units = (n + kUnit - 1) / kUnit;
  const long long want = (units + kWarps - 1) / kWarps;
  const int blocks = (int)(want < (long long)sms * per_sm
                               ? want : (long long)sms * per_sm);
  fused_corner_decode_kernel<F><<<blocks, kThreads, kSmemBytes, s>>>(
      local, feats, tw, packed, voxel_size, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// local [n, 8, 3], feats [n, 8, F], tw [n, 8] f32; packed = the decoder in
// the tensor-core layout of kernels/fused_decode.py pack_decoder_tc (device
// memory, 16-byte aligned); out [n].  Returns cudaGetLastError(), or
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

// Floats in the packed layout, for the wrapper's check.
extern "C" int bnv_fused_corner_decode_packed_size() { return kTotal; }
