// Fused PointNet encode of the K-frame fuse front: each sorted point's 8
// corner inputs, the 6 -> 64 -> 64 -> 64 -> 8 ReLU MLP on the tensor cores
// in 3xTF32, and the feature-major store the stage-1 segmented reduce
// reads, in one launch for all K frames.
//
// Replaces no TPU kernel: the JAX package leaves this encoder to XLA
// (bnv_fusion_tpu/fusion.py _encode_sorted_fm, vmapped over the frames).
// The port's plain version (kernels/fused_encode.py) makes, per frame, the
// [8N, 6] corner inputs, runs one matrix product, bias add and ReLU pass
// per layer over [8N, 64] activations in device memory (629 MB per layer
// at N = 307,200), and permutes the [N, 8, 8] result into [64, N]; this
// kernel keeps all of that in registers and shared memory.  Per point
// and corner p (voxel.corner_neighbors, voxel.local_offsets):
//   x_p  = [c - corner_p(c), n]      corner_p picks floor or ceil of each
//                                    coordinate by voxel._CORNER_PATTERN
//   y_p  = MLP(x_p)                  [F = 8]
//   out[k, f * 8 + p, i] = y_p[f] if valid[k, i] else 0
//
// What bounds it on this card: operations.  A point costs 8 corners x
// 9,088 multiply-adds against 28 bytes read and 256 bytes written, so
// device memory (3.35 TB/s) needs 0.026 ms for a frame of N = 307,200
// points and the dense TF32 peak (495 TFLOP/s) 0.090 ms counted once; the
// 3xTF32 products (csrc/mlp_tc.cuh: one TF32 pass misses float32 by
// ~1e-3) take three times that.  Design (csrc/fused_mlp.cu's tile, which
// the same MLP runs at ~41% of its 3xTF32 bound on row-major rows):
//   * a warp takes a chunk of 32 consecutive points of one frame, in 8
//     steps of 4 points.  A step is MT = 2 row tiles of 16 rows: tile m
//     holds points 2m (rows g) and 2m + 1 (rows g + 8), row g being corner
//     g (g = lane / 4), so lane (g, t) builds layer 0's A fragment of its
//     rows itself: column t is the offset along axis t from corner g's
//     floor or ceil (the pattern is a compile-time constant; t = 3: the
//     normal's x) and column t + 4 the normal's y and z (t < 2, else 0).
//     Floor, ceil and the difference are exact, so the inputs equal the
//     plain version's bit for bit;
//   * the four layers are mlp_tc::layer with the weights of
//     fused_mlp.pack_params for din = 6, dout = 8 (KS0 = 1 k-step, NT = 1
//     n-tile), copied into shared memory once per block; activations never
//     leave the registers (mlp_tc.cuh);
//   * the output accumulators hold features 2t and 2t + 1 of corner g for
//     the tile's two points: channel f * 8 + g.  Each lane writes them into
//     the warp's [64][33] staging (zero for an invalid point), and after
//     the chunk's 8 steps the warp stores each of the 64 channel rows as
//     32 consecutive floats, one 128-byte store per row;
//   * the chunk's inputs (96 floats of coordinates, 96 of normals, 32
//     flags) are loaded coalesced into registers one chunk ahead, and
//     staged in shared memory for the step's lanes to read;
//   * the fuse front sorts invalid points last, so a chunk, or a step,
//     without a valid point skips the MLP and stores zeros: the work
//     follows the points inside the bounds, not N;
//   * the grid is persistent (one block of 8 warps per SM, the weights'
//     ~73 KB and eight 8.8 KB stagings in shared memory) and warps stride
//     over the K * ceil(N / 32) chunks.  Any N is taken; a chunk past a
//     frame's end is masked.
// kBf16 (model.fuse_dtype=bfloat16) is nn.mlp_apply's bfloat16 operands:
// the inputs and each hidden layer's ReLU output are rounded to bfloat16
// (round to nearest even) and the weights come packed from their bfloat16
// values, so every operand is a TF32 value and one TF32 product per
// multiply-add (mlp_tc::layer's kOnePass) is exact, as the plain version's
// float32 product of the rounded operands is; biases and sums stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tc.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                    // 16-row tiles per step
constexpr int kStepPts = 2 * kMT;         // points per step
constexpr int kPts = 32;                  // points per warp chunk
constexpr int kSteps = kPts / kStepPts;
constexpr int kIn = 6;                    // offset (3) + normal (3)
constexpr int kF = 8;                     // features per corner
constexpr int kCh = 8 * kF;               // output channels, f * 8 + p
constexpr int kStride = kPts + 1;         // staging row, in floats

// fused_mlp.cu's packed layout for din = 6 (KS0 = 1), dout = 8 (NT = 1),
// in floats: the fragments of w0, w1, w2, w_out, then b0, b1, b2, b_out
constexpr int kFrag = 8 * 32 * 4;
constexpr int kW1 = kFrag;
constexpr int kW2 = kW1 + 8 * kFrag;
constexpr int kWo = kW2 + 8 * kFrag;
constexpr int kB0 = kWo + kFrag;
constexpr int kB1 = kB0 + 64;
constexpr int kB2 = kB1 + 64;
constexpr int kBo = kB2 + 64;
constexpr int kTotal = (kBo + 8 + 3) / 4 * 4;

// a warp's shared memory: the output staging, then the chunk's inputs
constexpr int kWarpFloats = kCh * kStride + kIn * kPts;
constexpr size_t kSmemBytes =
    (size_t)(kTotal + kWarps * kWarpFloats) * sizeof(float);

// voxel._CORNER_PATTERN: corner p takes the ceiling along axis d where
// bit 3 * p + d is set
constexpr int kPattern[8][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1},
                                {1, 1, 0}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};

constexpr unsigned ceil_bits() {
  unsigned b = 0;
  for (int p = 0; p < 8; ++p)
    for (int d = 0; d < 3; ++d) b |= unsigned(kPattern[p][d]) << (3 * p + d);
  return b;
}

constexpr unsigned kCeilBits = ceil_bits();

// x rounded to bfloat16 (nearest even) where kBf16, held in float32
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// the next layer's A fragments: ReLU, then the operands' rounding
template <bool kBf16>
__device__ __forceinline__ void relu_round_to_a(
    const float (&acc)[kMT][8][4], float (&a)[kMT][8][4]) {
  mlp_tc::relu_to_a<kMT>(acc, a);
  if (kBf16) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[m][j][q] = operand<true>(a[m][j][q]);
  }
}

// Chunk `chunk`'s inputs into registers: lane l holds coordinate and
// normal floats l, l + 32, l + 64 of the chunk's 96 (point-major, xyz
// minor) and point l's flag; zeros past the frame's end.
__device__ __forceinline__ void load_chunk(const float* __restrict__ coords,
                                           const float* __restrict__ normals,
                                           const uint8_t* __restrict__ valid,
                                           long long n, long long per_frame,
                                           long long chunk, int lane,
                                           float (&c)[3], float (&nr)[3],
                                           bool& v) {
  const long long frame = chunk / per_frame;
  const long long p0 = (chunk - frame * per_frame) * kPts;
  const long long base = frame * n + p0;
  const long long m = n - p0 < kPts ? n - p0 : kPts;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int e = lane + 32 * i;
    const bool ok = e < 3 * m;
    c[i] = ok ? __ldg(coords + 3 * base + e) : 0.f;
    nr[i] = ok ? __ldg(normals + 3 * base + e) : 0.f;
  }
  v = lane < m && __ldg(valid + base + lane) != 0;
}

}  // namespace

// Outside the anonymous namespace, so that a profiler's trace names it
// fused_encode_kernel<...> (benchmark/metrics/fused_encode.roofline.py
// reads it by that name).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
fused_encode_kernel(const float* __restrict__ coords,
                    const float* __restrict__ normals,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ packed, long long n,
                    long long per_frame, long long n_chunks,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const float* sw = reinterpret_cast<const float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* sout = reinterpret_cast<float*>(smem4) + kTotal + warp * kWarpFloats;
  float* sx = sout + kCh * kStride;      // coordinates [96], normals [96]
  const long long stride = (long long)gridDim.x * kWarps;
  long long chunk = (long long)blockIdx.x * kWarps + warp;

  // the first chunk's loads run while the block copies the weights
  float nc[3], nn[3];
  bool nv = false;
  if (chunk < n_chunks)
    load_chunk(coords, normals, valid, n, per_frame, chunk, lane, nc, nn, nv);
  const float4* src = reinterpret_cast<const float4*>(packed);
  for (int i = threadIdx.x; i < kTotal / 4; i += kThreads) smem4[i] = src[i];
  __syncthreads();

  for (; chunk < n_chunks; chunk += stride) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sx[lane + 32 * i] = nc[i];
      sx[3 * kPts + lane + 32 * i] = nn[i];
    }
    const unsigned vmask = __ballot_sync(0xffffffffu, nv);
    const long long frame = chunk / per_frame;
    const long long p0 = (chunk - frame * per_frame) * kPts;
    if (chunk + stride < n_chunks)
      load_chunk(coords, normals, valid, n, per_frame, chunk + stride, lane,
                 nc, nn, nv);
    __syncwarp();

    if (vmask) {
      for (int s = 0; s < kSteps; ++s) {
        const int q0 = kStepPts * s;
        if (((vmask >> q0) & 0xFu) == 0) {       // warp-uniform
#pragma unroll
          for (int i = 0; i < kCh * kStepPts / 32; ++i) {
            const int e = lane + 32 * i;
            sout[(e / kStepPts) * kStride + q0 + e % kStepPts] = 0.f;
          }
          continue;
        }
        float a[kMT][8][4], acc[kMT][8][4];
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* cp = sx + 3 * (q0 + 2 * m + h);
            const float* np = cp + 3 * kPts;
            float x0;
            if (t < 3) {
              const float c = cp[t];
              x0 = c - ((kCeilBits >> (3 * g + t)) & 1u ? ceilf(c)
                                                        : floorf(c));
            } else {
              x0 = np[0];
            }
            a[m][0][h] = operand<kBf16>(x0);           // row g + 8h, col t
            a[m][0][2 + h] = t < 2 ? operand<kBf16>(np[t + 1])
                                   : 0.f;               // col t + 4
          }
        constexpr int kNT = mlp_tc::kNTiles;
        mlp_tc::layer<1, kMT, kNT, kBf16>(a, acc, smem4, sw + kB0, lane);
        relu_round_to_a<kBf16>(acc, a);
        mlp_tc::layer<8, kMT, kNT, kBf16>(a, acc, smem4 + kW1 / 4, sw + kB1,
                                          lane);
        relu_round_to_a<kBf16>(acc, a);
        mlp_tc::layer<8, kMT, kNT, kBf16>(a, acc, smem4 + kW2 / 4, sw + kB2,
                                          lane);
        relu_round_to_a<kBf16>(acc, a);
        float o[kMT][1][4];
        mlp_tc::layer<8, kMT, 1, kBf16>(a, o, smem4 + kWo / 4, sw + kBo,
                                        lane);
        // o[m][0][2h + e]: feature 2t + e of corner g, point q0 + 2m + h
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = q0 + 2 * m + h;
            const bool ok = (vmask >> q) & 1u;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sout[((2 * t + e) * 8 + g) * kStride + q] =
                  ok ? o[m][0][2 * h + e] : 0.f;
          }
      }
    }
    __syncwarp();

    // the chunk's 64 channel rows, 32 consecutive points each
    if (p0 + lane < n) {
      float* dst = out + frame * kCh * n + p0 + lane;
#pragma unroll 8
      for (int ch = 0; ch < kCh; ++ch)
        dst[(long long)ch * n] = vmask ? sout[ch * kStride + lane] : 0.f;
    }
    __syncwarp();   // the staging is read before the next chunk writes it
  }
}

// Floats of the packed weights the kernel reads (fused_mlp.pack_params's
// layout for a 6 -> 64 x 3 -> 8 MLP), for the wrapper's check.
extern "C" int bnv_fused_encode_packed_size() { return kTotal; }

template <bool kBf16>
static int launch(const float* coords, const float* normals,
                  const uint8_t* valid, const float* packed, int k,
                  long long n, float* out, cudaStream_t s) {
  const auto kernel = fused_encode_kernel<kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, kSmemBytes)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long per_frame = (n + kPts - 1) / kPts;
  const long long n_chunks = per_frame * k;
  const long long want = (n_chunks + kWarps - 1) / kWarps;
  const int blocks = (int)(want < (long long)sms * per_sm
                               ? want : (long long)sms * per_sm);
  kernel<<<blocks, kThreads, kSmemBytes, s>>>(coords, normals, valid, packed,
                                              n, per_frame, n_chunks, out);
  return static_cast<int>(cudaGetLastError());
}

// coords, normals [k, n, 3] f32, valid [k, n] bool (one byte, 0 or 1),
// packed: fused_mlp.pack_params of the encoder, of its bfloat16-rounded
// weights where bf16 != 0 (device memory, 16-byte aligned); out [k, 64, n]
// f32.  Returns cudaGetLastError().
extern "C" int bnv_fused_encode(const float* coords, const float* normals,
                                const uint8_t* valid, const float* packed,
                                int k, long long n, int bf16, float* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || n <= 0) return 0;
  return bf16 ? launch<true>(coords, normals, valid, packed, k, n, out, s)
              : launch<false>(coords, normals, valid, packed, k, n, out, s);
}
