// Fused ReLU MLP: a whole din -> 64 -> 64 -> 64 -> dout stack (ReLU after
// each hidden layer, none after the last) in one kernel, its layers on the
// tensor cores in 3xTF32.
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
// What bounds it on this card: tensor-core operations.  A row costs
// din*64 + 2*64*64 + 64*dout multiply-adds (9,088 for the encoder) against
// (din + dout) * 4 bytes of I/O (56 B), so device memory (3.35 TB/s) needs
// 0.04 ms for the encoder's M = 2,457,600 rows, f32 FMAs (67 TFLOP/s)
// 0.67 ms.  The layers are dense 64-wide matrix products, so they run as
// mma.sync.m16n8k8 TF32 products; one TF32 pass misses the 1e-4 bound the
// kernel is held to, so every product is 3xTF32 (csrc/mlp_tc.cuh): three
// TF32 products at 495 TFLOP/s, 0.27 ms for the encoder.  Design (that of
// csrc/fused_decode.cu, on the same tile):
//   * rows are the MLP's rows.  A warp holds MT = 2 tiles of 16 rows (a
//     32-row unit) in registers from the input to the output and takes them
//     through the four layers with mlp_tc::layer and mlp_tc::relu_to_a;
//     activations never leave the registers.  Layer 0 has KS0 = ceil(din/8)
//     k-steps whose A fragments come from the input in its own column order
//     (zero past din; w0's rows are zero-padded, not permuted); w1, w2 and
//     w_out have their rows permuted (mlp_tc.cuh's note, kernels/mlp_tc.py);
//   * input: a unit is a contiguous span of 32 rows (din * 128 bytes).  Each
//     warp copies it with coalesced 16-byte cp.async into shared memory,
//     double-buffered, so the next unit's copy is in flight while this one's
//     products run (the card's asynchronous copy in place of the TPU's
//     BlockSpec pipelining).  A row of 24 or 68 bytes breaks 16-byte words
//     across rows, so the staging is padded per group of 4 rows (4 * din
//     floats, a whole number of 16-byte words) to a stride G = 4 (mod 8)
//     floats; the unit's row 4g + q is tile row g (q = 0, 2) or g + 8
//     (q = 1, 3) of tile q / 2, and lane (g, t) reads its A fragments at
//     g * G + q * din + column: the 8 row groups fall on 8 disjoint sets of
//     4 banks, free of conflicts for every din.  A base that is not 16-byte
//     aligned and the ragged last unit take 4-byte cp.async with zero fill
//     past M instead, inside the kernel;
//   * output: for dout >= 2 the output layer runs on the tensor cores too
//     (NT = ceil(dout/8) n-tiles, w_out's columns zero-padded to 8 * NT);
//     lane (g, t) holds columns 2t, 2t+1 of each n-tile, stored straight
//     from the accumulators (float2 stores for even dout, so for dout = 8 a
//     row is one whole 32-byte sector; masked scalar stores for odd dout).
//     For dout = 1 the output layer stays on FMAs as in the decode: each
//     lane sums its 16 columns, two shuffles sum a row's 4 lanes, and lane
//     t stores unit row 4g + t, one coalesced 128-byte store per unit.  One
//     n-tile would run 8 x 3 products per tile with 7 of 8 columns wasted,
//     and the f32 sum is exact where 3xTF32 is not;
//   * the packed weights (hi/lo split, permuted, in fragment order; 75 KB
//     for the encoder, 79 KB for the decoder, at most 91 KB) are copied
//     into shared memory once per block with float4 loads; the grid is
//     persistent (SMs times occupancy blocks) and warps stride over units.
//     Device memory sees each input and each output once; no intermediate
//     layer leaves the SM.  Any M is taken.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tc.cuh"

namespace {

constexpr int kH = 64;              // hidden width (tcnn n_neurons)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;              // 16-row tiles per warp
constexpr int kUnit = 16 * kMT;     // rows per warp iteration
constexpr int kMaxIn = 32;
constexpr int kMaxOut = 16;

// packed layout, in floats (kernels/fused_mlp.py pack_params), for KS0
// k-steps of layer 0 and NT n-tiles of the output layer: the fragments of
// w0 (at 0), w1, w2 and w_out (NT = 0, dout = 1: w_out's 64 floats), then
// b0, b1, b2 (64 each) and b_out (8 * NT floats, or 1), padded to float4s
struct Layout {
  int w1, w2, wo, b0, b1, b2, bo, total;
};

__host__ __device__ constexpr Layout layout(int ks0, int nt) {
  const int frag = 8 * 32 * 4;      // floats per (k-step, 8 n-tiles)
  const int w1 = ks0 * frag;
  const int w2 = w1 + 8 * frag;
  const int wo = w2 + 8 * frag;
  const int b0 = wo + (nt ? nt * frag : kH);
  const int b1 = b0 + kH, b2 = b1 + kH, bo = b2 + kH;
  return Layout{w1, w2, wo, b0, b1, b2, bo,
                (bo + (nt ? 8 * nt : 1) + 3) / 4 * 4};
}

// staging stride of a group of 4 rows, in floats: >= 4 * din, a multiple
// of 4 (16-byte words) and 4 (mod 8), so g * G mod 32 takes 8 distinct
// multiples of 4 for g = 0..7
__host__ __device__ inline int group_stride(int din) {
  return 4 * din + (din % 2 == 0 ? 4 : 0);
}

// dynamic shared memory of a block: the packed weights, then each warp's
// two staging buffers of 8 row groups
inline size_t smem_bytes(int ks0, int nt, int din) {
  return (size_t)(layout(ks0, nt).total + kWarps * 16 * group_stride(din)) *
         sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// 4 bytes, or zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start the copy of unit `unit` (rows 32 * unit ...) into the staging
// buffer s: unit row 4g + q, column c at s[g * G + q * din + c]; rows past
// m are zeros.
__device__ __forceinline__ void load_unit(const float* __restrict__ x,
                                          long long m, int din, int G,
                                          bool vec, long long unit, float* s,
                                          int lane) {
  const long long e0 = unit * kUnit * din;
  if (vec && (unit + 1) * kUnit <= m) {
    // 8 * din 16-byte words, din per group of 4 rows
    for (int c = lane; c < 8 * din; c += 32) {
      const int g = c / din;
      cp_async16(s + g * G + 4 * (c - g * din), x + e0 + 4 * c);
    }
  } else {
    const long long n_el = m * din;
    for (int e = lane; e < kUnit * din; e += 32) {
      const int g = e / (4 * din);
      const bool ok = e0 + e < n_el;
      cp_async4(s + g * G + (e - 4 * g * din), ok ? x + e0 + e : x, ok);
    }
  }
}

template <int KS0, int NT>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const float* __restrict__ x,
                 const float* __restrict__ packed, int din, int dout,
                 long long m, float* __restrict__ out) {
  static_assert(kMT == 2, "a group of 4 unit rows holds rows g and g + 8 "
                          "of both tiles");
  constexpr Layout L = layout(KS0, NT);
  extern __shared__ float4 smem4[];
  const float* sw = reinterpret_cast<const float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = group_stride(din);
  float* stage = reinterpret_cast<float*>(smem4) + L.total + warp * 16 * G;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long n_units = (m + kUnit - 1) / kUnit;
  const long long stride = (long long)gridDim.x * kWarps;
  long long unit = (long long)blockIdx.x * kWarps + warp;

  // the first unit's copy runs while the block loads the weights
  if (unit < n_units) load_unit(x, m, din, G, vec, unit, stage, lane);
  cp_async_commit();
  const float4* src = reinterpret_cast<const float4*>(packed);
  for (int i = threadIdx.x; i < L.total / 4; i += kThreads) smem4[i] = src[i];
  __syncthreads();

  int buf = 0;
  for (; unit < n_units; unit += stride, buf ^= 1) {
    if (unit + stride < n_units)
      load_unit(x, m, din, G, vec, unit + stride, stage + (buf ^ 1) * 8 * G,
                lane);
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();

    float a[kMT][8][4], acc[kMT][8][4];
    const float* s = stage + buf * 8 * G + g * G;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* r0 = s + 2 * mt * din;     // tile row g
      const float* r1 = r0 + din;             // tile row g + 8
#pragma unroll
      for (int j = 0; j < KS0; ++j) {
        const int c0 = 8 * j + t, c1 = c0 + 4;
        a[mt][j][0] = c0 < din ? r0[c0] : 0.f;
        a[mt][j][1] = c0 < din ? r1[c0] : 0.f;
        a[mt][j][2] = c1 < din ? r0[c1] : 0.f;
        a[mt][j][3] = c1 < din ? r1[c1] : 0.f;
      }
    }
    __syncwarp();   // all lanes have read this buffer before it is refilled

    mlp_tc::layer<KS0, kMT>(a, acc, smem4, sw + L.b0, lane);
    mlp_tc::relu_to_a<kMT>(acc, a);
    mlp_tc::layer<8, kMT>(a, acc, smem4 + L.w1 / 4, sw + L.b1, lane);
    mlp_tc::relu_to_a<kMT>(acc, a);
    mlp_tc::layer<8, kMT>(a, acc, smem4 + L.w2 / 4, sw + L.b2, lane);

    const long long row0 = unit * kUnit + 4 * g;  // + 2 * mt + h
    if constexpr (NT == 0) {
      const float bo = sw[L.bo];
      float v[kMT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float s0 = 0.f, s1 = 0.f;      // tile rows g and g + 8
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 wo =
              *reinterpret_cast<const float2*>(sw + L.wo + 8 * j + 2 * t);
          s0 = fmaf(fmaxf(acc[mt][j][0], 0.f), wo.x, s0);
          s0 = fmaf(fmaxf(acc[mt][j][1], 0.f), wo.y, s0);
          s1 = fmaf(fmaxf(acc[mt][j][2], 0.f), wo.x, s1);
          s1 = fmaf(fmaxf(acc[mt][j][3], 0.f), wo.y, s1);
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        v[mt][0] = s0 + bo;
        v[mt][1] = s1 + bo;
      }
      // every lane of a row group holds its 4 rows; lane t stores row t
      const float y = t == 0 ? v[0][0] : t == 1 ? v[0][1]
                    : t == 2 ? v[1][0] : v[1][1];
      if (row0 + t < m) out[row0 + t] = y;
    } else {
      float o[kMT][NT][4];
      mlp_tc::relu_to_a<kMT>(acc, a);
      mlp_tc::layer<8, kMT, NT>(a, o, smem4 + L.wo / 4, sw + L.bo, lane);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = row0 + 2 * mt + h;
          if (r >= m) continue;
          float* orow = out + r * dout;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int c = 8 * n + 2 * t;
            const float y0 = o[mt][n][2 * h], y1 = o[mt][n][2 * h + 1];
            if (dout % 2 == 0) {
              if (c < dout)
                *reinterpret_cast<float2*>(orow + c) = make_float2(y0, y1);
            } else {
              if (c < dout) orow[c] = y0;
              if (c + 1 < dout) orow[c + 1] = y1;
            }
          }
        }
    }
  }
}

template <int KS0, int NT>
int launch(const float* x, const float* packed, int din, int dout,
           long long m, float* out, cudaStream_t s) {
  auto kernel = fused_mlp_kernel<KS0, NT>;
  const size_t smem = smem_bytes(KS0, NT, din);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long units = (m + kUnit - 1) / kUnit;
  const long long want = (units + kWarps - 1) / kWarps;
  const int blocks = (int)(want < (long long)sms * per_sm
                               ? want : (long long)sms * per_sm);
  kernel<<<blocks, kThreads, smem, s>>>(x, packed, din, dout, m, out);
  return static_cast<int>(cudaGetLastError());
}

template <int KS0>
int launch_nt(int nt, const float* x, const float* packed, int din, int dout,
              long long m, float* out, cudaStream_t s) {
  if (nt == 0) return launch<KS0, 0>(x, packed, din, dout, m, out, s);
  if (nt == 1) return launch<KS0, 1>(x, packed, din, dout, m, out, s);
  return launch<KS0, 2>(x, packed, din, dout, m, out, s);
}

inline int ks0_of(int din) { return (din + 7) / 8; }
inline int nt_of(int dout) { return dout == 1 ? 0 : (dout + 7) / 8; }

}  // namespace

// Floats of the packed weights for (din, dout) (layout above), or -1 for a
// topology the kernel does not take.
extern "C" int bnv_fused_mlp_packed_size(int din, int dout) {
  if (din < 1 || din > kMaxIn || dout < 1 || dout > kMaxOut) return -1;
  return layout(ks0_of(din), nt_of(dout)).total;
}

// Bytes of dynamic shared memory a block of the kernel takes for
// (din, dout), or -1 as above.
extern "C" int bnv_fused_mlp_smem_bytes(int din, int dout) {
  if (din < 1 || din > kMaxIn || dout < 1 || dout > kMaxOut) return -1;
  return (int)smem_bytes(ks0_of(din), nt_of(dout), din);
}

// x [m, din] f32 row-major (any 4-byte alignment), packed weights (device
// memory, layout above, 16-byte aligned), out [m, dout].  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for din outside [1, 32] or
// dout outside [1, 16].
extern "C" int bnv_fused_mlp(const float* x, const float* packed, int din,
                             int dout, long long m, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (din < 1 || din > kMaxIn || dout < 1 || dout > kMaxOut)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  const int nt = nt_of(dout);
  switch (ks0_of(din)) {
    case 1: return launch_nt<1>(nt, x, packed, din, dout, m, out, s);
    case 2: return launch_nt<2>(nt, x, packed, din, dout, m, out, s);
    case 3: return launch_nt<3>(nt, x, packed, din, dout, m, out, s);
    default: return launch_nt<4>(nt, x, packed, din, dout, m, out, s);
  }
}
