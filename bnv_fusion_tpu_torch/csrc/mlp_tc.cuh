// A ReLU MLP layer of 8 * NT outputs (64 for the hidden layers) on
// Hopper's tensor cores in 3xTF32, for one warp holding MT tiles of 16 rows
// in registers.  Shared by the kernels built on the tcnn MLP's 64-wide
// layers: fused_decode.cu (its three hidden layers) and fused_mlp.cu (all
// four layers; the output layer of dout <= 16 as NT = 1 or 2 n-tiles).
// kernels/mlp_tc.py is the Python side: the weights' split, permutation and
// fragment order.
//
// Arithmetic.  mma.sync.m16n8k8 with TF32 operands and f32 accumulators.
// TF32 keeps 10 of f32's 23 mantissa bits, which alone misses the decode's
// 1e-4 x voxel bound and fused_mlp's 1e-4; each operand x is therefore
// split into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and every
// product is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the lo*lo term,
// ~2^-22 relative, is dropped).  TF32 x TF32 products are exact in f32, so
// what remains is f32 accumulation order.  The weights are split once per
// weight set on the host side (kernels/mlp_tc.py); activations are split
// here.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8" for .tf32), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row):  a0 = A[g][t]    a1 = A[g+8][t]
//                     a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8, col):   b0 = B[t][g]    b1 = B[t+4][g]
//   C/D (16 x 8):     c0 = C[g][2t]   c1 = C[g][2t+1]
//                     c2 = C[g+8][2t] c3 = C[g+8][2t+1]
// A layer's 64 outputs are 8 n-tiles; n-tile j's accumulator holds output
// columns 8j+2t and 8j+2t+1 of rows g and g+8.  The next layer's k-step j
// reads input columns 8j+t and 8j+t+4 in its A registers.  Taking
//   a0 = c0, a1 = c2, a2 = c1, a3 = c3
// makes the A fragment's column t the physical column 2t and its column
// t+4 the physical column 2t+1: logical k = kk inside the block of 8 is
// physical column 8j + kPerm[kk], kPerm = [0,2,4,6,1,3,5,7].  Permuting the
// next layer's weight rows the same way (row 8j+kk of the packed matrix is
// row 8j+kPerm[kk] of the true one) makes the product exact, so one
// layer's accumulators become the next one's A registers (after ReLU and
// the hi/lo split) with no trip through shared memory.
//
// Weight layout in shared memory, per layer of KS k-steps and NT n-tiles:
// one float4 per (k-step j, n-tile n, lane), (hi b0, hi b1, lo b0, lo b1),
// at index (j * NT + n) * 32 + lane, so a warp's B loads are 32 consecutive
// 16-byte words: one conflict-free LDS.128 feeds the 3 x MT products of
// that (j, n).

#pragma once

#include <stdint.h>

namespace mlp_tc {

constexpr int kWidth = 64;   // hidden width
constexpr int kNTiles = kWidth / 8;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo), both TF32 bit patterns, x ~= hi + lo
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m] = bias + A[m] W for MT row tiles and NT n-tiles of output; A[m]
// is given as KS k-steps of raw f32 A fragments, W as KS * NT * 32 float4
// in shared memory (layout above), bias as 8 * NT floats in shared memory.
// No ReLU here.  kOnePass takes the hi * hi product alone: exact where
// every operand is already a TF32 value (bfloat16-rounded activations and
// weights, whose lo parts are zero), and a third of the work.
template <int KS, int MT, int NT = kNTiles, bool kOnePass = false>
__device__ __forceinline__ void layer(const float (&a)[MT][8][4],
                                      float (&acc)[MT][NT][4],
                                      const float4* __restrict__ w,
                                      const float* __restrict__ bias,
                                      int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * n + 2 * t);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m][n][0] = bv.x;
      acc[m][n][1] = bv.y;
      acc[m][n][2] = bv.x;
      acc[m][n][3] = bv.y;
    }
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (kOnePass)
          hi[m][q] = to_tf32(a[m][j][q]);
        else
          split(a[m][j][q], hi[m][q], lo[m][q]);
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 b = w[(j * NT + n) * 32 + lane];
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (!kOnePass) {
          mma(acc[m][n], lo[m], bh0, bh1);
          mma(acc[m][n], hi[m], bl0, bl1);
        }
        mma(acc[m][n], hi[m], bh0, bh1);
      }
    }
  }
}

// The next layer's A fragments from this layer's accumulators: ReLU and
// the register order a = (c0, c2, c1, c3) of the note above.
template <int MT>
__device__ __forceinline__ void relu_to_a(const float (&acc)[MT][kNTiles][4],
                                          float (&a)[MT][8][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      a[m][j][0] = fmaxf(acc[m][j][0], 0.f);
      a[m][j][1] = fmaxf(acc[m][j][2], 0.f);
      a[m][j][2] = fmaxf(acc[m][j][1], 0.f);
      a[m][j][3] = fmaxf(acc[m][j][3], 0.f);
    }
}

}  // namespace mlp_tc
