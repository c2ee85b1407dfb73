// Segmented reduction of key-sorted streams, compacted to a static width.
//
// Replaces the Pallas TPU kernel bnv_fusion_tpu/kernels/seg_reduce.py
// (seg_reduce_sorted, body _kernel at :68-179).  Contract, per batch row b:
// rows with keys[b, i] >= sent are padding with zero payload; every maximal
// run of equal (key, key2) is one segment; segments are emitted in key order,
// the first u of them kept; the int channels are summed exactly, the float
// channels in f32; n_seg[b] counts every segment, dropped ones included.
// Output slots past min(n_seg, u) are zeroed.
//
// What bounds it on this card: it is memory-bound.  Stage 1 of the fuse path
// reads 16 x 307200 rows x 66 channels (~1.3 GB) for a few adds per element;
// nothing here is arithmetic.  The TPU kernel walks tiles in order and
// carries the open segment in scratch; Hopper runs blocks in parallel and in
// no order, so the design here reads the stream in four plain passes, none of
// which carries state between blocks:
//   1. count_ends:   each block counts the segment ends in its 256 rows
//                    (warp ballots; only the two key rows are read),
//   2. scan_blocks:  one block per batch row scans those counts into block
//                    offsets and the total n_seg,
//   3. emit_ends:    each end gets its rank (block offset + in-block ballot
//                    rank) and, if the rank is below u, writes its position
//                    and keys to the compacted outputs,
//   4. sum_segments: one warp per kept segment sums its rows from the
//                    previous end + 1 to its end; lane c owns channel c, and
//                    consecutive rows of a channel share cache sectors.
// The payload is read once (pass 4); the keys three times.  Sums run in row
// order with no atomics, so two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ bool is_end_at(const int* __restrict__ k,
                                          const int* __restrict__ k2, int i,
                                          int M, int sent) {
  const int key = k[i];
  if (key >= sent) return false;
  if (i + 1 >= M) return true;
  if (k[i + 1] != key) return true;
  return k2 != nullptr && k2[i + 1] != k2[i];
}

// Exclusive rank of `flag` among the block's threads; *total = block count.
__device__ __forceinline__ int block_rank(bool flag, int* total,
                                          int* s_warp /* [kWarps + 1] */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  const int lrank = __popc(m & ((1u << lane) - 1u));
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? s_warp[lane] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane < kWarps) s_warp[lane] = incl - v;
    if (lane == 31) s_warp[kWarps] = incl;
  }
  __syncthreads();
  *total = s_warp[kWarps];
  return s_warp[warp] + lrank;
}

__global__ void count_ends_kernel(const int* __restrict__ keys,
                                  const int* __restrict__ keys2, int M,
                                  int sent, int G, int* __restrict__ counts) {
  __shared__ int s_warp[kWarps + 1];
  const int b = blockIdx.y, g = blockIdx.x;
  const int i = g * kBlock + threadIdx.x;
  const int* k = keys + (size_t)b * M;
  const int* k2 = keys2 ? keys2 + (size_t)b * M : nullptr;
  const bool f = i < M && is_end_at(k, k2, i, M, sent);
  int total;
  block_rank(f, &total, s_warp);
  if (threadIdx.x == 0) counts[(size_t)b * G + g] = total;
}

// One block of 1024 threads per batch row: exclusive scan of G counts.
__global__ void scan_blocks_kernel(const int* __restrict__ counts, int G,
                                   int* __restrict__ offsets,
                                   int* __restrict__ n_seg) {
  __shared__ int s_warp[32];
  __shared__ int carry;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < G; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < G ? counts[(size_t)b * G + i] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = s_warp[lane];
      int wi = w;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, wi, d);
        if (lane >= d) wi += t;
      }
      s_warp[lane] = wi - w;
    }
    __syncthreads();
    const int excl = carry + s_warp[warp] + incl - v;
    if (i < G) offsets[(size_t)b * G + i] = excl;
    __syncthreads();
    if (threadIdx.x == 1023) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) n_seg[b] = carry;
}

__global__ void emit_ends_kernel(const int* __restrict__ keys,
                                 const int* __restrict__ keys2, int M,
                                 int sent, int G, int u,
                                 const int* __restrict__ offsets,
                                 int* __restrict__ end_pos,
                                 int* __restrict__ keys_u,
                                 int* __restrict__ keys2_u) {
  __shared__ int s_warp[kWarps + 1];
  const int b = blockIdx.y, g = blockIdx.x;
  const int i = g * kBlock + threadIdx.x;
  const int* k = keys + (size_t)b * M;
  const int* k2 = keys2 ? keys2 + (size_t)b * M : nullptr;
  const bool f = i < M && is_end_at(k, k2, i, M, sent);
  int total;
  const int r = block_rank(f, &total, s_warp) + offsets[(size_t)b * G + g];
  if (f && r < u) {
    const size_t o = (size_t)b * u + r;
    end_pos[o] = i;
    keys_u[o] = k[i];
    if (keys2_u) keys2_u[o] = k2 ? k2[i] : 0;
  }
}

__global__ void sum_segments_kernel(const int* __restrict__ cnts,
                                    const float* __restrict__ vals, int M,
                                    int n_int, int n_float, int u,
                                    const int* __restrict__ end_pos,
                                    const int* __restrict__ n_seg,
                                    int* __restrict__ keys_u,
                                    int* __restrict__ keys2_u,
                                    int* __restrict__ cnts_u,
                                    float* __restrict__ sums_u) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= u) return;
  const int ns = min(n_seg[b], u);
  const size_t o = (size_t)b * u + r;
  if (r >= ns) {
    if (lane == 0) {
      keys_u[o] = 0;
      if (keys2_u) keys2_u[o] = 0;
    }
    for (int c = lane; c < n_int; c += 32) cnts_u[o * n_int + c] = 0;
    for (int c = lane; c < n_float; c += 32) sums_u[o * n_float + c] = 0.f;
    return;
  }
  // valid rows precede the padding, so segments tile the row from 0
  const int end = end_pos[o];
  const int start = r == 0 ? 0 : end_pos[o - 1] + 1;
  for (int c = lane; c < n_int; c += 32) {
    const int* p = cnts + ((size_t)b * n_int + c) * M;
    unsigned s = 0;  // wraps like the int32 sums of the JAX package
    for (int j = start; j <= end; ++j) s += (unsigned)p[j];
    cnts_u[o * n_int + c] = (int)s;
  }
  for (int c = lane; c < n_float; c += 32) {
    const float* p = vals + ((size_t)b * n_float + c) * M;
    float s = 0.f;
    for (int j = start; j <= end; ++j) s += p[j];
    sums_u[o * n_float + c] = s;
  }
}

}  // namespace

// keys/keys2 [B, M] int32 (keys2 may be null), cnts [B, n_int, M] int32,
// vals [B, n_float, M] f32; scratch counts/offsets [B, ceil(M/256)] int32 and
// end_pos [B, u] int32; outputs keys_u/keys2_u [B, u], cnts_u [B, u, n_int],
// sums_u [B, u, n_float], n_seg [B].  Returns cudaGetLastError().
extern "C" int bnv_seg_reduce_sorted(
    const int* keys, const int* keys2, const int* cnts, const float* vals,
    int B, int M, int n_int, int n_float, int u, int sent, int* counts,
    int* offsets, int* end_pos, int* keys_u, int* keys2_u, int* cnts_u,
    float* sums_u, int* n_seg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = (M + kBlock - 1) / kBlock;
  const dim3 grid(G, B);
  count_ends_kernel<<<grid, kBlock, 0, s>>>(keys, keys2, M, sent, G, counts);
  scan_blocks_kernel<<<B, 1024, 0, s>>>(counts, G, offsets, n_seg);
  emit_ends_kernel<<<grid, kBlock, 0, s>>>(keys, keys2, M, sent, G, u, offsets,
                                           end_pos, keys_u, keys2_u);
  const dim3 grid4((u + kWarps - 1) / kWarps, B);
  sum_segments_kernel<<<grid4, kBlock, 0, s>>>(cnts, vals, M, n_int, n_float,
                                               u, end_pos, n_seg, keys_u,
                                               keys2_u, cnts_u, sums_u);
  return static_cast<int>(cudaGetLastError());
}
