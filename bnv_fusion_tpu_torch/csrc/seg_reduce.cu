// Segmented reduction of key-sorted streams, compacted to a static width.
//
// Replaces the Pallas TPU kernel bnv_fusion_tpu/kernels/seg_reduce.py
// (seg_reduce_sorted, body _kernel at :68-179).  Contract, per batch row b:
// rows with keys[b, i] >= sent are padding with zero payload; every maximal
// run of equal (key, key2) is one segment; segments are emitted in key order,
// the first u of them kept; the int channels are summed exactly (wrapping
// int32 adds), the float channels in f32; n_seg[b] counts every segment,
// dropped ones included.  Output slots past min(n_seg, u) are zeroed.
//
// What bounds it on this card: device memory.  Stage 1 of the fuse path
// reads 16 x 307200 rows x 66 channels (~1.3 GB) for one add per element.
// The payload is feature-major ([B, C, M]: each channel a plane of M rows),
// so the design streams each plane with rows along the threads, as the TPU
// kernel streams tiles with rows along the lanes.  The TPU kernel walks its
// tiles in order and carries the open segment in scratch; Hopper runs blocks
// in parallel and in no order, so the carry becomes a fix-up launch:
//   1. count_ends:  one block per tile of kT = kBlock x kR rows (128 x 8)
//                   counts the segment ends in it (only the key rows are
//                   read),
//   2. scan_tiles:  one block per batch row scans those counts into each
//                   tile's first rank and the total n_seg,
//   3. tile_sums:   one block per tile.  Thread i owns rows kR*i .. +kR-1,
//                   read with 16-byte loads (a warp's loads cover 1 KB of
//                   a plane).  It writes its ends' keys at their ranks.
//                   Then, eight channels at a time, it sums its rows
//                   serially by segment; a segmented scan with head flags
//                   (warp shuffles, then the warps' aggregates in shared
//                   memory) gives each thread the open sum carried into its
//                   rows, so the thread at each segment end holds the
//                   segment's in-tile sum at its rank.  Those are staged in
//                   shared memory as [rank][channel] and stored as runs of
//                   whole 32-byte sectors of the row-major [u, C] outputs.
//                   The tile's trailing open sum goes to scratch,
//   4. finish:      for each tile with an end, the trailing sums of the
//                   tiles before it, back to and including the last tile
//                   with an end, are added in tile order into its first
//                   segment (the segment that crossed the tile edge); the
//                   same launch's other blocks zero the slots past
//                   min(n_seg, u).
// Keys are read twice (passes 1 and 3), the payload once.  No atomics: the
// sums run in a fixed tree order, so two runs give the same bits; float sums
// differ from the plain version's row order only by f32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// tile shape and occupancy, tuned on the H100 (PERF.md)
constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kR = 8;                    // rows per thread, a multiple of 4
constexpr int kT = kBlock * kR;          // rows per tile
constexpr int kMinBlocks = 4;            // tile_sums blocks per SM
constexpr int kCC = 8;                   // channels per staged chunk
constexpr int kStride = kCC + 1;         // staging row stride (bank spread)
constexpr size_t kStageBytes = (size_t)kT * kStride * sizeof(uint32_t);
static_assert(kR % 4 == 0 && kR <= 32, "rows per thread");

// kR consecutive 32-bit words from row i0; rows >= M read as 0.  VEC: M and
// the plane base are multiples of 4 words, so each 16-byte load is wholly
// inside or wholly outside the row.
template <bool VEC>
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ p,
                                          int i0, int M,
                                          uint32_t (&v)[kR]) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < kR / 4; ++q) {
      const int i = i0 + 4 * q;
      const uint4 w = i < M ? __ldg(reinterpret_cast<const uint4*>(p + i))
                            : make_uint4(0, 0, 0, 0);
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] = i0 + r < M ? __ldg(p + i0 + r) : 0u;
  }
}

// The thread's keys (and keys2) and the bit mask of its rows that end a
// segment: a valid row whose successor has another (key, key2) or is past M.
template <bool VEC>
__device__ __forceinline__ unsigned end_flags(const int* __restrict__ k,
                                              const int* __restrict__ k2,
                                              int i0, int M, int sent,
                                              uint32_t (&key)[kR],
                                              uint32_t (&key2)[kR]) {
  load_rows<VEC>(reinterpret_cast<const uint32_t*>(k), i0, M, key);
  const bool more = i0 + kR < M;
  const int nxt = more ? __ldg(k + i0 + kR) : 0;
  int nxt2 = 0;
  if (k2) {
    load_rows<VEC>(reinterpret_cast<const uint32_t*>(k2), i0, M, key2);
    nxt2 = more ? __ldg(k2 + i0 + kR) : 0;
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) key2[r] = 0;
  }
  unsigned mask = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r;
    const int kk = (int)key[r];
    if (i >= M || kk >= sent) continue;
    bool end = i + 1 >= M;
    if (!end) {
      const int kn = r + 1 < kR ? (int)key[r + 1] : nxt;
      const int kn2 = r + 1 < kR ? (int)key2[r + 1] : nxt2;
      end = kn != kk || (k2 != nullptr && kn2 != (int)key2[r]);
    }
    mask |= (unsigned)end << r;
  }
  return mask;
}

// Exclusive prefix sum of v over the block; *total = the block's sum.
__device__ __forceinline__ int block_excl_sum(int v, int* total,
                                              int* s_warp /* [kWarps+1] */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += t;
    }
    __syncwarp();
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == kWarps - 1) s_warp[kWarps] = wi;
  }
  __syncthreads();
  *total = s_warp[kWarps];
  return s_warp[warp] + incl - v;
}

template <bool VEC>
__global__ void __launch_bounds__(kBlock)
count_ends_kernel(const int* __restrict__ keys, const int* __restrict__ keys2,
                  int M, int sent, int nT, int* __restrict__ counts) {
  __shared__ int s_warp[kWarps + 1];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int i0 = tile * kT + threadIdx.x * kR;
  uint32_t key[kR], key2[kR];
  const unsigned mask = end_flags<VEC>(keys + (size_t)b * M,
                                       keys2 ? keys2 + (size_t)b * M : nullptr,
                                       i0, M, sent, key, key2);
  int total;
  block_excl_sum(__popc(mask), &total, s_warp);
  if (threadIdx.x == 0) counts[(size_t)b * nT + tile] = total;
}

// One block of 1024 threads per batch row: exclusive scan of nT counts.
__global__ void scan_tiles_kernel(const int* __restrict__ counts, int nT,
                                  int* __restrict__ offsets,
                                  int* __restrict__ n_seg) {
  __shared__ int s_warp[32];
  __shared__ int carry;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nT; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < nT ? counts[(size_t)b * nT + i] : 0;
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
    if (i < nT) offsets[(size_t)b * nT + i] = excl;
    __syncthreads();
    if (threadIdx.x == 1023) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) n_seg[b] = carry;
}

// Adds in the channel's type: wrapping unsigned for the int channels, f32
// for the float ones; values travel as 32-bit patterns.
template <bool FLOAT>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  if (FLOAT) return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  return a + b;
}

__device__ __forceinline__ uint32_t add(bool fl, uint32_t a, uint32_t b) {
  return fl ? add<true>(a, b) : add<false>(a, b);
}

// Rows of this thread for nc channel planes from `plane` on (stride M);
// zeros past nc.
template <bool VEC>
__device__ __forceinline__ void load_chunk(const uint32_t* __restrict__ plane,
                                           int M, int nc, int i0,
                                           uint32_t (&v)[kCC][kR]) {
#pragma unroll
  for (int cc = 0; cc < kCC; ++cc) {
    if (cc < nc) {
      load_rows<VEC>(plane + (size_t)cc * M, i0, M, v[cc]);
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) v[cc][r] = 0u;
    }
  }
}

// Pass 3's row walk for one chunk of channels held in v: the sums of the
// thread's segments, in row order.  The first end's sum (which still lacks
// what the threads before carry in) goes to `first`; the later ends' sums
// are staged at their in-tile ranks (not past n_keep); the open sum after
// the last end (all rows if none) is left in x.
template <bool FLOAT>
__device__ __forceinline__ void walk_rows(const uint32_t (&v)[kCC][kR],
                                          int nc, unsigned mask, int rank_t,
                                          int n_keep, uint32_t* stage,
                                          uint32_t (&first)[kCC],
                                          uint32_t (&x)[kCC]) {
#pragma unroll
  for (int cc = 0; cc < kCC; ++cc) x[cc] = first[cc] = 0u;
  int slot = rank_t;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) x[cc] = add<FLOAT>(x[cc], v[cc][r]);
    if ((mask >> r) & 1u) {
      if (slot == rank_t) {
#pragma unroll
        for (int cc = 0; cc < kCC; ++cc) first[cc] = x[cc];
      } else if (slot < n_keep) {
#pragma unroll
        for (int cc = 0; cc < kCC; ++cc)
          if (cc < nc) stage[slot * kStride + cc] = x[cc];
      }
      ++slot;
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) x[cc] = 0u;
    }
  }
}

// The segmented scan over the block for one chunk: each thread's open sum
// x is combined with what the threads before it carry in, back to the last
// thread with an end.  Threads with an end stage their first end's sum
// (carry + first) at rank_t; the block's last thread writes the tile's
// trailing open sums to part.
template <bool FLOAT>
__device__ __forceinline__ void scan_chunk(
    uint32_t (&x)[kCC], const uint32_t (&first)[kCC], int nc, unsigned mask,
    int rank_t, int n_keep, uint32_t* __restrict__ part, uint32_t* stage,
    unsigned* s_flag /* [kWarps] */, uint32_t* s_agg /* [kWarps][kCC] */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // inclusive scan over the warp: (f, x) after (fu, xu) is
  // (f | fu, f ? x : xu + x); nc is the same for the whole block
  unsigned f = mask != 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned fu = __shfl_up_sync(0xffffffffu, f, d);
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      if (cc < nc) {
        const uint32_t xu = __shfl_up_sync(0xffffffffu, x[cc], d);
        if (lane >= d && !f) x[cc] = add<FLOAT>(xu, x[cc]);
      }
    }
    if (lane >= d) f |= fu;
  }
  if (lane == 31) {
    s_flag[warp] = f;
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) s_agg[warp * kCC + cc] = x[cc];
  }
  // exclusive value of the lane (lane 0: nothing before it in the warp)
  const unsigned fe = __shfl_up_sync(0xffffffffu, f, 1);
  uint32_t carry[kCC];
#pragma unroll
  for (int cc = 0; cc < kCC; ++cc)
    carry[cc] = cc < nc ? __shfl_up_sync(0xffffffffu, x[cc], 1) : 0u;
  __syncthreads();
  // the earlier warps' aggregates, in warp order, where a thread needs them:
  // for its first end when nothing in its warp before it has an end, and
  // for the tile's trailing sum when the last warp has no end
  const bool last = threadIdx.x == kBlock - 1;
  uint32_t c[kCC];
#pragma unroll
  for (int cc = 0; cc < kCC; ++cc) c[cc] = 0u;
  if ((mask && (lane == 0 || !fe)) || (last && !f)) {
    for (int w = 0; w < warp; ++w) {
      const bool fw = s_flag[w];
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc)
        c[cc] = fw ? s_agg[w * kCC + cc]
                   : add<FLOAT>(c[cc], s_agg[w * kCC + cc]);
    }
  }
  if (mask && rank_t < n_keep) {
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      if (cc >= nc) continue;
      const uint32_t in = lane == 0 ? c[cc]
                          : fe    ? carry[cc]
                                  : add<FLOAT>(c[cc], carry[cc]);
      stage[rank_t * kStride + cc] = add<FLOAT>(in, first[cc]);
    }
  }
  if (last) {
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc)
      if (cc < nc) part[cc] = f ? x[cc] : add<FLOAT>(c[cc], x[cc]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
tile_sums_kernel(const int* __restrict__ keys, const int* __restrict__ keys2,
                 const uint32_t* __restrict__ cnts,
                 const uint32_t* __restrict__ vals, int M, int n_int,
                 int n_float, int sent, int u, int nT,
                 const int* __restrict__ counts,
                 const int* __restrict__ offsets, int* __restrict__ keys_u,
                 int* __restrict__ keys2_u, uint32_t* __restrict__ cnts_u,
                 uint32_t* __restrict__ sums_u,
                 uint32_t* __restrict__ partial) {
  extern __shared__ uint32_t stage[];   // [kT][kStride]
  __shared__ int s_warp[kWarps + 1];
  __shared__ unsigned s_flag[kWarps];
  __shared__ uint32_t s_agg[kWarps * kCC];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int i0 = tile * kT + threadIdx.x * kR;
  const size_t bt = (size_t)b * nT + tile;
  // chunks of kCC channels: the int planes' chunks, then the float planes'
  const int nq_int = (n_int + kCC - 1) / kCC;
  const int nq = nq_int + (n_float + kCC - 1) / kCC;
  auto chunk = [&](int q, int* c0, int* nc) {
    const bool fl = q >= nq_int;
    const int n = fl ? n_float : n_int;
    *c0 = (fl ? q - nq_int : q) * kCC;
    *nc = min(kCC, n - *c0);
    return (fl ? vals : cnts) + ((size_t)b * n + *c0) * M;
  };
  // the first chunk's loads fly while the keys are ranked
  uint32_t v[kCC][kR];
  if (nq > 0) {
    int c0, nc;
    const uint32_t* plane = chunk(0, &c0, &nc);
    load_chunk<VEC>(plane, M, nc, i0, v);
  }
  uint32_t key[kR], key2[kR];
  const unsigned mask = end_flags<VEC>(keys + (size_t)b * M,
                                       keys2 ? keys2 + (size_t)b * M : nullptr,
                                       i0, M, sent, key, key2);
  int total;
  const int rank_t = block_excl_sum(__popc(mask), &total, s_warp);
  const int base = offsets[bt];
  const int n_keep = max(0, min(u - base, counts[bt]));
  {
    int slot = rank_t;
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if ((mask >> r) & 1u) {
        if (slot < n_keep) {
          const size_t o = (size_t)b * u + base + slot;
          keys_u[o] = (int)key[r];
          if (keys2_u) keys2_u[o] = (int)key2[r];
        }
        ++slot;
      }
  }
  uint32_t* part = partial + bt * (n_int + n_float);
  for (int q = 0; q < nq; ++q) {
    const bool fl = q >= nq_int;
    int c0, nc;
    chunk(q, &c0, &nc);
    uint32_t first[kCC], x[kCC];
    if (fl)
      walk_rows<true>(v, nc, mask, rank_t, n_keep, stage, first, x);
    else
      walk_rows<false>(v, nc, mask, rank_t, n_keep, stage, first, x);
    // v is spent: the next chunk's loads fly during the scan and stores
    if (q + 1 < nq) {
      int c1, nc1;
      const uint32_t* plane = chunk(q + 1, &c1, &nc1);
      load_chunk<VEC>(plane, M, nc1, i0, v);
    }
    if (fl)
      scan_chunk<true>(x, first, nc, mask, rank_t, n_keep, part + n_int + c0,
                       stage, s_flag, s_agg);
    else
      scan_chunk<false>(x, first, nc, mask, rank_t, n_keep, part + c0, stage,
                        s_flag, s_agg);
    __syncthreads();
    const int n = fl ? n_float : n_int;
    uint32_t* out = (fl ? sums_u : cnts_u) + ((size_t)b * u + base) * n + c0;
    if (nc == kCC) {
      for (int idx = threadIdx.x; idx < n_keep * kCC; idx += kBlock) {
        const int r = idx / kCC, cc = idx - r * kCC;
        out[(size_t)r * n + cc] = stage[r * kStride + cc];
      }
    } else {
      for (int idx = threadIdx.x; idx < n_keep * nc; idx += kBlock) {
        const int r = idx / nc, cc = idx - r * nc;
        out[(size_t)r * n + cc] = stage[r * kStride + cc];
      }
    }
    __syncthreads();
  }
}

// Blocks x < nT, one per tile: the segment that crosses into the tile from
// the left gets the trailing sums of the tiles before it, from the last
// tile with an end (or tile 0) up to the tile before, added in tile order
// into the tile's first kept segment.  Blocks x >= nT zero the output slots
// past min(n_seg, u).
__global__ void finish_kernel(const int* __restrict__ counts,
                              const int* __restrict__ offsets,
                              const uint32_t* __restrict__ partial,
                              const int* __restrict__ n_seg, int nT,
                              int n_int, int n_float, int u,
                              int* __restrict__ keys_u,
                              int* __restrict__ keys2_u,
                              uint32_t* __restrict__ cnts_u,
                              uint32_t* __restrict__ sums_u) {
  const int b = blockIdx.y, tile = blockIdx.x;
  if (tile >= nT) {
    const size_t ns = (size_t)min(n_seg[b], u);
    const size_t step = (size_t)(gridDim.x - nT) * blockDim.x;
    const size_t i0 = (size_t)(tile - nT) * blockDim.x + threadIdx.x;
    const size_t bu = (size_t)b * u;
    for (size_t i = ns + i0; i < (size_t)u; i += step) {
      keys_u[bu + i] = 0;
      if (keys2_u) keys2_u[bu + i] = 0;
    }
    for (size_t i = ns * n_int + i0; i < (size_t)u * n_int; i += step)
      cnts_u[bu * n_int + i] = 0u;
    for (size_t i = ns * n_float + i0; i < (size_t)u * n_float; i += step)
      sums_u[bu * n_float + i] = 0u;
    return;
  }
  const size_t bt = (size_t)b * nT + tile;
  if (tile == 0 || counts[bt] == 0) return;
  const int r0 = offsets[bt];
  if (r0 >= u) return;
  int j0 = tile - 1;
  while (j0 > 0 && counts[bt - tile + j0] == 0) --j0;
  const int C = n_int + n_float;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const bool fl = c >= n_int;
    uint32_t s = 0u;
    for (int j = j0; j < tile; ++j)
      s = add(fl, s, partial[(bt - tile + j) * C + c]);
    uint32_t* o = fl ? sums_u + ((size_t)b * u + r0) * n_float + (c - n_int)
                     : cnts_u + ((size_t)b * u + r0) * n_int + c;
    *o = add(fl, *o, s);
  }
}

template <bool VEC>
int launch(const int* keys, const int* keys2, const int* cnts,
           const float* vals, int B, int M, int n_int, int n_float, int u,
           int sent, int* counts, int* offsets, void* partial, int* keys_u,
           int* keys2_u, int* cnts_u, float* sums_u, int* n_seg,
           cudaStream_t s) {
  const int nT = (M + kT - 1) / kT;
  const dim3 grid(nT, B);
  if (kStageBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_sums_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kStageBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto* cu = reinterpret_cast<uint32_t*>(cnts_u);
  auto* su = reinterpret_cast<uint32_t*>(sums_u);
  auto* part = static_cast<uint32_t*>(partial);
  count_ends_kernel<VEC><<<grid, kBlock, 0, s>>>(keys, keys2, M, sent, nT,
                                                 counts);
  scan_tiles_kernel<<<B, 1024, 0, s>>>(counts, nT, offsets, n_seg);
  tile_sums_kernel<VEC><<<grid, kBlock, kStageBytes, s>>>(
      keys, keys2, reinterpret_cast<const uint32_t*>(cnts),
      reinterpret_cast<const uint32_t*>(vals), M, n_int, n_float, sent, u, nT,
      counts, offsets, keys_u, keys2_u, cu, su, part);
  // zeroing blocks: enough to cover the widest output at 128 per block
  const long long width = n_int > n_float ? n_int : n_float;
  const long long want = ((long long)u * (width > 1 ? width : 1) + 127) / 128;
  const int zero_blocks = (int)(want < 1024 ? want : 1024);
  finish_kernel<<<dim3(nT + zero_blocks, B), 128, 0, s>>>(
      counts, offsets, part, n_seg, nT, n_int, n_float, u, keys_u, keys2_u,
      cu, su);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// keys/keys2 [B, M] int32 (keys2 may be null), cnts [B, n_int, M] int32,
// vals [B, n_float, M] f32; scratch counts/offsets [B, nT] int32 and
// partial [B, nT, n_int + n_float] 32-bit words, nT = ceil(M / tile rows);
// outputs keys_u/keys2_u [B, u], cnts_u [B, u, n_int], sums_u
// [B, u, n_float], n_seg [B].  Returns cudaGetLastError().
extern "C" int bnv_seg_reduce_sorted(
    const int* keys, const int* keys2, const int* cnts, const float* vals,
    int B, int M, int n_int, int n_float, int u, int sent, int* counts,
    int* offsets, void* partial, int* keys_u, int* keys2_u, int* cnts_u,
    float* sums_u, int* n_seg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = M % 4 == 0 && aligned16(keys) && aligned16(keys2) &&
                   aligned16(cnts) && aligned16(vals);
  return vec ? launch<true>(keys, keys2, cnts, vals, B, M, n_int, n_float, u,
                            sent, counts, offsets, partial, keys_u, keys2_u,
                            cnts_u, sums_u, n_seg, s)
             : launch<false>(keys, keys2, cnts, vals, B, M, n_int, n_float, u,
                             sent, counts, offsets, partial, keys_u, keys2_u,
                             cnts_u, sums_u, n_seg, s);
}

// Rows per tile, for the wrapper's scratch sizes.
extern "C" int bnv_seg_reduce_tile_rows() { return kT; }
