// Fused Myers match sweep for the stage-3 matcher, for Hopper (sm_90a).
//
// Replaces sctagger_tpu/ops/match_pallas.py:_match_full_kernel (via
// match_full_tpu) and _match_full_dynls_kernel (via match_full_dynls_tpu):
// one kernel, two entry points (no bound / per-block bound from maxlens).
//
// Per read r it computes, over all P_pad patterns and all segment positions:
//   out[0, r]          min infix (HW) edit distance, starting from m
//   out[1, r]          number of patterns at that min
//   out[2 .. 9, r]     the first TIES_K such pattern ids, ascending (BIG = empty)
// exactly as the Pallas kernels do (pattern padding with all-zero Peq rows
// included: such rows score m and count as ties only for reads whose min is m).
//
// Design: one thread per read. A block of THREADS reads streams the Peq table
// through shared memory in tiles of TILE_P patterns, in ascending pattern
// order, so every lane reads the same pattern row (a broadcast) and the tie
// slots fall out ascending. Running min, count and slots live in registers;
// PB patterns are swept together per text position for instruction-level
// parallelism and to amortise the code load. When the read axis alone is too
// short to fill the card, the wrapper splits the pattern axis over
// blockIdx.y; each split writes a partial row block and merge_splits()
// combines them with the exact first-K rule (splits are ascending pattern
// ranges, so concatenating the slots of the splits that reach the global min,
// in split order, keeps the first TIES_K ascending).
//
// Bound: int32 ALU issue, not bytes. Each (read, pattern, position) cell costs
// about 17 integer ops (the Myers step, the score update and the running min)
// against one shared-memory load; the inputs are a few MB per chunk.
//
// Bit vectors are uint32: shifts of negative signed ints are undefined in
// C++, and m = 32 puts the score bit at bit 31. The score bit is read as
// (ph >> (m-1)) & 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TIES_K = 8;
constexpr int BIG = 1 << 28;
constexpr int ROWS = TIES_K + 2;
constexpr int THREADS = 128;  // reads per block
constexpr int TILE_P = 256;   // patterns per shared Peq tile (the P_pad unit)
constexpr int PB = 4;         // patterns swept together per thread
constexpr int PEQ_COLS = 8;   // pattern-major Peq row: codes 0..4 + padding

struct Ties {
  int best;
  int cnt;
  int slot[TIES_K];

  __device__ __forceinline__ void init(int m) {
    best = m;
    cnt = 0;
#pragma unroll
    for (int t = 0; t < TIES_K; ++t) slot[t] = BIG;
  }

  // Pattern p (ascending across calls) with distance d.
  __device__ __forceinline__ void add(int d, int p) {
    if (d < best) {
      best = d;
      cnt = 0;
#pragma unroll
      for (int t = 0; t < TIES_K; ++t) slot[t] = BIG;
    }
    if (d == best) {
      // static indices keep the slots in registers
#pragma unroll
      for (int t = 0; t < TIES_K; ++t)
        if (t == cnt) slot[t] = p;
      ++cnt;
    }
  }

  __device__ __forceinline__ void store(int32_t* out, int r, int r_pad) const {
    out[r] = best;
    out[(size_t)r_pad + r] = cnt;
#pragma unroll
    for (int t = 0; t < TIES_K; ++t) out[(size_t)(2 + t) * r_pad + r] = slot[t];
  }
};

template <bool DYN>
__global__ void __launch_bounds__(THREADS, 8)  // <= 64 registers a thread
match_sweep(const int8_t* __restrict__ seg, int ls, int r_pad,
            const int32_t* __restrict__ peq, int n_tiles, int tiles_per_split,
            const int32_t* __restrict__ maxlens, int mlen_block, int m,
            int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t tile[TILE_P * PEQ_COLS];

  const int r = blockIdx.x * THREADS + threadIdx.x;
  const bool live = r < r_pad;
  int bound = ls;
  if (DYN && live) bound = max(0, min(maxlens[r / mlen_block], ls));
  const unsigned sh = (unsigned)(m - 1);
  const int8_t* col = seg + r;

  Ties ties;
  ties.init(m);

  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // previous tile fully consumed
    // 16-byte copies; columns 4..7 become zero, so every code outside 0..3
    // (pad code 4 included) selects a zero Eq, as the Pallas select chain
    const int4* src = reinterpret_cast<const int4*>(peq) + (size_t)t * TILE_P * 2;
    int4* dst = reinterpret_cast<int4*>(tile);
    for (int i = threadIdx.x; i < TILE_P * 2; i += THREADS)
      dst[i] = (i & 1) ? make_int4(0, 0, 0, 0) : src[i];
    __syncthreads();
    if (!live) continue;

    for (int pl = 0; pl < TILE_P; pl += PB) {
      const uint32_t* tp = tile + pl * PEQ_COLS;
      uint32_t pv[PB], mv[PB];
      int score[PB], low[PB];
#pragma unroll
      for (int k = 0; k < PB; ++k) {
        pv[k] = 0xffffffffu;
        mv[k] = 0u;
        score[k] = m;
        low[k] = m;
      }
#pragma unroll 2
      for (int j = 0; j < bound; ++j) {
        const unsigned c = min((unsigned)(uint8_t)col[(size_t)j * r_pad], 4u);
#pragma unroll
        for (int k = 0; k < PB; ++k) {
          const uint32_t eq = tp[k * PEQ_COLS + c];
          const uint32_t xv = eq | mv[k];
          const uint32_t xh = (((eq & pv[k]) + pv[k]) ^ pv[k]) | eq;
          uint32_t ph = mv[k] | ~(xh | pv[k]);
          uint32_t mh = pv[k] & xh;
          score[k] += (int)((ph >> sh) & 1u) - (int)((mh >> sh) & 1u);
          ph <<= 1;
          mh <<= 1;
          pv[k] = mh | ~(xv | ph);
          mv[k] = ph & xv;
          low[k] = min(low[k], score[k]);
        }
      }
      const int p0 = t * TILE_P + pl;
#pragma unroll
      for (int k = 0; k < PB; ++k) ties.add(low[k], p0 + k);
    }
  }
  if (live) ties.store(out + (size_t)blockIdx.y * ROWS * r_pad, r, r_pad);
}

// partial: (n_split, ROWS, r_pad); out: (ROWS, r_pad).
__global__ void merge_splits(const int32_t* __restrict__ partial, int n_split,
                             int r_pad, int m, int32_t* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= r_pad) return;
  const size_t split_stride = (size_t)ROWS * r_pad;
  int best = m;
  for (int s = 0; s < n_split; ++s) best = min(best, partial[s * split_stride + r]);
  Ties ties;
  ties.init(best);
  int total = 0;
  for (int s = 0; s < n_split; ++s) {
    const int32_t* p = partial + s * split_stride;
    if (p[r] != best) continue;
    const int c = p[(size_t)r_pad + r];
#pragma unroll
    for (int t = 0; t < TIES_K; ++t)
      if (t < c) ties.add(best, p[(size_t)(2 + t) * r_pad + r]);
    total += c;
  }
  ties.cnt = total;
  ties.store(out, r, r_pad);
}

}  // namespace

extern "C" {

// seg: (ls, r_pad) int8 codes, position-major. peq: (p_pad, 8) int32,
// pattern-major, p_pad a multiple of 256, 16-byte aligned. maxlens: null
// (no bound) or one int32 bound per mlen_block consecutive reads. partial:
// (n_split, 10, r_pad) int32 scratch, unused when one split covers all
// tiles. out: (10, r_pad) int32. Launches on `stream`; returns
// cudaGetLastError() after the launches.
int sctag_match_full(const void* seg, int ls, int r_pad, const void* peq,
                     int p_pad, const void* maxlens, int mlen_block, int m,
                     int tiles_per_split, void* partial, void* out,
                     void* stream) {
  const int n_tiles = p_pad / TILE_P;
  const int n_split = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((r_pad + THREADS - 1) / THREADS, n_split);
  int32_t* dst = static_cast<int32_t*>(n_split > 1 ? partial : out);
  const int8_t* sg = static_cast<const int8_t*>(seg);
  const int32_t* pq = static_cast<const int32_t*>(peq);
  const int32_t* ml = static_cast<const int32_t*>(maxlens);
  if (ml != nullptr)
    match_sweep<true><<<grid, THREADS, 0, s>>>(sg, ls, r_pad, pq, n_tiles,
                                                tiles_per_split, ml, mlen_block,
                                                m, dst);
  else
    match_sweep<false><<<grid, THREADS, 0, s>>>(sg, ls, r_pad, pq, n_tiles,
                                                 tiles_per_split, nullptr, 1, m,
                                                 dst);
  if (n_split > 1) {
    const int mt = 256;
    merge_splits<<<(r_pad + mt - 1) / mt, mt, 0, s>>>(
        dst, n_split, r_pad, m, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
