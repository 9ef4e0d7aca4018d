// Myers match sweep for the stage-3 matcher, for Hopper (sm_90a), with the
// four epilogues of the Pallas match kernels.
//
// Replaces, in sctagger_tpu/ops/match_pallas.py, the four kernels that share
// _dp_sweep (:98), one templated sweep and one C entry point each:
//   FULL  _match_full_kernel via match_full_tpu (K1) and
//         _match_full_dynls_kernel via match_full_dynls_tpu (K2):
//           out (10, r_pad) int32: [0] min infix (HW) distance, starting from
//           m; [1] number of patterns at that min; [2 .. 9] the first TIES_K
//           such pattern ids, ascending (BIG = empty)
//   MIN   _match_min_kernel via match_min_tpu (K4):
//           out (1, r_pad) int32: the min distance alone
//   BEST  _match_best_kernel via match_best_tpu (K5):
//           out (p_pad, r_pad) int8: min(best distance, 127) of every
//           (pattern, read) pair
//   TIES  _match_ties_kernel via match_ties_tpu (K3), given target (r_pad,):
//           out (9, r_pad) int32: [0] number of patterns whose best distance
//           is target[r]; [1 .. 8] the first TIES_K such ids, ascending
// exactly as the Pallas kernels compute them over all P_pad patterns: pattern
// padding has an all-zero Peq, scores m, and so counts as a tie (FULL) or a
// hit (TIES, target == m) like any other pattern.
//
// Design: one thread per read. A block of THREADS reads streams the Peq table
// through shared memory in tiles of TILE_P patterns, in ascending pattern
// order, so every lane reads the same pattern row (a broadcast) and the tie
// slots fall out ascending. Running min, count and slots live in registers;
// PB patterns are swept together per text position for instruction-level
// parallelism and to amortise the code load. When the read axis alone is too
// short to fill the card, the wrapper splits the pattern axis over
// blockIdx.y. BEST needs no merge (each (pattern, read) byte is written once,
// the 32 reads of a warp to 32 consecutive bytes). FULL, MIN and TIES write a
// partial row block per split, and one merge kernel each combines them: MIN
// takes the min; FULL keeps the exact first-K rule (splits are ascending
// pattern ranges, so concatenating the slots of the splits that reach the
// global min, in split order, keeps the first TIES_K ascending); TIES is the
// same with the target fixed (every split's count adds, slots concatenate).
//
// Bound: the int32 ALU instruction rate, not bytes. Each (read, pattern,
// position) cell costs about 22 integer ops (the Myers step, the score update
// and the running min) against one shared-memory load; the inputs are a few MB
// per chunk. BEST adds one byte of output per (pattern, read), a few hundred
// MB at most per chunk, which the sweep of 24-32 positions per byte outlasts.
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

// Epilogues: what each (read, pattern) best distance feeds.
constexpr int FULL = 0;  // running min + ties (K1, K2)
constexpr int MIN = 1;   // running min (K4)
constexpr int BEST = 2;  // the int8 best matrix (K5)
constexpr int TIES = 3;  // hits at a given target (K3)

// int32 rows of one split's partial output (BEST writes bytes, no rows)
__host__ __device__ constexpr int rows_of(int epi) {
  return epi == FULL ? ROWS : epi == MIN ? 1 : epi == TIES ? TIES_K + 1 : 0;
}

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

  // One more hit, pattern p (ascending across calls).
  __device__ __forceinline__ void append(int p) {
    // static indices keep the slots in registers
#pragma unroll
    for (int t = 0; t < TIES_K; ++t)
      if (t == cnt) slot[t] = p;
    ++cnt;
  }

  // Pattern p (ascending across calls) with distance d, against the
  // running min.
  __device__ __forceinline__ void add(int d, int p) {
    if (d < best) {
      best = d;
      cnt = 0;
#pragma unroll
      for (int t = 0; t < TIES_K; ++t) slot[t] = BIG;
    }
    if (d == best) append(p);
  }

  // FULL rows: best, cnt, slots. TIES rows: cnt, slots.
  __device__ __forceinline__ void store(int32_t* out, int r, int r_pad,
                                        bool with_best) const {
    if (with_best) {
      out[r] = best;
      out += r_pad;
    }
    out[r] = cnt;
#pragma unroll
    for (int t = 0; t < TIES_K; ++t) out[(size_t)(1 + t) * r_pad + r] = slot[t];
  }
};

template <bool DYN, int EPI>
__global__ void __launch_bounds__(THREADS, 8)  // <= 64 registers a thread
match_sweep(const int8_t* __restrict__ seg, int ls, int r_pad,
            const int32_t* __restrict__ peq, int n_tiles, int tiles_per_split,
            const int32_t* __restrict__ maxlens, int mlen_block,
            const int32_t* __restrict__ target, int m, void* __restrict__ out) {
  __shared__ __align__(16) uint32_t tile[TILE_P * PEQ_COLS];

  const int r = blockIdx.x * THREADS + threadIdx.x;
  const bool live = r < r_pad;
  int bound = ls;
  if (DYN && live) bound = max(0, min(maxlens[r / mlen_block], ls));
  const unsigned sh = (unsigned)(m - 1);
  const int8_t* col = seg + r;
  const int tgt = (EPI == TIES && live) ? target[r] : 0;

  Ties ties;  // FULL: running min + ties; MIN: best; TIES: hits
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
      for (int k = 0; k < PB; ++k) {
        if (EPI == FULL) ties.add(low[k], p0 + k);
        if (EPI == MIN) ties.best = min(ties.best, low[k]);
        if (EPI == TIES && low[k] == tgt) ties.append(p0 + k);
        if (EPI == BEST)
          static_cast<int8_t*>(out)[(size_t)(p0 + k) * r_pad + r] =
              (int8_t)min(low[k], 127);
      }
    }
  }
  if (!live || EPI == BEST) return;
  int32_t* o = static_cast<int32_t*>(out) + (size_t)blockIdx.y * rows_of(EPI) * r_pad;
  if (EPI == MIN)
    o[r] = ties.best;
  else
    ties.store(o, r, r_pad, EPI == FULL);
}

// partial: (n_split, rows_of(EPI), r_pad); out: (rows_of(EPI), r_pad).
template <int EPI>
__global__ void merge_splits(const int32_t* __restrict__ partial, int n_split,
                             int r_pad, int m, int32_t* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= r_pad) return;
  const size_t split_stride = (size_t)rows_of(EPI) * r_pad;
  int best = m;  // FULL, MIN: the global min; TIES: unused
  if (EPI != TIES)
    for (int s = 0; s < n_split; ++s) best = min(best, partial[s * split_stride + r]);
  if (EPI == MIN) {
    out[r] = best;
    return;
  }
  Ties ties;
  ties.init(best);
  int total = 0;
  for (int s = 0; s < n_split; ++s) {
    const int32_t* p = partial + s * split_stride;
    if (EPI == FULL) {
      if (p[r] != best) continue;
      p += r_pad;  // FULL rows: best, then count and slots as TIES rows
    }
    const int c = p[r];
#pragma unroll
    for (int t = 0; t < TIES_K; ++t)
      if (t < c) ties.append(p[(size_t)(1 + t) * r_pad + r]);
    total += c;
  }
  ties.cnt = total;
  ties.store(out, r, r_pad, EPI == FULL);
}

template <int EPI>
int launch(const void* seg, int ls, int r_pad, const void* peq, int p_pad,
           const void* maxlens, int mlen_block, const void* target, int m,
           int tiles_per_split, void* partial, void* out, void* stream) {
  const int n_tiles = p_pad / TILE_P;
  const int n_split = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const bool merge = EPI != BEST && n_split > 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((r_pad + THREADS - 1) / THREADS, n_split);
  void* dst = merge ? partial : out;
  const int8_t* sg = static_cast<const int8_t*>(seg);
  const int32_t* pq = static_cast<const int32_t*>(peq);
  const int32_t* ml = static_cast<const int32_t*>(maxlens);
  const int32_t* tg = static_cast<const int32_t*>(target);
  if (EPI == FULL && ml != nullptr)
    match_sweep<true, FULL><<<grid, THREADS, 0, s>>>(
        sg, ls, r_pad, pq, n_tiles, tiles_per_split, ml, mlen_block, nullptr,
        m, dst);
  else
    match_sweep<false, EPI><<<grid, THREADS, 0, s>>>(
        sg, ls, r_pad, pq, n_tiles, tiles_per_split, nullptr, 1, tg, m, dst);
  if constexpr (EPI != BEST) {
    if (merge) {
      const int mt = 256;
      merge_splits<EPI><<<(r_pad + mt - 1) / mt, mt, 0, s>>>(
          static_cast<const int32_t*>(partial), n_split, r_pad, m,
          static_cast<int32_t*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All four entry points take the same arguments; each reads only its own.
// seg: (ls, r_pad) int8 codes, position-major. peq: (p_pad, 8) int32,
// pattern-major, p_pad a multiple of 256, 16-byte aligned. maxlens (FULL
// only): null (no bound) or one int32 bound per mlen_block consecutive reads.
// target (TIES only): (r_pad,) int32. partial: (n_split, rows, r_pad) int32
// scratch, unused when one split covers all tiles (and by BEST). out: see the
// top of this file. Launches on `stream`; returns cudaGetLastError() after
// the launches.
#define SCTAG_MATCH_ENTRY(name, epi)                                          \
  int name(const void* seg, int ls, int r_pad, const void* peq, int p_pad,   \
           const void* maxlens, int mlen_block, const void* target, int m,   \
           int tiles_per_split, void* partial, void* out, void* stream) {    \
    return launch<epi>(seg, ls, r_pad, peq, p_pad, maxlens, mlen_block,      \
                       target, m, tiles_per_split, partial, out, stream);    \
  }

extern "C" {
SCTAG_MATCH_ENTRY(sctag_match_full, FULL)
SCTAG_MATCH_ENTRY(sctag_match_min, MIN)
SCTAG_MATCH_ENTRY(sctag_match_best, BEST)
SCTAG_MATCH_ENTRY(sctag_match_ties, TIES)
}  // extern "C"
