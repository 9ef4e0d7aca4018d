// Stage-1 adapter scan for Hopper (sm_90a).
//
// Replaces sctagger_tpu/ops/adapter_pallas.py:_kernel (via _adapter_scan_call
// and adapter_scan_dispatch_packed). For read r and strand p (0 = the adapter,
// 1 = its reverse complement) it computes over the text positions j < len[r]:
//   out[6p + 0, r]        d, the min infix (HW) Myers distance, starting from m
//   out[6p + 1, r]        cnt, the number of end positions j whose score is d
//                         (not clipped)
//   out[6p + 2 .. 5, r]   the first SLOTS_K such positions, ascending; -1 in
//                         every slot at or past min(cnt, SLOTS_K)
// An empty read gives d = m and cnt = 0 on both strands.
//
// Design: one thread per read, both strands advanced in the same loop (two
// independent dependency chains for instruction-level parallelism). The text
// stays 2-bit packed and row-major, as the host encoder emits it (char j of a
// row at byte j >> 2, bits 2 * (j & 3)); a thread loads its row 16 bytes (64
// chars) at a time and loops to its own read's length, so a padded position
// never reaches the running min. The caller sorts reads by length, so the
// threads of a warp stop at similar lengths. Reads with non-ACGT chars are
// not representable in 2 bits: the caller routes them to its exact fallback.
//
// Bound: int32 instruction throughput, not bytes. A char costs two Myers
// steps plus the running-min bookkeeping (about 50 integer ops) against 1/4
// byte of text; a card full of reads is ALU-bound, a short chunk
// latency-bound on the serial Myers chain, which the two strands interleave.
//
// Bit vectors are uint32: shifts of negative signed ints are undefined in
// C++, and m = 32 puts the score bit at bit 31. The score bit is read as
// (ph >> (m-1)) & 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SLOTS_K = 4;
constexpr int ROWS_PER_STRAND = 2 + SLOTS_K;
constexpr int THREADS = 64;  // reads per block

struct Peq {
  uint32_t eq[2][4];  // [strand][base code A, C, G, T]
};

__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t c, uint32_t g,
                                         uint32_t t, uint32_t code) {
  return (code & 2u) ? ((code & 1u) ? t : g) : ((code & 1u) ? c : a);
}

struct Strand {
  uint32_t pv, mv;
  int score, d, cnt, s0, s1, s2, s3;

  __device__ __forceinline__ void init(int m) {
    pv = 0xffffffffu;
    mv = 0u;
    score = m;
    d = m;
    cnt = 0;
    s0 = s1 = s2 = s3 = -1;
  }

  __device__ __forceinline__ void step(uint32_t eq, unsigned sh, int j) {
    const uint32_t xv = eq | mv;
    const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
    uint32_t ph = mv | ~(xh | pv);
    uint32_t mh = pv & xh;
    score += (int)((ph >> sh) & 1u) - (int)((mh >> sh) & 1u);
    ph <<= 1;
    mh <<= 1;
    pv = mh | ~(xv | ph);
    mv = ph & xv;
    if (score < d) {  // a new min: forget the ends of the old one
      d = score;
      cnt = 0;
      s1 = s2 = s3 = -1;
    }
    if (score == d) {
      s0 = cnt == 0 ? j : s0;
      s1 = cnt == 1 ? j : s1;
      s2 = cnt == 2 ? j : s2;
      s3 = cnt == 3 ? j : s3;
      ++cnt;
    }
  }

  __device__ __forceinline__ void store(int32_t* out, int r, int b) const {
    out[r] = d;
    out[(size_t)b + r] = cnt;
    out[(size_t)2 * b + r] = s0;
    out[(size_t)3 * b + r] = s1;
    out[(size_t)4 * b + r] = s2;
    out[(size_t)5 * b + r] = s3;
  }
};

__global__ void __launch_bounds__(THREADS)
adapter_scan(const uint8_t* __restrict__ text, int b, int row_bytes,
             const int32_t* __restrict__ lens, Peq peq, int m,
             int32_t* __restrict__ out) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= b) return;
  const int len = min(lens[r], 4 * row_bytes);  // never read past the row
  const unsigned sh = (unsigned)(m - 1);
  const uint32_t fa = peq.eq[0][0], fc = peq.eq[0][1], fg = peq.eq[0][2],
                 ft = peq.eq[0][3];
  const uint32_t ra = peq.eq[1][0], rc_ = peq.eq[1][1], rg = peq.eq[1][2],
                 rt = peq.eq[1][3];
  const uint4* row = reinterpret_cast<const uint4*>(text + (size_t)r * row_bytes);

  Strand fwd, rev;
  fwd.init(m);
  rev.init(m);
  for (int j0 = 0; j0 < len; j0 += 64) {
    const uint4 v = __ldg(row + (j0 >> 6));
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      uint32_t word = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
      const int jq = j0 + 16 * q;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int j = jq + k;
        if (j < len) {
          const uint32_t code = word & 3u;
          fwd.step(pick(fa, fc, fg, ft, code), sh, j);
          rev.step(pick(ra, rc_, rg, rt, code), sh, j);
        }
        word >>= 2;
      }
    }
  }
  fwd.store(out, r, b);
  rev.store(out + (size_t)ROWS_PER_STRAND * b, r, b);
}

}  // namespace

extern "C" {

// text: (b, row_bytes) uint8, 2-bit packed rows, row_bytes a multiple of 16,
// 16-byte aligned. lens: (b,) int32, each <= 4 * row_bytes (a longer one is
// cut to the row). peq_host: 8 int32 in HOST memory, [strand][A, C, G, T]
// (bit i set where pattern char i is that base). out: (12, b) int32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
int sctag_adapter_scan(const void* text, int b, int row_bytes, const void* lens,
                       const int32_t* peq_host, int m, void* out, void* stream) {
  Peq peq;
  for (int p = 0; p < 2; ++p)
    for (int c = 0; c < 4; ++c) peq.eq[p][c] = (uint32_t)peq_host[4 * p + c];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adapter_scan<<<(b + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(text), b, row_bytes,
      static_cast<const int32_t*>(lens), peq, m, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
