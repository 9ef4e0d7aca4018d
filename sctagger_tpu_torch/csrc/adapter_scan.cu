// Stage-1 adapter scan for Hopper (sm_90a): one Myers sweep, two epilogues.
//
// Replaces sctagger_tpu/ops/adapter_pallas.py:_kernel (via _adapter_scan_call
// and adapter_scan_dispatch_packed). For read r and strand p (0 = the adapter,
// 1 = its reverse complement) the infix (HW) Myers score at text position j
// is the best distance of the pattern against a text span ending at j.
//
// SLOTS (sctag_adapter_scan), over the positions j < len[r] of 2-bit text:
//   out[6p + 0, r]        d, the min score, starting from m
//   out[6p + 1, r]        cnt, the number of positions whose score is d (not
//                         clipped)
//   out[6p + 2 .. 5, r]   the first SLOTS_K such positions, ascending; -1 in
//                         every slot at or past min(cnt, SLOTS_K)
// An empty read gives d = m and cnt = 0 on both strands.
//
// MASK (sctag_adapter_mask), for the reads SLOTS cannot decide (non-ACGT
// chars, more than SLOTS_K ends), over byte codes (A, C, G, T = 0..3; 4 and
// above match nothing, as the pad/junk code 4 does in the JAX mask path):
//   d[p, r]               the min score over j < len[r], clamped to m
//   bits[r, p, w]         bit (j & 31) of word j >> 5 set where j < len[r]
//                         and the score at j equals d[p, r]
//
// Design. Both epilogues walk a read in SEGMENTS. An alignment of cost <= m
// spans at most 2m text chars, and every HW score is <= m, so a Myers state
// started fresh at w0 <= lo - 2m gives the exact score at every j >= lo: a
// segment [lo, hi) is scanned from w0 ("warm-up", Myers only) and its
// positions are exact. Both strands advance in the same loop (two
// independent dependency chains). Bit vectors are uint32 with the pattern
// left-aligned (Peq shifted up by 32 - m): the score bit is bit 31 for every
// m, and the zero bits below the pattern shift a 0 into row 0, as HW wants.
//
// SLOTS: a read is cut into nseg (a power of two <= 32) segments of
// round_up(cdiv(len, nseg), 64) chars; lane k of a group of nseg adjacent
// lanes (one warp holds whole groups) takes segment k, so nseg x more threads
// fill the card for a small chunk. The hot loop is the Myers step and one
// compare, score <= d, per strand; the bookkeeping (new min: reset; tie:
// count and slot) sits behind that compare. A segment starts each strand's
// running min at U = min(m, that strand's warm-up scores): a warm-up score
// is >= the exact score there, so U >= the read's min D on that strand; a
// segment whose min is above U reports (U, 0), which the merge drops or adds
// as 0, and the segment holding D reports it exactly. That keeps the early run of new minima (d falling from m) out of
// all segments but the first. The group then merges in order by shuffles,
// the rule match_full.cu's merge_splits applies across its pattern split:
// the min; counts added at a common min; the first SLOTS_K ends in position
// order. Reads are length-sorted, so the lanes of a warp stop together.
//
// MASK: one pass, one strand a thread. A read is cut into nseg (a power of
// two <= 32, chosen per launch) segments of round_up(cdiv(len, nseg), 32)
// chars, so a segment owns whole mask words; a group of nseg adjacent lanes
// takes one strand of one read, lane k segment k, and the read's two groups
// sit side by side. A thread thus carries one Myers dependency chain: the
// card's in-order issue finds its parallelism across warps, which a thread
// stepping both strands did not give it (ptxas ordered one strand's steps
// before the other's). After the warm-up a thread keeps a running min d and
// cur, the word of its last drop. Each word of 32 chars is stepped with its
// scores kept in registers; its min wm and its positions at wm follow (a
// min and a compare per char, no branch), then d = min(d, wm) and the word
// is stored at once: its positions at wm if wm == d, else 0. The words
// stored before cur may hold positions of a higher min. The group's min D
// comes from xor shuffles (no atomics). Then each lane zeroes what is not
// at D: the words before cur when its d == D, all its words when d > D
// (the segment holds no position at D). This is exact: a segment whose own
// min is D holds exactly the read's argmin positions in its span. Every
// word of the output row is written (past a read's end: zeros), so the
// caller need not clear it. Codes are read 16 bytes a load (uint4), the
// next word's loads issued a word ahead; the Eq comes from a table in
// shared memory indexed by strand and byte code (zero from code 4 on), one
// load a char, so junk needs no test.
//
// Bound, on this card: int32 instruction issue, not bytes. SLOTS reads 1/4
// byte of text per char against two Myers steps (~30 integer instructions);
// MASK reads one byte per char against the same steps and writes 1/4 byte of
// mask bits. A segment of s chars steps its warm-up (2m to 2m + 15 chars:
// 48 at m = 22) and then its s chars: at m = 22 that is 1.19 steps per
// needed step at s = 256, the segment length of a full 4,096-read launch of
// 2 kbp reads, and a chain of 112 dependent steps at s = 64, the length at
// ~100 such reads, which sets the time of so small a launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SLOTS_K = 4;
constexpr int ROWS_PER_STRAND = 2 + SLOTS_K;
constexpr int SLOTS_THREADS = 128;  // whole warps, so a group never splits
constexpr int MASK_THREADS = 128;   // whole warps, so a group never splits
constexpr unsigned FULL = 0xffffffffu;

struct Peq {
  uint32_t eq[2][4];  // [strand][base code A, C, G, T], left-aligned
};

__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t c, uint32_t g,
                                         uint32_t t, uint32_t code) {
  return (code & 2u) ? ((code & 1u) ? t : g) : ((code & 1u) ? c : a);
}

// One strand's Myers column state; the score bit is bit 31.
struct Myers {
  uint32_t pv, mv;
  int score;

  __device__ __forceinline__ void init(int m) {
    pv = 0xffffffffu;
    mv = 0u;
    score = m;
  }

  __device__ __forceinline__ void step(uint32_t eq) {
    const uint32_t xv = eq | mv;
    const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
    uint32_t ph = mv | ~(xh | pv);
    uint32_t mh = pv & xh;
    score += (int)(ph >> 31) - (int)(mh >> 31);
    ph <<= 1;
    mh <<= 1;
    pv = mh | ~(xv | ph);
    mv = ph & xv;
  }
};

// Both strands of one read (SLOTS); Eq per base held in registers.
struct Pair {
  Myers f, r;
  uint32_t fa, fc, fg, ft, ra, rc, rg, rt;

  __device__ __forceinline__ void init(const Peq& p, int m) {
    fa = p.eq[0][0]; fc = p.eq[0][1]; fg = p.eq[0][2]; ft = p.eq[0][3];
    ra = p.eq[1][0]; rc = p.eq[1][1]; rg = p.eq[1][2]; rt = p.eq[1][3];
    f.init(m);
    r.init(m);
  }
  __device__ __forceinline__ void step(uint32_t code) {
    f.step(pick(fa, fc, fg, ft, code));
    r.step(pick(ra, rc, rg, rt, code));
  }
};

// SLOTS epilogue state of one strand over one segment.
struct Ends {
  int d, cnt, s0, s1, s2, s3;

  __device__ __forceinline__ void init(int u) {
    d = u;
    cnt = 0;
    s0 = s1 = s2 = s3 = -1;
  }

  // called when score <= d on either strand (a no-op on a strand above d)
  __device__ __forceinline__ void note(int score, int j) {
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

  // this (earlier positions) followed by b (later positions)
  __device__ __forceinline__ void merge(const Ends& b) {
    if (b.d < d) {
      *this = b;
    } else if (b.d == d) {
      const int c = cnt;
      s0 = c > 0 ? s0 : b.s0;
      s1 = c > 1 ? s1 : (c == 1 ? b.s0 : b.s1);
      s2 = c > 2 ? s2 : (c == 2 ? b.s0 : c == 1 ? b.s1 : b.s2);
      s3 = c > 3 ? s3 : (c == 3 ? b.s0 : c == 2 ? b.s1 : c == 1 ? b.s2 : b.s3);
      cnt += b.cnt;
    }
  }

  __device__ __forceinline__ Ends shfl_down(unsigned off) const {
    Ends o;
    o.d = __shfl_down_sync(FULL, d, off);
    o.cnt = __shfl_down_sync(FULL, cnt, off);
    o.s0 = __shfl_down_sync(FULL, s0, off);
    o.s1 = __shfl_down_sync(FULL, s1, off);
    o.s2 = __shfl_down_sync(FULL, s2, off);
    o.s3 = __shfl_down_sync(FULL, s3, off);
    return o;
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

// SLOTS, 16 chars of one packed word at positions j .. j + 15 (only those
// below hi when CHECK); the bookkeeping sits behind score <= d.
template <bool CHECK>
__device__ __forceinline__ void slots_word(uint32_t word, int j, int hi, Pair& s,
                                           Ends& fe, Ends& re) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (!CHECK || j + k < hi) {
      s.step(word & 3u);
      const int fs = s.f.score, rs = s.r.score;
      if (fs <= fe.d || rs <= re.d) {
        fe.note(fs, j + k);
        re.note(rs, j + k);
      }
    }
    word >>= 2;
  }
}

__global__ void __launch_bounds__(SLOTS_THREADS)
adapter_slots(const uint8_t* __restrict__ text, int b, int row_bytes,
              const int32_t* __restrict__ lens, Peq peq, int m, int log_nseg,
              int32_t* __restrict__ out) {
  const int g = blockIdx.x * SLOTS_THREADS + threadIdx.x;
  const int r = g >> log_nseg;
  const int nseg = 1 << log_nseg;
  const int k = g & (nseg - 1);
  const int len = r < b ? min(lens[r], 4 * row_bytes) : 0;  // never past the row
  const int seg = ((len + nseg - 1) / nseg + 63) & ~63;
  const int lo = k * seg;
  const int hi = min(lo + seg, len);

  Ends fe, re;
  fe.init(m);
  re.init(m);
  if (lo < hi) {
    const uint8_t* row = text + (size_t)r * row_bytes;
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(row);
    const uint4* w128 = reinterpret_cast<const uint4*>(row);
    Pair s;
    s.init(peq, m);
    // warm-up: whole words from w0 <= lo - 2m (lo is a multiple of 64)
    int uf = m, ur = m;
    for (int j = max(0, (lo - 2 * m) & ~15); j < lo; j += 16) {
      uint32_t word = __ldg(w32 + (j >> 4));
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        s.step(word & 3u);
        uf = min(uf, s.f.score);
        ur = min(ur, s.r.score);
        word >>= 2;
      }
    }
    fe.init(uf);
    re.init(ur);
    int j0 = lo;
    for (; j0 + 64 <= hi; j0 += 64) {
      const uint4 v = __ldg(w128 + (j0 >> 6));
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        const uint32_t word = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
        slots_word<false>(word, j0 + 16 * q, hi, s, fe, re);
      }
    }
    if (j0 < hi) {  // the ragged end: fewer than 64 chars
      const uint4 v = __ldg(w128 + (j0 >> 6));
      slots_word<true>(v.x, j0, hi, s, fe, re);
      slots_word<true>(v.y, j0 + 16, hi, s, fe, re);
      slots_word<true>(v.z, j0 + 32, hi, s, fe, re);
      slots_word<true>(v.w, j0 + 48, hi, s, fe, re);
    }
  }
  // merge the group's segments in order: lane k takes lane k + off's
  for (int off = 1; off < nseg; off <<= 1) {
    const Ends fo = fe.shfl_down(off), ro = re.shfl_down(off);
    if ((k & (2 * off - 1)) == 0) {
      fe.merge(fo);
      re.merge(ro);
    }
  }
  if (k == 0 && r < b) {
    fe.store(out, r, b);
    re.store(out + (size_t)ROWS_PER_STRAND * b, r, b);
  }
}

// MASK running state of one strand over one segment: the min d so far and
// cur, the word of its last drop.
struct Run {
  int d, cur;

  __device__ __forceinline__ void init(int m, int word) {
    d = m;
    cur = word;
  }
  // Word `w` is finished: wm is its min score, bits its positions at wm.
  // Returns the word to store: bits if wm is the running min, else 0.
  __device__ __forceinline__ uint32_t word(int wm, uint32_t bits, int w) {
    cur = wm < d ? w : cur;
    d = min(d, wm);
    return wm == d ? bits : 0u;
  }
};

// The byte code of char q (0..15) of a 16-byte load.
__device__ __forceinline__ uint32_t byte_of(const uint4& v, int q) {
  const uint32_t x = q < 4 ? v.x : q < 8 ? v.y : q < 12 ? v.z : v.w;
  return (x >> (8 * (q & 3))) & 0xffu;
}

// MASK warm-up over the 16 chars of one load: Myers only. eq[code] is the
// strand's Eq (zero for every code >= 4).
__device__ __forceinline__ void mask_warm(const uint4& v, const uint32_t* eq, Myers& s) {
#pragma unroll
  for (int q = 0; q < 16; ++q) s.step(eq[byte_of(v, q)]);
}

// The min score over 16 chars and the bits (0..15) of the chars at it.
struct Half {
  int best;
  uint32_t bits;
};

// MASK over the 16 chars of one load at positions j .. j + 15 (when CHECK,
// only those below hi; at least position j is). The scores are kept, so
// the bookkeeping is a min per char and one compare per char after it.
template <bool CHECK>
__device__ __forceinline__ Half mask_16(const uint4& v, int j, int hi, const uint32_t* eq,
                                        int m, Myers& s) {
  int sc[16];
  Half h;
  h.best = m;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    if (!CHECK || j + q < hi) {
      s.step(eq[byte_of(v, q)]);
      sc[q] = s.score;
    } else {  // past the segment: above every score
      sc[q] = m + 1;
    }
    h.best = min(h.best, sc[q]);
  }
  h.bits = 0u;
#pragma unroll
  for (int q = 0; q < 16; ++q) h.bits |= sc[q] == h.best ? 1u << q : 0u;
  return h;
}

// The word of two halves: its min and its positions at it.
__device__ __forceinline__ uint32_t join(const Half& a, const Half& b, int& wm) {
  wm = min(a.best, b.best);
  return (a.best == wm ? a.bits : 0u) | (b.best == wm ? b.bits << 16 : 0u);
}

// Stores 0 over words [w0, w1) of a mask row.
__device__ __forceinline__ void clear_words(uint32_t* row, int w0, int w1) {
  for (int q = w0; q < w1; ++q) row[q] = 0u;
}

__global__ void __launch_bounds__(MASK_THREADS)
adapter_mask(const uint8_t* __restrict__ codes, int b, int row_len,
             const int32_t* __restrict__ lens, Peq peq, int m, int log_nseg,
             int32_t* __restrict__ d_out, uint32_t* __restrict__ bits) {
  __shared__ uint32_t eq[2][256];  // Eq by strand and byte code
  for (int i = threadIdx.x; i < 512; i += MASK_THREADS)
    eq[i >> 8][i & 255] = (i & 255) < 4 ? peq.eq[i >> 8][i & 255] : 0u;
  __syncthreads();

  // thread g: segment k of strand p of read r
  const int g = blockIdx.x * MASK_THREADS + threadIdx.x;
  const int nseg = 1 << log_nseg;
  const int k = g & (nseg - 1);
  const int p = (g >> log_nseg) & 1;
  const int r = g >> (log_nseg + 1);
  const int len = r < b ? min(lens[r], row_len) : 0;  // never past the row
  const int seg = ((len + nseg - 1) / nseg + 31) & ~31;
  const int lo = k * seg;
  const int hi = min(lo + seg, len);
  const int words = row_len >> 5;
  uint32_t* out = bits + ((size_t)r * 2 + p) * words;  // used only when r < b

  Run run;
  run.init(m, lo >> 5);
  if (lo < hi) {
    const uint4* row = reinterpret_cast<const uint4*>(codes + (size_t)r * row_len);
    // the first word's loads and the warm-up's (w0 <= lo - 2m, lo - w0 <=
    // 64: at most 4 loads) go out together
    uint4 a0 = __ldg(row + (lo >> 4)), a1 = __ldg(row + (lo >> 4) + 1);
    const int w0 = max(0, (lo - 2 * m) & ~15);
    uint4 warm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (w0 + 16 * i < lo) warm[i] = __ldg(row + (w0 >> 4) + i);
    Myers s;
    s.init(m);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (w0 + 16 * i < lo) mask_warm(warm[i], eq[p], s);
    int wm, j = lo;
#pragma unroll 1
    for (; j + 32 <= hi; j += 32) {  // one mask word a trip
      const uint4 c0 = a0, c1 = a1;
      if (j + 32 < hi) {  // the next word's loads (j + 64 <= row_len)
        a0 = __ldg(row + (j >> 4) + 2);
        a1 = __ldg(row + (j >> 4) + 3);
      }
      const Half h0 = mask_16<false>(c0, j, hi, eq[p], m, s);
      const Half h1 = mask_16<false>(c1, j + 16, hi, eq[p], m, s);
      const uint32_t w = join(h0, h1, wm);
      out[j >> 5] = run.word(wm, w, j >> 5);
    }
    if (j < hi) {  // the ragged last word (both loads lie in the row)
      const Half h0 = mask_16<true>(a0, j, hi, eq[p], m, s);
      const Half h1 = mask_16<true>(a1, j + 16, hi, eq[p], m, s);
      const uint32_t w = join(h0, h1, wm);  // h1 may lie past hi: min m, no bits
      out[j >> 5] = run.word(wm, w, j >> 5);
    }
  }
  // the read's min on this strand: every lane of the group gets it
  int d = run.d;
  for (int off = 1; off < nseg; off <<= 1) d = min(d, __shfl_xor_sync(FULL, d, off));
  if (r >= b) return;
  if (k == 0) d_out[(size_t)p * b + r] = d;
  if (lo < hi)  // keep only the words at the read's min
    clear_words(out, lo >> 5, run.d == d ? run.cur : (hi + 31) >> 5);
  for (int w = ((len + 31) >> 5) + k; w < words; w += nseg) out[w] = 0u;  // past the end
}

Peq left_aligned(const int32_t* peq_host, int m) {
  Peq peq;
  for (int p = 0; p < 2; ++p)
    for (int c = 0; c < 4; ++c)
      peq.eq[p][c] = (uint32_t)peq_host[4 * p + c] << (32 - m);
  return peq;
}

}  // namespace

extern "C" {

// SLOTS. text: (b, row_bytes) uint8, 2-bit packed rows (char j at byte
// j >> 2, bits 2 * (j & 3)), row_bytes a multiple of 16, 16-byte aligned.
// lens: (b,) int32, each <= 4 * row_bytes (a longer one is cut to the row).
// peq_host: 8 int32 in HOST memory, [strand][A, C, G, T] (bit i set where
// pattern char i is that base). 1 <= m <= 32. log_nseg in 0..5 (segments per
// read). out: (12, b) int32. Launches on `stream`; returns cudaGetLastError().
int sctag_adapter_scan(const void* text, int b, int row_bytes, const void* lens,
                       const int32_t* peq_host, int m, int log_nseg, void* out,
                       void* stream) {
  const Peq peq = left_aligned(peq_host, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)b << log_nseg;
  const int blocks = (int)((threads + SLOTS_THREADS - 1) / SLOTS_THREADS);
  adapter_slots<<<blocks, SLOTS_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(text), b, row_bytes,
      static_cast<const int32_t*>(lens), peq, m, log_nseg,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// MASK. codes: (b, row_len) uint8 byte codes, row_len a multiple of 32,
// 16-byte aligned. lens: (b,) int32 (a longer one is cut to the row).
// peq_host and m as for SLOTS. log_nseg in 0..5 (segments per read). d_out:
// (2, b) int32. bits: (b, 2, row_len / 32) uint32, every word written.
// Launches on `stream`; returns cudaGetLastError().
int sctag_adapter_mask(const void* codes, int b, int row_len, const void* lens,
                       const int32_t* peq_host, int m, int log_nseg, void* d_out,
                       void* bits, void* stream) {
  const Peq peq = left_aligned(peq_host, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)b << (log_nseg + 1);  // x 2 strands
  const int blocks = (int)((threads + MASK_THREADS - 1) / MASK_THREADS);
  adapter_mask<<<blocks, MASK_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(codes), b, row_len,
      static_cast<const int32_t*>(lens), peq, m, log_nseg,
      static_cast<int32_t*>(d_out), static_cast<uint32_t*>(bits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
