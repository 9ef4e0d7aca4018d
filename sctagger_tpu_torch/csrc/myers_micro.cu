// Int32 instruction-rate ceiling microbenchmark for Hopper (sm_90a).
//
// Replaces tools/roofline.py:_micro_kernel, launched by measure_vpu_bound's
// run_c (K7). Each element of the (bp_c, br) input runs `chains`
// independent copies of the production Myers carry chain (the hb form of
// sctagger_tpu/ops/match_pallas.py:_myers_hw_step) for `iters` iterations,
// then folds them into one int32:
//   state of chain c: pv = x + c, mv = pv ^ 1, score = pv & 7, eq = pv >> 3
//   per iteration:    xv = eq | mv; xh = (((eq & pv) + pv) ^ pv) | eq;
//                     ph = mv | ~(xh | pv); mh = pv & xh;
//                     score += ((ph & HIGH) - (mh & HIGH)) >> 15;
//                     ph <<= 1; mh <<= 1; pv = mh | ~(xv | ph); mv = ph & xv;
//                     eq ^= pv                          (20 ops + 1 rotation)
//   out = sum over c of pv + score of chain 0
// bit for bit as the Pallas kernel (JAX int32: wrapping adds, arithmetic
// right shifts). The Pallas grid repeats the same block `grid` times; here
// `grid` copies of the element range run as separate thread blocks and all
// write the same value.
//
// Design: one thread per element, chains unrolled in registers so they are
// independent instruction streams; the iteration loop is not unrolled, so
// one loop trip of the compiled code is one iteration of every chain. The
// input comes from device memory and every chain reaches the output (pv
// through the sum; each score of chains 1.. through an empty asm that keeps
// it live), so nvcc can neither fold the chain into constants nor drop one.
//
// Bound: by design nothing but the int32 instruction rate: 21 source ops an
// iteration per chain against one 4-byte load and one store per element. nvcc
// fuses logical ops into LOP3 and adds into IADD3, so the source-op rate this
// measures can exceed the card's INT32 instruction rate; it is the ceiling for
// kernels counted the same way (one op per C integer operator).
//
// Bit vectors are uint32 (left shifts of negative signed ints are undefined
// in C++); the score difference is a signed int32 shifted right, which
// nvcc does arithmetically, as JAX does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t HIGH = 1u << 15;

template <int CHAINS>
__global__ void __launch_bounds__(THREADS)
myers_micro(const int32_t* __restrict__ x, int n, int blocks_per_copy,
            int iters, int32_t* __restrict__ out) {
  const int i = (blockIdx.x % blocks_per_copy) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int32_t x0 = x[i];
  uint32_t pv[CHAINS], mv[CHAINS], eq[CHAINS];
  int32_t score[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    const int32_t p = x0 + c;
    pv[c] = (uint32_t)p;
    mv[c] = (uint32_t)(p ^ 1);
    score[c] = p & 7;
    eq[c] = (uint32_t)(p >> 3);
  }
#pragma unroll 1
  for (int j = 0; j < iters; ++j) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const uint32_t xv = eq[c] | mv[c];
      const uint32_t xh = (((eq[c] & pv[c]) + pv[c]) ^ pv[c]) | eq[c];
      uint32_t ph = mv[c] | ~(xh | pv[c]);
      uint32_t mh = pv[c] & xh;
      score[c] += ((int32_t)(ph & HIGH) - (int32_t)(mh & HIGH)) >> 15;
      ph <<= 1;
      mh <<= 1;
      pv[c] = mh | ~(xv | ph);
      mv[c] = ph & xv;
      eq[c] ^= pv[c];
    }
  }
  uint32_t acc = (uint32_t)score[0];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc += pv[c];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) asm volatile("" : : "r"(score[c]));
  out[i] = (int32_t)acc;
}

template <int CHAINS>
void launch(const int32_t* x, int n, int iters, int grid, int32_t* out,
            cudaStream_t s) {
  const int per_copy = (n + THREADS - 1) / THREADS;
  myers_micro<CHAINS><<<grid * per_copy, THREADS, 0, s>>>(x, n, per_copy,
                                                          iters, out);
}

}  // namespace

extern "C" {

// x, out: (n,) int32 on the device. chains: 1, 2, 4 or 8. The element range
// runs `grid` times over. Launches on `stream`; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for another chain count).
int sctag_myers_micro(const void* x, int n, int iters, int chains, int grid,
                      void* out, void* stream) {
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: launch<1>(xi, n, iters, grid, o, s); break;
    case 2: launch<2>(xi, n, iters, grid, o, s); break;
    case 4: launch<4>(xi, n, iters, grid, o, s); break;
    case 8: launch<8>(xi, n, iters, grid, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
