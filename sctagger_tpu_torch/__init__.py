"""sctagger_tpu_torch — the PyTorch + CUDA port of sctagger_tpu.

Same CLI surface and byte-identical outputs as the JAX package
(``sctagger_tpu``), which stays in the repository as the reference each
module of the port is tested against. This package imports torch and numpy
and never jax; the JAX-free host modules of ``sctagger_tpu`` (sequence
packing, TSV I/O, the native host library, ``cli.parse_args``) are reused by
import.

Ported so far: the ``extract_lr_bc`` and ``match_trie`` subcommands, the
single-device ``entry()``, and the roofline and match-profile tools.

Layout (each module mirrors its ``sctagger_tpu`` counterpart's name):
  runtime.py          device selection (cuda when available, else cpu)
  observability.py    stage stats and the progress bar
  ops/myers.py        plain-torch Myers bit-vector edit distance
  ops/adapter_cuda.py the adapter-scan kernel's wrapper + plain version
  ops/match_cuda.py   the match kernels' wrappers + plain versions (full,
                      min, best matrix, ties)
  ops/micro_cuda.py   the int32 microkernel's wrapper + plain version
  ops/_build.py       nvcc build + ctypes binding of csrc/*.cu
  ops/exact_prefilter.py  host dist<=1 prefilter (copied, JAX-free)
  models/adapter.py   scan_adapters(_stream): prefilter, kernel, fallbacks
  models/matcher.py   match_segments: prefilter, chunk dispatch, ties
  stages/extract_lr_bc.py the extract_lr_bc stage
  stages/match_trie.py    the match_trie stage
  csrc/adapter_scan.cu    the hand-written Hopper (sm_90a) adapter-scan kernel
  csrc/match_full.cu  the hand-written Hopper (sm_90a) match kernel, four
                      epilogues
  csrc/myers_micro.cu the hand-written Hopper int32 instruction-rate microkernel
  entry.py            entry(): one forward step (match_min) on a toy problem
  tools/roofline.py   the int32 ceiling and the kernels' shares of it
  tools/profile_match.py  the match passes timed at the profile shape
"""

__version__ = "0.1.0"
