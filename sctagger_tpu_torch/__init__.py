"""sctagger_tpu_torch — the PyTorch + CUDA port of sctagger_tpu.

Same CLI surface and byte-identical outputs as the JAX package
(``sctagger_tpu``), which stays in the repository as the reference each
module of the port is tested against. This package imports torch and numpy,
never jax and nothing of ``sctagger_tpu``: the host modules it needs
(sequence packing, ranges, cutoffs, FASTQ, TSV and BAM I/O, the native host
library, the part store, the CLI's argument surface, stage stats, plots) are
copies under the same module names. It runs on the card; the CPU only when asked (``device="cpu"``, or
``SCTAG_DEVICE=cpu`` for the CLI).

Ported: the four subcommands (``extract_lr_bc``, ``extract_sr_bc``,
``extract_sr_bc_from_lr``, ``match_trie``) with batch checkpoint/resume,
multi-host runs (``--n-hosts``; fs or gloo transport) and the in-process
device grid, the ``pipeline`` runner, the ``SCTAG_PROFILE`` trace,
``entry()`` and ``dryrun_multichip()``, and the roofline and match-profile
tools.

Layout (each module mirrors its ``sctagger_tpu`` counterpart's name):
  runtime.py          device selection (cuda; cpu only when asked)
  cli.py              the argument surface and the subcommand dispatch
  observability.py    stage stats and spans (SCTAG_STATS), the SCTAG_PROFILE
                      torch.profiler trace with the program's spans, the
                      progress bar
  utils.py            small helpers (copy)
  plots.py            the reference's charts (copy)
  core/packing.py     sequence codes and encoders (copy)
  core/ranges.py      adapter-range detection and filtering (copy)
  core/cutoff.py      the whitelist cutoffs (copy)
  io/fastq.py, io/tsv.py, io/bam.py  FASTQ, TSV and BAM I/O on the native
                      library (copies)
  io/sharding.py      per-host record shards (copy)
  parallel/multihost.py  HostGroup: cross-host reductions (fs or gloo),
                      blobs, the part merge
  parallel/mesh.py    the (data, model) device grid and its shard_* calls
  native/             the g++ host library: BAM/FASTQ/TSV I/O, range search,
                      the host adapter prefilters, the whitelist hash table
                      and probe (copied sources) + build.py
  pipeline/checkpoint.py  batch part files (copy)
  pipeline/runner.py  the Snakefile-equivalent runner
  ops/myers.py        plain-torch Myers bit-vector edit distance
  ops/adapter_cuda.py the adapter-scan kernels' wrappers + plain versions
                      (slots; exact argmin mask)
  ops/match_cuda.py   the match kernels' wrappers + plain versions (full,
                      min, best matrix, ties)
  ops/micro_cuda.py   the int32 microkernel's wrapper + plain version
  ops/_build.py       nvcc build + ctypes binding of csrc/*.cu
  ops/exact_prefilter.py  host dist<=1 prefilter (copied, JAX-free)
  ops/exact_lookup.py the alt stage's key table, host and device probes
  ops/topk_count.py   count_and_rank_host (copy)
  models/adapter.py   scan_adapters_stream: prefilter, kernel, fallbacks
  models/matcher.py   match_segments: prefilter, chunk dispatch, ties
  stages/extract_lr_bc.py the extract_lr_bc stage
  stages/extract_sr_bc.py the extract_sr_bc stage (host C++)
  stages/extract_sr_bc_from_lr.py the extract_sr_bc_from_lr stage
  stages/match_trie.py    the match_trie stage
  csrc/adapter_scan.cu    the hand-written Hopper (sm_90a) adapter-scan
                      kernel, two epilogues (slots; argmin mask)
  csrc/match_full.cu  the hand-written Hopper (sm_90a) match kernel, four
                      epilogues
  csrc/myers_micro.cu the hand-written Hopper int32 instruction-rate microkernel
  entry.py            entry(): one forward step (match_min) on a toy problem;
                      dryrun_multichip(n): the stages at 1 vs n devices
  tools/roofline.py   the int32 ceiling and the kernels' shares of it
  tools/profile_match.py  the match passes timed at the profile shape
"""

__version__ = "0.1.0"
