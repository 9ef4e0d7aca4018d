"""Benchmark of the PyTorch/CUDA port (``sctagger_tpu_torch``) on one GPU.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Everything a cell needs is found by
name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<generator>.py``, ``stages/<stage>.py`` and
``metrics/<metric>.py``.
"""
