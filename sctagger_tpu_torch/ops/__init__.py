"""Ops of the port: plain-torch Myers twins and the CUDA kernels
(match, adapter scan, the int32 microkernel).

Nothing is imported eagerly: importing a kernel module must never build or
load a CUDA library (the CPU tests import every module)."""
