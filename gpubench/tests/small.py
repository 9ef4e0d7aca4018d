"""Cell sizes a CPU test run holds (the workloads' own shapes, fewer rows
and a smaller whitelist)."""

SMALL = {
    "sr25k.match.sub": {"config": {"segments_per_invocation": 3000, "whitelist_barcodes": 300},
                        "params": {"warm_rows": 200, "check_sample": 400}},
    "wl3m.alt.probe": {"config": {"lr_rows_per_invocation": 20000, "whitelist_barcodes": 50000},
                       "params": {"warm_rows": 500, "warm_whitelist": 1000, "cells": 300}},
    "sr25k.lr.scan": {"config": {"reads_per_invocation": 1500},
                      "params": {"len_min": 200, "len_max": 600, "warm_reads": 200}},
}
