#!/usr/bin/env python3
"""The control of a cell's check: the reference of a lower guarantee put in
the program's place, judged by the cell's own check at the cell's size.

    python3 gpubench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed with the compared numbers; a control that
does its job reads above the limits. Needs the card unless --device cpu.
The controls: match_trie, the sweep cut to max_error - 1 (``band``);
extract_sr_bc_from_lr, the forward words only (``forward``);
extract_lr_bc, reads beyond distance 2 left without a strand (``band``)."""

import argparse
import json
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from gpubench import manifest  # noqa: E402

CONTROLS = {"match_trie": "band", "extract_sr_bc_from_lr": "forward", "extract_lr_bc": "band"}


def control_readings(cell: str, seed: int, device, overrides: dict | None = None) -> dict:
    spec = manifest.cell(cell)
    work = spec["workload"]
    params = {**work["params"], **(overrides or {}).get("params", {})}
    config = {**spec["config_data"], **(overrides or {}).get("config", {})}
    stage = manifest.module("stages", work["stage"])
    data = manifest.module("traffic", work["generator"]).generate(params, config, seed)
    verdict, info = stage.check(data, config, params, [], device, seed,
                                control=CONTROLS[work["stage"]])
    return {"workload": cell, "seed": seed, "control": CONTROLS[work["stage"]],
            "checks": verdict, "info": info}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in a.seeds:
        t = time.perf_counter()
        r = control_readings(a.workload, seed, torch.device(a.device))
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
