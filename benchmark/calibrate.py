"""Readings that the limits of the comparison are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--seconds S] [--control] [--faults] [--out PATH]

For each seed, in one process: the cell's set-up, a short window, the
program's state released, then the numbers its comparison with the plain
reference reads (``program``); with ``--control`` the same numbers between
the reference and the reference computed one precision below the
configuration's (TF32 for float32, float8 e4m3 for bfloat16), put in the
program's place; with ``--faults`` the numbers for the faults the cell can
have, planted in the reference put in the program's place. One JSON line a
seed, on standard output and appended to ``--out``. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import guard, harness  # noqa: E402

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def readings(cell, control: bool, faults: bool) -> dict:
    import torch

    from benchmark.reference import sd15
    from benchmark.reference.precision import Precision, exact_float32

    t0 = time.perf_counter()
    d = harness.load_driver(cell)
    d.setup()
    d.window(cell.seconds)
    d.release()
    out = {"seed": cell.seed, "program": {k: v["value"] for k, v in
                                          d.check().items()}}
    if hasattr(d, "last_gaps"):
        out["program_all"] = d.last_gaps
    drv = cell.traffic["driver"]
    dtype = cell.config.get("dtype", cell.config.get("precision"))
    low = Precision(CONTROL[dtype])
    with exact_float32():
        if drv == "render":
            if control:
                out["control"] = d.gaps(d.reference_frames(low),
                                        d.reference_frames(Precision()))
            if faults:
                # a diagnosis, not a fault: the reference ordered by the
                # depth levels of a [tile | depth] key, as the program is
                out["depth_levels"] = d.gaps(
                    d.kept, d.reference_frames(Precision(),
                                               depth_levels=True))
        elif drv == "edit" and control:
            unet, vae = d.reference_nets("float32")
            ref = d.reference_round(unet, vae)
            for net in (unet, vae):
                sd15.set_precision(net, CONTROL[dtype])
            out["control"] = d.gaps(d.reference_round(unet, vae), ref)
            del unet, vae
    out["seconds"] = time.perf_counter() - t0
    del d
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("[calibrate] no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        cell = harness.load_cell(args.workload, int(s), args.seconds, False,
                                 "cuda")
        line = json.dumps(readings(cell, args.control, args.faults))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    guard.check("after the readings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
