"""Run one cell of the benchmark of ``dge_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the repository root, on a machine with the cards the cell asks for.
It sets up, measures for ``--seconds``, compares what the timed path
produced with the plain reference in ``benchmark/reference/``, and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and ``checks`` (each compared number and its limit, also the last lines on
standard error). It exits with another code than 0, and prints no result,
without enough CUDA cards, or where a module of JAX or of the JAX package
is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import guard  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard.check("at start")

    from benchmark import harness

    harness.set_cache_dirs()
    import torch

    cell = harness.load_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda")
    if not torch.cuda.is_available():
        print("[bench] no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import dge_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"[bench] the program (dge_tpu_torch) is not importable: {e}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"[bench] {args.workload} seed {args.seed}: {msg}",
              file=sys.stderr, flush=True)

    from benchmark.yardstick.timing import card_line

    log(card_line())

    out = harness.run_cell(cell, T_START, log)
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
