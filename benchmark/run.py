#!/usr/bin/env python3
"""Run one cell of the benchmark of raft_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` measures the cell's end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` profiles the cell's
fixed number of calls and reports its per-layer metrics.  Either way the
output is checked against the plain reference and the last line of
standard output is one JSON object.  Exits non-zero, with no result,
without enough CUDA devices for the cell.  See benchmark/README.md."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def pin_program_env() -> None:
    """The program at its defaults: every ``RAFT_TPU_*`` knob the caller's
    environment holds (a route such as ``RAFT_TPU_BEM_ASSEMBLY``, a cache
    switch, a fault injection) is dropped, and the program's cache root is
    a fixed directory inside the checkout."""
    for k in [k for k in os.environ if k.startswith(("RAFT_TPU_", "RAFT_EVIDENCE_"))]:
        del os.environ[k]
    os.environ["RAFT_TPU_TORCH_CACHE_DIR"] = str(HERE / ".cache" / "program")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_program_env()
    sys.path.insert(0, str(HERE.parent))
    from benchmark.harness import runner

    try:
        runner.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except runner.NoDevice as e:
        print(f"no run: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
