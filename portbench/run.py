"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(`python3 -m portbench.run` alike.) The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and last `checks`, each compared number with its
limit (also the last lines of standard error). Exits non-zero, printing no
result, without a CUDA card or when a forbidden module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import harness

    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    torch.manual_seed(args.seed % (2**63))
    cell = harness.load_cell(args.workload)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
