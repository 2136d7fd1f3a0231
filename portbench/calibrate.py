"""The readings the limits of `correct` are set from: per seed, the
program's numbers against the plain reference (the lower readings), a
second sound float32 witness, and the control's, the reference computed in
bfloat16 and put in the program's place (the upper readings). Not part of
a benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--frames 8] [--witness-seeds 3]

One JSON line per seed. The control rounds every floating tensor to
bfloat16 where a stage hands it on (mesh vertices and poses into the
raster, the rendered cloud, the ICP targets and correction, the cost's
clouds); the arithmetic inside a stage stays float32. `--frames` reads the
first frames of each seed's pool alone (they are the frames a run serves
first, at their own sizes). The witness is the program's replies against
the reference with its fixed-order float32 sums (the ICP's normal
equations and the normals' covariances, which follow the kernels' order)
taken by PyTorch's own reductions instead: how far a sound reordering of
float32 arithmetic moves the numbers.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def bf16(t):
    import torch

    return t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t


def as_reply(ans) -> dict:
    """A reference answer in the service's reply format."""
    from portbench.reference.geometry import matrix_to_quat

    return {"detections": [
        {"name": n, "translation": [float(x) for x in p[:3, 3]],
         "quaternion_xyzw": list(matrix_to_quat(p[:3, :3]))}
        for n, p in zip(ans.names, ans.poses)]}


def control_numbers(cell, details, device) -> dict:
    from portbench import compare, harness

    ref = harness.reference_for(cell, details["bank"], device, quant=bf16)
    replies = [as_reply(ref.answer(f)) for f in details["frames"]]
    return compare.compare(cell.traffic["mode"], replies, details["answers"],
                           list(range(len(replies))), details["bank"])


@contextlib.contextmanager
def plain_sums():
    """The reference's ordered float32 sums taken by PyTorch's reductions."""
    from portbench.reference import icp

    saved = icp._fixed_order_sum, icp._ordered_sum
    icp._fixed_order_sum = lambda x: x.sum(-1)
    icp._ordered_sum = lambda x, dim: x.sum(dim)
    try:
        yield
    finally:
        icp._fixed_order_sum, icp._ordered_sum = saved


def witness_numbers(cell, details, device) -> dict:
    """The program's replies against the reference with plain sums."""
    from portbench import compare, harness

    with plain_sums():
        ref = harness.reference_for(cell, details["bank"], device)
        answers = [ref.answer(f) for f in details["frames"]]
    return compare.compare(cell.traffic["mode"], details["replies"], answers,
                           details["frame_of"], details["bank"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="portbench/calibrate.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--frames", type=int, default=0,
                        help="the first frames of each seed's pool alone")
    parser.add_argument("--witness-seeds", default="",
                        help="seeds that also read the plain-sum witness")
    args = parser.parse_args(argv)

    from portbench import harness

    harness.cache_dirs()
    witness = {int(s) for s in args.witness_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        cell = harness.load_cell(args.workload)
        if args.frames:
            cell.traffic["frames"] = args.frames
        details: dict = {}
        t0 = time.perf_counter()
        res = harness.run_cell(
            cell, seed, 0.0, False, T_START,
            min_requests=cell.traffic["frames"], details=details)
        line = {"workload": args.workload, "seed": seed,
                "program": details["numbers"], "correct": res["correct"],
                "peak_bytes": res["device"]["memory_peak_bytes"],
                "frame_ms": res["metrics"]["frame_ms"]["value"],
                "rows": [sum(len(v) for v in f.get("pose_lists", {}).values())
                         for f in details["frames"]],
                "program_s": time.perf_counter() - t0}
        t1 = time.perf_counter()
        line["control"] = control_numbers(cell, details, "cuda")
        line["control_s"] = time.perf_counter() - t1
        if seed in witness:
            t2 = time.perf_counter()
            line["witness"] = witness_numbers(cell, details, "cuda")
            line["witness_s"] = time.perf_counter() - t2
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
