"""Run the pose-split scorer with several ranks, one process each.

    python3 -m perception_tpu_torch.parallel.run --ranks 2 --backend gloo \\
        --device cpu --poses 48
    python3 -m perception_tpu_torch.parallel.run --ranks 1 --backend nccl \\
        --poses 2048

The launcher starts `--ranks` processes of this module, each given its rank,
the world size and a rendezvous file in a fresh temporary directory
(`init_method="file://..."`), and waits for them. Every rank builds the
scoring benchmark's problem (`eval/bench_scene.build_bench_problem`, from
the seed: the same in every process) or loads saved batches (`--inputs`,
files `save_batch` wrote), scores the first k poses for each k of `--counts`
(default: all of them) with `score_pose_batch_multichip` on its device, and
rank 0 scores the same poses again in one process with `score_pose_batch`.
Each rank prints one JSON line per count: its chunk's batch ms and the
gather's ms (host clock, the device synchronised), and whether its gathered
result equals rank 0's one-process result on every field (rank 0 shares it
through the process group). With `--out DIR` each rank also saves its
results there (`rank<r>.pt`: {(batch, k): the PoseScores fields}). The
exit code is non-zero if a rank failed or a result differed.

Ranks on one card take the "gloo" backend (NCCL refuses two ranks on one
device); "nccl" wants one card per rank (rank r on cuda:r).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from perception_tpu_torch.parallel.dist import initialize_multihost
from perception_tpu_torch.parallel.sharding import (
    make_pose_mesh,
    score_pose_batch_multichip,
)
from perception_tpu_torch.pipeline.scorer import (
    ObservedScene,
    PoseScores,
    ScorerConfig,
    score_pose_batch,
)


def save_batch(path: str, args: tuple, cfg: ScorerConfig, **aux) -> None:
    """Save score_pose_batch's nine positional inputs, its configuration and
    its aux banks (host copies) for `--inputs`."""
    *tensors, scene = args
    torch.save({
        "args": [t.cpu() for t in tensors],
        "scene": {f.name: getattr(scene, f.name).cpu()
                  for f in dataclasses.fields(scene)},
        "cfg": dataclasses.asdict(cfg),
        "aux": {k: None if v is None else v.cpu() for k, v in aux.items()},
    }, path)


def load_batch(path: str) -> tuple[tuple, ScorerConfig, dict]:
    """(args, cfg, aux) of a file save_batch wrote, on the host."""
    data = torch.load(path, weights_only=False)
    cfg = dict(data["cfg"])
    if cfg.get("roi_shape") is not None:
        cfg["roi_shape"] = tuple(cfg["roi_shape"])
    return ((*data["args"], ObservedScene(**data["scene"])),
            ScorerConfig(**cfg), data["aux"])


def bench_batch(poses: int, seed: int, device) -> tuple[tuple, ScorerConfig,
                                                        dict]:
    """The bench problem's batch (bumpy1024 models, 640x480, stride 8, ROI
    32, p2p ICP) on `device`."""
    from perception_tpu_torch.eval.bench_scene import build_bench_problem

    bp = build_bench_problem(n_poses=poses, model_kind="bumpy1024",
                             seed=seed, device=device, icp_mode="fused")
    return bp.args, bp.cfg, bp.bank_inputs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _equal(a: PoseScores, b: PoseScores) -> bool:
    return all(torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu())
               for f in dataclasses.fields(a))


def _score_count(mesh, args, cfg, aux, k: int):
    """The first k poses of a batch scored over the mesh (after a warm-up
    call), rank 0's one-process result for them shared with every rank,
    and whether the two are equal on every field."""
    device = mesh.device
    fixed, per_pose, (proj, scene) = args[:3], args[3:7], args[7:]
    batch = [x[:k] for x in per_pose]
    score_pose_batch_multichip(mesh, *fixed, *batch, proj, scene, cfg, **aux)
    _sync(device)
    timings: dict = {}
    got = score_pose_batch_multichip(mesh, *fixed, *batch, proj, scene, cfg,
                                     timings=timings, **aux)
    ref = None
    if mesh.rank == 0:
        ref = score_pose_batch(
            *[x.to(device) for x in (*fixed, *batch, proj)],
            ObservedScene(**{f.name: getattr(scene, f.name).to(device)
                             for f in dataclasses.fields(scene)}),
            cfg, **{n: None if v is None else v.to(device)
                    for n, v in aux.items()})
    if mesh.world_size > 1:
        box = [None if ref is None else {
            f.name: getattr(ref, f.name).cpu()
            for f in dataclasses.fields(ref)}]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        ref = PoseScores(**box[0])
    return _equal(got, ref), got, timings


def rank_main(opts) -> int:
    if opts.world > 1:
        initialize_multihost(opts.backend, num_processes=opts.world,
                             process_id=opts.rank, init_method=opts.init)
    else:
        # initialize_multihost is a no-op for one process: a group of one,
        # so that the mesh still runs over a real process group.
        dist.init_process_group(opts.backend, init_method=opts.init,
                                world_size=1, rank=0)
    # NCCL: rank r on card r; gloo: every rank on `--device` (card 0 for
    # "cuda").
    device = (torch.device("cuda", opts.rank) if opts.backend == "nccl"
              else torch.device(opts.device))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    if opts.threads:
        torch.set_num_threads(opts.threads)
    batches = ([load_batch(path) for path in opts.inputs] if opts.inputs
               else [bench_batch(opts.poses, opts.seed, device)])
    mesh = make_pose_mesh(device)
    ok = True
    saved = {}
    for b, (args, cfg, aux) in enumerate(batches):
        counts = ([int(c) for c in opts.counts.split(",")] if opts.counts
                  else [args[3].shape[0]])
        for k in counts:
            equal, got, timings = _score_count(mesh, args, cfg, aux, k)
            ok &= equal
            saved[b, k] = {f.name: getattr(got, f.name).cpu()
                           for f in dataclasses.fields(got)}
            print(json.dumps({
                "rank": mesh.rank, "world_size": mesh.world_size,
                "backend": opts.backend, "device": str(device), "batch": b,
                "poses": k, "chunk": -(-k // mesh.world_size), **timings,
                "valid_poses": int((got.total_cost >= 0).sum()),
                "equal_to_one_process": equal}), flush=True)
    if opts.out:
        torch.save(saved, os.path.join(opts.out, f"rank{mesh.rank}.pt"))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0 if ok else 1


def launch(ranks: int, backend: str, device: str = "cuda",
           inputs: list[str] | None = None, poses: int = 48, seed: int = 0,
           counts: str | None = None, out: str | None = None,
           threads: int = 0, timeout: float = 900.0,
           rendezvous_dir: str | None = None) -> tuple[int, list[dict]]:
    """Start `ranks` processes of this module and wait for them (the
    rendezvous file in `rendezvous_dir`, default a fresh temporary
    directory). Returns the worst exit code and every JSON line the ranks
    printed."""
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        common = ["--world", str(ranks), "--backend", backend, "--device",
                  device, "--init", init, "--poses", str(poses), "--seed",
                  str(seed), "--threads", str(threads)]
        for path in inputs or ():
            common += ["--inputs", path]
        for flag, value in (("--counts", counts), ("--out", out)):
            if value:
                common += [flag, str(value)]
        # Each rank writes to its own files: a rank blocked on a full pipe
        # would stall the others in their collectives.
        logs = [(open(os.path.join(tmp, f"rank{r}.out"), "w+"),
                 open(os.path.join(tmp, f"rank{r}.err"), "w+"))
                for r in range(ranks)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "perception_tpu_torch.parallel.run",
             "--rank", str(r), *common], stdout=out_f, stderr=err_f,
            text=True) for r, (out_f, err_f) in enumerate(logs)]
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                p.wait()
        lines, codes = [], [p.returncode for p in procs]
        for r, (out_f, err_f) in enumerate(logs):
            out_f.seek(0)
            err_f.seek(0)
            lines += [json.loads(l) for l in out_f.read().splitlines()
                      if l.startswith("{")]
            if codes[r]:
                print(f"rank {r} exited {codes[r]}:\n{err_f.read()[-4000:]}",
                      file=sys.stderr)
            out_f.close()
            err_f.close()
        code = max((abs(c) for c in codes), default=0)
        return code, lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2,
                    help="processes to launch (the launcher's)")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' or 'cpu' (gloo); nccl puts rank r on cuda:r")
    ap.add_argument("--inputs", action="append",
                    help="a batch saved by save_batch (repeatable)")
    ap.add_argument("--poses", type=int, default=48,
                    help="bench problem candidates (without --inputs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--counts", help="comma-separated pose counts to score "
                    "(the first k poses each; default all)")
    ap.add_argument("--out", help="directory for each rank's rank<r>.pt")
    ap.add_argument("--threads", type=int, default=0,
                    help="PyTorch intra-op threads per rank (0: its default)")
    ap.add_argument("--timeout", type=float, default=900.0)
    # Set by the launcher for each rank.
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.rank is not None:
        return rank_main(opts)
    code, lines = launch(opts.ranks, opts.backend, opts.device, opts.inputs,
                         opts.poses, opts.seed, opts.counts, opts.out,
                         opts.threads, opts.timeout)
    for line in lines:
        print(json.dumps(line))
    if not code and not all(l["equal_to_one_process"] for l in lines):
        code = 1
    return code


if __name__ == "__main__":
    raise SystemExit(main())
