#!/usr/bin/env python3
"""Smoke test of the PyTorch port (perception_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds the three hand-written kernels from `perception_tpu_torch/csrc/`,
holds each against its plain PyTorch twin on the card at the shapes of the
scoring benchmark (benchmarks/bench_scene.py: bumpy1024 models, 2048 poses,
ROI 32), scores the batch on the card and again on the CPU twins, and then
serves three /localize requests through the port's HTTP service, checking
the detections against the ground truth. Every phase prints one JSON line;
the run ends with a {"kernels": [...]} line, the card's `nvidia-smi` name and
power limit, and {"ok": true, "device": {...}}. Any failed check raises and
the exit code is non-zero. There is no CPU fallback: without a CUDA device
the script exits with code 2 and prints nothing on stdout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from perception_tpu_torch.eval.bench_scene import build_bench_problem
from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import cost, cost_fused, icp_fused, raster_direct
from perception_tpu_torch.pipeline import scorer
from perception_tpu_torch.pipeline.recognizer import ObjectRecognizer
from perception_tpu_torch.serve import serve

N_POSES = 2048
N_CPU = 256
INVALID_KEY = 2**31 - 1
# name -> (module, twin, source, TPU kernel it replaces)
KERNELS = {
    "raster_direct": (raster_direct, raster_direct.rasterize_direct_twin,
                      "perception_tpu_torch/csrc/raster_direct.cu",
                      "perception_tpu/ops/pallas_raster_direct.py:320"),
    "icp_fused": (icp_fused, icp_fused.icp_fused_twin,
                  "perception_tpu_torch/csrc/icp_fused.cu",
                  "perception_tpu/ops/pallas_icp.py:632"),
    "cost_fused": (cost_fused, cost_fused.nn_cost_fused_twin,
                   "perception_tpu_torch/csrc/cost_fused.cu",
                   "perception_tpu/ops/pallas_cost.py:221"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def recorded_kernel_calls():
    """Record the first call of each kernel wrapper made by the pipeline
    (its arguments exactly as the main path gives them)."""
    seen: dict[str, tuple] = {}
    sites = [(raster_direct, "rasterize_direct", "raster_direct"),
             (scorer, "icp_fused", "icp_fused"),
             (cost, "nn_cost_fused", "cost_fused")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]

    def recorder(fn, name):
        def call(*args, **kwargs):
            seen.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return call

    for (mod, attr, name), (_, _, fn) in zip(sites, saved):
        setattr(mod, attr, recorder(fn, name))
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def compare(name: str, kernel_out, twin_out) -> dict:
    """Hold a kernel's output against its twin's with the kernel's bar."""
    if name == "raster_direct":
        k, t = kernel_out, twin_out
        same = k == t
        frac = same.float().mean().item()
        diff = ~same
        silhouette = (k[diff] == INVALID_KEY) | (t[diff] == INVALID_KEY)
        step = ((k[diff] >> 11) - (t[diff] >> 11)).abs() <= 1
        both = (k != INVALID_KEY) & (t != INVALID_KEY)
        err = ((k >> 11) - (t >> 11)).abs()[both].max().item() if both.any() \
            else 0
        require(frac >= 0.995, f"raster keys equal on {frac:.5f} < 0.995")
        require(bool((silhouette | step).all()),
                "raster: a differing pixel is neither silhouette nor 1 cm")
        return {"equal_frac": frac, "max_abs_err": float(err),
                "err_unit": "cm of depth"}
    if name == "icp_fused":
        per_pose = (kernel_out - twin_out).abs().amax(dim=(1, 2))
        frac = (per_pose <= 1e-4).float().mean().item()
        require(frac >= 0.99, f"ICP deltas within 1e-4 on {frac:.4f} < 0.99")
        return {"within_1e-4_frac": frac,
                "max_abs_err": per_pose.max().item(),
                "err_unit": "delta entry (rotation, m)"}
    same = torch.stack([a == b for a, b in zip(kernel_out, twin_out)]).all(0)
    err = max((a - b).abs().max().item() for a, b in zip(kernel_out, twin_out))
    frac = same.float().mean().item()
    require(frac >= 0.999, f"cost counts equal on {frac:.4f} < 0.999")
    return {"equal_frac": frac, "max_abs_err": err, "err_unit": "count"}


def kernel_phase(name: str, call: tuple, label: str) -> dict:
    mod, twin, _, _ = KERNELS[name]
    args, kwargs = call
    pargs, pkw = mod.prepare_inputs(*args, **kwargs)
    out_k = mod.launch_kernel(*pargs, **pkw)
    sync()
    out_t = twin(*pargs, **pkw)
    sync()
    result = compare(name, out_k, out_t)
    result["ms"] = time_ms(lambda: mod.launch_kernel(*pargs, **pkw))
    result["plain_ms"] = time_ms(lambda: twin(*pargs, **pkw))
    shapes = [list(a.shape) for a in pargs if isinstance(a, torch.Tensor)]
    emit({"phase": "kernel", "kernel": name, "case": label,
          "shapes": shapes, **result})
    return result


def cpu_scene(scene: scorer.ObservedScene) -> scorer.ObservedScene:
    return scorer.ObservedScene(**{f.name: getattr(scene, f.name).cpu()
                                   for f in dataclasses.fields(scene)})


def check_kernels(bp) -> dict:
    """Run each kernel and its twin on the inputs the scoring batch (and the
    full-frame observation render) hands the wrapper; compare and time."""
    with recorded_kernel_calls() as calls:
        bp.score()
    with recorded_kernel_calls() as frame_calls:
        bp.env.render_composite(bp.gt)
    sync()
    require(set(calls) == set(KERNELS), f"scoring called {sorted(calls)}")
    results = {name: kernel_phase(name, calls[name], "scoring batch")
               for name in KERNELS}
    kernel_phase("raster_direct", frame_calls["raster_direct"],
                 "observation 640x480 stride 1")
    return results


def check_slice(bp) -> None:
    """score_pose_batch on the card; its first N_CPU poses on the CPU."""
    n = len(bp.candidates)
    out = bp.score()
    sync()
    require(out.total_cost.shape == (n,), "total_cost shape")
    require(bool(torch.isfinite(out.adjusted_poses).all()),
            "adjusted poses finite")
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        bp.score()
        sync()
        runs.append((time.perf_counter() - t0) * 1e3)
    batch_ms = statistics.median(runs)
    verts, colors, valid, poses, ids, labels, totals, proj, scene = bp.args
    env = bp.env
    t0 = time.perf_counter()
    ref = scorer.score_pose_batch(
        verts.cpu(), colors.cpu(), valid.cpu(), poses[:N_CPU].cpu(),
        ids[:N_CPU].cpu(), labels[:N_CPU].cpu(), totals[:N_CPU].cpu(),
        proj.cpu(), cpu_scene(scene), bp.cfg,
        bank_backface=env._render_bank[3].cpu(),
        bank_icp_samples=env._bank_icp_samples.cpu(),
        bank_icp_normals=env._bank_icp_normals.cpu())
    cpu_s = time.perf_counter() - t0
    g_tot = out.total_cost[:N_CPU].cpu()
    tot_eq = (g_tot == ref.total_cost).float().mean().item()
    tot_diff = (g_tot - ref.total_cost).abs().max().item()
    trans = (out.adjusted_poses[:N_CPU, :3, 3].cpu()
             - ref.adjusted_poses[:, :3, 3]).abs().amax(dim=1)
    trans_ok = (trans <= 1e-3).float().mean().item()
    emit({"phase": "slice", "poses": n, "batch_ms": batch_ms,
          "batch_ms_runs": runs, "poses_per_s": n / batch_ms * 1e3,
          "valid_poses": int((out.total_cost >= 0).sum()),
          "cpu_twin_poses": N_CPU, "cpu_twin_s": cpu_s,
          "total_equal_frac": tot_eq, "total_max_diff": tot_diff,
          "total_differs_at": torch.nonzero(g_tot != ref.total_cost)
          .flatten().tolist(),
          "translation_within_1mm_frac": trans_ok})
    require(tot_eq >= 0.98, f"total_cost equal on {tot_eq:.3f} < 0.98")
    require(tot_diff <= 2, f"total_cost differs by {tot_diff} > 2")
    require(trans_ok >= 0.98, f"translations within 1 mm on {trans_ok:.3f}")


def check_served_path(bp, dev) -> tuple[dict, dict]:
    """Recogniser from the bench models, the port's own GT observation, then
    three /localize requests with every candidate; returns the kernel
    launches and twin calls counted during the requests alone."""
    env = bp.env
    rec = ObjectRecognizer.from_models(env.bank.models, env.camera, env.perch,
                                       env.env, t_cap=1024, device=dev)
    rec.env.set_observation_from_states(bp.gt)
    rin = rec.env._input
    visible = [i for i, c in enumerate(rec.env._observed.seg_count.tolist())
               if c > 0]
    require(visible == [1, 2], f"visible objects {visible} != [1, 2]")
    names = [f"blob{i}" for i in range(3)]
    pose_lists: dict[str, list] = {}
    for c in bp.candidates:
        pose_lists.setdefault(names[c.id], []).append(
            [c.pose.x, c.pose.y, c.pose.z, *c.pose.quaternion()])
    body = json.dumps({
        "depth_image": np.asarray(rin.depth_image).tolist(),
        "label_mask": np.asarray(rin.label_mask).tolist(),
        "depth_factor": rin.depth_factor,
        "cam_to_world": np.asarray(rin.cam_to_world).tolist(),
        "segmented_object_names": names,
        "pose_lists": pose_lists,
        "mode": "greedy"}).encode()
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/localize"
    latency, responses, split = [], [], []
    stats = rec.env.stats
    try:
        build.reset_counts()
        for _ in range(3):
            gpu0 = stats.gpu_time
            t0 = time.perf_counter()
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                responses.append(json.loads(resp.read()))
            latency.append((time.perf_counter() - t0) * 1e3)
            # Host-clock split of the request (the server runs in this
            # process): observed-scene build, greedy scoring + argmin, and
            # the scoring dispatch inside it.
            split.append({"set_input_ms": stats.input_time * 1e3,
                          "greedy_ms": stats.time * 1e3,
                          "score_batch_ms": (stats.gpu_time - gpu0) * 1e3})
        launches = dict(build.LAUNCHES)
        twins = dict(build.TWIN_CALLS)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread stopped")
    # The handler's two largest host stages outside those spans, timed
    # once here on the same request: payload decode and candidate pruning.
    t0 = time.perf_counter()
    payload = json.loads(body)
    np.asarray(payload["depth_image"], np.float64)
    np.asarray(payload["label_mask"], np.int32)
    decode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rec.env.generate_successors_6dof(
        {k: np.asarray(v, np.float64) for k, v in pose_lists.items()})
    successors_ms = (time.perf_counter() - t0) * 1e3
    errors_mm: dict[str, list] = {}
    for out in responses:
        dets = {d["name"]: d for d in out["detections"]}
        for i in visible:
            require(names[i] in dets, f"{names[i]} not detected")
            gt = bp.gt[i].pose
            err = float(np.linalg.norm(np.asarray(dets[names[i]]["translation"])
                                       - [gt.x, gt.y, gt.z]))
            errors_mm.setdefault(names[i], []).append(err * 1e3)
            require(err < 0.02, f"{names[i]} off by {err * 1e3:.1f} mm")
    emit({"phase": "serve", "requests": len(responses),
          "latency_ms": latency, "latency_split": split,
          "decode_ms": decode_ms, "successors_ms": successors_ms,
          "candidates": len(bp.candidates),
          "detection_error_mm": errors_mm, "launches": launches,
          "twin_calls": twins, "jax_imported": "jax" in sys.modules})
    return launches, twins


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (this script has no CPU mode)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line})

    # 2. Build the kernel library from the sources in the checkout.
    build.library()
    emit({"phase": "build", "seconds": build.build_seconds,
          "ptxas": [l.strip() for l in build.build_log.splitlines()
                    if "registers" in l or "spill" in l]})

    # 3. Each kernel against its twin, at the shapes the main path gives it.
    t0 = time.perf_counter()
    bp = build_bench_problem(n_poses=N_POSES, model_kind="bumpy1024",
                             device=dev)
    sync()
    emit({"phase": "bench_problem", "poses": N_POSES,
          "seconds": time.perf_counter() - t0,
          "seg_count": bp.env._observed.seg_count.tolist()})
    results = check_kernels(bp)
    # 4. The slice on the card, and its first N_CPU poses on the CPU twins.
    check_slice(bp)
    # 5. The served path; the counts cover exactly the three requests.
    launches, twins = check_served_path(bp, dev)
    require(all(launches.get(n, 0) > 0 for n in KERNELS),
            f"kernel launches during the requests: {launches}")
    require(sum(twins.values()) == 0, f"twins ran on the card: {twins}")
    require("jax" not in sys.modules, "jax was imported")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, (_, _, src, tpu) in KERNELS.items()]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
