#!/usr/bin/env python3
"""Smoke test of the PyTorch port (perception_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from `perception_tpu_torch/csrc/`, holds
each against its plain PyTorch twin on the card at the shapes of the scoring
benchmark (bumpy1024 models, 2048 poses; the depth-only and the colour-gated
cost, ROI 32 and full frame; the three rasters of `kernel_backend` "auto",
"pallas" (with its table's setup kernel) and "pallas_bin" at the depth ROI
and colour full-frame batches, with an A/B of their times; the real-sensor
profile on a Kinect-degraded observation with the fused ICP in its exact, d2d, symmetric and adaptive
modes; the composed "nn" and "gicp" refiners with the 1-NN kernel), scores
the batches on the card and again on the CPU twins, serves /localize
requests through the port's HTTP service on five paths (depth ROI, colour
ROI, colour full frame, real-sensor profile, gicp), and runs the `localize`
CLI on the bench scene written as files (PLY models, PNG images, poses.txt,
a JSON config) with kernel_backend "pallas_bin" and "pallas", checking the
detections against the ground truth. Then the search modes on a 3-DoF
table-top scene (`eval/table_scene.py`: three bumpy1024 models on a table,
640x480 at stride 24, batches of 1100, 15 ICP iterations, a Kinect-degraded
depth frame in mm): the grid successors, each kernel of the greedy-ICP batch
against its twin (the Lab colour cost on a use_color_cost variant), the
tree's batch (no ICP) through the bin raster against the twins, one tree
expansion with tree occlusion against the CPU twins (every unflagged pose
among those compared), served "greedy_icp" (each object within 30 mm) and
"tree" requests and an MHA* plan (within one grid step in x and y, and
theta_res in yaw), the CLI in both modes (the tree through the bin
raster), and the scene at the configuration defaults (detections printed,
no bar). Then the scorer's and env's other branches on the bench scene:
the speed profile (`EnvConfig.fast_profile()`: the fused ICP on the model
source's 256 surface samples against 128 targets, its slice and a served
request), the re-render cost on the colour ROI batch (two rasters; the
colour cost reads the re-render's face ids), the coarse pre-ICP raster
(stride 16 over 16x16), the per-pose spread crop of 128 targets, projective
ICP (no ICP kernel; the median translation error of the visible objects'
poses no worse after ICP), the composed colour cost (the colour full-frame
batch without the face Lab table: the 1-NN kernel at 2048 x 1280 x 256
beside torch.cdist), the fine-stride re-score (`set_input` time and peak
memory with the stride-4 scene, the stride-4 batch against its twins, a
served request), a pose refinement round (a served request and the poses
it scored) and the particle log-likelihood (both modes, card against CPU).
Then the deployment: the colour fine re-score batch (stride 4, ROI 64x64,
P = 4096), which above the fused colour cost's caps takes the composed cost
(the raster and the 1-NN kernel, held against their twins and as a slice);
then the six zoo models written as PLY files with a JSON config, three
640x480 scenes generated on the card (`eval/dataset_gen.py`, seed 42, three
objects each) with about 2048 candidates per frame
(`eval/ycb.generate_candidates`) dropped into a spool directory,
`python3 -m perception_tpu_torch.serve --config ... --warmup` and
`python3 -m perception_tpu_torch.camera_loop --spool ... --url ...` as
subprocesses, every object with at least half its pixels unoccluded within
20 mm (ADD and ADD-S printed beside) and the three the JAX package misses
too within 1 mm of the port's CPU-twin detections, /status, / and
/overlay.png checked, and the frames again through an in-process
FrameWatcher, whose detections must equal the served ones; the first
frame's raster, ICP and cost and the first scene's render are held against
their twins at these shapes, and the frame's batch as a slice.
Then the rest of the package: the depth ROI batch split across ranks
(`perception_tpu_torch.parallel.run` processes: one rank over NCCL, two
sharing the card over gloo; 2048 and 2047 poses, every field equal to
score_pose_batch's), the YCB-Video driver at full width (the zoo models as
PLY files under YCB names, the deploy scenes written in the YCB layout and
read back, run_dataset with about 2048 candidates per frame and its
accuracy.json, the first frame in "detections" mask mode and with the
colour cost, run_on_conveyor with warm start; the first frame's raster, ICP
and cost and the colour frame's cost held against their twins, the batch as
a slice; every object at least half unoccluded within 20 mm), the view
generator on the zoo PLYs (42 views at 150x150, its raster against the
twin) and VFH (trained on the bench models on the card; a rendered view
finds its model). Then the switches (section 12): the bench problem built
under PT_DECIMATE=cluster (bench models and LOD-256 bank by vertex
clustering) and with the ICP's stagnation streak at 10**9 (the fused ICP
without its early exit, as the JAX package's PT_ICP_NO_EARLY_EXIT=1), each
with its raster, ICP and cost against their twins, its slice against the
CPU twins and the env's greedy pass within 20 mm;
the clustered bank's borderline triangles at the rasters' area cull; the
ICP's device time and the batch with early exit on and off in turns; and
the localize CLI three times with PT_MODEL_CACHE_DIR set (written, read
back with equal output_poses.txt, written anew under PT_DECIMATE=cluster).
Every variable it sets is restored.
The 1-NN kernel, the three
rasters and the keys path's setup, the fused ICP (every mode) and the three
cost kernels are also held against their twins at edge shapes (several
reference tiles, ties, a pose with no valid reference; one pose, a 24x24
ROI, T = 200, T = 1024 at 640x480 stride 1, a pose behind the camera,
T = 2048 over the 80x60 frame, T = 336 at 640x480, poses close enough to
fill the bin raster's wide list, the 26x20 grid of 640x480 at stride 24;
poses without a valid target or
source, targets at max_correspondence / sensor_resolution +-1 ulp, N = 1,
N = 13, P = 77 with S = 45, a cost with P = 15000; for the colour costs
also only explain-only points, tied targets whose copies fail the gate
where the originals pass and the reverse, face ids outside [0, T)). Last,
it traces one depth, noisy and gicp batch and four of the branch batches
(fast, re-render, coarse, projective) with torch.profiler (device busy
time, top ops). A kernel's `ms` is one launch between two CUDA events, the host's
enqueue of it included; its `device_ms` is the device alone (a device spin
queued ahead of the start event, so the host enqueues the launch while the
card is busy). The launch counts are set to 0 just before each served path or scored
batch and read just after it. Every phase prints one JSON line; the run
ends with a {"kernels": [...]} line, the card's `nvidia-smi` name and power limit, and {"ok": true,
"device": {...}}. Any failed check raises and the exit code is non-zero.
There is no CPU fallback: without a CUDA device the script exits with code 2
and prints nothing on stdout.

`bound_ms` is the least time the H100 could take for a kernel's work: the
larger of its float32 operations over 67 TFLOP/s and its bytes (each input
read once, each output written once) over 3.35 TB/s. Operations per element
are counted from the kernels' sources (the *_OPS constants below); the
rasters count the pixels inside each drawn triangle's screen bounding box
(the coefficient-table raster without the setup, which it does not run;
the setup kernel its 130 operations per pose and triangle),
ICP the iterations and association sweeps each pose of this run ran, the
colour gate the points of this run that reach it. The ICP and the three
cost kernels sweep only valid (point, target) pairs, so their `bound_ms`
counts those (and the colour gates); `bound_dense_ms` counts every pair, and
`valid_pair_share` is the valid pairs' share of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import io
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from perception_tpu_torch import cli
from perception_tpu_torch.camera_loop import FrameWatcher
from perception_tpu_torch.core.config import EnvConfig, PerchConfig
from perception_tpu_torch.core.pose import CAM_TO_BODY, ContPose, quat_to_matrix
from perception_tpu_torch.core.state import ObjectState
from perception_tpu_torch.eval import metrics, table_scene, workloads
from perception_tpu_torch.eval import ycb as ycb_mod
from perception_tpu_torch.eval.bench_scene import (
    BenchProblem,
    bench_meshes,
    build_bench_problem,
)
from perception_tpu_torch.eval.dataset_gen import (
    DatasetGenerator,
    write_ycb_layout,
    write_zoo_plys,
)
from perception_tpu_torch.eval.fat import _rle_encode
from perception_tpu_torch.eval.model_zoo import zoo_raw_geometry
from perception_tpu_torch.eval.table_scene import build_table_scene
from perception_tpu_torch.eval.vfh import VFHPoseEstimator
from perception_tpu_torch.eval.ycb import YCB_CAMERA, generate_candidates
from perception_tpu_torch.io.images import decode_png, write_png
from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import (
    cost,
    cost_fused,
    cost_fused_color,
    icp_fused,
    knn,
    likelihood,
    raster_bin,
    raster_direct,
    raster_keys,
    rasterizer,
)
from perception_tpu_torch.ops import icp as icp_ops
from perception_tpu_torch.parallel import run as shard_run
from perception_tpu_torch.pipeline import env as pipeline_env
from perception_tpu_torch.pipeline import scorer
from perception_tpu_torch.pipeline.env import PerceptionEnv, RecognitionInput
from perception_tpu_torch.pipeline.heuristics import (
    Detection,
    DetectionHeuristicFactory,
)
from perception_tpu_torch.pipeline.mha_star import MHAStarPlanner
from perception_tpu_torch.pipeline.recognizer import (
    ModelSpec,
    ObjectRecognizer,
)
from perception_tpu_torch.tools import view_generator
from perception_tpu_torch.pipeline.search import TreeSearch
from perception_tpu_torch.serve import (
    LocalizerService,
    recognizer_from_config,
    serve,
)

N_POSES = 2048
N_CPU = 256
INVALID_KEY = 2**31 - 1
FP32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
HBM_BYTES = 3.35e12       # H100 SXM HBM3
# Float32 operations per element, counted in csrc/*.cu.
RASTER_PAIR_OPS = 16      # 4 plane evaluations (2 mul + 2 add) per pixel x tri
RASTER_TRI_OPS = 130      # per-pose triangle setup
ICP_PAIR_OPS = 8          # expanded-form distance per source x target
# Per source point and Gauss-Newton iteration, by mode: transform, residual,
# Jacobian and the mode's sums (29 / 44 + centroid pass / 71 / the 3x3
# weight, its adjugate and 29 sums).
ICP_POINT_OPS = {"p2p": 120, "d2d": 200, "sym": 310, "exact": 260}
NN_PAIR_OPS = 9           # 3 sub, 3 mul, 3 add per query x reference
COST_PAIR_OPS = 9         # 3 sub, 3 mul, 3 add per point x target
CIEDE_OPS = 160           # one CIEDE2000 per gated point
SPIN_CYCLES = 400_000     # ~0.2 ms of device spin ahead of a kernel timing


@dataclasses.dataclass(frozen=True)
class Kernel:
    prepare: object
    launch: object
    twin: object
    source: str
    replaces: str


KERNELS = {
    "raster_direct": Kernel(
        raster_direct.prepare_inputs, raster_direct.launch_kernel,
        raster_direct.rasterize_direct_twin,
        "perception_tpu_torch/csrc/raster_direct.cu",
        "perception_tpu/ops/pallas_raster_direct.py:320"),
    "raster_keys": Kernel(
        raster_keys.prepare_inputs, raster_keys.launch_kernel,
        raster_keys.rasterize_keys_twin,
        "perception_tpu_torch/csrc/raster_keys.cu",
        "perception_tpu/ops/pallas_raster.py:115"),
    # The keys path's table setup: no TPU kernel (XLA element-wise code in
    # the JAX package's render_pose_batch).
    "keys_setup": Kernel(
        raster_keys.prepare_setup, raster_keys.launch_setup,
        raster_keys.setup_twin, "perception_tpu_torch/csrc/raster_keys.cu",
        "perception_tpu/ops/rasterizer.py:375"),
    "raster_bin": Kernel(
        raster_bin.prepare_inputs, raster_bin.launch_kernel,
        raster_bin.rasterize_bin_twin,
        "perception_tpu_torch/csrc/raster_bin.cu",
        "perception_tpu/ops/pallas_raster_bin.py:306"),
    "icp_fused": Kernel(
        icp_fused.prepare_inputs, icp_fused.launch_kernel,
        icp_fused.icp_fused_twin, "perception_tpu_torch/csrc/icp_fused.cu",
        "perception_tpu/ops/pallas_icp.py:632"),
    "cost_fused": Kernel(
        cost_fused.prepare_inputs, cost_fused.launch_kernel,
        cost_fused.nn_cost_fused_twin,
        "perception_tpu_torch/csrc/cost_fused.cu",
        "perception_tpu/ops/pallas_cost.py:221"),
    "cost_fused_color": Kernel(
        cost_fused_color.prepare_inputs, cost_fused_color.launch_kernel,
        cost_fused_color.nn_cost_fused_color_twin,
        "perception_tpu_torch/csrc/cost_fused_color.cu",
        "perception_tpu/ops/pallas_cost.py:274"),
    "cost_fused_color_tri": Kernel(
        cost_fused_color.prepare_inputs_tri,
        cost_fused_color.launch_kernel_tri,
        cost_fused_color.nn_cost_fused_color_tri_twin,
        "perception_tpu_torch/csrc/cost_fused_color.cu",
        "perception_tpu/ops/pallas_cost.py:361"),
    "nn1_batch": Kernel(
        knn.prepare_inputs, knn.launch_kernel, knn.nn1_batch_twin,
        "perception_tpu_torch/csrc/knn.cu",
        "perception_tpu/ops/pallas_knn.py:71"),
}
# The wrappers each kernel is recorded at: (module, attribute) pairs.
SITES = {
    "raster_direct": ((raster_direct, "rasterize_direct"),),
    "raster_keys": ((raster_keys, "rasterize_keys"),),
    "keys_setup": ((raster_keys, "setup_table"),),
    "raster_bin": ((raster_bin, "rasterize_bin"),),
    "icp_fused": ((scorer, "icp_fused"),),
    "cost_fused": ((cost, "nn_cost_fused"),),
    "cost_fused_color": ((cost, "nn_cost_fused_color"),),
    "cost_fused_color_tri": ((cost, "nn_cost_fused_color_tri"),),
    # The composed refiners' association, and the composed cost's.
    "nn1_batch": ((icp_ops, "nn1_batch"), (scorer, "nn1_batch")),
}
ICP_MODES = ("exact", "d2d", "sym", "adaptive")   # beside p2p (depth batch)
DEPTH = ("raster_direct", "icp_fused", "cost_fused")
# kernel_backend -> the kernels its raster runs, the raster last.
RASTER_KERNELS = {"auto": ("raster_direct",),
                  "pallas": ("keys_setup", "raster_keys"),
                  "pallas_bin": ("raster_bin",)}
REPO = Path(__file__).resolve().parent
# (kernel, case) -> the prepared inputs kernel_phase held it on, and the
# wrapper call they were prepared from.
INPUTS: dict[tuple[str, str], tuple] = {}
CALLS: dict[tuple[str, str], tuple] = {}
ROI_CASE = "scoring batch"
NOISY_CASE = "noisy batch"
# ICP mode -> the case its kernel phase ran (the batch and scorer mode).
ICP_CASES = {"p2p": ROI_CASE, "exact": NOISY_CASE,
             **{m: f"{NOISY_CASE}, icp {m}" for m in ("d2d", "sym", "adaptive")}}
FULL_CASE = "colour full-frame batch"
FRAME_CASE = "observation 640x480 stride 1"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sync() -> None:
    """Wait for the card (nothing to wait for where there is none, as when
    the tests run the deploy scenes on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def event_times(fn, warmup: int = 3, reps: int = 20,
                device_only: bool = False) -> list[float]:
    """CUDA-event times of fn() in ms, one per run. With device_only, a
    0.2 ms device-side spin is queued ahead of the start event, so the host
    enqueues fn's launches while the card is busy and the events time the
    device alone (without it they also time the host's launch overhead,
    during which the card idles)."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, warmup: int = 3, reps: int = 20,
            device_only: bool = False) -> float:
    """Median CUDA-event time of fn() in ms."""
    return statistics.median(event_times(fn, warmup, reps, device_only))


def device_ms(fn) -> float:
    """A kernel's device time: median of 20 after 3 warm-ups, device only."""
    return time_ms(fn, device_only=True)


@contextlib.contextmanager
def recorded_kernel_calls(extra: dict | None = None):
    """Record the first call of each kernel wrapper made by the pipeline
    (its arguments exactly as the main path gives them), and of the
    functions `extra` names as SITES does."""
    seen: dict[str, tuple] = {}
    sites = [(name, mod, attr)
             for name, pairs in {**SITES, **(extra or {})}.items()
             for mod, attr in pairs]
    saved = [getattr(mod, attr) for _, mod, attr in sites]

    def recorder(fn, name):
        def call(*args, **kwargs):
            seen.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return call

    for (name, mod, attr), fn in zip(sites, saved):
        setattr(mod, attr, recorder(fn, name))
    try:
        yield seen
    finally:
        for (_, mod, attr), fn in zip(sites, saved):
            setattr(mod, attr, fn)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def box_pairs(xmin, xmax, ymin, ymax, drawable, anchors, pkw) -> int:
    """(pixel, triangle) pairs a bounding-box rasteriser must test: per pose
    and drawable triangle ([N, T] screen boxes), the strided pixels of the
    ROI inside the box."""
    return int(box_pixels(xmin, xmax, ymin, ymax, drawable, anchors,
                          pkw).sum().item())


def box_pixels(xmin, xmax, ymin, ymax, drawable, anchors,
               pkw) -> torch.Tensor:
    """[N, T]: the strided ROI pixels inside each drawable triangle's
    box."""
    height, stride = pkw["height"], pkw["stride"]
    ax, ay = anchors[:, 0:1].float(), anchors[:, 1:2].float()
    # Pixel column i sits at x = (ax + i) * stride, row j at
    # y = height - 1 - (ay + j) * stride.
    i0 = (torch.ceil(xmin / stride) - ax).clamp(min=0)
    i1 = (torch.floor(xmax / stride) - ax).clamp(max=pkw["roi_w"] - 1)
    j0 = (torch.ceil((height - 1 - ymax) / stride) - ay).clamp(min=0)
    j1 = (torch.floor((height - 1 - ymin) / stride)
          - ay).clamp(max=pkw["roi_h"] - 1)
    cols = (i1 - i0 + 1).clamp(min=0)
    rows = (j1 - j0 + 1).clamp(min=0)
    return cols * rows * drawable


def screen_boxes(pargs: tuple, pkw: dict, finite_guard: bool = False):
    """Each pose's triangles' screen boxes [N, T] (xmin, xmax, ymin, ymax)
    and whether the setup draws them, from the rasters' arguments that
    read the bank (direct, bin)."""
    verts16, pose12, model_ids, anchors, proj12 = pargs
    width, height = pkw["width"], pkw["height"]
    coefs = raster_direct._triangle_setup(verts16, pose12, model_ids, proj12,
                                          width, height, finite_guard)
    drawable = torch.isfinite(coefs[:, 8])          # [N, T]
    v = verts16[model_ids.long()]                   # [N, 16, T]
    p = [pose12[:, i:i + 1] for i in range(12)]
    pr = proj12.tolist()
    sx, sy = [], []
    for k in range(3):
        vx, vy, vz = v[:, 3 * k], v[:, 3 * k + 1], v[:, 3 * k + 2]
        x = (p[0] * vx + p[1] * vy + p[2] * vz + p[3]) * 100.0
        y = (p[4] * vx + p[5] * vy + p[6] * vz + p[7]) * 100.0
        z = (p[8] * vx + p[9] * vy + p[10] * vz + p[11]) * 100.0
        zdiv = torch.where(z > 1e-3, z, 1.0)
        sx.append((x * pr[0] + y * pr[1] + z * pr[2] + pr[3]) / zdiv
                  * (width / 2) + width / 2)
        sy.append((y * pr[5] + z * pr[6] + pr[7]) / zdiv
                  * (height / 2) + height / 2)
    sx, sy = torch.stack(sx), torch.stack(sy)       # [3, N, T]
    return sx.amin(0), sx.amax(0), sy.amin(0), sy.amax(0), drawable


def raster_pairs(pargs: tuple, pkw: dict) -> int:
    """box_pairs of the rasters that read the bank (direct, bin)."""
    return box_pairs(*screen_boxes(pargs, pkw), pargs[3], pkw)


def bin_ranges(pargs: tuple, pkw: dict) -> torch.Tensor:
    """The bin kernel's per-triangle patch ranges [N, 4, T] over the whole
    ROI (raster_bin.patch_ranges of its drawn triangles' widened boxes)."""
    xmin, xmax, ymin, ymax, drawn = screen_boxes(pargs, pkw, True)
    boxes = torch.stack([xmin - 1.0, xmax + 1.0, ymin - 1.0, ymax + 1.0], 1)
    return raster_bin.patch_ranges(
        boxes, drawn, pargs[3], **{k: pkw[k] for k in ("height", "stride",
                                                        "roi_h", "roi_w")})


def wide_triangles(pargs: tuple, pkw: dict) -> int:
    """(pose, triangle) pairs the bin kernel puts in its wide list: drawn
    triangles whose range spans more than MAX_BINS 8x4-pixel patches of the
    ROI (the shapes it is asked for fit one window)."""
    rng = bin_ranges(pargs, pkw)
    bins = (rng[:, 1] - rng[:, 0] + 1) * (rng[:, 3] - rng[:, 2] + 1)
    return int(((rng[:, 0] <= rng[:, 1]) & (bins > raster_bin.MAX_BINS))
               .sum())


def window_crossings(pargs: tuple, pkw: dict) -> tuple[int, int]:
    """(windows of patches the bin kernel bins the ROI in, (pose, triangle)
    pairs whose patch range spans more than one of them)."""
    t, roi_h, roi_w = pargs[0].shape[2], pkw["roi_h"], pkw["roi_w"]
    win_w, win_h = raster_bin.window(t, roi_h, roi_w)
    ntx = -(-roi_w // raster_bin.PATCH_W)
    nty = -(-roi_h // raster_bin.PATCH_H)
    rng = bin_ranges(pargs, pkw)
    cross = ((rng[:, 0] <= rng[:, 1]) & (rng[:, 2] <= rng[:, 3])
             & ((rng[:, 0] // win_w != rng[:, 1] // win_w)
                | (rng[:, 2] // win_h != rng[:, 3] // win_h)))
    return -(-ntx // win_w) * -(-nty // win_h), int(cross.sum())


def split_anchors(pargs: tuple, pkw: dict) -> torch.Tensor:
    """Per pose, the ROI anchor (0, y0) that puts the bin raster's first
    split between windows of patch rows through the middle of the pose's
    tallest drawn triangle (the rasters' arguments with any anchors)."""
    t, roi_h, roi_w = pargs[0].shape[2], pkw["roi_h"], pkw["roi_w"]
    _, win_h = raster_bin.window(t, roi_h, roi_w)
    _, _, ymin, ymax, drawn = screen_boxes(pargs, pkw, True)
    tall = torch.where(drawn, ymax - ymin, -1.0).argmax(dim=1, keepdim=True)
    mid = ((ymin + ymax) / 2).gather(1, tall)[:, 0]
    row = (pkw["height"] - 1 - mid) / pkw["stride"]
    last = pkw["height"] // pkw["stride"] - roi_h
    y0 = torch.nan_to_num(row - win_h * raster_bin.PATCH_H).round()
    y0 = torch.where(drawn.any(dim=1), y0.clamp(0, last), 0.0)
    return torch.stack([torch.zeros_like(y0), y0], 1).to(torch.int32)


def keys_pairs(pargs: tuple, pkw: dict) -> tuple[int, int]:
    """(box_pairs of the coefficient-table raster from the per-triangle
    boxes it is given, +-inf for culled triangles; the (pose, triangle)
    table rows it must read: those whose box, widened by 1 px, holds a pixel
    of the pose's ROI)."""
    boxes, anchors = pargs[1], pargs[2]
    xmin, xmax, ymin, ymax = boxes.unbind(-1)
    drawn = torch.isfinite(xmin)
    pairs = box_pairs(xmin, xmax, ymin, ymax, drawn, anchors, pkw)
    rows = box_pixels(xmin - 1.0, xmax + 1.0, ymin - 1.0, ymax + 1.0, drawn,
                      anchors, pkw) > 0
    return pairs, int(rows.sum().item())


def work(name: str, pargs: tuple, pkw: dict, out, twin_extra) -> tuple:
    """(float32 operations, bytes) of one call at these inputs."""
    outs = out if isinstance(out, tuple) else (out,)
    moved = nbytes(pargs) + nbytes(outs)
    if name in ("raster_direct", "raster_bin"):
        n, t = pargs[1].shape[0], pargs[0].shape[2]
        return (raster_pairs(pargs, pkw) * RASTER_PAIR_OPS
                + n * t * RASTER_TRI_OPS), moved
    if name == "raster_keys":
        # Pairs in the boxes; every box and key, and only the table rows of
        # triangles whose widened box meets the ROI.
        pairs, rows = twin_extra
        table, boxes, anchors = pargs
        moved = (nbytes((boxes, anchors)) + nbytes(outs)
                 + rows * table.shape[2] * table.element_size())
        return pairs * RASTER_PAIR_OPS, moved
    if name == "keys_setup":
        n, t = pargs[1].shape[0], pargs[0].shape[2]
        return n * t * RASTER_TRI_OPS, moved
    if name == "icp_fused":
        _, p, _ = pargs[0].shape
        s = pargs[3].shape[1]
        iters, sweeps = twin_extra              # [N] per pose, as run
        ops = (sweeps.sum().item() * p * s * ICP_PAIR_OPS
               + iters.sum().item() * p * ICP_POINT_OPS[pkw["mode"]])
        return ops, moved
    if name == "nn1_batch":
        n, p, _ = pargs[0].shape
        return n * p * pargs[1].shape[1] * NN_PAIR_OPS, moved
    n, p, _ = pargs[0].shape
    s = pargs[-2 if name != "cost_fused" else 2].shape[1]
    ops = n * p * s * COST_PAIR_OPS
    if name != "cost_fused":
        ops += twin_extra * CIEDE_OPS           # points that reach the gate
    return ops, moved


def valid_work(name: str, pargs: tuple, pkw: dict, twin_extra):
    """(float32 operations, share of the dense pairs) counting only valid
    (point, target) pairs, for the kernels that sweep only those: ICP's
    association sweeps and per-point terms over its valid sources, the three
    costs' distances over their valid points (cadd <= 0), plus the colour
    costs' gates. None for other kernels."""
    if name == "icp_fused":
        src, _, sadd, tgt = pargs
        iters, sweeps = twin_extra
        nv = (sadd < float("inf")).sum(dim=1).double().cpu()
        nt = (tgt[..., 7] < 1e30).sum(dim=1).double().cpu()
        pairs = (sweeps.double().cpu() * nv * nt).sum().item()
        dense = sweeps.double().sum().item() * src.shape[1] * tgt.shape[1]
        ops = (pairs * ICP_PAIR_OPS + (iters.double().cpu() * nv).sum().item()
               * ICP_POINT_OPS[pkw["mode"]])
        return ops, pairs / max(dense, 1.0)
    if name.startswith("cost_fused"):
        cloud, cadd = pargs[:2]
        tgt4 = pargs[2] if name == "cost_fused" else pargs[-2]
        nv = (cadd <= 0.0).sum(dim=1).double()
        nt = (tgt4[..., 3] == 0.0).sum(dim=1).double()
        pairs = (nv * nt).sum().item()
        ops = pairs * COST_PAIR_OPS
        if name != "cost_fused":
            ops += twin_extra * CIEDE_OPS       # points that reach the gate
        return (ops,
                pairs / (cloud.shape[0] * cloud.shape[1] * tgt4.shape[1]))
    return None


def gated_points(pargs: tuple, pkw: dict) -> int:
    """Points of a colour-kernel call that evaluate CIEDE2000: close to
    their winner and not explain-only."""
    cloud, cadd, tgt4 = pargs[0], pargs[1], pargs[-2]
    dmin, _ = cost_fused.nearest(cloud, tgt4)
    return int(((dmin <= pkw["max_dist_sq"]) & (cadd == 0.0)).sum())


def compare(name: str, kernel_out, twin_out) -> dict:
    """Hold a kernel's output against its twin's with the kernel's bar."""
    if name == "keys_setup":
        return compare_setup(kernel_out, twin_out)
    if name in ("raster_direct", "raster_keys", "raster_bin"):
        same = kernel_out == twin_out
        frac = same.float().mean().item()
        err = ((kernel_out >> 11) - (twin_out >> 11)).abs().max().item()
        require(frac == 1.0, f"{name} keys equal to the twin on {frac:.6f}")
        return {"equal_frac": frac, "max_abs_err": float(err),
                "err_unit": "cm of depth"}
    if name == "icp_fused":
        per_pose = (kernel_out - twin_out).abs().amax(dim=(1, 2))
        frac = (per_pose == 0).float().mean().item()
        require(frac == 1.0, f"ICP deltas equal to the twin on {frac:.4f}")
        return {"equal_frac": frac, "max_abs_err": per_pose.max().item(),
                "err_unit": "delta entry (rotation, m)"}
    if name == "nn1_batch":
        (kd, ki), (td, ti) = kernel_out, twin_out
        same = (ki == ti) & (kd == td)
        frac = same.float().mean().item()
        fin = torch.isfinite(kd) & torch.isfinite(td)
        err = (kd - td).abs()[fin].max().item() if fin.any() else 0.0
        require(frac == 1.0, f"nn1_batch equal to the twin on {frac:.6f}")
        return {"equal_frac": frac, "max_abs_err": err, "err_unit": "m^2"}
    same = torch.stack([a == b for a, b in zip(kernel_out, twin_out)]).all(0)
    err = max((a - b).abs().max().item() for a, b in zip(kernel_out, twin_out))
    frac = same.float().mean().item()
    require(frac == 1.0, f"{name} counts equal on {frac:.6f}")
    return {"equal_frac": frac, "max_abs_err": err, "err_unit": "count"}


def compare_setup(kernel_out, twin_out) -> dict:
    """The setup kernel against keys_setup + pack_coefficients: every box
    bit for bit (int32 views); every table entry of a drawable triangle
    (box not (+inf, -inf, ..)) bit for bit; alpha_c = -inf on every culled
    row, and so on each row where the twin has alpha_c = -inf (where the
    twin's is NaN, both fail every coverage test and no raster reads the
    rest of the row)."""
    (k_tab, k_box), (t_tab, t_box) = kernel_out, twin_out
    inf = float("inf")
    culled = (t_box[..., 0] == inf) & (t_box[..., 1] == -inf)
    drawn = ~culled
    boxes_equal = torch.equal(k_box.view(torch.int32), t_box.view(torch.int32))
    rows_equal = (k_tab.view(torch.int32)
                  == t_tab.view(torch.int32)).all(dim=-1)
    frac = rows_equal[drawn].float().mean().item() if drawn.any() else 1.0
    alpha_ok = bool(torch.isneginf(k_tab[..., 8][culled]).all())
    twin_nan = int(torch.isnan(t_tab[..., 8][culled]).sum())
    err = ((k_tab[drawn] - t_tab[drawn]).abs().nan_to_num(0.0).max().item()
           if drawn.any() else 0.0)
    require(boxes_equal, "keys_setup boxes equal to the twin's")
    require(frac == 1.0, f"keys_setup drawable rows equal on {frac:.6f}")
    require(alpha_ok, "keys_setup alpha_c = -inf on every culled row")
    return {"equal_frac": frac, "max_abs_err": err,
            "err_unit": "table entry", "drawn_rows": int(drawn.sum()),
            "culled_rows": int(culled.sum()),
            "culled_rows_twin_alpha_nan": twin_nan}


CDIST_MODES = ("donot_use_mm_for_euclid_dist", "use_mm_for_euclid_dist")


def library_ms(name: str, pargs: tuple) -> tuple[float | None, str | None]:
    """One PyTorch call computing the kernel's function, timed, where there
    is one: the 1-NN as cdist with the invalid references masked to inf,
    then min. cdist's difference form first; where that fails at the shape
    (on the H100 its launch at 2048 x 4096 x 256 is an invalid
    configuration), its matrix-product form. Returns (ms, the cdist
    compute_mode timed), (None, None) where no call runs; a "library" line
    gives each failure. Used nowhere in the port."""
    if name != "nn1_batch":
        return None, None
    query, ref4 = pargs
    ref = ref4[..., :3].contiguous()
    valid = ref4[..., 3] == 0.0
    for mode in CDIST_MODES:
        def call():
            d = torch.cdist(query, ref, compute_mode=mode)
            return torch.where(valid[:, None, :], d, float("inf")).min(dim=-1)
        try:
            return time_ms(call), mode
        except RuntimeError as e:
            emit({"phase": "library", "kernel": name, "compute_mode": mode,
                  "shapes": [list(query.shape), list(ref.shape)],
                  "error": str(e).splitlines()[0]})
            torch.cuda.empty_cache()
    return None, None


def kernel_phase(name: str, call: tuple, label: str) -> dict:
    k = KERNELS[name]
    args, kwargs = call
    pargs, pkw = k.prepare(*args, **kwargs)
    INPUTS[name, label] = pargs, pkw
    CALLS[name, label] = call
    out_k = k.launch(*pargs, **pkw)
    sync()
    extra = None
    iterations = {}
    if name == "icp_fused":
        out_t, iters, sweeps = k.twin(*pargs, **pkw, return_counts=True)
        extra = (iters, sweeps)
        iterations = {"mode": pkw["mode"], "nn_every": pkw["nn_every"],
                      "iterations_mean": iters.mean().item(),
                      "iterations_max": iters.max().item(),
                      "sweeps_mean": sweeps.mean().item()}
    else:
        out_t = k.twin(*pargs, **pkw)
        if name.startswith("cost_fused_color"):
            extra = gated_points(pargs, pkw)
        elif name == "raster_keys":
            extra = keys_pairs(pargs, pkw)
    sync()
    result = compare(name, out_k, out_t)
    result["ms"] = time_ms(lambda: k.launch(*pargs, **pkw))
    result["device_ms"] = device_ms(lambda: k.launch(*pargs, **pkw))
    result["plain_ms"] = time_ms(lambda: k.twin(*pargs, **pkw), warmup=1,
                                 reps=5)
    ops, moved = work(name, pargs, pkw, out_k, extra)
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, moved / HBM_BYTES * 1e3
    # The bound counts the work this run's data needs: over valid pairs for
    # the kernels that sweep only those (the dense count beside it).
    valid = valid_work(name, pargs, pkw, extra)
    if valid is not None:
        result.update(ops_dense=ops, bound_dense_ms=max(t_ops, t_bytes),
                      valid_pair_share=valid[1])
        ops = valid[0]
        t_ops = ops / FP32_FLOPS * 1e3
    lib_ms, lib_mode = library_ms(name, pargs)
    result.update(ops=ops, bytes=moved, bound_ms=max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes",
                  library_ms=lib_ms, **iterations)
    if lib_mode is not None:
        result["library_call"] = f"torch.cdist(compute_mode={lib_mode!r})"
    if name == "raster_keys":
        result["table_rows_read"] = extra[1]
    shapes = [list(a.shape) for a in pargs if isinstance(a, torch.Tensor)]
    emit({"phase": "kernel", "kernel": name, "case": label,
          "shapes": shapes, **result})
    return result


def profile_batch(bp, label: str, cfg=None, top: int = 8) -> None:
    """One scoring batch under torch.profiler (CPU + CUDA activity): the
    device's busy time (the kernels' device time summed; one stream, so they
    do not overlap) against the host clock around the batch, the kernels that
    take most of it, and the PyTorch ops that launched most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bp.score(cfg=cfg)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bp.score(cfg=cfg)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.name[:80], [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    op_ms = {e.key: getattr(e, "self_device_time_total", 0) / 1e3
             for e in ops}
    emit({"phase": "profile", "case": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
          "kernel_launches": sum(v[1] for v in kernels.values()),
          "top_kernels_ms": sorted(([k, v[0], v[1]] for k, v in
                                    kernels.items()), key=lambda r: -r[1])[:top],
          "top_ops_device_ms": sorted(op_ms.items(),
                                      key=lambda r: -r[1])[:top]})


def cpu_scene(scene: scorer.ObservedScene) -> scorer.ObservedScene:
    return scorer.ObservedScene(**{f.name: getattr(scene, f.name).cpu()
                                   for f in dataclasses.fields(scene)})


def check_kernels(bp, path: tuple, label: str, cfg=None,
                  only: tuple | None = None) -> tuple[dict, dict]:
    """The scoring batch (with `cfg` if given) must call exactly the kernels
    of `path`; run each of them (or those in `only`) and its twin on the
    inputs the batch hands its wrapper; compare and time. Also returns the
    launches the batch made (counts set to 0 just before it)."""
    build.reset_counts()
    with recorded_kernel_calls() as calls:
        bp.score(cfg=cfg)
    sync()
    launches = dict(build.LAUNCHES)
    require(set(calls) == set(path), f"{label} called {sorted(calls)}")
    require(all(launches.get(n, 0) > 0 for n in path),
            f"{label} launches {launches}")
    return {name: kernel_phase(name, calls[name], label)
            for name in (path if only is None else only)}, launches


def check_slice(bp, label: str, equal_frac: float = 0.98, max_diff: int = 2,
                close_frac: float = 1.0, trans_frac: float = 0.98) -> None:
    """score_pose_batch on the card; its first N_CPU poses on the CPU. The
    totals must be equal on `equal_frac` of the poses and within `max_diff`
    on `close_frac`, the translations within 1 mm on `trans_frac`."""
    n = len(bp.candidates)
    out = bp.score()
    sync()
    require(out.total_cost.shape == (n,), "total_cost shape")
    require(bool(torch.isfinite(out.adjusted_poses).all()),
            "adjusted poses finite")
    # CUDA events around the whole batch: the stream's idle gaps between
    # its launches count.
    runs = event_times(bp.score, warmup=1, reps=10)
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
        bank_icp_normals=env._bank_icp_normals.cpu(),
        bank_tri_lab=env._render_bank_lab.cpu() if bp.use_lab else None)
    cpu_s = time.perf_counter() - t0
    g_tot = out.total_cost[:N_CPU].cpu()
    tot_eq = (g_tot == ref.total_cost).float().mean().item()
    diffs = (g_tot - ref.total_cost).abs()
    tot_diff = diffs.max().item()
    close = (diffs <= max_diff).float().mean().item()
    trans = (out.adjusted_poses[:N_CPU, :3, 3].cpu()
             - ref.adjusted_poses[:, :3, 3]).abs().amax(dim=1)
    trans_ok = (trans <= 1e-3).float().mean().item()
    valid_tot = out.total_cost[out.total_cost >= 0].float()
    emit({"phase": "slice", "case": label, "poses": n, "batch_ms": batch_ms,
          "batch_ms_runs": runs, "poses_per_s": n / batch_ms * 1e3,
          "valid_poses": int((out.total_cost >= 0).sum()),
          "median_valid_total": valid_tot.median().item(),
          "cpu_twin_poses": N_CPU, "cpu_twin_s": cpu_s,
          "total_equal_frac": tot_eq, "total_max_diff": tot_diff,
          "total_differs_at": torch.nonzero(g_tot != ref.total_cost)
          .flatten().tolist(),
          "translation_within_1mm_frac": trans_ok,
          "translation_max_diff_m": trans.max().item()})
    require(tot_eq >= equal_frac, f"{label}: total_cost equal on {tot_eq:.3f}")
    require(close >= close_frac,
            f"{label}: total_cost within {max_diff} on {close:.3f}")
    require(trans_ok >= trans_frac,
            f"{label}: translations within 1 mm on {trans_ok:.3f}")


def check_served_path(bp, dev, label: str, requests: int,
                      responses: list | None = None) -> dict:
    """Recogniser from the bench models and configuration, the port's own
    GT observation (with its colour image), then `requests` /localize
    requests with every candidate, each object visible in the observation
    within 20 mm. Returns the kernel launches counted during the requests
    alone; appends the responses to `responses` if given."""
    env = bp.env
    rec = ObjectRecognizer.from_models(env.bank.models, env.camera, env.perch,
                                       env.env, t_cap=1024, device=dev)
    bp.observe(rec.env)
    rin = rec.env._input
    visible = [i for i, c in enumerate(rec.env._observed.seg_count.tolist())
               if c > 0]
    require(visible == [1, 2], f"visible objects {visible} != [1, 2]")
    names = [f"blob{i}" for i in range(3)]
    pose_lists: dict[str, list] = {}
    for c in bp.candidates:
        pose_lists.setdefault(names[c.id], []).append(
            [c.pose.x, c.pose.y, c.pose.z, *c.pose.quaternion()])
    payload = {
        "depth_image": np.asarray(rin.depth_image).tolist(),
        "label_mask": np.asarray(rin.label_mask).tolist(),
        "depth_factor": rin.depth_factor,
        "cam_to_world": np.asarray(rin.cam_to_world).tolist(),
        "segmented_object_names": names,
        "pose_lists": pose_lists,
        "mode": "greedy"}
    color = env.perch.use_color_cost
    if color:
        payload["color_image"] = np.asarray(rin.color_image).tolist()
    body = json.dumps(payload).encode()
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/localize"
    latency, split = [], []
    responses = [] if responses is None else responses
    stats = rec.env.stats
    try:
        sync()
        torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        for _ in range(requests):
            gpu0 = stats.gpu_time
            t0 = time.perf_counter()
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                responses.append(json.loads(resp.read()))
            latency.append((time.perf_counter() - t0) * 1e3)
            # Host-clock split of the request (the server runs in this
            # process): payload decode, observed-scene build, greedy scoring
            # + argmin, and the scoring dispatch inside it.
            split.append({
                "decode_ms": responses[-1]["stats"]["decode_time"] * 1e3,
                "set_input_ms": stats.input_time * 1e3,
                "greedy_ms": stats.time * 1e3,
                "score_batch_ms": (stats.gpu_time - gpu0) * 1e3})
        launches = dict(build.LAUNCHES)
        twins = dict(build.TWIN_CALLS)
        peak_bytes = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread stopped")
    # The handler's largest host stage outside those spans, timed once here
    # on the same request: candidate generation and validity pruning.
    t0 = time.perf_counter()
    rec.env.generate_successors_6dof(
        {k: np.asarray(v, np.float64) for k, v in pose_lists.items()})
    successors_ms = (time.perf_counter() - t0) * 1e3
    errors_mm: dict[str, list] = {}
    for out in responses:
        dets = {d["name"]: d for d in out["detections"]}
        for i in visible:
            require(names[i] in dets, f"{label}: {names[i]} not detected")
            gt = bp.gt[i].pose
            err = float(np.linalg.norm(np.asarray(dets[names[i]]["translation"])
                                       - [gt.x, gt.y, gt.z]))
            errors_mm.setdefault(names[i], []).append(err * 1e3)
            require(err < 0.02,
                    f"{label}: {names[i]} off by {err * 1e3:.1f} mm")
    emit({"phase": "serve", "case": label, "requests": len(responses),
          "color_image": color, "payload_mb": len(body) / 1e6,
          "latency_ms": latency, "latency_split": split,
          "successors_ms": successors_ms,
          "candidates": len(bp.candidates),
          "scenes_rendered": [r["stats"]["scenes_rendered"]
                              for r in responses],
          "peak_memory_bytes": peak_bytes,
          "detection_error_mm": errors_mm, "launches": launches,
          "twin_calls": twins,
          "jax_package_imported": sorted(
              m for m in sys.modules
              if m.split(".")[0] in ("jax", "perception_tpu", "benchmarks"))})
    require(sum(twins.values()) == 0, f"{label}: twins ran: {twins}")
    return launches


def raster_ab(case: str, problems: dict) -> None:
    """The three rasters of `kernel_backend` at one batch: bin and direct on
    the inputs the bin batch hands its wrapper (they read the same), keys on
    its own batch's (the same poses and anchors). The bin keys must equal
    the direct keys, and so must the keys-kernel keys. Then, in turns, each
    kernel (median of 20 after 3 warm-ups), the keys path's setup as the
    card runs it (one kernel launch) and as the CPU runs it (keys_setup and
    pack_coefficients in PyTorch, here on the card; the setup kernel is held
    to it), and each backend's whole batch (median of 10 after 1)."""
    calls = {}
    for backend, bp in problems.items():
        with recorded_kernel_calls() as seen:
            bp.score()
        sync()
        calls[backend] = seen[RASTER_KERNELS[backend][-1]]
        if backend == "pallas":
            setup_call = seen["keys_setup"]
    bargs, bkw = calls["pallas_bin"]
    prepared = {
        "raster_direct": raster_direct.prepare_inputs(*bargs, **bkw),
        "raster_bin": raster_bin.prepare_inputs(*bargs, **bkw),
        "raster_keys": raster_keys.prepare_inputs(*calls["pallas"][0],
                                                  **calls["pallas"][1])}
    require(torch.equal(prepared["raster_keys"][0][2],
                        prepared["raster_direct"][0][3]),
            f"{case}: the keys and bin batches have other ROI anchors")
    launch = {name: (lambda k=KERNELS[name], a=a: k.launch(*a[0], **a[1]))
              for name, a in prepared.items()}
    out = {name: fn() for name, fn in launch.items()}
    sync()
    direct = out["raster_direct"]
    bin_equal = (out["raster_bin"] == direct).float().mean().item()
    require(bin_equal == 1.0, f"{case}: bin keys equal direct on {bin_equal}")
    keys_bp = problems["pallas"]
    verts, _, valid, poses, ids, _, _, proj, _ = keys_bp.args
    cfg = keys_bp.cfg
    backface = keys_bp.env._render_bank[3]
    sargs, skw = raster_keys.prepare_setup(*setup_call[0], **setup_call[1])

    def setup_kernel():
        return raster_keys.launch_setup(*sargs, **skw)

    def setup_pytorch():
        coefs, abs_base, ok, boxes = rasterizer.keys_setup(
            verts, valid, poses, ids.long(), proj, cfg.width, cfg.height,
            backface)
        return raster_keys.pack_coefficients(coefs, abs_base, ok), boxes
    table = setup_kernel()[0]
    require(torch.equal(table, prepared["raster_keys"][0][0]),
            f"{case}: the timed setup gives the batch's coefficient table")
    setup_check = compare_setup((table, prepared["raster_keys"][0][1]),
                                setup_pytorch())
    order = ["raster_direct", "raster_keys", "raster_bin"]
    kernel_ms: dict[str, list] = {n: [] for n in order}
    for name in order + order[::-1]:
        kernel_ms[name].append(time_ms(launch[name]))
    setup_ms: dict[str, list] = {"kernel": [], "pytorch": []}
    for name, fn in (("pytorch", setup_pytorch), ("kernel", setup_kernel),
                     ("kernel", setup_kernel), ("pytorch", setup_pytorch)):
        setup_ms[name].append(time_ms(fn))
    batch_ms: dict[str, list] = {b: [] for b in problems}
    for backend in ["auto", "pallas", "pallas_bin", "pallas_bin", "pallas",
                    "auto"]:
        batch_ms[backend] += event_times(problems[backend].score, warmup=1,
                                         reps=10)
    mean_ms = {n: statistics.mean(v) for n, v in kernel_ms.items()}
    keys_equal = (out["raster_keys"] == direct).float().mean().item()
    emit({"phase": "raster_ab", "case": case,
          "poses": int(direct.shape[0]), "pixels": int(direct.shape[1]),
          "kernel_ms": mean_ms, "kernel_ms_turns": kernel_ms,
          "direct_over_bin": mean_ms["raster_direct"] / mean_ms["raster_bin"],
          "keys_setup_ms": statistics.mean(setup_ms["pytorch"]),
          "keys_setup_kernel_ms": statistics.mean(setup_ms["kernel"]),
          "keys_setup_ms_turns": setup_ms,
          "keys_setup_kernel_vs_pytorch": setup_check,
          "batch_ms": {b: statistics.median(v) for b, v in batch_ms.items()},
          "bin_equal_direct_frac": bin_equal,
          "keys_equal_direct_frac": keys_equal})
    require(keys_equal == 1.0,
            f"{case}: keys-raster keys equal direct on {keys_equal}")


def edge_phase(name: str, label: str, pargs: tuple, pkw: dict):
    """One kernel against its twin at an edge shape; exact equality."""
    k = KERNELS[name]
    out = k.launch(*pargs, **pkw)
    sync()
    res = compare(name, out, k.twin(*pargs, **pkw))
    shapes = [list(a.shape) for a in pargs if isinstance(a, torch.Tensor)]
    emit({"phase": "edge", "kernel": name, "case": label, "shapes": shapes,
          **{key: pkw[key] for key in ("roi_h", "roi_w", "stride")
             if key in pkw},
          **res})
    return out


def nn1_edge_cases(dev) -> None:
    """The 1-NN kernel at shapes off the main path: several reference tiles
    and a partial query block, fewer queries and references than a tile, a
    pose with no valid reference, and exact ties between duplicated
    references (each must go to the lowest valid index)."""
    rng = np.random.default_rng(5)

    def cloud(*shape):
        x = rng.normal(0, 0.05, shape).astype(np.float32)
        x[..., 2] += 0.6
        return x

    cases = [(f"N={n} P={p} S={s}", cloud(n, p, 3), cloud(n, s, 3),
              rng.random((n, s)) > 0.3)
             for n, p, s in ((3, 300, 700), (2, 50, 40))]
    rvalid = rng.random((4, 256)) > 0.3
    rvalid[1] = False
    cases.append(("pose 1 without a valid reference", cloud(4, 256, 3),
                  cloud(4, 256, 3), rvalid))
    ref = cloud(4, 256, 3)
    ref[:, 128:] = ref[:, :128]                 # every reference twice
    query = ref.copy()                          # 128 exact hits at d = 0
    query[:, 128:] += rng.normal(0, 1e-3, (4, 128, 3)).astype(np.float32)
    rvalid = np.ones((4, 256), bool)
    rvalid[:, :16] = False                      # their duplicates win
    cases.append(("every reference twice (exact ties)", query, ref, rvalid))
    for label, q, r, rv in cases:
        q, r, rv = (torch.as_tensor(a, device=dev) for a in (q, r, rv))
        pargs, pkw = knn.prepare_inputs(q, None, r, rv)
        dist, idx = edge_phase("nn1_batch", label, pargs, pkw)
        if "pose 1" in label:
            require(bool(torch.isinf(dist[1]).all() and (idx[1] == 0).all()),
                    "nn1_batch: a pose without references gives (inf, 0)")
        if "ties" in label:
            first = torch.where(idx >= 128, idx - 128, idx)
            require(bool(((idx < 128) | (first < 16)).all()),
                    "nn1_batch: a tie went to the higher valid index")


def raster_edge_cases() -> None:
    """The three rasters, and the keys path's setup, at shapes off the main
    path, from the scoring batch's inputs: one pose; a 24x24 ROI (2x2
    tiles, the last ones 8 wide); T = 200 (a multiple of neither the tile,
    the setup pass nor the cluster); T = 1024 over the 640x480 frame at
    stride 1 for 8 candidate poses; a batch whose second pose lies behind
    the camera (every triangle culled); T = 2048 (the observation bank
    twice: ties between copies, eight cull passes) over the 80x60 full
    frame; T = 336 over 640x480 at stride 1, the most triangles the parent
    commit's bin kernel took there (T x 49 B + (4 + T / 4) B per 8x16 tile
    <= 227 KB); T = 1024 over that frame with the 8 poses 0.16 m from
    the camera, whose large triangles fill the bin raster's wide list; and
    T = 16 over a 2048x1792 ROI at stride 1 (the parent commit's bin kernel
    took it at 230,160 B) for 2 of those poses and 2 of the batch's, which
    the bin raster covers in two windows of patches, each ROI anchored in a
    2048x3584 frame so that its tallest triangle crosses from one window
    into the next; T = 1024 over the 640x480 frame at stride 24, the 3-DoF
    search's 26x20 grid, whose last column of 8x4 patches is 2 pixels wide,
    for the 8 candidate poses and for the 8 poses at 0.16 m."""
    pargs, pkw = INPUTS["raster_direct", ROI_CASE]
    verts16, pose12, ids, anchors, proj12 = pargs
    frame_verts, _, _, frame_anchors, _ = INPUTS["raster_direct",
                                                 FRAME_CASE][0]
    frame_kw = INPUTS["raster_direct", FRAME_CASE][1]
    full_kw = INPUTS["raster_direct", FULL_CASE][1]
    frame8 = frame_anchors[:1].expand(8, 2).contiguous()
    grid24_kw = {**frame_kw, "stride": 24, "roi_h": frame_kw["height"] // 24,
                 "roi_w": frame_kw["width"] // 24}
    behind = pose12[:4].clone()
    behind[1, 11] = -behind[1, 11]              # z translation negated
    near = pose12[:8].clone()
    near[:, 3], near[:, 7], near[:, 11] = 0.0, 0.0, 0.16
    double = torch.cat([frame_verts, frame_verts], dim=2).contiguous()
    windows_kw = {**frame_kw, "width": 2048, "height": 3584, "roi_h": 1792,
                  "roi_w": 2048}
    windows_args = (frame_verts[:, :, :16].contiguous(),
                    torch.cat([pose12[:2], near[:2]]), ids[:4], None, proj12)
    windows_args = (*windows_args[:3],
                    split_anchors(windows_args, windows_kw), proj12)
    cases = [
        ("N=1", (verts16, pose12[:1], ids[:1], anchors[:1], proj12), pkw),
        ("ROI 24x24", pargs, {**pkw, "roi_h": 24, "roi_w": 24}),
        ("T=200", (verts16[:, :, :200].contiguous(), *pargs[1:]), pkw),
        ("T=1024, 640x480 stride 1, 8 poses",
         (frame_verts, pose12[:8], ids[:8], frame8, proj12), frame_kw),
        ("pose 1 behind the camera", (verts16, behind, ids[:4], anchors[:4],
                                      proj12), pkw),
        ("T=2048 (the observation bank twice), 80x60 full frame, 8 poses",
         (double, pose12[:8], ids[:8], torch.zeros_like(frame8), proj12),
         full_kw),
        ("T=336, 640x480 stride 1, 8 poses",
         (frame_verts[:, :, :336].contiguous(), pose12[:8], ids[:8], frame8,
          proj12), frame_kw),
        ("T=1024, 640x480 stride 1, 8 poses at 0.16 m (wide list)",
         (frame_verts, near, ids[:8], frame8, proj12), frame_kw),
        ("T=16, 2048x1792 ROI of a 2048x3584 frame, stride 1, 4 poses "
         "(bin windows)", windows_args, windows_kw),
        ("T=1024, 640x480 stride 24 (26x20, partly filled patches), 8 poses",
         (frame_verts, pose12[:8], ids[:8], torch.zeros_like(frame8),
          proj12), grid24_kw),
        ("T=1024, 640x480 stride 24 (26x20, partly filled patches), 8 poses "
         "at 0.16 m", (frame_verts, near, ids[:8], torch.zeros_like(frame8),
                       proj12), grid24_kw)]
    require(frame_verts.shape[0] == verts16.shape[0],
            "the observation bank has the scoring bank's models")
    for label, args, kw in cases:
        for name in ("raster_direct", "raster_keys", "raster_bin"):
            if name == "raster_keys":
                setup = edge_phase("keys_setup", label,
                                   (args[0], args[1], args[2], args[4]),
                                   {k: kw[k] for k in ("width", "height")})
                keys = edge_phase(name, label, (*setup, args[3]),
                                  {k: kw[k] for k in ("height", "stride",
                                                      "roi_h", "roi_w")})
            else:
                keys = edge_phase(name, label, args, kw)
            if "behind" in label:
                require(bool((keys[1] == INVALID_KEY).all()
                             and (keys[0] != INVALID_KEY).any()),
                        f"{name}: a pose behind the camera drew pixels")
        if "wide list" in label:
            wide = wide_triangles(args, kw)
            emit({"phase": "edge", "kernel": "raster_bin", "case": label,
                  "wide_list_pose_triangles": wide})
            require(wide > 0, "no triangle reached the bin's wide list")
        if "windows" in label:
            windows, crossing = window_crossings(args, kw)
            emit({"phase": "edge", "kernel": "raster_bin", "case": label,
                  "windows": windows, "window_crossing_triangles": crossing})
            require(windows > 1 and crossing > 0,
                    "the bin's windows were not exercised")


def ulp_steps(v: torch.Tensor, steps: int) -> torch.Tensor:
    """The nonzero entries of v moved by `steps` float32 ulps away from zero
    (towards it if steps < 0)."""
    toward = (torch.where(v > 0, math.inf, -math.inf) if steps > 0
              else torch.zeros_like(v))
    out = v.clone()
    for _ in range(abs(steps)):
        out = torch.where(out == 0, out, torch.nextafter(out, toward))
    return out


def boundary_rows(points: torch.Tensor, radius: float) -> torch.Tensor:
    """Targets at `radius` from each of 8 points, along an axis and along the
    diagonal, exactly and one ulp either side (two per point, mirrored)."""
    dev = points.device
    axis = torch.tensor([radius, 0.0, 0.0], device=dev)
    diag = torch.full((3,), radius / math.sqrt(3.0), device=dev)
    offs = [ulp_steps(o, k) for o in (axis, diag) for k in (0, 1, -1)]
    offs += [torch.tensor([0.0, -radius, 0.0], device=dev),
             torch.tensor([0.0, 0.0, radius], device=dev)]
    rows = [torch.stack([points[k] + o, points[k] - o])
            for k, o in enumerate(offs)]
    return torch.cat(rows)                          # [16, 3]


def icp_edge_cases() -> None:
    """The fused ICP against its twin at edge inputs, in every mode (from
    the inputs each mode's batch handed the wrapper): 13 in-view poses (not
    a multiple of the adaptive group of 8), one without a valid target, one
    without a valid source, one whose targets sit at max_correspondence
    from its sources (axis and diagonal, +-1 ulp), one with every target
    twice (exact ties); N = 1; P = 77 and S = 45 (not multiples of 32)."""
    for mode, label in ICP_CASES.items():
        (src, valid, tgt, nrm), kw = CALLS["icp_fused", label]
        keep = torch.nonzero(valid.any(dim=1)).flatten()[:13]
        src, valid, tgt = src[keep].clone(), valid[keep].clone(), \
            tgt[keep].clone()
        nrm = None if nrm is None else nrm[keep].clone()
        tgt[1, :, 7] = 1e30                          # no valid target
        valid[2] = False                             # no valid source
        first = torch.nonzero(valid[3]).flatten()[:8]
        xyz = boundary_rows(src[3, first], kw["max_correspondence"])
        normals = tgt[3, :16, 3:6]
        tgt[3, :16] = icp_fused.pack_targets(
            xyz, torch.ones(16, dtype=torch.bool, device=xyz.device), normals)
        tgt[4, 1::2] = tgt[4, 0:-1:2]                # every target twice
        cases = [("13 poses: no target, no source, boundary, ties",
                  (src, valid, tgt, nrm)),
                 ("N=1", (src[:1], valid[:1], tgt[:1],
                          None if nrm is None else nrm[:1])),
                 ("P=77 S=45", (src[:, :77].contiguous(),
                                valid[:, :77].contiguous(),
                                tgt[:, :45].contiguous(),
                                None if nrm is None
                                else nrm[:, :77].contiguous()))]
        for case, args in cases:
            pargs, pkw = icp_fused.prepare_inputs(*args, **kw)
            out = edge_phase("icp_fused", f"{mode}: {case}", pargs, pkw)
            if case.startswith("13"):
                eye = torch.eye(4, device=out.device)
                require(bool((out[1] == eye).all() and (out[2] == eye).all()),
                        f"icp_fused {mode}: an empty pose moved")


def cost_edge_cases() -> None:
    """The depth-only cost kernel against its twin at edge inputs, from the
    depth batch's call: 13 poses, one without a valid target, one without a
    valid point, one with targets at sensor_resolution from its points
    (axis and diagonal, +-1 ulp), one with every target twice (exact ties);
    N = 1; P = 77 and S = 45 (not multiples of 32); P = 15000 (the points
    staged in several chunks)."""
    (cloud, cvalid, txyz, tvalid, res), kw = CALLS["cost_fused", ROI_CASE]
    expl = kw.get("cloud_explain_only")
    keep = torch.nonzero(cvalid.any(dim=1) & tvalid.any(dim=1)).flatten()[:13]
    cloud, cvalid, txyz, tvalid = (a[keep].clone() for a in
                                   (cloud, cvalid, txyz, tvalid))
    expl = None if expl is None else expl[keep].clone()
    tvalid[0] = False                                # no valid target
    cvalid[1] = False                                # no valid point
    real = cvalid[2] if expl is None else cvalid[2] & ~expl[2]
    real = torch.nonzero(real).flatten()[:8]
    txyz[2, :16] = boundary_rows(cloud[2, real], res)
    tvalid[2, :16] = True
    txyz[3, 1::2] = txyz[3, 0:-1:2]                  # every target twice
    tvalid[3, 1::2] = tvalid[3, 0:-1:2]
    full = (cloud, cvalid, txyz, tvalid, res, expl)
    # P = 15000 (several staged chunks): each cloud repeated, each copy
    # shifted by 3 mm along x.
    shift = torch.zeros((12, 1, 3), device=cloud.device)
    shift[:, 0, 0] = torch.arange(12, device=cloud.device) * 0.003
    big = (cloud[:, None] + shift).reshape(cloud.shape[0], -1, 3)
    cases = [("13 poses: no target, no point, boundary, ties", full),
             ("N=1", tuple(a[:1] if isinstance(a, torch.Tensor) else a
                           for a in full)),
             ("P=77 S=45", (cloud[:, :77], cvalid[:, :77], txyz[:, :45],
                            tvalid[:, :45], res,
                            None if expl is None else expl[:, :77])),
             ("P=15000", (big[:, :15000], cvalid.repeat(1, 12)[:, :15000],
                          txyz, tvalid, res, None if expl is None
                          else expl.repeat(1, 12)[:, :15000]))]
    for case, (c, cv, t, tv, r, e) in cases:
        pargs, pkw = cost_fused.prepare_inputs(c, cv, t, tv, r, e)
        out = edge_phase("cost_fused", case, pargs, pkw)
        if case.startswith("13"):
            require(out[2][0].item() == 0 and out[0][1].item() == 0
                    and out[2][2].item() > 0,
                    f"cost_fused edges: counts {[o[:4].tolist() for o in out]}")


# Colour kernel -> the names of its prepared arguments.
COLOR_FIELDS = {
    "cost_fused_color": ("cloud", "cadd", "lab", "tgt4", "tlab"),
    "cost_fused_color_tri": ("cloud", "cadd", "tri", "mids", "bank_lab",
                             "tgt4", "tlab"),
}


def color_edge_cases() -> None:
    """Both colour cost kernels against their twins at edge inputs, from the
    inputs the colour ROI (face ids) and full-frame (Lab) batches handed
    them: 13 poses, of which 0 has no valid target, 1 no valid point, 2 only
    explain-only points, 3 targets at sensor_resolution from its real points
    (axis and diagonal, +-1 ulp), 4 and 5 every target twice with one
    rendered Lab per pose, the original's Lab passing the gate and the
    copy's failing (4) or the reverse (5), so that a winner other than the
    lowest index changes the counts, 6 face ids -1, T and T + 7 on its real
    points (zero Lab in the Lab form); N = 1 (pose 4); P = 77 and S = 45;
    P = 15000 (poses 3-4, the points staged in several chunks)."""
    for name, label in (("cost_fused_color_tri", "colour ROI batch"),
                        ("cost_fused_color", FULL_CASE)):
        names = COLOR_FIELDS[name]
        pargs, pkw = INPUTS[name, label]
        f = dict(zip(names, pargs))
        per_point = ("cloud", "cadd", "tri" if "tri" in f else "lab")
        keep = torch.nonzero(((f["cadd"] == 0).sum(dim=1) > 64)
                             & (f["tgt4"][..., 3] == 0).any(dim=1)).flatten()
        require(len(keep) >= 13, f"{name} edges: {len(keep)} poses to use")
        f = {k: v if k == "bank_lab" else v[keep[:13]].clone()
             for k, v in f.items()}
        dev = f["cloud"].device
        real = f["cadd"] == 0.0
        f["tgt4"][0, :, 3] = math.inf                    # no valid target
        f["cadd"][1] = math.inf                          # no valid point
        f["cadd"][2] = torch.where(f["cadd"][2] <= 0, -1.0, math.inf)
        if "tri" in f:
            f["tri"][1:3] = -1                           # as prepare_inputs_tri
        first = torch.nonzero(real[3]).flatten()[:8]
        f["tgt4"][3, :16, :3] = boundary_rows(f["cloud"][3, first],
                                              math.sqrt(pkw["max_dist_sq"]))
        f["tgt4"][3, :16, 3] = 0.0
        if "tri" in f:
            t = f["bank_lab"].shape[1]
            face = f["tri"][3, first].long()
            f["tlab"][3, :16:2] = f["bank_lab"][f["mids"][3].long(),
                                                face.clamp(0, t - 1)]
        else:
            f["tlab"][3, :16:2] = f["lab"][3, first]     # these pass
        for i, orig_passes in ((4, True), (5, False)):
            f["tgt4"][i, 1::2] = f["tgt4"][i, 0:-1:2]    # every target twice
            if "tri" in f:
                face = int(f["tri"][i][real[i]][0])
                f["tri"][i] = torch.where(real[i], face, -1)
                lab0 = f["bank_lab"][f["mids"][i].long(), face]
            else:
                lab0 = f["lab"][i][real[i]][0].clone()
                f["lab"][i] = lab0
            far = lab0 + torch.tensor([40.0 if lab0[0] < 50 else -40.0, 30.0,
                                       -30.0], device=dev)
            passes = 0 if orig_passes else 1
            f["tlab"][i, passes::2] = lab0
            f["tlab"][i, 1 - passes::2] = far
        rows = torch.nonzero(real[6]).flatten()
        if "tri" in f:
            t = f["bank_lab"].shape[1]
            for k, bad in enumerate((-1, t, t + 7)):
                f["tri"][6, rows[k::3]] = bad
        else:
            f["lab"][6, rows[::3]] = 0.0

        def cut(poses, points=slice(None), targets=slice(None), fn=None):
            out = {}
            for k, v in f.items():
                if k == "bank_lab":
                    out[k] = v
                    continue
                v = v[poses]
                if k in per_point:
                    v = fn(v) if fn else v[:, points]
                elif k in ("tgt4", "tlab"):
                    v = v[:, targets]
                out[k] = v.contiguous()
            return tuple(out[k] for k in names)

        # P = 15000 (several staged chunks): each cloud repeated, each copy
        # shifted by 3 mm along x.
        p = f["cloud"].shape[1]
        big = list(cut(slice(3, 5), fn=lambda v: v.repeat(
            1, 12, *([1] * (v.dim() - 2)))[:, :15000]))
        shift = (torch.arange(15000, device=dev) // p).float() * 0.003
        big[0] = (big[0] + shift[:, None] * torch.tensor(
            [1.0, 0.0, 0.0], device=dev)).contiguous()
        cases = [("13 poses: no target, no point, explain-only, boundary, "
                  "ties, face ids", cut(slice(None))),
                 ("N=1 (ties)", cut(slice(4, 5))),
                 ("P=77 S=45", cut(slice(None), slice(0, 77), slice(0, 45))),
                 ("P=15000", tuple(big))]
        for case, args in cases:
            out = edge_phase(name, case, args, pkw)
            if case.startswith("13"):
                pn, un, ex = (o.tolist() for o in out)
                require(ex[0] == 0 and un[0] == pn[0] > 0
                        and pn[1] == un[1] == ex[1] == 0
                        and pn[2] == un[2] == 0 and ex[2] > 0
                        and un[4] < pn[4] and un[5] == pn[5],
                        f"{name} edges: counts {[pn, un, ex]}")


def write_ply(path: Path, verts: np.ndarray, faces: np.ndarray,
              colors: np.ndarray) -> None:
    """An ASCII PLY mesh with per-vertex colours (rounded to uchar)."""
    rgb = np.clip(np.rint(colors), 0, 255).astype(int)
    lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}",
             "property float x", "property float y", "property float z",
             "property uchar red", "property uchar green",
             "property uchar blue", f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [f"{x:.17g} {y:.17g} {z:.17g} {r} {g} {b}"
              for (x, y, z), (r, g, b) in zip(verts, rgb)]
    lines += [f"3 {a} {b} {c}" for a, b, c in faces]
    path.write_text("\n".join(lines) + "\n")


def write_bench_scene(bp, root: Path, backend: str) -> list:
    """The bench scene as files under root: the four models as PLY, the
    observation as PNGs, every candidate in its object's poses.txt, and
    scene.json with the problem's PerchConfig and EnvConfig
    (kernel_backend = backend). Returns the model names."""
    env = bp.env
    rin = env._input
    names = [m.name for m in env.bank.models]
    for name, v, f, colors in bench_meshes(
            np.random.default_rng(bp.seed), "bumpy1024",
            env.bank.tri_valid.shape[1]):
        write_ply(root / f"{name}.ply", v, f, colors)
    write_png(str(root / "depth.png"),
              np.rint(rin.depth_image).astype(np.uint16))
    write_png(str(root / "mask.png"), rin.label_mask.astype(np.uint8))
    write_png(str(root / "rgb.png"),
              np.rint(rin.color_image).astype(np.uint8))
    for i, name in enumerate(names):
        rows = [[c.pose.x, c.pose.y, c.pose.z, *c.pose.quaternion()]
                for c in bp.candidates if c.id == i]
        if rows:
            (root / "rendered" / name).mkdir(parents=True)
            np.savetxt(root / "rendered" / name / "poses.txt", rows)
    config = {
        "camera": dataclasses.asdict(env.camera),
        "input": {"depth_image": "depth.png", "color_image": "rgb.png",
                  "label_mask": "mask.png",
                  "depth_factor": rin.depth_factor,
                  "cam_to_world": np.asarray(rin.cam_to_world).tolist(),
                  "segmented_object_names": rin.segmented_object_names},
        "model_bank": [{"name": n, "path": f"{n}.ply"} for n in names],
        "rendered_root_dir": "rendered",
        "mode": "greedy",
        "perch_params": dataclasses.asdict(env.perch),
        "env_params": {**dataclasses.asdict(env.env),
                       "kernel_backend": backend},
    }
    (root / "scene.json").write_text(json.dumps(config))
    return names


def check_cli_path(bp, backend: str) -> dict:
    """The bench scene as files (`write_bench_scene`), then
    `perception_tpu_torch.cli localize --device cuda` in this process.
    Returns the kernel launches of the run (counts set to 0 just before
    it)."""
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        names = write_bench_scene(bp, root, backend)
        stdout = io.StringIO()
        build.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["localize", "--config", str(root / "scene.json"),
                           "--output", str(root / "out"), "--device",
                           "cuda"])
        sync()
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        twins = dict(build.TWIN_CALLS)
        require(rc == 0, f"cli {backend}: exit code {rc}")
        require((root / "out" / "output_poses.txt").exists(),
                f"cli {backend}: no output_poses.txt")
        summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    dets = dict(zip(summary["detected"], summary["poses"]))
    errors_mm = {}
    for i in (1, 2):
        require(names[i] in dets, f"cli {backend}: {names[i]} not detected")
        gt = bp.gt[i].pose
        err = float(np.linalg.norm(np.asarray(dets[names[i]][:3])
                                   - [gt.x, gt.y, gt.z]))
        errors_mm[names[i]] = err * 1e3
        require(err < 0.02, f"cli {backend}: {names[i]} off by "
                f"{err * 1e3:.1f} mm")
    emit({"phase": "cli", "kernel_backend": backend, "seconds": seconds,
          "candidates": len(bp.candidates),
          "scenes_rendered": summary["scenes_rendered"],
          "detected": summary["detected"], "detection_error_mm": errors_mm,
          "launches": launches, "twin_calls": twins})
    require(all(launches.get(n, 0) > 0
                for n in (*RASTER_KERNELS[backend], *DEPTH[1:])),
            f"cli {backend}: launches {launches}")
    require(launches.get("raster_direct", 0) == 0,
            f"cli {backend}: the direct raster ran")
    require(sum(twins.values()) == 0, f"cli {backend}: twins ran: {twins}")
    return launches


# -- The search modes on the 3-DoF table-top scene ---------------------------

TABLE_CASE = "3-DoF table batch"
TABLE_COLOR_CASE = "3-DoF table batch, colour"
TABLE_BIN_CASE = "3-DoF table batch, pallas_bin, no ICP"
# Detections of the greedy-ICP baseline (refined by ICP) must lie within
# 30 mm in (x, y) of the ground truth; those of the tree and MHA* are grid
# poses: within one grid step in x and in y, and theta_res in yaw.
ICP_BAR = "30 mm in (x, y)"
GRID_BAR = "res in x and in y, theta_res in yaw"
TREE_OCCLUSION_CM = 3.0
MIN_UNFLAGGED = 8


class TableBatch:
    """One `score_object_states` call on the table scene's first
    `gpu_batch_size` grid candidates: with ICP, as the greedy-ICP baseline
    scores them, or without, as a tree expansion does; `score` is what
    check_kernels records."""

    def __init__(self, scene, do_icp: bool = True):
        self.env = scene.env
        self.do_icp = do_icp
        self.env.set_input(scene.rin)
        cands = self.env.generate_successors_3dof()
        self.candidates = cands[:self.env.perch.gpu_batch_size]

    def score(self, cfg=None):
        return self.env.score_object_states(self.candidates,
                                            do_icp=self.do_icp)


def make_table_scene(dev, **kw):
    t0 = time.perf_counter()
    scene = build_table_scene(device=dev, **kw)
    sync()
    emit({"phase": "table_scene", **kw, "seconds": time.perf_counter() - t0,
          "placements": [list(p) for p in table_scene.PLACEMENTS],
          "region": table_scene.REGION,
          "table_height": table_scene.TABLE_HEIGHT})
    return scene


def check_successors(scene) -> list:
    env = scene.env
    env.set_input(scene.rin)
    sync()
    t0 = time.perf_counter()
    succ = env.generate_successors_3dof()
    ms = (time.perf_counter() - t0) * 1e3
    per_model = [sum(1 for s in succ if s.id == i)
                 for i in range(len(env.bank.models))]
    near_gt = [sum(1 for s in succ if s.id == g.id
                   and abs(s.pose.x - g.pose.x) <= env.env.res / 2
                   and abs(s.pose.y - g.pose.y) <= env.env.res / 2)
               for g in scene.gt]
    emit({"phase": "successors", "grid": len(env.grid_3dof()),
          "valid": len(succ), "valid_per_model": per_model,
          "valid_at_gt_cell": near_gt, "host_ms": ms,
          "observed_points": int(env._observed.count.item())})
    require(all(n > 0 for n in near_gt), f"a GT cell was pruned: {near_gt}")
    require(max(per_model) <= 512,
            f"more than the tree's 512 candidates per model: {per_model}")
    return succ


def check_tree_occlusion(scene, succ) -> None:
    """One tree expansion with use_tree_occlusion: ground-truth object 0
    composed onto the observation, every candidate of the other models
    scored against it on the card; N_CPU of them on the CPU twins: every
    pose the card left unflagged (at least MIN_UNFLAGGED, so the fused cost
    is compared on poses that score against the composed source), then
    flagged ones in order. The occlusion threshold is TREE_OCCLUSION_CM: at
    the default 1 cm the Kinect noise puts part of every render in front of
    the source, and every pose is flagged."""
    env = scene.env
    search = TreeSearch(env)
    node = search.root()
    depth, label = search._compose(node, scene.gt[0])
    cands = [s for s in succ if s.id != 0][:env.perch.gpu_batch_size]
    composed = dataclasses.replace(
        env._scene, source_depth=env._tensor(depth, torch.int32),
        source_label=env._tensor(label, torch.int32))
    saved = env.perch
    env.perch = dataclasses.replace(env.perch, use_tree_occlusion=True,
                                    gpu_occlusion_threshold=TREE_OCCLUSION_CM)
    try:
        cfg = env._scorer_config(do_icp=False)
    finally:
        env.perch = saved
    require(cfg.use_tree_occlusion and cfg.cost_type == 0
            and not cfg.use_segmentation_label, "tree-occlusion config")
    poses = env.poses_to_camera(cands)
    ids = np.asarray([s.id for s in cands], np.int64)
    labels = np.zeros(len(cands), np.int64)
    totals = env._observed_totals(cands, labels, env._observed)
    rb = env._render_bank
    args = (env._tensor(poses, torch.float32), env._tensor(ids),
            env._tensor(labels), env._tensor(totals, torch.float32))
    kw = dict(bank_backface=rb[3], bank_icp_samples=env._bank_icp_samples,
              bank_icp_normals=env._bank_icp_normals,
              bank_tri_lab=env._render_bank_lab)

    def score():
        return scorer.score_pose_batch(*rb[:3], *args, env._proj, composed,
                                       cfg, **kw)
    build.reset_counts()
    out = score()
    sync()
    launches = dict(build.LAUNCHES)
    batch_ms = time_ms(score, warmup=1, reps=10)
    flags = out.pose_occluded.cpu()
    # Unflagged first (stable, so each group keeps its order), N_CPU of them.
    sel = torch.sort(torch.argsort(flags, stable=True)[:N_CPU]).values
    t0 = time.perf_counter()
    ref = scorer.score_pose_batch(
        *(t.cpu() for t in rb[:3]), *(a.cpu()[sel] for a in args),
        env._proj.cpu(), cpu_scene(composed), cfg,
        **{k: v.cpu() for k, v in kw.items()})
    cpu_s = time.perf_counter() - t0
    g_tot = out.total_cost.cpu()[sel]
    diffs = (g_tot - ref.total_cost).abs()
    eq = (g_tot == ref.total_cost).float().mean().item()
    open_ = flags[sel] == 0
    emit({"phase": "tree_occlusion", "poses": len(cands),
          "occlusion_threshold_cm": TREE_OCCLUSION_CM,
          "flagged": int(flags.sum()), "batch_ms": batch_ms,
          "launches": launches, "cpu_twin_poses": len(sel),
          "cpu_twin_unflagged": int(open_.sum()),
          "cpu_twin_unflagged_scored": int((ref.total_cost[open_] >= 0).sum()),
          "cpu_twin_s": cpu_s,
          "flags_equal_cpu": bool(torch.equal(flags[sel], ref.pose_occluded)),
          "total_equal_frac": eq,
          "unflagged_total_equal_frac": (
              (g_tot == ref.total_cost)[open_].float().mean().item()),
          "total_max_diff": diffs.max().item()})
    require(torch.equal(flags[sel], ref.pose_occluded),
            "tree occlusion: pose_occluded differs from the CPU twin")
    require(int(flags.sum()) > 0, "tree occlusion: no pose flagged")
    require(int((ref.total_cost[open_] >= 0).sum()) >= MIN_UNFLAGGED,
            f"tree occlusion: fewer than {MIN_UNFLAGGED} unflagged poses "
            "scored")
    require(bool((out.total_cost.cpu()[flags.bool()] == -1).all()),
            "tree occlusion: a flagged pose scored")
    require(eq >= 0.98 and diffs.max().item() <= 2,
            f"tree occlusion: totals equal on {eq:.3f}")
    require((g_tot == ref.total_cost)[open_].float().mean().item() >= 0.98,
            "tree occlusion: unflagged totals differ from the CPU twin")
    require(all(launches.get(n, 0) > 0 for n in ("raster_direct",
                                                  "cost_fused")),
            f"tree occlusion launches {launches}")


def within_bar(scene, e: dict, mode: str) -> bool:
    """A detection's errors (TableScene.errors) within the mode's bar."""
    if mode == "greedy_icp":
        return e["dxy"] <= 0.03
    res, theta = scene.env.env.res, scene.env.env.theta_res
    return e["dx"] <= res and e["dy"] <= res and e["dyaw"] <= theta


def table_errors(scene, names: list, poses: list, mode: str) -> list:
    """Each ground-truth object must be detected, within the mode's bar."""
    index = {m.name: i for i, m in enumerate(scene.models)}
    ids = [index[n] for n in names]
    require(sorted(ids) == list(range(len(scene.gt))),
            f"{mode}: detected {names}")
    errs = scene.errors(poses, ids)
    bar = ICP_BAR if mode == "greedy_icp" else GRID_BAR
    for e in errs:
        require(within_bar(scene, e, mode),
                f"{mode}: object {e['id']} outside the bar ({bar}): {e}")
    return errs


def report_table_defaults(dev) -> None:
    """The table scene with each of table_scene.PERCH_SETTINGS and
    ENV_SETTINGS left at its configuration default, then all of them: the
    successors, then greedy ICP and the tree from Python. Their errors are
    printed beside the bars and not required: the scene keeps those
    settings because the defaults miss the bars at stride 24."""
    names = (*table_scene.PERCH_SETTINGS, *table_scene.ENV_SETTINGS)
    for left_out in [(n,) for n in names] + [names]:
        scene = make_table_scene(dev, at_defaults=left_out)
        env, rec = scene.env, scene.recognizer
        env.set_input(scene.rin)
        succ = env.generate_successors_3dof()
        index = {m.name: i for i, m in enumerate(scene.models)}
        for mode, run in (("greedy_icp", rec.localize_objects_greedy_icp),
                          ("tree", rec.localize_objects)):
            t0 = time.perf_counter()
            result = run(scene.rin)
            sync()
            seconds = time.perf_counter() - t0
            errs = scene.errors(result.poses,
                                [index[n] for n in result.names])
            emit({"phase": "table_defaults", "mode": mode,
                  "at_defaults": list(left_out),
                  "valid_per_model": [sum(1 for s in succ if s.id == i)
                                      for i in range(len(scene.models))],
                  "seconds": seconds, "detected": result.names,
                  "errors": errs,
                  "within_bar": [within_bar(scene, e, mode) for e in errs],
                  "bar": ICP_BAR if mode == "greedy_icp" else GRID_BAR})


def check_table_served(scene, dev, mode: str, requests: int) -> dict:
    """POST /localize on the table scene's observation (no label mask, the
    3-DoF region) in `mode`; returns the launches of the requests alone."""
    rin = scene.rin
    payload = {"depth_image": np.asarray(rin.depth_image).tolist(),
               "depth_factor": rin.depth_factor,
               "cam_to_world": np.asarray(rin.cam_to_world).tolist(),
               "x_min": rin.x_min, "x_max": rin.x_max, "y_min": rin.y_min,
               "y_max": rin.y_max, "table_height": rin.table_height,
               "mode": mode}
    body = json.dumps(payload).encode()
    rec = scene.recognizer
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/localize"
    latency, responses = [], []
    try:
        build.reset_counts()
        for _ in range(requests):
            gpu0 = rec.env.stats.gpu_time
            t0 = time.perf_counter()
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                responses.append(json.loads(resp.read()))
            score_ms = (rec.env.stats.gpu_time - gpu0) * 1e3
            latency.append({
                "request_ms": (time.perf_counter() - t0) * 1e3,
                "localize_ms": rec.env.stats.time * 1e3,
                "set_input_ms": rec.env.stats.input_time * 1e3,
                "score_batches_ms": score_ms,
                "score_ms_per_expansion": (
                    score_ms / max(1, responses[-1]["stats"]["expands"]))})
        launches = dict(build.LAUNCHES)
        twins = dict(build.TWIN_CALLS)
        peak_bytes = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread stopped")
    errs = []
    for out in responses:
        dets = out["detections"]
        errs.append(table_errors(
            scene, [d["name"] for d in dets],
            [ContPose.from_quat(*d["translation"], *d["quaternion_xyzw"])
             for d in dets], mode))
    stats = responses[-1]["stats"]
    emit({"phase": "serve_table", "mode": mode, "requests": len(responses),
          "payload_mb": len(body) / 1e6, "latency": latency,
          "expands": stats["expands"],
          "scenes_rendered": stats["scenes_rendered"],
          "errors": errs,
          "bar": ICP_BAR if mode == "greedy_icp" else GRID_BAR,
          "launches": launches, "twin_calls": twins})
    require(sum(twins.values()) == 0, f"{mode}: twins ran: {twins}")
    return launches


def check_mha_star(scene) -> dict:
    """One MHAStarPlanner plan from Python: each model's 16 grid candidates
    nearest its detection (a box around the ground truth's projected
    centre), the anchor queue and the detection queue."""
    env = scene.env
    env.set_input(scene.rin)
    cam = env.camera
    dets = []
    for g in scene.gt:
        mat = env.pose_to_camera(g)
        u = cam.fx * mat[0, 3] / mat[2, 3] + cam.cx
        v = cam.fy * mat[1, 3] / mat[2, 3] + cam.cy
        dets.append(Detection(name=scene.models[g.id].name,
                              bbox=(u - 40, v - 40, u + 40, v + 40)))
    factory = DetectionHeuristicFactory(dets, cam,
                                        cam_to_world=scene.rin.cam_to_world)
    h = factory.heuristic([m.name for m in scene.models])
    cands = sorted(env.generate_successors_3dof(), key=h)
    planner = MHAStarPlanner(env, cands, heuristics=[h], w1=10.0, w2=50.0,
                             max_expansions=20, max_successors_per_model=16)
    build.reset_counts()
    t0 = time.perf_counter()
    state = planner.plan()
    sync()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    objs = state.object_states
    errs = table_errors(scene, [scene.models[o.id].name for o in objs],
                        [o.pose for o in objs], "mha_star")
    emit({"phase": "mha_star", "seconds": seconds,
          "expands": planner.stats.expands,
          "scenes_rendered": planner.stats.scenes_rendered,
          "cost": planner.stats.cost, "errors": errs,
          "bar": GRID_BAR, "launches": launches})
    require(launches.get("raster_direct", 0) > 0
            and launches.get("cost_fused", 0) > 0
            and launches.get("icp_fused", 0) == 0,
            f"mha_star launches {launches}")
    return launches


def check_table_cli(scene, mode: str, backend: str) -> dict:
    """The table scene as files (the three models as PLY, the depth frame
    as a 16-bit PNG in mm, a JSON config with the 3-DoF region) and
    `localize --device cuda` in `mode`; returns the run's launches."""
    env = scene.env
    rin = scene.rin
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        meshes = bench_meshes(np.random.default_rng(0), "bumpy1024",
                              table_scene.T_CAP)[1:]
        for m, (_, v, f, colors) in zip(scene.models, meshes):
            write_ply(root / f"{m.name}.ply", v, f, colors)
        write_png(str(root / "depth.png"),
                  np.asarray(rin.depth_image).astype(np.uint16))
        config = {
            "camera": dataclasses.asdict(env.camera),
            "input": {"depth_image": "depth.png",
                      "depth_factor": rin.depth_factor,
                      "cam_to_world": np.asarray(rin.cam_to_world).tolist(),
                      "x_min": rin.x_min, "x_max": rin.x_max,
                      "y_min": rin.y_min, "y_max": rin.y_max,
                      "table_height": rin.table_height},
            "model_bank": [{"name": m.name, "path": f"{m.name}.ply"}
                           for m in scene.models],
            "mode": mode, "use_external_pose_list": 0,
            "perch_params": dataclasses.asdict(env.perch),
            "env_params": {**dataclasses.asdict(env.env),
                           "kernel_backend": backend},
        }
        (root / "scene.json").write_text(json.dumps(config))
        stdout = io.StringIO()
        build.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["localize", "--config", str(root / "scene.json"),
                           "--output", str(root / "out"), "--device", "cuda"])
        sync()
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        twins = dict(build.TWIN_CALLS)
        require(rc == 0, f"cli {mode}: exit code {rc}")
        summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    poses = [ContPose.from_quat(*p) for p in summary["poses"]]
    errs = table_errors(scene, summary["detected"], poses, mode)
    emit({"phase": "cli_table", "mode": mode, "kernel_backend": backend,
          "seconds": seconds, "expands": summary["expands"],
          "scenes_rendered": summary["scenes_rendered"], "errors": errs,
          "launches": launches, "twin_calls": twins})
    require(sum(twins.values()) == 0, f"cli {mode}: twins ran: {twins}")
    return launches


# The scorer and env branches (section 8 of main).
FAST_CASE = "fast profile batch"
COMPOSED_CASE = "composed colour batch"
FAST_FIELDS = dict(icp_source="model", icp_stagnation_streak=5,
                   icp_crop_targets=128)
# Section 8's batches by label, for section 9's profiles.
BRANCH_BATCHES: dict = {}


def check_fast(dev) -> tuple[dict, dict]:
    """EnvConfig.fast_profile() on the depth ROI batch: the fused ICP at the
    model-source inputs (the bank's 256 surface samples per pose, a crop of
    128 targets, streak 5) against its twin, one raster launch per batch
    (after ICP), the slice, and one served request. Returns the ICP's
    kernel result and the served launches."""
    bp = problem(dev, env_overrides=FAST_FIELDS)
    require(bp.env.env == bp.env.env.fast_profile(),
            "the fast batch runs the speed profile")
    BRANCH_BATCHES[FAST_CASE] = bp
    res, counts = check_kernels(bp, DEPTH, FAST_CASE, only=("icp_fused",))
    src, tgt = CALLS["icp_fused", FAST_CASE][0][0], \
        CALLS["icp_fused", FAST_CASE][0][2]
    require(src.shape[1] == 256 and tgt.shape[1] == 128,
            f"model-source ICP shapes {list(src.shape)} {list(tgt.shape)}")
    require(counts == {"raster_direct": 1, "icp_fused": 1, "cost_fused": 1},
            f"fast batch launches {counts}")
    check_slice(bp, "fast profile")
    served = check_served_path(bp, dev, "fast profile", 1)
    require(all(served.get(n, 0) > 0 for n in DEPTH)
            and served.get("nn1_batch", 0) == 0,
            f"fast profile served launches {served}")
    return res["icp_fused"], served


def check_render_cost(dev) -> dict:
    """cost_cloud="render" on the colour ROI path: two raster launches per
    batch, and the tri-id colour cost reads the face ids of the re-render at
    the adjusted poses. Returns the batch's launches."""
    bp = problem(dev, use_color=True, env_overrides={"cost_cloud": "render"})
    label = "render-cost colour ROI batch"
    BRANCH_BATCHES[label] = bp
    _, counts = check_kernels(
        bp, ("raster_direct", "icp_fused", "cost_fused_color_tri"), label,
        only=("cost_fused_color_tri",))
    require(counts == {"raster_direct": 2, "icp_fused": 1,
                       "cost_fused_color_tri": 1}, f"{label} launches {counts}")
    out = bp.score()
    verts, colors, valid, _, ids, labels, _, proj, scene = bp.args
    rerender, _ = scorer._render_and_cloud(
        verts, colors, valid, out.adjusted_poses, ids, proj, scene, labels,
        bp.cfg, bp.env._render_bank[3])
    tri = CALLS["cost_fused_color_tri", label][0][2]
    p = rerender.tri_id[0].numel()
    require(torch.equal(tri[:, :p], rerender.tri_id.reshape(len(ids), p)),
            "the colour cost reads the re-render's face ids")
    require(bool((tri[:, p:] == -1).all()), "no explain-only points")
    check_slice(bp, "render cost, colour ROI")
    return counts


def check_coarse(dev) -> dict:
    """icp_render_scale=2 on the depth ROI batch: the pre-ICP raster at
    stride 16 over 16x16 (held against its twin there), then the re-render
    at stride 8 over 32x32. Returns the batch's launches."""
    bp = problem(dev, env_overrides={"icp_render_scale": 2})
    label = "coarse batch"
    BRANCH_BATCHES[label] = bp
    _, counts = check_kernels(bp, DEPTH, label, only=("raster_direct",))
    kw = CALLS["raster_direct", label][1]
    require(kw["stride"] == 16 and tuple(kw["roi_shape"]) == (16, 16),
            f"coarse raster at stride {kw['stride']}, {kw['roi_shape']}")
    require(counts == {"raster_direct": 2, "icp_fused": 1, "cost_fused": 1},
            f"{label} launches {counts}")
    check_slice(bp, "coarse")
    return counts


def check_pose_crop(dev) -> dict:
    """icp_crop_share="pose" with the spread crop of 128 targets: the fused
    ICP at those inputs against its twin, and the slice."""
    bp = problem(dev, env_overrides=dict(
        icp_crop_share="pose", icp_crop_mode="spread", icp_crop_targets=128))
    label = "pose-crop batch"
    _, counts = check_kernels(bp, DEPTH, label, only=("icp_fused",))
    require(CALLS["icp_fused", label][0][2].shape[1] == 128,
            "pose crop of 128 targets")
    check_slice(bp, "pose crop, spread")
    return counts


def check_projective(dev) -> dict:
    """icp_mode="projective" on the depth ROI batch: no ICP kernel (the
    association reads the organised observed map), the slice, and the
    translation error against the ground truth before and after ICP on the
    visible objects' poses: the median no worse after. (A few candidates
    diverge under projective association, in the JAX package alike, so the
    mean is printed, not held.)"""
    bp = problem(dev, icp_mode="projective")
    label = "projective batch"
    BRANCH_BATCHES[label] = bp
    _, counts = check_kernels(bp, ("raster_direct", "cost_fused"), label,
                              only=())
    check_slice(bp, "projective")
    out = bp.score()
    env = bp.env
    gt_t = torch.as_tensor(env.poses_to_camera(bp.gt)[:, :3, 3], device=dev)
    labels = bp.args[5]
    target = gt_t[labels]
    before = (bp.args[3][:, :3, 3] - target).norm(dim=1)
    after = (out.adjusted_poses[:, :3, 3] - target).norm(dim=1)
    errors = {}
    for i, count in enumerate(env._observed.seg_count.tolist()[:3]):
        m = labels == i
        errors[f"object {i}"] = {
            "poses": int(m.sum()), "observed_points": count,
            "mean_before_m": before[m].mean().item(),
            "mean_after_m": after[m].mean().item(),
            "median_before_m": before[m].median().item(),
            "median_after_m": after[m].median().item()}
    visible = env._observed.seg_count[labels] > 0
    med_before = before[visible].median().item()
    med_after = after[visible].median().item()
    emit({"phase": "projective", "launches": counts,
          "translation_error": errors,
          "visible_median_m": {"before_icp": med_before,
                               "after_icp": med_after},
          "mean_m": {"before_icp": before.mean().item(),
                     "after_icp": after.mean().item()}})
    require(med_after <= med_before,
            f"projective ICP median error {med_after} > {med_before}")
    return counts


def check_composed(color_full) -> tuple[dict, dict]:
    """Cost type 3 without the face Lab table on the colour full-frame
    batch: the composed cost, whose 1-NN kernel runs at N = 2048, P = the
    full-frame cap plus 256 explain-only samples, S = 256 (held against its
    twin, timed beside torch.cdist), and the slice."""
    bp = dataclasses.replace(color_full, use_lab=False)
    res, counts = check_kernels(
        bp, ("raster_direct", "icp_fused", "nn1_batch"), COMPOSED_CASE,
        only=("nn1_batch",))
    query, ref = CALLS["nn1_batch", COMPOSED_CASE][0][:3:2]
    require(tuple(query.shape) == (N_POSES, 1024 + 256, 3)
            and ref.shape[1] == 256,
            f"composed 1-NN shapes {list(query.shape)} {list(ref.shape)}")
    require(counts == {"raster_direct": 1, "icp_fused": 1, "nn1_batch": 1},
            f"{COMPOSED_CASE} launches {counts}")
    check_slice(bp, "composed colour")
    return res["nn1_batch"], counts


def check_fine(dev) -> dict:
    """fine_stride=4 on the depth ROI batch: set_input's time and peak
    device memory with and without the fine scene, the fine re-score batch
    (stride 4, ROI 64x64, P = 4096; no ICP) against its twins and as a
    slice, and one served request. Returns the served launches."""
    bp = problem(dev, env_overrides={"fine_stride": 4})
    env = bp.env
    rin = env._input
    timings = {}
    for fine in (0, 4):
        env.env = dataclasses.replace(env.env, fine_stride=fine)
        sync()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        env.set_input(rin)
        sync()
        timings[fine] = ((time.perf_counter() - t0) * 1e3,
                         torch.cuda.max_memory_allocated() - before)
    scene = env._scene_fine
    emit({"phase": "fine_scene", "set_input_ms": timings[4][0],
          "set_input_ms_without_fine": timings[0][0],
          "set_input_peak_bytes": timings[4][1],
          "set_input_peak_bytes_without_fine": timings[0][1],
          "fine_seg_shape": list(scene.seg_xyz.shape),
          "fine_observed_points": int(env._observed_fine.count)})
    cfg = env._scorer_config(do_icp=False, stride=4)
    require(cfg.roi_shape == (64, 64) and cfg.max_points_per_pose == 4096,
            f"fine config {cfg.roi_shape} {cfg.max_points_per_pose}")
    labels = bp.args[5]
    totals = env._observed_fine.seg_count.float()[labels]
    fine_bp = dataclasses.replace(
        bp, args=(*bp.args[:6], totals, bp.args[7], scene), cfg=cfg)
    label = "fine re-score batch"
    check_kernels(fine_bp, ("raster_direct", "cost_fused"), label)
    require(CALLS["cost_fused", label][0][0].shape[1] == 4096,
            "fine cost at P = 4096")
    check_slice(fine_bp, "fine re-score")
    served = check_served_path(bp, dev, "fine stride", 1)
    require(served == {"raster_direct": 2, "icp_fused": 1, "cost_fused": 2},
            f"fine stride served launches {served}")
    return served


def check_refine(dev) -> dict:
    """pose_refinement_rounds=1 at the default 12 axes on the depth ROI
    batch: one served request (both objects within 20 mm) and the poses it
    scored in the sweep and in the round. Returns the served launches."""
    bp = problem(dev, env_overrides={"pose_refinement_rounds": 1})
    responses: list = []
    served = check_served_path(bp, dev, "refine", 1, responses)
    env = bp.env
    sweep = len(env.generate_successors_6dof(
        {f"blob{i}": np.asarray([[c.pose.x, c.pose.y, c.pose.z,
                                  *c.pose.quaternion()]
                                 for c in bp.candidates if c.id == i])
         for i in range(3)}))
    scored = responses[-1]["stats"]["scenes_rendered"]
    winners = len(responses[-1]["detections"])
    per_round = 2 * env.env.pose_refinement_axes * winners
    emit({"phase": "refine", "rounds": env.env.pose_refinement_rounds,
          "axes": env.env.pose_refinement_axes, "winners": winners,
          "sweep_poses": sweep, "scored_poses": scored,
          "round_poses": scored - sweep, "launches": served})
    require(scored - sweep == per_round,
            f"refinement scored {scored - sweep} != {per_round}")
    require(all(served.get(n, 0) == 2 for n in DEPTH),
            f"refine served launches {served}")
    return served


def check_likelihood(bp) -> None:
    """particle_log_likelihood in both modes on the bench batch's 2048
    full-frame renders (80x60 at stride 8) against its source depth: the
    card against the CPU within 1e-4 relative, the same best particle."""
    verts, colors, valid, poses, ids, _, _, proj, scene = bp.args
    cfg = bp.cfg
    out = rasterizer.render_pose_batch(
        verts, colors, valid, poses, ids, proj, width=cfg.width,
        height=cfg.height, stride=cfg.stride,
        bank_backface=bp.env._render_bank[3])
    rend = likelihood.depth_cm_to_m(out.depth)
    obs = likelihood.depth_cm_to_m(scene.source_depth)
    rows = {}
    for mode in ("gaussian_mixture", "disparity_truncated"):
        gpu = likelihood.particle_log_likelihood(obs, rend, mode=mode)
        sync()
        cpu = likelihood.particle_log_likelihood(obs.cpu(), rend.cpu(),
                                                 mode=mode)
        rel = ((gpu.cpu() - cpu).abs()
               / cpu.abs().clamp(min=1e-30)).max().item()
        best = int(likelihood.best_particle(gpu))
        rows[mode] = {"max_rel_err": rel, "best_particle": best,
                      "ms": time_ms(lambda: likelihood.particle_log_likelihood(
                          obs, rend, mode=mode))}
        require(rel <= 1e-4, f"likelihood {mode}: rel err {rel}")
        require(best == int(likelihood.best_particle(cpu)),
                f"likelihood {mode}: best particle")
    emit({"phase": "likelihood", "particles": int(rend.shape[0]),
          "pixels": int(rend[0].numel()), **rows})


# -- The deployment: the service and the camera loop as their own processes --

DEPLOY_SCENES = 3
DEPLOY_SEED = 42          # benchmarks/accuracy_synthetic.py's default seed
DEPLOY_CANDIDATES = 2048  # per frame, all objects together
ZOO_NAMES = ("mug", "bowl", "l_bracket", "elbow", "cracker_box", "soup_can")
# The JAX accuracy harness's placements (x 0.5-0.85, y +-0.2, z +-0.08 m for
# a 256x192 camera at fx 320) with y and z scaled by 0.7: the bench camera's
# half-angles are 0.75 of the harness camera's, and its principal point lies
# 7 px left of the frame's centre. Every centre is checked to project inside.
DEPLOY_PLACEMENT = dict(num_objects=3, x_range=(0.5, 0.85),
                        y_range=(-0.14, 0.14), z_range=(-0.056, 0.056),
                        min_separation=0.055)
DEPLOY_BAR_M = 0.02       # objects with >= half their pixels unoccluded
# The objects the JAX package itself puts more than 20 mm off on these
# frames and candidates, on the CPU (`python -m tests.test_torch_deploy`:
# 47.3, 25.1 and 102.1 mm; 93.0 for the soup can on JAX's own render of the
# scene, whose silhouettes differ): the candidates start on the ray through
# the segment's centroid, and a pose's origin lies up to 10.5 cm from the
# drawn object's centre (the model's preprocessing offset). The bar for them
# is the port's own detection on the CPU twins from the same run, its
# translation (m) recorded here: the card's must lie within
# DEPLOY_TWIN_BAR_M of it.
DEPLOY_REFERENCE_MISSES = {
    ("frame0000", "mug"): (0.652304940615113, 0.08924221819499151,
                           0.04461697799453744),
    ("frame0001", "cracker_box"): (0.6556558018922806, -0.15157720491290097,
                                   -0.0398470643162728),
    ("frame0001", "soup_can"): (0.6398256950080394, 0.145737686753273,
                                0.10888892114162446)}
DEPLOY_TWIN_BAR_M = 0.001
READY_TIMEOUT_S = 300
LOOP_TIMEOUT_S = 300
DEPLOY_CASE = "deploy frame"
DEPLOY_RENDER_CASE = "deploy generator render 640x480"
# The env's scoring call, recorded beside the kernels of a deploy frame.
BATCH_SITE = {"score_pose_batch": ((pipeline_env, "score_pose_batch"),)}


def deploy_config(model_paths: dict) -> dict:
    """serve.main's JSON config at the bench scene's width: the bench
    intrinsics (YCB-Video's) at 640x480, stride 8, ROI 32, 20 ICP iterations,
    p2p, the depth-only cost, every candidate of a frame in one batch."""
    return {
        "camera": dataclasses.asdict(YCB_CAMERA),
        "model_bank": [{"name": n, "path": p} for n, p in model_paths.items()],
        "gpu_stride": 8, "gpu_batch_size": DEPLOY_CANDIDATES,
        "sensor_resolution": 0.01, "min_neighbor_points_for_valid_pose": 8,
        "max_icp_iterations": 20, "use_color_cost": False,
        "env_params": {"width": 640, "height": 480,
                       "max_points_per_pose": 1024,
                       "max_observed_points": 8192,
                       "max_points_per_label": 1024, "max_labels": 8,
                       "roi_size": 32, "icp_mode": "fused"},
    }


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Child:
    """A `python3 -m` subprocess whose output lines are collected by a
    thread; `wait_for` blocks until a line contains a text."""

    def __init__(self, args: list[str]):
        self.lines: list[str] = []
        self._seen = threading.Condition()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            with self._seen:
                self.lines.append(line.rstrip("\n"))
                self._seen.notify_all()
        with self._seen:
            self._seen.notify_all()

    def wait_for(self, text: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        with self._seen:
            while True:
                for line in self.lines:
                    if text in line:
                        return line
                left = deadline - time.monotonic()
                require(self.proc.poll() is None and left > 0,
                        f"{self.proc.args[2]}: no {text!r} line: "
                        + " | ".join(self.lines[-20:]))
                self._seen.wait(min(left, 1.0))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._thread.join(timeout=30)


def http_get(url: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def inside_view(state: ObjectState) -> bool:
    """The object's centre projects inside the bench camera's frame."""
    cam = YCB_CAMERA
    x, y, z = (np.linalg.inv(CAM_TO_BODY)
               @ [state.pose.x, state.pose.y, state.pose.z, 1.0])[:3]
    u, v = cam.fx * x / z + cam.cx, cam.fy * y / z + cam.cy
    return z > 0 and 0 <= u < cam.width and 0 <= v < cam.height


def deploy_candidates(depth_mm: np.ndarray, label: np.ndarray, names: list,
                      cam) -> tuple[dict, int, int]:
    """Step 3: generate_candidates for about DEPLOY_CANDIDATES candidates in
    all over a frame's objects (depth in mm). One rotation per depth layer
    counts the layers; then as many rotations as fill DEPLOY_CANDIDATES (a
    half sphere: num_samples // 2 rotations per layer). Returns the
    candidates, num_samples and the layers."""
    def candidates(num_samples: int) -> dict:
        return generate_candidates(depth_mm, label, names, cam,
                                   depth_factor=1000.0,
                                   num_samples=num_samples,
                                   cam_to_world=CAM_TO_BODY)
    layers = sum(len(v) for v in candidates(2).values())
    num_samples = 2 * (DEPLOY_CANDIDATES // layers)
    return candidates(num_samples), num_samples, layers


def make_frames(rec, root: Path, spool: Path) -> list[dict]:
    """Steps 2-4: DEPLOY_SCENES scenes from the zoo bank rendered on the card
    (written with write_scene), candidates from deploy_candidates, each
    frame dropped into `spool` in the camera loop's contract (depth in mm,
    depth_factor 1000). Each frame also keeps the kernel calls of its
    scene's render (`render_calls`) and the launches it made
    (`render_launches`, counts set to 0 just before it)."""
    gen = DatasetGenerator(rec.env, np.random.default_rng(DEPLOY_SEED))
    cam = rec.env.camera
    frames = []
    for i in range(DEPLOY_SCENES):
        key = f"frame{i:04d}"
        sync()
        build.reset_counts()
        t0 = time.perf_counter()
        with recorded_kernel_calls() as render_calls:
            scene = gen.sample_scene(**DEPLOY_PLACEMENT)
        sync()
        render_ms = (time.perf_counter() - t0) * 1e3
        render_launches = dict(build.LAUNCHES)
        require(len(scene.states) == DEPLOY_PLACEMENT["num_objects"],
                f"{key}: {len(scene.states)} objects placed")
        require(all(inside_view(s) for s in scene.states),
                f"{key}: an object's centre lies outside the view")
        gt = gen.write_scene(scene, str(root / "scenes"), key)
        names = [o["name"] for o in gt["objects"]]
        depth_mm = (scene.depth * 10).astype(np.uint16)
        cands, num_samples, layers = deploy_candidates(depth_mm, scene.label,
                                                       names, cam)
        write_png(str(spool / f"{key}-depth.png"), depth_mm)
        write_png(str(spool / f"{key}-color.png"),
                  scene.color.astype(np.uint8))
        write_png(str(spool / f"{key}-labels.png"),
                  scene.label.astype(np.uint8))
        request = {"depth_factor": gt["depth_factor"],
                   "cam_to_world": CAM_TO_BODY.tolist(),
                   "segmented_object_names": names,
                   "pose_lists": {k: v.tolist() for k, v in cands.items()}}
        (spool / f"{key}-request.json").write_text(json.dumps(request))
        # Each object's pixels in the scene against its render alone.
        alone = [int((rec.env.render_composite([s])[2] > 0).sum())
                 for s in scene.states]
        seen = [int((scene.label == j + 1).sum())
                for j in range(len(scene.states))]
        frames.append({"key": key, "scene": scene, "names": names,
                       "visible_share": [b / a if a else 0.0
                                         for a, b in zip(alone, seen)],
                       "render_calls": render_calls,
                       "render_launches": render_launches})
        emit({"phase": "deploy_frame", "frame": key, "objects": names,
              "generator_render_ms": render_ms,
              "generator_launches": render_launches,
              "num_samples": num_samples, "depth_layers": layers,
              "candidates": {k: len(v) for k, v in cands.items()},
              "candidates_total": sum(len(v) for v in cands.values()),
              "unoccluded_pixels": alone, "segment_pixels": seen})
    return frames


def detection_errors(rec, frame: dict, dets: dict) -> dict:
    """Step 8: per object of the frame, the translation error, ADD and
    ADD-S (m) of its detection against the ground truth, over the model's
    surface points (`sample_surface_points`), and its visible share."""
    out = {}
    for state, name, share in zip(frame["scene"].states, frame["names"],
                                  frame["visible_share"]):
        row = {"visible_share": share, "detected": name in dets}
        if name in dets:
            d = dets[name]
            r_est = quat_to_matrix(*d["quaternion_xyzw"])
            t_est = np.asarray(d["translation"])
            r_gt = state.pose.rotation()
            t_gt = np.asarray([state.pose.x, state.pose.y, state.pose.z])
            pts = rec.bank.models[state.id].sample_surface_points()
            row.update(
                translation_m=metrics.trans_err(t_est, t_gt),
                add_m=metrics.add_err(r_est, t_est, r_gt, t_gt, pts),
                adds_m=metrics.adi_err(r_est, t_est, r_gt, t_gt, pts),
                rotation_deg=metrics.rot_err_deg(r_est, r_gt))
        out[name] = row
    return out


def check_overlay(rec, frame: dict, response: dict, png: bytes) -> dict:
    """Step 9: the served overlay decodes to [480, 640, 3] uint8 and equals
    the observation's colour outside the detections' render and the 0.45 /
    0.55 blend with it inside (re-rendered here from the response's poses,
    on <= 0.1% of pixels another face or silhouette pixel)."""
    overlay = decode_png(png)
    require(overlay.shape == (480, 640, 3) and overlay.dtype == np.uint8,
            f"overlay {overlay.shape} {overlay.dtype}")
    bank = rec.bank
    states = [ObjectState(id=bank.index_of(d["name"]), symmetric=False,
                          pose=ContPose.from_quat(*d["translation"],
                                                  *d["quaternion_xyzw"]),
                          segmentation_label_id=k + 1)
              for k, d in enumerate(response["detections"])]
    det_depth, det_color, _ = rec.env.render_composite(states)
    obs = frame["scene"].color.astype(np.uint8).astype(np.float64)
    mask = det_depth > 0
    expect = obs.copy()
    expect[mask] = 0.45 * obs[mask] + 0.55 * det_color[mask]
    expect = np.clip(expect, 0, 255).astype(np.uint8)
    equal = (overlay == expect).all(axis=-1)
    changed = (overlay != obs.astype(np.uint8)).any(axis=-1)
    out = {"rendered_pixels": int(mask.sum()),
           "changed_pixels": int(changed.sum()),
           "equal_to_blend_frac": float(equal.mean()),
           "changed_outside_render": int((changed & ~mask).sum())}
    require(out["equal_to_blend_frac"] >= 0.999,
            f"overlay equals the blend on {out['equal_to_blend_frac']}")
    require(out["changed_outside_render"] <= 0.001 * mask.size,
            f"overlay changed {out['changed_outside_render']} pixels "
            "outside the detections' render")
    return out


def check_deploy_kernels(rec, frame: dict, calls: dict) -> dict:
    """The deploy path's kernels held against their twins at its own shapes:
    the generator's full-frame render of the first scene (the raster over
    the zoo bank's full meshes), and the first in-process frame's scoring
    batch (the raster over the bank's render LOD, p2p ICP, the depth cost:
    about DEPLOY_CANDIDATES candidates of three labels in one batch); then
    that batch's slice against the CPU twins."""
    require(set(frame["render_calls"]) == {"raster_direct"},
            f"the generator's render called {sorted(frame['render_calls'])}")
    res = {"render": kernel_phase(
        "raster_direct", frame["render_calls"]["raster_direct"],
        DEPLOY_RENDER_CASE)}
    require(set(calls) == {*DEPTH, *BATCH_SITE},
            f"{DEPLOY_CASE} called {sorted(calls)}")
    for name in DEPTH:
        res[name] = kernel_phase(name, calls[name], DEPLOY_CASE)
    args, kwargs = calls["score_pose_batch"]
    batch = BenchProblem(
        env=rec.env, candidates=[None] * args[3].shape[0], gt=[],
        args=args[:9], cfg=args[9],
        use_lab=kwargs.get("bank_tri_lab") is not None)
    check_slice(batch, DEPLOY_CASE)
    return res


def check_deploy() -> tuple[dict, dict, dict]:
    """The port as a robot deploys it (steps of the deploy phase): zoo
    models as PLY files and a JSON config; scenes generated on the card;
    candidates; frames dropped into a spool; `perception_tpu_torch.serve`
    and `perception_tpu_torch.camera_loop` as their own processes; the
    answers scored against the ground truth; /status, / and /overlay.png;
    the same frames through an in-process FrameWatcher, the first one's
    kernels and slice against their twins (check_deploy_kernels). Returns
    those kernels' phases, the launches of that frame (its request and its
    overlay) and of the first scene's render."""
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        spool = root / "spool"
        spool.mkdir()
        # 1. Models and config.
        paths = write_zoo_plys(str(root), {n: n for n in ZOO_NAMES})
        cfg_path = root / "deploy.json"
        cfg_path.write_text(json.dumps(deploy_config(paths)))
        rec = recognizer_from_config(str(cfg_path), "cuda")
        # 2-4. Scenes, candidates, the spool.
        frames = make_frames(rec, root, spool)
        # 5. The kernels are built (main's phase 2): the service loads them.
        port = free_port()
        url = f"http://127.0.0.1:{port}"
        server = loop = None
        try:
            t0 = time.perf_counter()
            server = Child(["perception_tpu_torch.serve", "--config",
                            str(cfg_path), "--port", str(port), "--warmup"])
            warm = server.wait_for("warmup:", READY_TIMEOUT_S)
            server.wait_for(f"localizer on :{port}", READY_TIMEOUT_S)
            ready_s = time.perf_counter() - t0
            # 6. Before any request.
            code, page = http_get(f"{url}/")
            require(code == 200 and b"No localisation served yet" in page,
                    f"GET / before a request: {code}")
            require(http_get(f"{url}/overlay.png")[0] == 404,
                    "GET /overlay.png before a request is not 404")
            # 7. The camera loop.
            t0 = time.perf_counter()
            loop = Child(["perception_tpu_torch.camera_loop", "--spool",
                          str(spool), "--url", f"{url}/localize"])
            for f in frames:
                loop.wait_for(f"localised frame {f['key']}", LOOP_TIMEOUT_S)
            loop_s = time.perf_counter() - t0
            loop.stop()
            served = {f["key"]: json.loads(
                (spool / f"{f['key']}-detections.json").read_text())
                for f in frames}
            for key, out in served.items():
                require("error" not in out, f"{key}: {out.get('error')}")
            # 9. Status, page and overlay after the last frame.
            last = frames[-1]
            code, status = http_get(f"{url}/status")
            want = {k: v for k, v in served[last["key"]].items()
                    if k not in ("frame", "latency_s")}
            require(code == 200 and json.loads(status) == want,
                    "GET /status is not the last frame's response")
            code, page = http_get(f"{url}/")
            require(code == 200 and b'<img src="/overlay.png"' in page
                    and all(f"<td>{d['name']}</td>".encode() in page
                            for d in want["detections"]),
                    "GET / does not list the last frame's objects")
            code, png = http_get(f"{url}/overlay.png")
            require(code == 200, f"GET /overlay.png: {code}")
            overlay = check_overlay(rec, last, want, png)
        finally:
            for child in (loop, server):
                if child is not None:
                    child.stop()
        # 8. The answers against the ground truth.
        errors, misses = {}, []
        for f in frames:
            dets = {d["name"]: d for d in served[f["key"]]["detections"]}
            errors[f["key"]] = detection_errors(rec, f, dets)
            for name, row in errors[f["key"]].items():
                twin = DEPLOY_REFERENCE_MISSES.get((f["key"], name))
                row["reference_miss"] = twin is not None
                if twin is not None:
                    row["cpu_twin_diff_m"] = (float(np.linalg.norm(
                        np.subtract(dets[name]["translation"], twin)))
                        if name in dets else None)
                    held = (row["cpu_twin_diff_m"] is not None
                            and row["cpu_twin_diff_m"] <= DEPLOY_TWIN_BAR_M)
                else:
                    held = (row["visible_share"] < 0.5
                            or (row["detected"]
                                and row["translation_m"] < DEPLOY_BAR_M))
                if not held:
                    misses.append(f"{f['key']}/{name}")
        # 10. The same frames in process.
        spool2 = root / "spool_in_process"
        spool2.mkdir()
        for f in frames:
            for suffix in ("depth.png", "color.png", "labels.png",
                           "request.json"):
                shutil.copy(spool / f"{f['key']}-{suffix}", spool2)
        watcher = FrameWatcher(str(spool2), service=LocalizerService(rec))
        in_process, request_ms = {}, []
        launches = twins = phases = None
        for f in frames:
            build.reset_counts()
            t0 = time.perf_counter()
            with recorded_kernel_calls(BATCH_SITE) as calls:
                in_process[f["key"]] = watcher.process(f["key"])
            sync()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            if launches is None:
                launches = dict(build.LAUNCHES)
                twins = dict(build.TWIN_CALLS)
                # Before the next frame's set_input replaces the scene.
                phases = check_deploy_kernels(rec, f, calls)
        max_dt, max_dq = 0.0, 0.0
        for f in frames:
            a = {d["name"]: d for d in served[f["key"]]["detections"]}
            b = {d["name"]: d for d in in_process[f["key"]]["detections"]}
            require(a.keys() == b.keys(),
                    f"{f['key']}: served {sorted(a)} in process {sorted(b)}")
            for name in a:
                max_dt = max(max_dt, float(np.abs(
                    np.subtract(a[name]["translation"],
                                b[name]["translation"])).max()))
                qa = np.asarray(a[name]["quaternion_xyzw"])
                qb = np.asarray(b[name]["quaternion_xyzw"])
                max_dq = max(max_dq, float(min(np.abs(qa - qb).max(),
                                               np.abs(qa + qb).max())))
            require((spool2 / f"{f['key']}-overlay.png").exists(),
                    f"{f['key']}: no in-process overlay")
    emit({"phase": "deploy", "frames": len(frames),
          "serve_warmup_line": warm, "serve_ready_s": ready_s,
          "camera_loop_s": loop_s,
          "served_latency_s": [served[f["key"]]["latency_s"] for f in frames],
          "served_scenes_rendered": [served[f["key"]]["stats"]
                                     ["scenes_rendered"] for f in frames],
          "in_process_request_ms": request_ms,
          "detections": errors, "overlay": overlay,
          "served_vs_in_process": {"max_translation_diff_m": max_dt,
                                   "max_quaternion_diff": max_dq},
          "launches_one_frame": launches, "twin_calls": twins})
    require(not misses, f"objects at least half visible off by >= 20 mm, "
            f"or a reference miss off its CPU twin's detection by more than "
            f"1 mm, or missed: {misses}")
    require(max_dt <= 1e-5 and max_dq <= 1e-5,
            f"served and in-process detections differ: {max_dt} m, {max_dq}")
    require(launches == {"raster_direct": 2, "icp_fused": 1, "cost_fused": 1},
            f"one in-process frame (request + overlay) launched {launches}")
    require(sum(twins.values()) == 0, f"deploy: twins ran: {twins}")
    return phases, launches, frames[0]["render_launches"]


def check_fine_color(dev) -> dict:
    """The colour fine re-score batch (stride 4, ROI 64x64, P = 4096 plus the
    explain-only samples, use_color_cost; no ICP): above the fused colour
    cost's caps it takes the composed cost, so it launches the raster and
    the 1-NN and neither colour kernel; its slice against the CPU twins.
    Returns the 1-NN's kernel phase and the batch's launches."""
    bp = problem(dev, use_color=True, env_overrides={"fine_stride": 4})
    env = bp.env
    cfg = env._scorer_config(do_icp=False, stride=4)
    require(cfg.roi_shape == (64, 64) and cfg.max_points_per_pose == 4096
            and cfg.cost_type == 3, f"fine colour config {cfg}")
    labels = bp.args[5]
    totals = env._observed_fine.seg_count.float()[labels]
    fine_bp = dataclasses.replace(
        bp, args=(*bp.args[:6], totals, bp.args[7], env._scene_fine),
        cfg=cfg)
    label = "colour fine re-score batch"
    res, counts = check_kernels(fine_bp, ("raster_direct", "nn1_batch"),
                                label)
    require(counts == {"raster_direct": 1, "nn1_batch": 1},
            f"{label} launches {counts}")
    check_slice(fine_bp, "colour fine re-score")
    return res["nn1_batch"], counts

# -- Section 11: the pose split, the YCB driver, the view generator, VFH -----

SHARD_COUNTS = (N_POSES, N_POSES - 1)   # the second pads on two ranks
# The YCB sweep's models: the zoo shapes as PLY files, under YCB-Video class
# names where the zoo has the object (the names pick the rotation sampler's
# symmetry mode and ADD-S, as on the real dataset).
YCB_NAMES = {"025_mug": "mug", "024_bowl": "bowl", "l_bracket": "l_bracket",
             "elbow": "elbow", "003_cracker_box": "cracker_box",
             "005_tomato_soup_can": "soup_can"}
YCB_SYMMETRIC = ("024_bowl", "005_tomato_soup_can")
YCB_CANDIDATES = 2048     # per frame, about: num_samples is chosen for it
YCB_CASE = "ycb frame"
YCB_COLOR_CASE = "ycb colour frame"
VIEWS_CASE = "view bank 150x150"
# The objects the JAX package itself puts more than 20 mm off in the YCB
# sweep and the conveyor on the CPU (`python -m
# tests.test_torch_eval_drivers`: the same scenes, files and candidates;
# 61.3, 194.9, 97.4 and 99.4 mm, the port's CPU twins within 1.5 mm of
# JAX), and the translation (m, camera frame) the port detects for them on
# the CPU twins: the card's must lie within DEPLOY_TWIN_BAR_M of it.
YCB_REFERENCE_MISSES = {
    ("0001", "025_mug"): (-0.12760870368375934, -0.06087804426401176,
                          0.5886567914594827),
    ("0002", "003_cracker_box"): (0.2021684336662293, -0.1383395931124688,
                                  0.696297837793827),
    ("0002", "005_tomato_soup_can"): (-0.14515933394432068,
                                      -0.10196056962013245,
                                      0.6398108415305614),
    ("0003", "005_tomato_soup_can"): (-0.07743192315101624,
                                      0.005027569830417634,
                                      0.7986724346876144)}


def check_sharded(bp) -> dict:
    """The pose split on the card (parallel/run.py ranks as processes): the
    depth ROI batch at N_POSES and N_POSES - 1 poses, with one rank over
    NCCL and with two ranks sharing the card over gloo; each rank's
    gathered result must equal this process's score_pose_batch on every
    field, bit for bit; then the padding poses on the kernels
    (check_padding). Returns each rank's JSON lines."""
    refs = {k: bp.score(n=k) for k in SHARD_COUNTS}
    sync()
    out = {}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = f"{tmp}/batch.pt"
        shard_run.save_batch(path, bp.args, bp.cfg, **bp.bank_inputs)
        for ranks, backend in ((1, "nccl"), (2, "gloo")):
            rdir = Path(tmp) / backend
            rdir.mkdir()
            t0 = time.perf_counter()
            code, lines = shard_run.launch(
                ranks, backend, device="cuda", inputs=[path],
                counts=",".join(map(str, SHARD_COUNTS)), out=str(rdir),
                timeout=300, rendezvous_dir=tmp)
            seconds = time.perf_counter() - t0
            require(code == 0, f"sharded {backend} x{ranks}: exit {code}")
            require(len(lines) == ranks * len(SHARD_COUNTS)
                    and all(l["equal_to_one_process"] for l in lines),
                    f"sharded {backend} x{ranks}: {lines}")
            for r in range(ranks):
                saved = torch.load(rdir / f"rank{r}.pt")
                for k in SHARD_COUNTS:
                    for f in dataclasses.fields(refs[k]):
                        require(torch.equal(saved[0, k][f.name],
                                            getattr(refs[k], f.name).cpu()),
                                f"sharded {backend} rank {r} at {k} poses: "
                                f"{f.name} differs from score_pose_batch")
            out[backend] = lines
            emit({"phase": "sharded", "backend": backend, "ranks": ranks,
                  "poses": list(SHARD_COUNTS), "launch_s": seconds,
                  "ranks_lines": lines})
    emit({"phase": "sharded_padding", **check_padding(bp)})
    return out


def check_padding(bp, pad: int = 3) -> dict:
    """The pose split's padding on the kernels: the batch's last `pad`
    poses replaced by zero poses of model 0, label 0 and total 0. They reach
    the raster's perspective divide and the ICP: every field finite, their
    total -1, and the other poses scored as without them."""
    n = len(bp.candidates) - pad
    verts, colors, valid, poses, ids, labels, totals, proj, scene = bp.args

    def padded(x):
        return torch.cat([x[:n], torch.zeros((pad, *x.shape[1:]),
                                             dtype=x.dtype, device=x.device)])

    out = scorer.score_pose_batch(
        verts, colors, valid, padded(poses), padded(ids), padded(labels),
        padded(totals), proj, scene, bp.cfg, **bp.bank_inputs)
    ref = bp.score(n=n)
    sync()
    fields = dataclasses.fields(out)
    res = {"padding_poses": pad,
           "finite": all(bool(torch.isfinite(getattr(out, f.name).float())
                              .all()) for f in fields),
           "padding_totals": out.total_cost[n:].tolist(),
           "others_equal": all(torch.equal(getattr(out, f.name)[:n],
                                           getattr(ref, f.name))
                               for f in fields)}
    require(res["finite"] and res["others_equal"]
            and all(t == -1 for t in res["padding_totals"]),
            f"padding poses on the kernels: {res}")
    return res


def ycb_recognizer(root: Path, dev) -> ObjectRecognizer:
    """The zoo models as PLY files under YCB names, loaded by a recogniser
    at the deploy phase's configuration (640x480, stride 8, ROI 32, p2p)."""
    paths = write_zoo_plys(str(root), YCB_NAMES)
    specs = [ModelSpec(name=n, path=p, symmetric=n in YCB_SYMMETRIC)
             for n, p in paths.items()]
    cfg = deploy_config(paths)
    return ObjectRecognizer(
        specs, YCB_CAMERA,
        PerchConfig(**{k: v for k, v in cfg.items()
                       if k not in ("camera", "model_bank", "env_params")}),
        EnvConfig(**cfg["env_params"]), use_external_pose_list=True,
        device=dev)


def make_ycb_dataset(root: Path, dev) -> dict:
    """Three 640x480 scenes of three zoo objects from DEPLOY_SEED with
    DEPLOY_PLACEMENT, rendered by the generator on `dev`, written in the
    YCB-Video layout under root/ycb, read back; num_samples for about
    YCB_CANDIDATES candidates per frame, every frame in one batch. Returns
    the recogniser, the dataset, scenes, keyframes, frames, num_samples,
    the candidates per frame and each object's visible share."""
    rec = ycb_recognizer(root, dev)
    gen = DatasetGenerator(rec.env, np.random.default_rng(DEPLOY_SEED))
    scenes = [gen.sample_scene(**DEPLOY_PLACEMENT)
              for _ in range(DEPLOY_SCENES)]
    # Each object's pixels in the scene against its render alone.
    visible = [[(int((sc.label == j + 1).sum())
                 / max(1, int((rec.env.render_composite([s])[2] > 0).sum())))
                for j, s in enumerate(sc.states)] for sc in scenes]
    keyframes = write_ycb_layout(str(root / "ycb"), rec.env, scenes)
    ds = ycb_mod.YCBVideoDataset(str(root / "ycb"))
    frames = [ds.load_frame(*k) for k in keyframes]

    def candidates(ns: int) -> list[int]:
        out = []
        for f in frames:
            mask, names = ycb_mod.frame_masks(rec, f)
            out.append(sum(len(v) for v in ycb_mod.generate_candidates(
                f.depth, mask, names, f.intrinsics, num_samples=ns).values()))
        return out

    num_samples = min(range(4, 400, 2), key=lambda ns: abs(
        np.mean(candidates(ns)) - YCB_CANDIDATES))
    counts = candidates(num_samples)
    rec.env.perch = dataclasses.replace(
        rec.env.perch, gpu_batch_size=-(-max(counts) // 64) * 64)
    return dict(rec=rec, ds=ds, scenes=scenes, keyframes=keyframes,
                frames=frames, num_samples=num_samples, candidates=counts,
                visible=visible)


def ycb_errors(data: dict, results: list) -> dict:
    """Per frame and object: the translation error (m) of the detection's
    origin (the preprocessed model's, as the deploy bar takes it), ADD,
    ADD-S and the protocol's error, beside the visible share."""
    rec = data["rec"]
    out = {}
    for f, res, vis, sc in zip(data["frames"], results, data["visible"],
                               data["scenes"]):
        rows = {}
        for j, s in enumerate(sc.states):
            name = rec.bank.models[s.id].name
            row = {"visible_share": vis[j], "detected": name in res.errors}
            if name in res.detected_poses:
                pre = rec.bank.models[s.id].preprocessing_transform
                t_gt = (f.gt_poses[name] @ np.linalg.inv(pre))[:3, 3]
                row.update(
                    translation=res.detected_poses[name][0, :3].tolist(),
                    translation_m=float(np.linalg.norm(
                        res.detected_poses[name][0, :3] - t_gt)),
                    add_m=res.add_errors[name], adds_m=res.adis_errors[name],
                    error_m=res.errors[name])
            rows[name] = row
        out[f.scene] = rows
    return out


def ycb_misses(errors: dict) -> list:
    """The objects off the bar: at least half visible and not within
    DEPLOY_BAR_M, or a reference miss off its CPU-twin detection."""
    misses = []
    for scene, rows in errors.items():
        for name, row in rows.items():
            twin = YCB_REFERENCE_MISSES.get((scene, name))
            if twin is not None:
                row["reference_miss"] = True
                row["cpu_twin_diff_m"] = (float(np.linalg.norm(
                    np.subtract(row["translation"], twin)))
                    if row["detected"] else None)
                held = (row["cpu_twin_diff_m"] is not None
                        and row["cpu_twin_diff_m"] <= DEPLOY_TWIN_BAR_M)
            else:
                held = row["visible_share"] < 0.5 or (
                    row["detected"] and row["translation_m"] < DEPLOY_BAR_M)
            if not held:
                misses.append(f"{scene}/{name}")
    return misses


def coco_detections(frame, path: Path) -> None:
    """A COCO detections file of a frame's label-image instances, their
    masks in the ported RLE (eval/fat._rle_encode)."""
    anns = []
    for cid in np.unique(frame.label[frame.label > 0]):
        mask = frame.label == cid
        ys, xs = np.nonzero(mask)
        anns.append({"image_id": 1, "category_id": int(cid), "score": 1.0,
                     "bbox": [int(xs.min()), int(ys.min()),
                              int(xs.max() - xs.min() + 1),
                              int(ys.max() - ys.min() + 1)],
                     "segmentation": _rle_encode(mask)})
    h, w = frame.label.shape
    path.write_text(json.dumps({
        "images": [{"id": 1, "width": w, "height": h,
                    "file_name": f"{frame.scene}/{frame.frame}-color.png"}],
        "annotations": anns,
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(frame.class_list)]}))


def check_ycb(dev) -> dict:
    """The YCB-Video driver at full width: make_ycb_dataset, the depth PNG
    round trip (half a centimetre), run_dataset over the three keyframes
    (accuracy.json; per-frame launches), the first frame again in
    "detections" mask mode (a COCO file of its label image: the same
    detections) and with use_color_cost (the colour ROI kernel), then
    run_on_conveyor with warm start over the three frames. The first
    frame's raster, ICP and cost are held against their twins at its
    shapes, and its batch as a slice; the colour frame's cost kernel too.
    Every object at least half unoccluded within 20 mm (reference misses
    within 1 mm of the port's CPU-twin detection). Returns the kernel
    phases and the launches of one frame."""
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        data = make_ycb_dataset(root, dev)
        rec, frames = data["rec"], data["frames"]
        round_trip = max(float(np.abs(f.depth.astype(np.float64) / 100.0
                                      - sc.depth).max())
                         for f, sc in zip(frames, data["scenes"]))
        emit({"phase": "ycb_dataset", "seconds": time.perf_counter() - t0,
              "keyframes": data["keyframes"],
              "objects": [list(f.gt_poses) for f in frames],
              "num_samples": data["num_samples"],
              "candidates": data["candidates"],
              "gpu_batch_size": rec.env.perch.gpu_batch_size,
              "visible_share": data["visible"],
              "depth_round_trip_max_cm": round_trip})
        require(round_trip <= 0.5, f"depth PNG round trip {round_trip} cm")

        # The sweep, each frame's launches and the first frame's calls.
        launches, twins, results, calls = [], [], [], {}
        localize = rec.localize_objects_greedy_render

        def counted(rin, pose_lists, output_dir=None):
            sync()
            build.reset_counts()
            with recorded_kernel_calls(BATCH_SITE) as seen:
                out = localize(rin, pose_lists, output_dir=output_dir)
            sync()
            launches.append(dict(build.LAUNCHES))
            twins.append(sum(build.TWIN_CALLS.values()))
            if not calls:
                calls.update(seen)
            return out

        evaluate = ycb_mod.evaluate_frame

        def recorded(*args, **kwargs):
            results.append(evaluate(*args, **kwargs))
            return results[-1]

        rec.localize_objects_greedy_render = counted
        ycb_mod.evaluate_frame = recorded
        try:
            t0 = time.perf_counter()
            report = ycb_mod.run_dataset(
                rec, data["ds"], num_samples=data["num_samples"],
                output_root=str(root / "out"))
            sweep_s = time.perf_counter() - t0
        finally:
            ycb_mod.evaluate_frame = evaluate
            rec.localize_objects_greedy_render = localize
        require(json.loads((root / "out" / "accuracy.json").read_text())
                == json.loads(json.dumps(report)), "accuracy.json")
        errors = ycb_errors(data, results)
        misses = ycb_misses(errors)
        emit({"phase": "ycb_sweep", "frames": len(results),
              "sweep_s": sweep_s,
              "frame_runtime_s": [r.runtime for r in results],
              "report": report, "detections": errors,
              "launches_per_frame": launches, "twin_calls": twins})
        require(all(l == {"raster_direct": 1, "icp_fused": 1,
                          "cost_fused": 1} for l in launches)
                and not any(twins), f"ycb launches {launches}, twins {twins}")
        phases = {name: kernel_phase(name, calls[name], YCB_CASE)
                  for name in DEPTH}
        args, kwargs = calls["score_pose_batch"]
        check_slice(BenchProblem(
            env=rec.env, candidates=[None] * args[3].shape[0], gt=[],
            args=args[:9], cfg=args[9],
            use_lab=kwargs.get("bank_tri_lab") is not None), YCB_CASE)

        # The first frame in "detections" mask mode and with colour.
        frame0 = frames[0]
        coco = root / "detections.json"
        coco_detections(frame0, coco)
        det = ycb_mod.evaluate_frame(
            rec, frame0, num_samples=data["num_samples"],
            mask_mode="detections", detections_json=str(coco))
        same = (det.detected == results[0].detected and all(
            np.array_equal(det.detected_poses[n], results[0].detected_poses[n])
            for n in det.detected))
        emit({"phase": "ycb_detections_mode", "frame": frame0.scene,
              "detected": det.detected, "errors": det.errors,
              "equal_to_gt_masks": same})
        require(same, "detections mode differs from the GT-mask frame")
        perch = rec.env.perch
        rec.env.perch = dataclasses.replace(perch, use_color_cost=True)
        build.reset_counts()
        try:
            with recorded_kernel_calls() as color_calls:
                color = ycb_mod.evaluate_frame(
                    rec, frame0, num_samples=data["num_samples"])
            sync()
        finally:
            rec.env.perch = perch
        color_launches = dict(build.LAUNCHES)
        color_errors = ycb_errors(
            {**data, "frames": [frame0], "visible": data["visible"][:1],
             "scenes": data["scenes"][:1]}, [color])
        emit({"phase": "ycb_colour_frame", "frame": frame0.scene,
              "launches": color_launches, "detections": color_errors})
        require(color_launches.get("cost_fused_color_tri", 0) == 1
                and "cost_fused" not in color_launches,
                f"colour frame launches {color_launches}")
        phases["cost_fused_color_tri"] = kernel_phase(
            "cost_fused_color_tri", color_calls["cost_fused_color_tri"],
            YCB_COLOR_CASE)

        # The conveyor: the three frames in order, warm-started.
        t0 = time.perf_counter()
        conveyor = workloads.run_on_conveyor(
            rec, frames, num_samples=data["num_samples"], warm_start=True)
        conveyor_errors = ycb_errors(data, conveyor)
        conveyor_misses = ycb_misses(conveyor_errors)
        emit({"phase": "ycb_conveyor", "seconds": time.perf_counter() - t0,
              "detections": conveyor_errors,
              "warm_start_rows": [{n: r.tolist() for n, r in
                                   c.detected_poses.items()}
                                  for c in conveyor]})
    require(not misses, f"ycb sweep: objects off the bar: {misses}")
    require(not conveyor_misses,
            f"ycb conveyor: objects off the bar: {conveyor_misses}")
    return {"phases": phases, "launches": launches[0],
            "color_launches": color_launches}


def check_views() -> dict:
    """tools/view_generator on the zoo PLYs at resolution 150, level 1 (42
    views), stride 1, on the card: one raster launch per model, its first
    call held against the twin; every written <name>-views.npz loads with
    42 poses, 42 clouds and its entropies."""
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        models, out = Path(tmp) / "models", Path(tmp) / "views"
        models.mkdir()
        for name in ZOO_NAMES:
            v, f, c, _ = zoo_raw_geometry(name)
            write_ply(models / f"{name}.ply", v, f, c)
        build.reset_counts()
        t0 = time.perf_counter()
        with recorded_kernel_calls() as calls:
            code = view_generator.main([str(models), str(out), "--level=1",
                                        "--resolution=150"])
        sync()
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        require(code == 0, f"view_generator exit {code}")
        require(launches == {"raster_direct": len(ZOO_NAMES)}
                and not build.TWIN_CALLS, f"view bank launches {launches}")
        phase = kernel_phase("raster_direct", calls["raster_direct"],
                             VIEWS_CASE)
        banks = {}
        for name in ZOO_NAMES:
            bank = np.load(out / f"{name}-views.npz")
            clouds = [k for k in bank.files if k.startswith("cloud_")]
            require(bank["poses"].shape == (42, 4, 4) and len(clouds) == 42
                    and bank["entropy"].max() == 1.0,
                    f"{name}-views.npz: {bank.files}")
            banks[name] = [len(bank[k]) for k in clouds]
    emit({"phase": "view_generator", "seconds": seconds,
          "launches": launches, "points_per_view": banks})
    return {"phase": phase, "launches": launches}


def check_vfh(bp) -> None:
    """VFH on the bench models: train (30 fibonacci views each at 0.8 m,
    rendered on the card, k-NN normals on the card), then estimate from a
    rendered training view of each model: its model must come back."""
    env0 = bp.env
    env = PerceptionEnv(env0.bank, env0.camera, env0.perch, env0.env,
                        device=env0.device)
    env._input = RecognitionInput(
        depth_image=np.zeros((env.camera.height, env.camera.width)),
        cam_to_world=np.eye(4))
    est = VFHPoseEstimator(env)
    t0 = time.perf_counter()
    n = est.train(num_views=30, distance=0.8)
    sync()
    train_s = time.perf_counter() - t0
    require(n == 30 * len(env.bank.models), f"vfh trained {n} views")
    found = {}
    for mid, model in enumerate(env.bank.models):
        entry = [e for e in est.entries if e.name == model.name][7]
        pts, nrm = est._view_cloud(ObjectState(
            id=mid, symmetric=False, segmentation_label_id=1,
            pose=ContPose.from_euler(0, 0, 0.8, 0, entry.pitch, entry.yaw)))
        found[model.name] = [m.name for m in est.estimate(pts, nrm, k=3)]
    emit({"phase": "vfh", "views": n, "train_s": train_s,
          "nearest_views": found})
    require(all(v[0] == k for k, v in found.items()), f"vfh: {found}")



# -- Section 12: the decimator and early-exit switches, the model cache ------

CLUSTER_CASE = "clustered bank batch"
NO_EXIT_CASE = "early exit off batch"
SWITCHES = ("PT_DECIMATE", "PT_MODEL_CACHE_DIR")
NO_EARLY_EXIT = {"icp_stagnation_streak": 10**9}   # a streak no run reaches
DETECTION_BAR_M = 0.02


@contextlib.contextmanager
def switches(**values):
    """The port's environment switches set as given (None: unset) for the
    block; every one of SWITCHES is restored after it."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k, v in values.items():
        require(k in SWITCHES, f"unknown switch {k}")
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def area_culls(pargs: tuple, pkw: dict) -> dict:
    """Of a direct-raster call's (pose, triangle) pairs that pass the
    validity, facing and depth tests (the twin's setup): those whose screen
    area is at most raster_direct.AREA_CULL_PX2 (the cull removes them), and those
    within 10x of it (drawn, but borderline)."""
    verts16, pose12, model_ids, _, proj12 = pargs
    ok, area = raster_direct._triangle_setup(
        verts16, pose12, model_ids, proj12, pkw["width"], pkw["height"],
        areas=True)
    cull = raster_direct.AREA_CULL_PX2
    return {"pairs_tested": int(ok.sum()),
            "below_area_cull": int((ok & (area <= cull)).sum()),
            "within_10x_of_cull": int((ok & (area > cull)
                                       & (area <= 10 * cull)).sum())}


def greedy_errors(bp, label: str) -> tuple[dict, dict]:
    """The env's greedy pass over the problem's candidates (the user's
    entry point, with the switches of the caller's block): per visible
    object the chosen pose's translation error (m) to the ground truth,
    within DETECTION_BAR_M; and the pass's launches (counts set to 0 just
    before it)."""
    build.reset_counts()
    t0 = time.perf_counter()
    state, _ = bp.env.compute_greedy_poses(bp.candidates, do_icp=True)
    sync()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    chosen = {s.segmentation_label_id: s.pose for s in state.object_states}
    seg = bp.env._observed.seg_count.tolist()
    errors = {}
    for i, gt in enumerate(bp.gt):
        if seg[i] == 0:
            continue                         # out of view (GT object 0)
        got = chosen.get(gt.segmentation_label_id)
        require(got is not None, f"{label}: object {i} not detected")
        errors[i] = float(np.linalg.norm(
            [got.x - gt.pose.x, got.y - gt.pose.y, got.z - gt.pose.z]))
    emit({"phase": "greedy", "case": label, "seconds": seconds,
          "detection_error_mm": {k: v * 1e3 for k, v in errors.items()},
          "launches": launches})
    require(all(e < DETECTION_BAR_M for e in errors.values()),
            f"{label}: detections {errors}")
    require(all(launches.get(n, 0) > 0 for n in DEPTH),
            f"{label}: launches {launches}")
    return errors, launches


def icp_iterations(label: str) -> torch.Tensor:
    """Per pose, the iterations the fused ICP ran on the inputs that
    kernel_phase held it on for `label` (the twin's counts, which equal
    the kernel's)."""
    pargs, pkw = INPUTS["icp_fused", label]
    return icp_fused.icp_fused_twin(*pargs, **pkw, return_counts=True)[1]


def check_switch_variant(dev, label: str, case: str, env: dict,
                         **kw) -> dict:
    """The bench problem built (with `kw`) and scored under the switches
    `env`: each kernel of the depth batch against its twin, the batch as a
    slice against the CPU twins, and the greedy pass's detections. Returns
    the problem, the kernel phases and the greedy pass's launches."""
    with switches(**env):
        bp = problem(dev, **kw)
        results, _ = check_kernels(bp, DEPTH, case)
        check_slice(bp, label)
        errors, launches = greedy_errors(bp, label)
    return {"problem": bp, "results": results, "launches": launches,
            "errors": errors}


def check_model_cache(bp) -> None:
    """The localize CLI three times on the bench scene as files, with
    PT_MODEL_CACHE_DIR a fresh directory: the first run
    (PT_DECIMATE=qem) writes one .npz entry per model, the second
    (PT_DECIMATE unset, which keys as "qem") loads every model from them
    and writes the same output_poses.txt, the third (PT_DECIMATE=cluster)
    writes new entries under other keys. Each run's model-load seconds are the
    recogniser's load_model_cached calls on the host clock."""
    from perception_tpu_torch.io import model_cache
    from perception_tpu_torch.pipeline import recognizer

    load_model, cached = model_cache.load_model, recognizer.load_model_cached
    counts = {"decimated": 0, "seconds": 0.0}

    def counted_load(*a, **k):
        counts["decimated"] += 1
        return load_model(*a, **k)

    def timed_cached(*a, **k):
        t0 = time.perf_counter()
        try:
            return cached(*a, **k)
        finally:
            counts["seconds"] += time.perf_counter() - t0

    (REPO / "build").mkdir(exist_ok=True)
    runs = []
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root, cache = Path(tmp), Path(tmp) / "model_cache"
        names = write_bench_scene(bp, root, "auto")
        model_cache.load_model = counted_load
        recognizer.load_model_cached = timed_cached
        try:
            for run, decimator in enumerate(("qem", None, "cluster")):
                counts.update(decimated=0, seconds=0.0)
                stdout = io.StringIO()
                out = root / f"out{run}"
                t0 = time.perf_counter()
                with switches(PT_MODEL_CACHE_DIR=str(cache),
                              PT_DECIMATE=decimator), \
                        contextlib.redirect_stdout(stdout):
                    rc = cli.main(["localize", "--config",
                                   str(root / "scene.json"), "--output",
                                   str(out), "--device", "cuda"])
                sync()
                require(rc == 0, f"cache run {run}: exit code {rc}")
                summary = json.loads(
                    stdout.getvalue().strip().splitlines()[-1])
                dets = dict(zip(summary["detected"], summary["poses"]))
                errors_mm = {}
                for i in (1, 2):
                    gt = bp.gt[i].pose
                    errors_mm[names[i]] = 1e3 * float(np.linalg.norm(
                        np.asarray(dets[names[i]][:3])
                        - [gt.x, gt.y, gt.z]))
                runs.append({
                    "run": run, "PT_DECIMATE": decimator,
                    "seconds": time.perf_counter() - t0,
                    "model_load_s": counts["seconds"],
                    "models_decimated": counts["decimated"],
                    "entries": sorted(f.name for f in cache.glob("*.npz")),
                    "poses": (out / "output_poses.txt").read_bytes(),
                    "detection_error_mm": errors_mm})
        finally:
            model_cache.load_model = load_model
            recognizer.load_model_cached = cached
    first, second, third = runs
    emit({"phase": "model_cache", "runs": [
        {k: v for k, v in r.items() if k != "poses"} for r in runs],
          "poses_equal_on_read": first["poses"] == second["poses"]})
    n = len(names)
    require(first["models_decimated"] == n and len(first["entries"]) == n,
            "the first run writes one entry per model")
    require(second["models_decimated"] == 0
            and second["entries"] == first["entries"],
            "the second run reads every model from the cache")
    require(first["poses"] == second["poses"],
            "output_poses.txt equal when read from the cache")
    require(third["models_decimated"] == n
            and len(third["entries"]) == 2 * n
            and set(first["entries"]) < set(third["entries"]),
            "PT_DECIMATE=cluster writes new entries under other keys")
    for r in runs:
        require(all(e < DETECTION_BAR_M * 1e3
                    for e in r["detection_error_mm"].values()),
                f"cache run {r['run']}: {r['detection_error_mm']}")


def check_switches(dev, depth) -> dict:
    """Section 12: the bench problem (a) on the clustered bank
    (PT_DECIMATE=cluster: bench models and LOD-256 bank) and (b) with the
    ICP's early exit off (EnvConfig.icp_stagnation_streak 10**9, what the
    JAX package's PT_ICP_NO_EARLY_EXIT=1 sets) on the default bank; the
    ICP's device time and the batch with early exit on and off side by
    side; the model cache through the CLI. Returns the two variants."""
    t0 = time.perf_counter()
    before = {k: os.environ.get(k) for k in SWITCHES}
    clustered = check_switch_variant(dev, "clustered bank", CLUSTER_CASE,
                                     {"PT_DECIMATE": "cluster"})
    cbank = clustered["problem"].env
    emit({"phase": "clustered_bank",
          "bench_triangles": cbank.bank.tri_valid.sum(1).tolist(),
          "lod_triangles": cbank._render_bank[2].sum(1).tolist(),
          "area_cull": area_culls(*INPUTS["raster_direct", CLUSTER_CASE]),
          "default_bank_area_cull": area_culls(
              *INPUTS["raster_direct", ROI_CASE])})
    no_exit = check_switch_variant(dev, "early exit off", NO_EXIT_CASE, {},
                                   env_overrides=NO_EARLY_EXIT)
    require(no_exit["problem"].cfg.icp_stagnation_streak == 10**9,
            "the streak reaches the scorer configuration")
    on, off = icp_iterations(ROI_CASE), icp_iterations(NO_EXIT_CASE)
    max_it = INPUTS["icp_fused", NO_EXIT_CASE][1]["max_iterations"]
    # Without the stagnation exit a pose follows the same steps until that
    # exit would have stopped it, then goes on: never fewer iterations.
    require(bool((off >= on).all()) and off.float().mean() > on.float().mean(),
            "early exit off: no pose runs fewer iterations, the mean rises")
    # The ICP's device time and the whole batch with early exit on and off,
    # in turns (on, off, off, on, on, off).
    icp = {c: INPUTS["icp_fused", c] for c in (ROI_CASE, NO_EXIT_CASE)}
    launch = KERNELS["icp_fused"].launch
    bp_off = no_exit["problem"]
    ab = {"icp_device_ms_on": [], "icp_device_ms_off": [],
          "batch_ms_on": [], "batch_ms_off": []}
    for tag in ("on", "off", "off", "on", "on", "off"):
        pargs, pkw = icp[ROI_CASE if tag == "on" else NO_EXIT_CASE]
        ab[f"icp_device_ms_{tag}"].append(
            device_ms(lambda: launch(*pargs, **pkw)))
        bp = depth if tag == "on" else bp_off
        ab[f"batch_ms_{tag}"].append(
            statistics.median(event_times(bp.score, warmup=1, reps=10)))
    emit({"phase": "early_exit_ab", **ab,
          "iterations_on": {"mean": on.float().mean().item(),
                            "max": int(on.max())},
          "iterations_off": {"mean": off.float().mean().item(),
                             "max": int(off.max()),
                             "poses_at_max": int((off == max_it).sum()),
                             "poses": len(off)},
          "icp_device_ratio_off_on": statistics.median(
              ab["icp_device_ms_off"]) / statistics.median(
              ab["icp_device_ms_on"])})
    check_model_cache(depth)
    emit({"phase": "section", "section": 12,
          "seconds": time.perf_counter() - t0})
    require({k: os.environ.get(k) for k in SWITCHES} == before,
            "section 12 restored the switches")
    return {"cluster": clustered, "no_exit": no_exit}

def problem(dev, **kw):
    t0 = time.perf_counter()
    bp = build_bench_problem(n_poses=N_POSES, model_kind="bumpy1024",
                             device=dev, **kw)
    sync()
    emit({"phase": "bench_problem", "poses": N_POSES, **kw,
          "seconds": time.perf_counter() - t0,
          "seg_count": bp.env._observed.seg_count.tolist()})
    return bp


def main() -> int:
    # A crash in native code (the kernels' ctypes calls, the mesh loader)
    # prints the Python stack of every thread to stderr.
    faulthandler.enable()
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

    # 3. Each kernel against its twin, at the shapes the main path gives it:
    # the depth-only ROI batch (and the full-frame observation render), the
    # colour ROI batch and the colour full-frame batch.
    depth = problem(dev)
    results, _ = check_kernels(depth, DEPTH, ROI_CASE)
    with recorded_kernel_calls() as frame_calls:
        depth.env.render_composite(depth.gt)
    sync()
    kernel_phase("raster_direct", frame_calls["raster_direct"], FRAME_CASE)
    # Every kernel of a colour batch is held against its twin there too; the
    # {"kernels"} line reports the raster and ICP from the depth batch.
    color_roi = problem(dev, use_color=True)
    results["cost_fused_color_tri"] = check_kernels(
        color_roi, ("raster_direct", "icp_fused", "cost_fused_color_tri"),
        "colour ROI batch")[0]["cost_fused_color_tri"]
    color_full = problem(dev, use_color=True, roi_size=0)
    results["cost_fused_color"] = check_kernels(
        color_full, ("raster_direct", "icp_fused", "cost_fused_color"),
        FULL_CASE)[0]["cost_fused_color"]
    # The coefficient-table and bin rasters (kernel_backend "pallas",
    # "pallas_bin") at the depth ROI and colour full-frame batches, each
    # against its twin; then the A/B of the three rasters. The {"kernels"}
    # line reports them from the depth ROI batch.
    for case, base, kw, cost_kernel in (
            ("depth ROI", depth, {}, "cost_fused"),
            ("colour full frame", color_full,
             dict(use_color=True, roi_size=0), "cost_fused_color")):
        problems = {"auto": base}
        for backend in ("pallas", "pallas_bin"):
            names = RASTER_KERNELS[backend]
            problems[backend] = problem(dev, kernel_backend=backend, **kw)
            res = check_kernels(
                problems[backend], (*names, "icp_fused", cost_kernel),
                f"{case} batch, {backend}", only=names)[0]
            for name in names:
                results.setdefault(name, res[name])
        raster_ab(case, problems)
    # The real-sensor profile on the Kinect-degraded observation: the exact
    # fused ICP with source normals; then the fused ICP in its other modes
    # and the composed "nn" refiner, each scored once on the same batch.
    noisy = problem(dev, icp_mode="fused_d2d_exact", sensor="kinect")
    require(noisy.env.env == noisy.env.env.noisy_profile(),
            "the noisy batch runs the real-sensor profile")
    icp_results, _ = check_kernels(noisy, DEPTH, NOISY_CASE)
    icp_results = {"exact": icp_results["icp_fused"]}
    with recorded_kernel_calls() as calls:
        noisy.score()
    src_xyz, src_valid = calls["icp_fused"][0][:2]
    emit({"phase": "breakdown", "case": "noisy batch",
          "source_normals_ms": time_ms(
              lambda: icp_ops.cloud_normals(src_xyz, src_valid), warmup=1,
              reps=5)})
    icp_launches = {}
    for mode, change in (
            ("d2d", dict(icp_mode="fused_d2d")),
            ("sym", dict(icp_mode="fused_d2d", icp_d2d_symmetric=True)),
            ("adaptive", dict(icp_mode="fused_d2d", icp_nn_every=0))):
        res, counts = check_kernels(
            noisy, DEPTH, ICP_CASES[mode],
            cfg=dataclasses.replace(noisy.cfg, **change), only=("icp_fused",))
        icp_results[mode] = res["icp_fused"]
        icp_launches[mode] = counts["icp_fused"]
    nn_cfg = dataclasses.replace(noisy.cfg, icp_mode="nn")
    _, nn_counts = check_kernels(
        noisy, ("raster_direct", "nn1_batch", "cost_fused"),
        "noisy batch, icp nn", cfg=nn_cfg, only=())
    nn_out = noisy.score(cfg=nn_cfg)
    sync()
    require(bool(torch.isfinite(nn_out.adjusted_poses).all()),
            "nn: adjusted poses finite")
    emit({"phase": "scored", "case": "noisy batch, icp nn",
          "launches": nn_counts,
          "valid_poses": int((nn_out.total_cost >= 0).sum()),
          "batch_ms": time_ms(lambda: noisy.score(cfg=nn_cfg), warmup=1,
                              reps=5)})
    # The composed GICP refiner on the same observation: the 1-NN kernel at
    # its first iteration's inputs.
    gicp = problem(dev, icp_mode="gicp", sensor="kinect")
    results["nn1_batch"] = check_kernels(
        gicp, ("raster_direct", "nn1_batch", "cost_fused"),
        "gicp batch")[0]["nn1_batch"]
    # Every redesigned kernel at edge shapes.
    nn1_edge_cases(dev)
    raster_edge_cases()
    icp_edge_cases()
    cost_edge_cases()
    color_edge_cases()

    # 4. The slices on the card, and their first N_CPU poses on the CPU.
    check_slice(depth, "depth ROI")
    check_slice(color_roi, "colour ROI")
    check_slice(color_full, "colour full frame")
    # The real-sensor slice rounds alike on both devices (fixed-order
    # normals, bit-equal kernels); the GICP slice sums its normal equations
    # with torch reductions, whose order differs between the devices.
    check_slice(noisy, "noisy profile", equal_frac=1.0, max_diff=0,
                trans_frac=1.0)
    check_slice(gicp, "gicp", equal_frac=0.0, max_diff=5, close_frac=0.98)

    # 5. The served paths; the counts cover exactly each path's requests.
    launches = check_served_path(depth, dev, "depth ROI", 3)
    require(all(launches.get(n, 0) > 0 for n in DEPTH),
            f"depth launches during the requests: {launches}")
    color_launches = check_served_path(color_roi, dev, "colour ROI", 3)
    require(color_launches.get("cost_fused_color_tri", 0) > 0
            and color_launches.get("cost_fused", 0) == 0,
            f"colour ROI launches during the requests: {color_launches}")
    launches["cost_fused_color_tri"] = color_launches["cost_fused_color_tri"]
    full_launches = check_served_path(color_full, dev, "colour full frame", 1)
    require(full_launches.get("cost_fused_color", 0) > 0,
            f"colour full-frame launches: {full_launches}")
    launches["cost_fused_color"] = full_launches["cost_fused_color"]
    noisy_launches = check_served_path(noisy, dev, "noisy profile", 2)
    require(all(noisy_launches.get(n, 0) > 0 for n in DEPTH)
            and noisy_launches.get("nn1_batch", 0) == 0,
            f"noisy-profile launches: {noisy_launches}")
    icp_launches["exact"] = noisy_launches["icp_fused"]
    gicp_launches = check_served_path(gicp, dev, "gicp", 1)
    require(gicp_launches.get("nn1_batch", 0) > 0
            and gicp_launches.get("icp_fused", 0) == 0,
            f"gicp launches: {gicp_launches}")
    launches["nn1_batch"] = gicp_launches["nn1_batch"]

    # 6. The localize CLI on the bench scene as files, through the bin and
    # the coefficient-table raster.
    for backend in ("pallas_bin", "pallas"):
        cli_launches = check_cli_path(depth, backend)
        for name in RASTER_KERNELS[backend]:
            launches[name] = cli_launches[name]

    # 7. The search modes on the 3-DoF table-top scene (640x480, stride 24,
    # batches of 1100): the grid successors, each kernel of the greedy-ICP
    # batch against its twin (the Lab colour cost on a use_color_cost
    # variant), one tree expansion with tree occlusion against the CPU
    # twins, the tree's batch through the bin raster against the twins,
    # served greedy_icp and tree requests, an MHA* plan, the CLI in both
    # modes (the tree through the bin raster), and the scene at the
    # configuration defaults, reported without a bar.
    table = make_table_scene(dev)
    succ = check_successors(table)
    check_kernels(TableBatch(table), DEPTH, TABLE_CASE)
    check_kernels(TableBatch(make_table_scene(dev, use_color=True)),
                  ("raster_direct", "icp_fused", "cost_fused_color"),
                  TABLE_COLOR_CASE, only=("cost_fused_color",))
    # The tree's own scoring batch through the bin raster, as the tree CLI
    # run below scores its expansions.
    check_kernels(TableBatch(make_table_scene(
        dev, env_overrides={"kernel_backend": "pallas_bin"}), do_icp=False),
        ("raster_bin", "cost_fused"), TABLE_BIN_CASE)
    check_tree_occlusion(table, succ)
    icp_served = check_table_served(table, dev, "greedy_icp", 2)
    require(all(icp_served.get(n, 0) > 0 for n in DEPTH),
            f"served greedy_icp launches {icp_served}")
    tree_served = check_table_served(table, dev, "tree", 1)
    require(tree_served.get("raster_direct", 0) > 0
            and tree_served.get("cost_fused", 0) > 0
            and tree_served.get("icp_fused", 0) == 0,
            f"served tree launches {tree_served}")
    check_mha_star(table)
    cli_icp = check_table_cli(table, "greedy_icp", "auto")
    require(all(cli_icp.get(n, 0) > 0 for n in DEPTH),
            f"cli greedy_icp launches {cli_icp}")
    cli_tree = check_table_cli(table, "tree", "pallas_bin")
    require(cli_tree.get("raster_bin", 0) > 0
            and cli_tree.get("cost_fused", 0) > 0
            and cli_tree.get("icp_fused", 0) == 0,
            f"cli tree launches {cli_tree}")
    report_table_defaults(dev)

    # 8. The scorer's and env's other branches on the bench scene (depth
    # ROI batch unless named): the speed profile (model-source ICP), the
    # re-render cost (colour ROI), the coarse pre-ICP pass, the per-pose
    # spread crop, projective ICP, the composed colour cost (colour full
    # frame without the face Lab table), the fine-stride re-score, a pose
    # refinement round, and the particle log-likelihood.
    fast_icp, fast_served = check_fast(dev)
    check_render_cost(dev)
    check_coarse(dev)
    check_pose_crop(dev)
    check_projective(dev)
    composed_nn1, composed_counts = check_composed(color_full)
    check_fine(dev)
    check_refine(dev)
    check_likelihood(depth)

    # 10. The deployment: the colour fine re-score above the fused colour
    # cost's caps (the composed cost: raster and 1-NN), then the service
    # and the camera loop as their own processes on generated zoo scenes,
    # and the same frames in process.
    fine_color_nn1, fine_color_counts = check_fine_color(dev)
    deploy, deploy_launches, render_launches = check_deploy()

    # 11. The rest of the package: the pose split across ranks (one over
    # NCCL, two sharing the card over gloo), the YCB-Video driver at full
    # width (reader, sweep, mask modes, colour, conveyor), the view
    # generator and VFH.
    t0 = time.perf_counter()
    check_sharded(depth)
    ycb = check_ycb(dev)
    views = check_views()
    check_vfh(depth)
    emit({"phase": "section", "section": 11,
          "seconds": time.perf_counter() - t0})

    # 12. The switches: the bench problem on the clustered bank
    # (PT_DECIMATE=cluster) and with the ICP's early exit off (stagnation
    # streak 10**9), each kernel against its twin, the slices and
    # the greedy detections; the ICP with early exit on and off side by
    # side; the model cache (PT_MODEL_CACHE_DIR) through three CLI runs.
    variants = check_switches(dev, depth)

    # 9. Where a batch's time goes on the device, last: the profiler's CUPTI
    # session is the one process-wide state no other phase changes.
    profile_batch(depth, "depth ROI batch")
    profile_batch(noisy, "noisy batch")
    profile_batch(gicp, "gicp batch")
    for label, bp in BRANCH_BATCHES.items():
        profile_batch(bp, label)
    require(not any(m.split(".")[0] in ("jax", "perception_tpu", "benchmarks")
                    for m in sys.modules),
            "jax or the JAX package was imported")

    def entry(name, res, count, mode=None):
        k = KERNELS[name]
        out = {"name": name, "route": "cuda", "source": k.source,
               "replaces": k.replaces, "launches": count,
               "max_abs_err": res["max_abs_err"], "ms": res["ms"],
               "device_ms": res["device_ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
               "bound_by": res["bound_by"], "library_ms": res["library_ms"]}
        if "library_call" in res:
            out["library_call"] = res["library_call"]
        if mode:
            out["mode"] = mode
        if "bound_dense_ms" in res:
            out.update(bound_dense_ms=res["bound_dense_ms"],
                       valid_pair_share=res["valid_pair_share"])
        return out

    print(json.dumps({"kernels": [
        entry(name, results[name], launches[name],
              "p2p" if name == "icp_fused" else None)
        for name in KERNELS] + [
        entry("icp_fused", icp_results[m], icp_launches[m], m)
        for m in ICP_MODES] + [
        entry("icp_fused", fast_icp, fast_served["icp_fused"],
              "p2p, model source"),
        entry("nn1_batch", composed_nn1, composed_counts["nn1_batch"],
              "composed cost"),
        entry("nn1_batch", fine_color_nn1, fine_color_counts["nn1_batch"],
              "composed cost, colour fine re-score"),
        entry("raster_direct", deploy["render"],
              render_launches["raster_direct"], DEPLOY_RENDER_CASE),
        entry("raster_direct", deploy["raster_direct"],
              deploy_launches["raster_direct"],
              f"{DEPLOY_CASE} (request and overlay)")] + [
        entry(name, deploy[name], deploy_launches[name],
              f"p2p, {DEPLOY_CASE}" if name == "icp_fused" else DEPLOY_CASE)
        for name in ("icp_fused", "cost_fused")] + [
        entry(name, ycb["phases"][name], ycb["launches"][name],
              f"p2p, {YCB_CASE}" if name == "icp_fused" else YCB_CASE)
        for name in DEPTH] + [
        entry("cost_fused_color_tri", ycb["phases"]["cost_fused_color_tri"],
              ycb["color_launches"]["cost_fused_color_tri"], YCB_COLOR_CASE),
        entry("raster_direct", views["phase"],
              views["launches"]["raster_direct"],
              f"{VIEWS_CASE} (one launch per model)")] + [
        entry(name, v["results"][name], v["launches"][name],
              f"p2p, {case}" if name == "icp_fused" else case)
        for v, case in ((variants["cluster"], CLUSTER_CASE),
                        (variants["no_exit"], NO_EXIT_CASE))
        for name in DEPTH]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
