"""The reference's REAL captured demo frame as a reusable workload.

The port's copy of `perception_tpu/eval/demo_frame.py`; the env it builds
runs on the card unless given device="cpu", and the capture's PNGs are read
by `io/images.py`. The capture lives in the reference's checkout
(PERCH_REFERENCE_ROOT, default ~/reference); `available()` says whether it
is there.

The reference ships one real Kinect capture in-tree
(`sbpl_perception/demo/demo_depth.png`, 16-bit 0.1 mm units, + RGB):
a conference-table scene with an orange Tide jug, a white Tilex spray
bottle and a small white cup, localised by its `demo.cpp` via the 3-DoF
search path. This module packages that frame — real noise, holes,
clutter, a background person — as a workload both the example script
(`examples/demo_reference_scene.py`) and the regression test
(`tests/test_demo_frame.py`) drive:

  * Kinect V1 intrinsics (camera_config.yaml: fx=fy=576.0976),
  * demo camera pose + world-frame table bounds (demo.cpp:26-49),
    composed with the optical->body rotation exactly as the reference's
    image-input path does (search_env.cpp:5941-5950),
  * 16-bit depth read + depth_factor per the image branch
    (search_env.cpp:5887-5915).

The reference's CAD meshes for these objects are not shipped in its repo
(resolved from external rosparam paths), so primitive PROXY models sized
to the products stand in. No ground truth exists for the capture either,
so `run_oracle()` manufactures an internal pseudo-GT: the same search at
a much finer grid/stride, frozen in-tree (tests/data/
demo_frame_pseudo_gt.json) — real-sensor regression coverage the
synthetic zoo cannot give (poses only move if the pipeline's behaviour
on real data moves).
"""

from __future__ import annotations

import json
import os

import numpy as np

DEMO_DIR = os.path.join(
    os.environ.get("PERCH_REFERENCE_ROOT",
                   os.path.join(os.path.expanduser("~"), "reference")),
    "sbpl_perception", "demo")

# demo.cpp:26-30 — camera BODY pose in the world frame.
CAMERA_POSE = np.array([
    [0.00974155, 0.997398, -0.0714239, -0.031793],
    [-0.749216, -0.040025, -0.661116, 0.743224],
    [-0.662254, 0.0599522, 0.746877, 0.878005],
    [0.0, 0.0, 0.0, 1.0]])

# demo.cpp:45-50 — world-frame search bounds over the table.
BOUNDS = dict(x_min=-0.179464, x_max=0.141014,
              y_min=-0.397647, y_max=0.0103991, table_height=0.0)

# search_env.cpp:5941-5950 — optical -> body frame.
CAM_TO_BODY = np.array([[0, 0, 1, 0], [-1, 0, 0, 0],
                        [0, -1, 0, 0], [0, 0, 0, 1]], np.float64)

PSEUDO_GT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "data",
    "demo_frame_pseudo_gt.json")


def available() -> bool:
    return os.path.exists(os.path.join(DEMO_DIR, "demo_depth.png"))


def _cylinder(r, h, n=24):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.c_[r * np.cos(ang), r * np.sin(ang)]
    verts = np.r_[np.c_[ring, np.zeros(n)], np.c_[ring, np.full(n, h)],
                  [[0, 0, 0]], [[0, 0, h]]]
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + i], [j, n + j, n + i],        # wall
                  [2 * n, j, i], [2 * n + 1, n + i, n + j]]  # caps
    return verts, np.asarray(faces)


def _box(w, d, h):
    x, y = w / 2, d / 2
    verts = np.array([
        [-x, -y, 0], [x, -y, 0], [x, y, 0], [-x, y, 0],
        [-x, -y, h], [x, -y, h], [x, y, h], [-x, y, h]])
    faces = np.array([
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    return verts, faces


def build_models():
    """Primitive proxies sized to the real products in the frame."""
    from perception_tpu_torch.core.mesh import mesh_model_from_arrays

    # Tide 50-oz jug: rounded carton ~ 18 x 11 cm footprint, 26 cm tall.
    v, f = _box(0.18, 0.11, 0.26)
    tide = mesh_model_from_arrays(
        "tide", v, f, colors=np.tile([225.0, 90, 40], (len(v), 1)))
    # Tilex spray bottle: body cylinder ~ 9.5 cm diameter, 26 cm overall.
    v, f = _cylinder(0.048, 0.26)
    tilex = mesh_model_from_arrays(
        "tilex_spray", v, f, colors=np.tile([235.0, 235, 240], (len(v), 1)),
        symmetric=True)
    # Small cup: ~ 7 cm diameter, 10 cm tall.
    v, f = _cylinder(0.035, 0.10)
    glass = mesh_model_from_arrays(
        "glass_7", v, f, colors=np.tile([240.0, 240, 245], (len(v), 1)),
        symmetric=True)
    return [tide, tilex, glass]


def build_env(stride: int = 4, res: float = 0.02,
              theta_res: float = np.pi / 8, batch: int = 512,
              device="cuda"):
    """The demo deployment config at a parameterised grid/stride.

    Defaults are the example's config (roman_gpu_env_config.yaml
    semantics: sensor_resolution 0.02, occlusion flagging off, colour
    cost on — the depth-only cost cannot tell a 26 cm orange jug from a
    26 cm white bottle). stride/res scale the work for the oracle
    (finer) and the regression test (coarser).
    """
    from perception_tpu_torch.core.config import (
        CameraIntrinsics, EnvConfig, PerchConfig)
    from perception_tpu_torch.core.mesh import ModelBank
    from perception_tpu_torch.pipeline.env import PerceptionEnv

    cam = CameraIntrinsics(fx=576.09757860, fy=576.09757860,
                           cx=321.06398107, cy=242.97676897,
                           width=640, height=480)
    bank = ModelBank.from_models(build_models(), t_cap=128)
    env = PerceptionEnv(
        bank, cam,
        PerchConfig(gpu_stride=stride, gpu_batch_size=batch,
                    sensor_resolution=0.02,
                    gpu_occlusion_threshold=100.0,
                    use_color_cost=True,
                    color_distance_threshold=18.0,
                    # demo_env_config.yaml scales 500 neighbours at full
                    # res; keep the fraction constant across strides.
                    min_neighbor_points_for_valid_pose=max(
                        2, int(500 / (stride * stride))),
                    ),
        EnvConfig(width=cam.width, height=cam.height,
                  res=res, theta_res=theta_res,
                  max_labels=2, max_points_per_label=8192,
                  max_observed_points=8192, max_points_per_pose=2048,
                  icp_downsample=2),
        device=device)
    return env


def load_input(env) -> None:
    """Feed the real capture through the image-input path."""
    from perception_tpu_torch.io.images import read_png, read_rgb
    from perception_tpu_torch.pipeline.env import RecognitionInput

    depth = read_png(os.path.join(DEMO_DIR, "demo_depth.png"))
    rgb = read_rgb(os.path.join(DEMO_DIR, "demo_rgb.png"))
    assert depth.dtype == np.uint16 and depth.shape == (480, 640)
    rin = RecognitionInput(
        depth_image=depth.astype(np.float64),
        color_image=rgb.astype(np.float64),
        depth_factor=10000.0,          # 0.1 mm units in this capture
        cam_to_world=CAMERA_POSE @ CAM_TO_BODY,
        segmented_object_names=[m.name for m in env.bank.models],
        use_external_pose_list=False,   # 3-DoF bounds-filtered mode
        **BOUNDS)
    env.set_input(rin)
    return depth, rgb


def localise(env):
    """Full 3-DoF search on the loaded frame; returns (state, chosen).

    Uses the collision commit ordering (the reference greedy-ICP
    baseline's permutation commit, search_env.cpp:6500-6766): with no
    segmentation labels the two white proxies otherwise race for the
    same physical object.
    """
    candidates = env.generate_successors_3dof()
    return env.compute_greedy_poses(candidates, do_icp=False,
                                    collision_ordering=True)


def run_oracle(write: bool = True, device="cuda") -> dict:
    """Best-effort oracle: the same search at a 2x finer grid, 2x finer
    stride and 2x finer yaw than the deployment config. No external GT
    exists for this capture, so the oracle's poses are frozen in-tree as
    pseudo-GT for the regression test (VERDICT r3 #7)."""
    env = build_env(stride=2, res=0.01, theta_res=np.pi / 16, batch=512,
                    device=device)
    load_input(env)
    state, chosen = localise(env)
    assert state.num_objects == 3
    gt = {}
    for sel, su in zip(state.object_states, chosen):
        gt[env.bank.models[sel.id].name] = {
            "x": round(float(sel.pose.x), 4),
            "y": round(float(sel.pose.y), 4),
            "yaw": round(float(sel.pose.yaw), 4),
            "cost": int(su.cost),
        }
    out = {"config": "oracle stride=2 res=0.01 theta=pi/16", "poses": gt}
    if write:
        os.makedirs(os.path.dirname(PSEUDO_GT_PATH), exist_ok=True)
        with open(PSEUDO_GT_PATH, "w") as f:
            json.dump(out, f, indent=2)
    return out


def load_pseudo_gt() -> dict | None:
    if not os.path.exists(PSEUDO_GT_PATH):
        return None
    with open(PSEUDO_GT_PATH) as f:
        return json.load(f)
