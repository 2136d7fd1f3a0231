"""The scoring benchmark's problem, built without JAX.

The same scene as `benchmarks/bench_scene.py:build_bench_problem` from the
same seed: four blob models (the bank padded to t_cap), three ground-truth
objects rendered at 640x480 as the observation (degraded by a sensor model
when one is named), and n_poses candidates that perturb the ground truth by
2 cm / 0.15 rad. Settings come as arguments (the
JAX version reads BENCH_* / PT_* environment variables; their defaults are
the values used here). `convex_blob` and `bumpy_blob` are this module's own
copies of the JAX benchmark's model generators.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perception_tpu_torch.core.config import (
    CameraIntrinsics,
    EnvConfig,
    PerchConfig,
)
from perception_tpu_torch.core.mesh import (
    ModelBank,
    decimate,
    mesh_model_from_arrays,
)
from perception_tpu_torch.core.pose import (
    ContPose,
    euler_xyz_to_matrix,
    matrix_to_quat,
)
from perception_tpu_torch.core.state import ObjectState
from perception_tpu_torch.eval.sensor_model import by_name
from perception_tpu_torch.pipeline.env import PerceptionEnv
from perception_tpu_torch.pipeline.scorer import (
    PoseScores,
    ScorerConfig,
    score_pose_batch,
)


@dataclasses.dataclass
class BenchProblem:
    env: PerceptionEnv
    candidates: list[ObjectState]
    gt: list[ObjectState]         # the three scene objects (label i + 1)
    args: tuple                   # score_pose_batch positional inputs
    cfg: ScorerConfig
    sensor: str = "none"          # eval.sensor_model name of the observation
    seed: int = 0
    use_lab: bool = True          # pass the env's face Lab table (colour
                                  # cost: the fused kernels; without it the
                                  # composed cost)

    def observe(self, env: PerceptionEnv) -> None:
        """Give `env` this problem's observation: the ground truth rendered,
        degraded by the sensor model with the JAX benchmark's rng."""
        if self.sensor in ("none", "off", ""):
            env.set_observation_from_states(self.gt)
        else:
            env.set_observation_from_states(
                self.gt, sensor=by_name(self.sensor),
                rng=np.random.default_rng((self.seed, 0xC0FFEE)))

    @property
    def bank_inputs(self) -> dict:
        """score_pose_batch's bank keyword inputs, as the env passes them
        (the face Lab table where use_lab)."""
        env = self.env
        return dict(bank_backface=env._render_bank[3],
                    bank_icp_samples=env._bank_icp_samples,
                    bank_icp_normals=env._bank_icp_normals,
                    bank_tri_lab=env._render_bank_lab if self.use_lab
                    else None)

    def score(self, n: int | None = None,
              cfg: ScorerConfig | None = None) -> PoseScores:
        """Score the first n candidates (all by default) in one batch, with
        this problem's configuration or `cfg`."""
        (verts, colors, valid, poses, ids, labels, totals, proj,
         scene) = self.args
        sl = slice(None, n)
        return score_pose_batch(
            verts, colors, valid, poses[sl], ids[sl], labels[sl], totals[sl],
            proj, scene, cfg or self.cfg, **self.bank_inputs)

    def first_call(self, module, attr: str,
                   cfg: ScorerConfig | None = None) -> tuple:
        """The (args, kwargs) of the first call that scoring this problem
        (with `cfg` if given) makes to module.attr."""
        seen = {}
        wrapped = getattr(module, attr)

        def record(*args, **kwargs):
            seen.setdefault("call", (args, kwargs))
            return wrapped(*args, **kwargs)

        setattr(module, attr, record)
        try:
            self.score(cfg=cfg)
        finally:
            setattr(module, attr, wrapped)
        return seen["call"]


def convex_blob(rng, radius=0.06, n_pts=600):
    """Convex hull of n_pts jittered points on a sphere."""
    from scipy.spatial import ConvexHull

    pts = rng.normal(size=(n_pts, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= radius * rng.uniform(0.7, 1.3, (n_pts, 1))
    return pts, ConvexHull(pts).simplices


def bumpy_blob(rng, radius=0.06, target=1024):
    """Non-convex ~target-triangle model: an icosphere (5120 faces) with
    smooth radial bumps, decimated to the cap."""
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(4):                       # 20 -> 5120 faces
        mids, verts, out = {}, list(v), []

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in mids:
                mids[k] = len(verts)
                verts.append((verts[a] + verts[b]) / 2)
            return mids[k]

        for (a, b, c) in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v, f = np.asarray(verts, float), np.asarray(out)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    # Smooth low-order radial field: non-convex lobes, still star-shaped.
    freq = rng.uniform(1.5, 3.5, (3, 3))
    phase = rng.uniform(0, 2 * np.pi, 3)
    r = 1.0 + 0.22 * np.sum(
        [np.sin(v @ freq[i] + phase[i]) for i in range(3)], axis=0) / 3
    v = v * (radius * r[:, None])
    dv, df, _ = decimate(v, f, None, target)
    return dv, df


def bench_meshes(rng: np.random.Generator, model_kind: str = "blob",
                 t_cap: int = 1024) -> list[tuple]:
    """The four bench models as (name, vertices [V, 3], faces [F, 3],
    vertex colours [V, 3] in 0..255), drawn from rng in the JAX benchmark's
    order."""
    meshes = []
    for i in range(4):
        if model_kind == "bumpy1024":
            v, f = bumpy_blob(rng, radius=0.05 + 0.015 * i, target=t_cap)
        elif model_kind == "blob":
            v, f = convex_blob(rng, radius=0.05 + 0.015 * i)
        else:
            raise ValueError(f"unknown model_kind {model_kind!r}")
        meshes.append((f"blob{i}", v, f, rng.uniform(40, 220, (len(v), 3))))
    return meshes


def build_bench_problem(n_poses: int = 512, t_cap: int = 1024,
                        width: int = 640, height: int = 480, stride: int = 8,
                        seed: int = 0, model_kind: str = "blob",
                        use_color: bool = False, roi_size: int = 32,
                        icp_mode: str = "auto", sensor: str = "none",
                        kernel_backend: str = "auto",
                        env_overrides: dict | None = None,
                        device: str | torch.device = "cuda") -> BenchProblem:
    """model_kind: "blob" (convex hulls) or "bumpy1024" (~t_cap-triangle
    non-convex models), as BENCH_MODELS selects for the JAX version;
    use_color: the CIEDE2000-gated cost (PT_USE_COLOR); roi_size: the
    strided ROI side, 0 for the full frame; icp_mode: the EnvConfig ICP mode
    (PT_ICP_MODE; "fused_d2d_exact" is the real-sensor profile); sensor: the
    eval.sensor_model degrading the observation (PT_SENSOR, e.g. "kinect");
    kernel_backend: the EnvConfig raster backend (the JAX version's is
    "auto"); env_overrides: further EnvConfig fields (the JAX version's
    PT_* variables)."""
    rng = np.random.default_rng(seed)
    cam = CameraIntrinsics(fx=1066.778, fy=1067.487, cx=312.9869,
                           cy=241.3109, width=width, height=height)
    models = [mesh_model_from_arrays(name, v, f, colors=colors,
                                     use_external_pose_list=True)
              for name, v, f, colors in bench_meshes(rng, model_kind, t_cap)]
    bank = ModelBank.from_models(models, t_cap=t_cap)
    perch = PerchConfig(gpu_stride=stride, gpu_batch_size=n_poses,
                        sensor_resolution=0.01,
                        min_neighbor_points_for_valid_pose=8,
                        use_color_cost=use_color)
    env_cfg = EnvConfig(width=width, height=height, max_points_per_pose=1024,
                        max_observed_points=8192, max_points_per_label=1024,
                        max_labels=4, roi_size=roi_size,
                        kernel_backend=kernel_backend,
                        icp_mode=icp_mode, **(env_overrides or {}))
    env = PerceptionEnv(bank, cam, perch, env_cfg, device=device)

    gt = []
    for i in range(3):
        pose = ContPose.from_quat(
            0.55 + 0.12 * i, -0.25 + 0.22 * i, 0.02 * i,
            *matrix_to_quat(euler_xyz_to_matrix(*rng.uniform(-1.5, 1.5, 3))))
        gt.append(ObjectState(id=i, symmetric=False, pose=pose,
                              segmentation_label_id=i + 1))
    problem = BenchProblem(env=env, candidates=[], gt=gt, args=(), cfg=None,
                           sensor=sensor, seed=seed)
    problem.observe(env)

    cands = []
    for k in range(n_poses):
        base = gt[k % 3]
        jt = rng.normal(0, 0.02, 3)
        rot = (euler_xyz_to_matrix(*rng.normal(0, 0.15, 3))
               @ base.pose.rotation())
        pose = ContPose.from_quat(base.pose.x + jt[0], base.pose.y + jt[1],
                                  base.pose.z + jt[2], *matrix_to_quat(rot))
        cands.append(ObjectState(
            id=base.id, symmetric=False, pose=pose,
            segmentation_label_id=base.segmentation_label_id))

    cfg = env._scorer_config(do_icp=True)
    seg_count = env._observed.seg_count.cpu().numpy().astype(np.float32)
    poses = env.poses_to_camera(cands)
    ids = np.asarray([s.id for s in cands], np.int64)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands], np.int64)
    dev = env._tensor
    rb_verts, rb_colors, rb_valid, _ = env._render_bank
    args = (rb_verts, rb_colors, rb_valid, dev(poses), dev(ids), dev(labels),
            dev(seg_count[labels]), env._proj, env._scene)
    return dataclasses.replace(problem, candidates=cands, args=args, cfg=cfg)
