"""A 3-DoF table-top scene for the search modes, built without JAX.

Three of the scoring benchmark's models (`bench_scene.bench_meshes` 1-3,
preprocessed for 3-DoF: base at z = 0) stand on a table at `table_height`,
at distinct (x, y, yaw) off the search grid, in front of a camera pitched
down at the table. The ground truth rendered at full resolution, degraded by
a sensor model and rounded to millimetres, is the observation: a depth image
(and colour), no instance mask.

The configuration follows the reference's 3-DoF GPU settings
(`roman_gpu_env_config.yaml`: `gpu_batch_size` 1100, `gpu_stride` 24, 15 ICP
iterations) with the EnvConfig's grid (`res` 0.04 m, `theta_res` pi/8) over
a 0.5 m x 0.6 m region; every observed point is one segment, so the costs
count the whole segment (`cost_crop_targets` 0) against each pose's own
cylinder of observed points (`use_cylinder_observed`). At stride 24 an object
shows 39-44 observed points within its circumscribed radius: a pose is valid
with 35, which also keeps every model's grid candidates under the tree
search's 512; a point is explained within 2 cm, half the grid step; and ICP
takes every rendered point (`icp_downsample` 1: with one in four, the few
points left let ICP slide poses off their objects). The blobs are not
symmetric: the search enumerates 16 yaws per cell.
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
from perception_tpu_torch.core.mesh import MeshModel, mesh_model_from_arrays
from perception_tpu_torch.core.pose import (
    CAM_TO_BODY,
    ContPose,
    euler_xyz_to_matrix,
)
from perception_tpu_torch.core.state import ObjectState
from perception_tpu_torch.eval.bench_scene import bench_meshes
from perception_tpu_torch.eval.sensor_model import by_name
from perception_tpu_torch.pipeline.env import RecognitionInput
from perception_tpu_torch.pipeline.recognizer import ObjectRecognizer

T_CAP = 1024
# The search region (world frame, m) and the table under it.
REGION = dict(x_min=0.55, x_max=1.05, y_min=-0.30, y_max=0.30)
TABLE_HEIGHT = -0.40
# The camera at the world origin, pitched down at the table (rad).
CAMERA_PITCH = 0.39
# Ground-truth (x, y, yaw) per model: 3-6 mm and 3.7-5.6 degrees off the
# nearest cell of the res / theta_res grid, at least 0.24 m apart; the
# smallest model in front.
PLACEMENTS = ((0.714, -0.005, 5.17), (0.906, 0.145, 2.42),
              (0.955, -0.143, 3.83))
# The scene's settings off the PerchConfig / EnvConfig defaults (0.01, 30
# and 4); `build_table_scene(at_defaults=...)` leaves the named ones out.
PERCH_SETTINGS = dict(sensor_resolution=0.02,
                      min_neighbor_points_for_valid_pose=35)
ENV_SETTINGS = dict(icp_downsample=1)


def camera_to_world() -> np.ndarray:
    """The optical camera frame -> world: the body frame (x forward, z up)
    pitched down by CAMERA_PITCH."""
    pitch = np.eye(4)
    pitch[:3, :3] = euler_xyz_to_matrix(0.0, CAMERA_PITCH, 0.0)
    return pitch @ CAM_TO_BODY


@dataclasses.dataclass
class TableScene:
    recognizer: ObjectRecognizer
    models: list[MeshModel]
    gt: list[ObjectState]
    rin: RecognitionInput          # the observation, 3-DoF input

    @property
    def env(self):
        return self.recognizer.env

    def errors(self, poses: list[ContPose], ids: list[int]) -> list[dict]:
        """Per detection against its ground truth: |dx|, |dy|, the (x, y)
        distance (m) and the yaw difference wrapped to [0, pi]."""
        out = []
        for pose, mid in zip(poses, ids):
            gt = self.gt[mid].pose
            rot = pose.rotation()
            yaw = float(np.arctan2(rot[1, 0], rot[0, 0]))
            out.append({"id": mid, "dx": abs(pose.x - gt.x),
                        "dy": abs(pose.y - gt.y),
                        "dxy": float(np.hypot(pose.x - gt.x, pose.y - gt.y)),
                        "dyaw": abs((yaw - gt.yaw + np.pi) % (2 * np.pi)
                                    - np.pi)})
        return out


def build_table_scene(width: int = 640, height: int = 480, stride: int = 24,
                      batch: int = 1100, use_color: bool = False,
                      env_overrides: dict | None = None,
                      at_defaults: tuple[str, ...] = (),
                      device: str | torch.device = "cuda") -> TableScene:
    """The scene at the given frame size, stride and batch (the reference's
    640x480, 24 and 1100 by default; a smaller frame at the same grid, such
    as 320x240 at stride 12, rehearses it on the CPU); use_color scores
    with the colour gate (cost type 1); `env_overrides` replace EnvConfig
    fields; `at_defaults` names the PERCH_SETTINGS and ENV_SETTINGS left at
    the configuration defaults. The
    Kinect sensor model degrades the observation with draws from
    np.random.default_rng(0), after the models'."""
    rng = np.random.default_rng(0)
    scale = width / 640.0
    cam = CameraIntrinsics(fx=1066.778 * scale, fy=1067.487 * scale,
                           cx=312.9869 * scale, cy=241.3109 * scale,
                           width=width, height=height)
    models = [mesh_model_from_arrays(name, v, f, colors=colors,
                                     use_external_pose_list=False)
              for name, v, f, colors in bench_meshes(rng, "bumpy1024",
                                                     T_CAP)[1:]]
    perch = PerchConfig(gpu_stride=stride, gpu_batch_size=batch,
                        max_icp_iterations=15, use_cylinder_observed=True,
                        use_color_cost=use_color,
                        **{k: v for k, v in PERCH_SETTINGS.items()
                           if k not in at_defaults})
    env_cfg = EnvConfig(**{
        **dict(width=width, height=height, cost_crop_targets=0),
        **{k: v for k, v in ENV_SETTINGS.items() if k not in at_defaults},
        **(env_overrides or {})})
    rec = ObjectRecognizer.from_models(models, cam, perch, env_cfg,
                                       t_cap=T_CAP, device=device)
    gt = [ObjectState(id=i, symmetric=False,
                      pose=ContPose.from_euler(x, y, TABLE_HEIGHT, 0.0, 0.0,
                                               yaw),
                      segmentation_label_id=1)
          for i, (x, y, yaw) in enumerate(PLACEMENTS)]
    c2w = camera_to_world()
    env = rec.env
    # The renders read the camera pose from the env's input.
    env._input = RecognitionInput(depth_image=np.zeros((height, width)),
                                  cam_to_world=c2w,
                                  use_external_pose_list=False)
    depth, color, _ = env.render_composite(gt)
    depth_m, color = by_name("kinect").apply(
        depth.astype(np.float64) / env.env.gpu_depth_factor, color, rng)
    # A depth camera's frame: uint16 millimetres.
    rin = RecognitionInput(
        depth_image=np.rint(depth_m * 1000.0), color_image=color,
        depth_factor=1000.0,
        cam_to_world=c2w, use_external_pose_list=False,
        table_height=TABLE_HEIGHT, **REGION)
    env._input = None
    return TableScene(recognizer=rec, models=models, gt=gt, rin=rin)
