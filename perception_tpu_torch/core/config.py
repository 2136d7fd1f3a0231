"""Configuration dataclasses: camera intrinsics, search/scoring parameters
(reference `PERCHParams`, search_env.h:106-190) and scene parameters
(`EnvParams`).

The port's own copy of `perception_tpu/core/config.py`: the same fields with
the same defaults, so a configuration means the same thing to both packages
(the JAX file's field comments give the evidence behind each default). The
file reader is `load_config` (JSON, or YAML where the module is installed),
which the CLI, the service and `load_yaml_config` read through;
`from_yaml_dict` takes an already parsed mapping. Both of the
JAX EnvConfig's profiles are copied: the speed profile `fast_profile` and
the real-sensor profile `noisy_profile`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics of the observed RGB-D camera."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def matrix(self) -> np.ndarray:
        """The 3x3 intrinsic matrix K (float32)."""
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32)

    def projection(self, near: float = 10.0, far: float = 10000.0) -> np.ndarray:
        """OpenGL-style projection from intrinsics, with the sign flips of
        `cuda_renderer::compute_proj` (renderer.cpp:199-223); near/far in
        render units (cm)."""
        w, h = float(self.width), float(self.height)
        p = np.zeros((4, 4), dtype=np.float32)
        p[0, 0] = 2 * self.fx / w
        p[0, 1] = 2 * 0.0 / w
        p[0, 2] = 2 * self.cx / w - 1.0
        p[1, 1] = -2 * self.fy / h
        p[1, 2] = 1.0 - 2 * self.cy / h
        p[2, 2] = (far + near) / (far - near)
        p[2, 3] = -2 * far * near / (far - near)
        p[3, 2] = 1.0
        return p


@dataclasses.dataclass(frozen=True)
class PerchConfig:
    """Search / scoring parameters; names follow the reference YAML keys."""

    sensor_resolution: float = 0.01           # m; NN match radius for cost
    min_neighbor_points_for_valid_pose: int = 30
    min_points_for_constraint_cloud: int = 50
    max_icp_iterations: int = 20
    icp_max_correspondence: float = 0.05      # m
    use_model_specific_search_resolution: bool = False
    icp_type: int = 3                         # 3 = integrated on-device ICP
    use_color_cost: bool = False              # CIEDE2000 gate (cost type 3)
    color_distance_threshold: float = 15.0    # CIEDE2000 units
    use_downsampling: bool = False
    downsampling_leaf_size: float = 0.01
    use_clutter_mode: bool = False
    clutter_regularizer: float = 0.1
    use_gpu: bool = True
    gpu_batch_size: int = 700                 # poses per device dispatch
    gpu_stride: int = 8                       # pixel stride for cloud sampling
    gpu_occlusion_threshold: float = 1.0      # cm
    use_tree_occlusion: bool = False
    use_cylinder_observed: bool = False
    footprint_tolerance: float = 0.05         # m
    depth_median_blur: int = 5
    vis_expanded_states: bool = False
    vis_successors: bool = False
    print_expanded_states: bool = False
    debug_verbose: bool = False
    use_rcnn_heuristic: bool = False
    use_adaptive_resolution: bool = False

    @classmethod
    def from_yaml_dict(cls, d: Mapping[str, Any]) -> "PerchConfig":
        """Build from a reference-style `perch_params:` mapping."""
        if "perch_params" in d:
            d = d["perch_params"]
        aliases = {
            "sensor_resolution_radius": "sensor_resolution",
            "visualize_expanded_states": "vis_expanded_states",
            "visualize_successors": "vis_successors",
        }
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in d.items():
            key = aliases.get(key, key)
            if key in fields:
                kwargs[key] = value
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Scene / search-space parameters and the static capacities."""

    width: int = 640
    height: int = 480
    x_min: float = -1.0
    x_max: float = 1.0
    y_min: float = -1.0
    y_max: float = 1.0
    table_height: float = 0.0
    res: float = 0.04                         # translation grid (m)
    theta_res: float = 0.3926991              # yaw grid (rad)
    use_external_pose_list: int = 0
    shift_pose_centroid: int = 0
    gpu_depth_factor: float = 100.0           # render depth units per metre
    input_depth_factor: float = 100.0
    max_triangles_per_model: int = 1024
    max_points_per_pose: int = 1024           # rendered-cloud cap per pose
    max_observed_points: int = 8192
    max_points_per_label: int = 4096          # per-segment observed cap
    max_labels: int = 32
    icp_downsample: int = 4
    roi_size: int = 0                         # strided ROI side; 0 = full frame
    icp_render_scale: int = 1
    render_lod: int = 256                     # raster-bank triangle target
    icp_crop_targets: int = 256
    icp_crop_mode: str = "near"
    icp_crop_share: str = "label"
    cost_crop_targets: int = 256
    icp_nn_every: int = 2
    icp_assoc_trigger: float = 0.004
    icp_gather: str = "take"
    icp_source: str = "render"
    icp_model_samples: int = 256
    cost_cloud: str = "transform"
    icp_stagnation_streak: int = 8
    histogram_pruning: bool = False
    voxel_pruning: bool = False
    fine_stride: int = 0
    pose_refinement_rounds: int = 0
    pose_refinement_axes: int = 12
    pose_refinement_angle: float = 0.25       # rad
    fine_top_k: int = 8
    icp_mode: str = "auto"
    cost_aug_samples: int = 0
    icp_exact_nn_every: int = 1
    icp_d2d_symmetric: bool = False
    icp_gicp_epsilon: float = 0.05
    kernel_backend: str = "auto"

    @classmethod
    def from_yaml_dict(cls, d: Mapping[str, Any]) -> "EnvConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def fast_profile(self) -> "EnvConfig":
        """The documented speed profile: the render-free ICP source (surface
        samples behind a facing-cosine mask), a stagnation streak of 5 and a
        128-target crop (the JAX package measured each a small, not
        significant AUC loss, for about +25% throughput together)."""
        return dataclasses.replace(
            self, icp_source="model", icp_stagnation_streak=5,
            icp_crop_targets=128)

    def noisy_profile(self) -> "EnvConfig":
        """The documented real-sensor profile: the exact-covariance fused
        D2D refiner (the JAX package measured it +3.21 [+1.06, +5.34] paired
        AUC over the point-to-plane default under its Kinect noise model, and
        not better noise-free), for physical depth cameras."""
        return dataclasses.replace(self, icp_mode="fused_d2d_exact")


def load_config(path: str) -> dict:
    """A config file's mapping: YAML by extension (needs the `yaml` module),
    JSON otherwise (a JSON file is also valid YAML)."""
    with open(path) as f:
        if not path.endswith((".yaml", ".yml")):
            return json.load(f)
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(
                f"{path}: a YAML config needs the 'yaml' module (PyYAML), "
                "which is not installed; give the config as .json") from e
        return yaml.safe_load(f)


def load_yaml_config(path: str) -> tuple[PerchConfig, EnvConfig]:
    """(PerchConfig, EnvConfig) from one config file's top-level keys."""
    raw = load_config(path)
    return PerchConfig.from_yaml_dict(raw), EnvConfig.from_yaml_dict(raw)
