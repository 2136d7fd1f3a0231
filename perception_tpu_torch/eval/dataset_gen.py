"""Synthetic ground-truth scene generation.

The port's copy of `perception_tpu/eval/dataset_gen.py`: the reference's
`DatasetGenerator` (sbpl_perception/src/utils/dataset_generator.cpp: random
valid object placements rendered to labelled depth scenes), rendered through
the port env's `render_composite` (the direct raster kernel on the card).
The same seed draws the same placements as the JAX package. PNGs are
written by `io.images.write_png` (colour in RGB order, as the JAX package's
files decode), `.mat` files by `scipy.io.savemat`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
from scipy.io import savemat

from perception_tpu_torch.core.pose import ContPose
from perception_tpu_torch.core.state import ObjectState
from perception_tpu_torch.eval.model_zoo import zoo_raw_geometry
from perception_tpu_torch.io.images import write_png


@dataclasses.dataclass
class GeneratedScene:
    states: list[ObjectState]
    depth: np.ndarray        # [H, W] int32 cm
    color: np.ndarray        # [H, W, 3]
    label: np.ndarray        # [H, W] int32 1-based instance ids


class DatasetGenerator:
    def __init__(self, env, rng: np.random.Generator | None = None):
        """env: a PerceptionEnv whose model bank supplies the objects."""
        self.env = env
        self.rng = rng or np.random.default_rng(0)

    def sample_scene(
        self,
        num_objects: int | None = None,
        x_range: tuple[float, float] = (0.45, 0.75),
        y_range: tuple[float, float] = (-0.2, 0.2),
        z_range: tuple[float, float] = (-0.05, 0.05),
        yaw_only: bool = False,
        min_separation: float = 0.08,
        max_attempts: int = 100,
    ) -> GeneratedScene:
        """Random non-overlapping placements of distinct models, rendered to
        a labelled observation (dataset_generator.cpp GenerateHaltonPoses /
        GenerateScenes semantics, with rejection instead of Halton
        sequences)."""
        bank = self.env.bank
        n_models = len(bank.models)
        count = num_objects or self.rng.integers(1, n_models + 1)
        count = min(count, n_models)
        model_ids = self.rng.choice(n_models, size=count, replace=False)

        states: list[ObjectState] = []
        placed: list[np.ndarray] = []
        for mid in model_ids:
            for _ in range(max_attempts):
                pos = np.array([
                    self.rng.uniform(*x_range),
                    self.rng.uniform(*y_range),
                    self.rng.uniform(*z_range),
                ])
                if all(np.linalg.norm(pos[:2] - p[:2]) >= min_separation
                       for p in placed):
                    break
            else:
                continue
            placed.append(pos)
            if yaw_only:
                pose = ContPose.from_euler(
                    *pos, 0.0, 0.0, self.rng.uniform(0, 2 * np.pi))
            else:
                q = self.rng.normal(size=4)
                q /= np.linalg.norm(q)
                pose = ContPose.from_quat(*pos, *q)
            states.append(ObjectState(
                id=int(mid), symmetric=bank.models[mid].symmetric, pose=pose,
                segmentation_label_id=len(states) + 1))

        depth, color, label = self.env.render_composite(states)
        return GeneratedScene(states=states, depth=depth, color=color,
                              label=label)

    def write_scene(self, scene: GeneratedScene, out_dir: str,
                    name: str = "scene") -> dict:
        """Persist a generated scene as depth/color/label PNGs + GT json
        (depth in mm: `depth_factor` 1000)."""
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, f"{name}-depth.png"),
                  (scene.depth * 10).astype(np.uint16))  # cm -> mm png
        write_png(os.path.join(out_dir, f"{name}-color.png"),
                  scene.color.astype(np.uint8))
        write_png(os.path.join(out_dir, f"{name}-label.png"),
                  scene.label.astype(np.uint8))
        gt = {
            "objects": [
                {
                    "name": self.env.bank.models[s.id].name,
                    "pose": [s.pose.x, s.pose.y, s.pose.z,
                             *s.pose.quaternion()],
                    "label": s.segmentation_label_id,
                }
                for s in scene.states
            ],
            "depth_factor": 1000,
        }
        with open(os.path.join(out_dir, f"{name}-gt.json"), "w") as f:
            json.dump(gt, f, indent=2)
        return gt


# --------------------------------------------------------------------------
# YCB-Video directory-layout export
# --------------------------------------------------------------------------

def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    """Indexed ASCII PLY with optional per-vertex uchar colours."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    color_props = ("property uchar red\nproperty uchar green\n"
                   "property uchar blue\n" if colors is not None else "")
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"{color_props}"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n")
    with open(path, "w") as f:
        f.write(header)
        for i, v in enumerate(verts):
            if colors is not None:
                c = np.asarray(colors[i]).astype(int)
                f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def write_zoo_plys(root: str, name_map: dict[str, str],
                   resolution: float = 1.0) -> dict[str, str]:
    """Export zoo shapes as `<root>/models/<name>/textured.ply` (the
    YCB_Video_Dataset models layout) and return name -> path.

    name_map maps the on-disk model name (e.g. "024_bowl") to a zoo shape
    key (e.g. "bowl"), so a generated dataset can carry real YCB class
    names — which routes symmetric objects through the ADD-S metric and
    the YCB_SYMMETRY rotation-sampling table exactly as a real dataset
    would (fat_pose_image.py model loading)."""
    out: dict[str, str] = {}
    for name, zoo_key in name_map.items():
        d = os.path.join(root, "models", name)
        os.makedirs(d, exist_ok=True)
        v, f, c, _sym = zoo_raw_geometry(zoo_key, resolution=resolution)
        path = os.path.join(d, "textured.ply")
        write_ply(path, v, f, c)
        out[name] = path
    return out


def write_ycb_layout(root: str, env, scenes: "list[GeneratedScene]",
                     depth_factor: float = 10000.0) -> list[tuple[str, str]]:
    """Persist generated scenes as a frozen on-disk dataset in the exact
    YCB-Video directory layout the reference's run_ycb_6d driver reads
    (fat_pose_image.py:3307-3440):

        image_sets/classes.txt          class-id order (bank model order)
        image_sets/keyframe.txt         "SSSS/FFFFFF" per frame
        data/SSSS/FFFFFF-color.png      RGB
        data/SSSS/FFFFFF-depth.png      uint16, metres * depth_factor
        data/SSSS/FFFFFF-label.png      uint8 CLASS ids (not instance ids)
        data/SSSS/FFFFFF-meta.mat       cls_indexes, poses [3,4,n]
                                        (raw model frame -> camera),
                                        intrinsic_matrix, factor_depth

    Scene i becomes data/{i+1:04d}/000001-*. Returns the keyframe list.
    env must be the environment the scenes were rendered with (its
    camera + model preprocessing define the GT pose frames)."""
    names = [m.name for m in env.bank.models]
    os.makedirs(os.path.join(root, "image_sets"), exist_ok=True)
    with open(os.path.join(root, "image_sets", "classes.txt"), "w") as f:
        f.write("\n".join(names) + "\n")

    keyframes: list[tuple[str, str]] = []
    for i, scene in enumerate(scenes):
        sdir, fid = f"{i + 1:04d}", "000001"
        os.makedirs(os.path.join(root, "data", sdir), exist_ok=True)
        base = os.path.join(root, "data", sdir, fid)
        depth_m = scene.depth.astype(np.float64) / 100.0   # cm -> m
        write_png(base + "-depth.png",
                  np.round(depth_m * depth_factor).astype(np.uint16))
        write_png(base + "-color.png", scene.color.astype(np.uint8))
        # render_composite labels are 1-based indices into scene.states;
        # the YCB label image carries CLASS ids (classes.txt order,
        # 1-based).
        class_label = np.zeros_like(scene.label, dtype=np.uint8)
        for j, s in enumerate(scene.states):
            class_label[scene.label == j + 1] = s.id + 1
        write_png(base + "-label.png", class_label)

        poses = env.poses_to_camera(scene.states)[:, :3].transpose(
            1, 2, 0).astype(np.float64)
        cls = [s.id + 1 for s in scene.states]
        savemat(base + "-meta.mat", {
            "cls_indexes": np.asarray(cls).reshape(-1, 1),
            "poses": poses,
            "intrinsic_matrix": env.camera.matrix().astype(np.float64),
            "factor_depth": np.asarray([[depth_factor]]),
        })
        keyframes.append((sdir, fid))

    with open(os.path.join(root, "image_sets", "keyframe.txt"), "w") as f:
        for sdir, fid in keyframes:
            f.write(f"{sdir}/{fid}\n")
    return keyframes
