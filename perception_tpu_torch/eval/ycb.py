"""YCB-Video dataset loading and the 6-DoF evaluation driver.

The port's copy of `perception_tpu/eval/ycb.py` (host NumPy and SciPy, as
there; the recogniser it drives runs on its env's device). It replaces the
reference's Python experiment layer (fat_dataset/fat_pose_image.py:
run_ycb_6d at :3307, visualize_sphere_sampling at :1456) minus the
ROS / MaskRCNN plumbing:

  * dataset access in the standard YCB-Video layout
    (data/SSSS/FFFFFF-{color.png,depth.png,label.png,meta.mat} +
    image_sets/keyframe.txt + classes.txt). PNGs are read by
    `io/images.py` (no OpenCV): the colour image comes as RGB, as the JAX
    reader flips OpenCV's BGR;
  * candidate generation: per-object mask centroid unprojected at depth
    layers min..max mask depth (2 cm resolution; 1 cm for scissors),
    crossed with fibonacci-sphere rotation samples under the object's
    symmetry mode (fat_pose_image.py:1633-1660);
  * accuracy: ADD / ADD-S against GT poses from meta.mat, aggregated with
    the YCB toolbox AUC protocol. The masks come from the GT label image,
    PoseCNN results or COCO detections (`io/masks.py`), the reference's
    mask modes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.core.pose import euler_xyz_to_matrix, matrix_to_quat
from perception_tpu_torch.eval.metrics import (
    add_err,
    adi_err,
    compute_pose_metrics,
)
from perception_tpu_torch.eval.sampling import get_rotation_samples
from perception_tpu_torch.io.images import read_grey, read_rgb

# Objects scored with ADD-S (symmetric) in the YCB-Video protocol.
YCB_ADDS_OBJECTS = {
    "024_bowl", "036_wood_block", "051_large_clamp",
    "052_extra_large_clamp", "061_foam_brick",
}

YCB_CAMERA = CameraIntrinsics(
    fx=1066.778, fy=1067.487, cx=312.9869, cy=241.3109, width=640, height=480)
YCB_DEPTH_FACTOR = 10000.0


@dataclasses.dataclass
class YCBFrame:
    scene: str
    frame: str
    color: np.ndarray          # [H, W, 3] uint8 RGB
    depth: np.ndarray          # [H, W] uint16 (factor 10000)
    label: np.ndarray          # [H, W] uint8 class ids
    gt_poses: dict[str, np.ndarray]   # name -> [4, 4] model->camera
    intrinsics: CameraIntrinsics
    class_list: list[str] | None = None   # label-image class-id order


class YCBVideoDataset:
    """Standard YCB-Video directory layout reader."""

    def __init__(self, root: str):
        self.root = root
        classes_file = os.path.join(root, "image_sets", "classes.txt")
        with open(classes_file) as f:
            self.classes = [l.strip() for l in f if l.strip()]

    def keyframes(self) -> list[tuple[str, str]]:
        path = os.path.join(self.root, "image_sets", "keyframe.txt")
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    scene, frame = line.split("/")
                    out.append((scene, frame))
        return out

    def load_frame(self, scene: str, frame: str) -> YCBFrame:
        from scipy.io import loadmat

        base = os.path.join(self.root, "data", scene, frame)
        color = read_rgb(base + "-color.png")
        depth = read_grey(base + "-depth.png")
        label = read_grey(base + "-label.png")
        meta = loadmat(base + "-meta.mat")
        intr = meta.get("intrinsic_matrix")
        cam = YCB_CAMERA
        if intr is not None:
            cam = CameraIntrinsics(
                fx=float(intr[0, 0]), fy=float(intr[1, 1]),
                cx=float(intr[0, 2]), cy=float(intr[1, 2]),
                width=color.shape[1], height=color.shape[0])
        gt = {}
        cls_idx = meta["cls_indexes"].ravel().astype(int)
        rt = meta["poses"]  # [3, 4, n]
        for i, ci in enumerate(cls_idx):
            mat = np.eye(4)
            mat[:3, :] = rt[:, :, i]
            gt[self.classes[ci - 1]] = mat
        return YCBFrame(scene=scene, frame=frame, color=color, depth=depth,
                        label=np.asarray(label), gt_poses=gt, intrinsics=cam,
                        class_list=self.classes)


def mask_from_labels(label_img: np.ndarray,
                     class_ids: list[int]) -> np.ndarray:
    """Class-id label image -> 1-based instance mask in required-object order
    (visualize_sphere_sampling's overall_binary_mask, :1546-1567)."""
    out = np.zeros_like(label_img, dtype=np.int32)
    for i, ci in enumerate(class_ids):
        out[label_img == ci] = i + 1
    return out


def generate_candidates(
    depth: np.ndarray,
    instance_mask: np.ndarray,
    object_names: list[str],
    camera: CameraIntrinsics,
    depth_factor: float = YCB_DEPTH_FACTOR,
    num_samples: int = 60,
    cam_to_world: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """Per-object candidate pose rows [K, 7] (the poses.txt contract): the
    mask's 2D centroid unprojected at min..max mask depth in `resolution`
    layers, crossed with the symmetry-aware rotation samples. Object i is
    instance i + 1 of the mask; an object without depth in its mask gets
    no entry."""
    out: dict[str, np.ndarray] = {}
    for i, name in enumerate(object_names):
        mask = instance_mask == (i + 1)
        obj_depth = np.where(mask, depth, 0).astype(np.float64)
        nz = obj_depth[obj_depth > 0]
        if nz.size == 0:
            continue
        min_depth = nz.min() / depth_factor
        max_depth = nz.max() / depth_factor
        ys, xs = np.nonzero(mask)
        centroid = np.array([xs.mean(), ys.mean()])

        resolution = 0.01 if name == "037_scissors" else 0.02
        rotations = get_rotation_samples(name, num_samples)
        quats = [matrix_to_quat(euler_xyz_to_matrix(*r)) for r in rotations]

        rows = []
        for d in np.arange(min_depth, max_depth + resolution, resolution):
            x = (centroid[0] - camera.cx) / camera.fx * d
            y = (centroid[1] - camera.cy) / camera.fy * d
            point = np.array([x, y, d, 1.0])
            if cam_to_world is not None:
                point = cam_to_world @ point
            for q in quats:
                rows.append([point[0], point[1], point[2], *q])
        out[name] = np.asarray(rows)
    return out


@dataclasses.dataclass
class FrameResult:
    scene: str
    frame: str
    errors: dict[str, float]          # per-object ADD(-S) error (m)
    add_errors: dict[str, float]
    adis_errors: dict[str, float]
    runtime: float
    detected: list[str]
    # The detections as poses.txt rows [1, 7] (x y z qx qy qz qw), by name:
    # the conveyor's warm start (eval/workloads.py).
    detected_poses: dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)


def frame_masks(recognizer, frame: YCBFrame,
                object_names: list[str] | None = None,
                mask_mode: str = "gt", posecnn_root: str | None = None,
                detections_json: str | None = None
                ) -> tuple[np.ndarray, list[str]]:
    """The frame's 1-based instance mask and its object names by mask_mode
    (the reference's mask_type, fat_pose_image.py): "gt" from the frame's
    GT label image; "posecnn" from `<posecnn_root>/<NNNNNN>.mat` PoseCNN
    results (get_posecnn_mask:1322); "detections" from MaskRCNN-style COCO
    detections in detections_json. The names default to the frame's GT
    objects the recogniser's bank knows."""
    from perception_tpu_torch.io.masks import (
        load_coco_detections,
        load_posecnn_mat,
    )

    names = object_names or [n for n in frame.gt_poses
                             if n in recognizer.bank.names]
    if mask_mode == "gt":
        class_ids = [recognizer_class_id(recognizer, frame, n) for n in names]
        return mask_from_labels(frame.label, class_ids), names
    class_list = frame.class_list or getattr(frame, "_class_list", None)
    if mask_mode == "posecnn":
        if posecnn_root is None:
            raise ValueError("mask_mode='posecnn' needs posecnn_root")
        det = load_posecnn_mat(
            os.path.join(posecnn_root, f"{int(frame.frame):06d}.mat"),
            class_list)
    elif mask_mode == "detections":
        if detections_json is None:
            raise ValueError("mask_mode='detections' needs detections_json")
        det = load_coco_detections(
            detections_json, class_list=class_list,
            file_name=f"{frame.scene}/{frame.frame}-color.png",
            height=frame.color.shape[0], width=frame.color.shape[1])
    else:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    return det.label_mask(required_objects=names)


def localize_and_score(recognizer, frame: YCBFrame, instance_mask, names,
                       pose_lists: dict[str, np.ndarray],
                       output_dir: str | None = None) -> FrameResult:
    """Greedy recognition of `names` (instances 1.. of instance_mask) from
    the candidate rows `pose_lists`, scored ADD / ADD-S against the frame's
    GT (ADD-S for YCB_ADDS_OBJECTS)."""
    from perception_tpu_torch.pipeline.env import RecognitionInput

    rin = RecognitionInput(
        depth_image=frame.depth.astype(np.float64),
        color_image=frame.color.astype(np.float32),
        label_mask=instance_mask,
        depth_factor=YCB_DEPTH_FACTOR,
        cam_to_world=np.eye(4),
        segmented_object_names=names,
        use_external_pose_list=True)
    t0 = time.perf_counter()
    result = recognizer.localize_objects_greedy_render(
        rin, pose_lists, output_dir=output_dir)
    runtime = time.perf_counter() - t0

    errors, adds, adis, rows = {}, {}, {}, {}
    for name, pose in zip(result.names, result.poses):
        rows[name] = np.asarray([[pose.x, pose.y, pose.z,
                                  *pose.quaternion()]], np.float64)
        gt = frame.gt_poses.get(name)
        if gt is None:
            continue
        model = recognizer.bank.models[recognizer.bank.index_of(name)]
        pts = model.sample_surface_points()
        # meta.mat GT maps the raw model frame to camera; a detection maps
        # the preprocessed frame, so the raw->camera estimate is
        # pose @ preprocessing, compared on raw model points.
        est = pose.transform() @ model.preprocessing_transform
        pre_inv = np.linalg.inv(model.preprocessing_transform)
        raw_pts = pts @ pre_inv[:3, :3].T + pre_inv[:3, 3]
        adds[name] = add_err(est[:3, :3], est[:3, 3],
                             gt[:3, :3], gt[:3, 3], raw_pts)
        adis[name] = adi_err(est[:3, :3], est[:3, 3],
                             gt[:3, :3], gt[:3, 3], raw_pts)
        errors[name] = adis[name] if name in YCB_ADDS_OBJECTS else adds[name]
    return FrameResult(scene=frame.scene, frame=frame.frame, errors=errors,
                       add_errors=adds, adis_errors=adis, runtime=runtime,
                       detected=result.names, detected_poses=rows)


def evaluate_frame(
    recognizer,
    frame: YCBFrame,
    object_names: list[str] | None = None,
    num_samples: int = 60,
    output_dir: str | None = None,
    mask_mode: str = "gt",
    posecnn_root: str | None = None,
    detections_json: str | None = None,
) -> FrameResult:
    """Run greedy recognition on one frame and score ADD/ADD-S vs GT, with
    the masks of `mask_mode` (frame_masks) and generate_candidates'
    candidates."""
    instance_mask, names = frame_masks(
        recognizer, frame, object_names, mask_mode, posecnn_root,
        detections_json)
    pose_lists = generate_candidates(
        frame.depth, instance_mask, names, frame.intrinsics,
        num_samples=num_samples)
    return localize_and_score(recognizer, frame, instance_mask, names,
                              pose_lists, output_dir)


def recognizer_class_id(recognizer, frame: YCBFrame, name: str) -> int:
    """Class id of `name` in the frame's label image (YCB: classes.txt
    order, 1-based). The class list rides on the frame (load_frame sets it);
    a legacy `_class_list` attribute is honoured for old callers."""
    class_list = frame.class_list or getattr(frame, "_class_list", None)
    if class_list is not None:
        return class_list.index(name) + 1
    raise ValueError("frame.class_list is unset (load_frame populates it; "
                     "set it explicitly for hand-built frames)")


def run_dataset(
    recognizer,
    dataset: YCBVideoDataset,
    max_frames: int | None = None,
    num_samples: int = 60,
    output_root: str | None = None,
    **mask_kwargs,
) -> dict:
    """Full keyframe sweep -> per-object and overall AUC (run_ycb_6d);
    with output_root, each frame's outputs in <scene>_<frame>/ and the
    report in accuracy.json."""
    per_object: dict[str, list[float]] = {}
    runtimes = []
    frames = dataset.keyframes()
    if max_frames:
        frames = frames[:max_frames]
    for scene, fid in frames:
        frame = dataset.load_frame(scene, fid)
        out_dir = (os.path.join(output_root, f"{scene}_{fid}")
                   if output_root else None)
        res = evaluate_frame(recognizer, frame, num_samples=num_samples,
                             output_dir=out_dir, **mask_kwargs)
        runtimes.append(res.runtime)
        for name, err in res.errors.items():
            per_object.setdefault(name, []).append(err)

    report = {"objects": {}, "runtime_mean": float(np.mean(runtimes))
              if runtimes else 0.0}
    all_errs = []
    for name, errs in sorted(per_object.items()):
        m = compute_pose_metrics(np.asarray(errs))
        report["objects"][name] = m
        all_errs.extend(errs)
    if all_errs:
        report["overall"] = compute_pose_metrics(np.asarray(all_errs))
    if output_root:
        os.makedirs(output_root, exist_ok=True)
        with open(os.path.join(output_root, "accuracy.json"), "w") as f:
            json.dump(report, f, indent=2)
    return report
