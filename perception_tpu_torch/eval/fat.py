"""NVIDIA FAT (Falling Things) dataset reader + converters.

The port's copy of `perception_tpu/eval/fat.py` (host NumPy and SciPy, as
there; images through `io/images.py`: PNG, and the colour frames' baseline
JPEG, without OpenCV). It covers the reference's FAT tooling surface
(convert_fat_coco.py, fat_pose_image.py FAT mode) for this pipeline:

  * `FATDataset`: reads the FAT directory layout (scene dirs with
    _object_settings.json / _camera_settings.json and per-frame
    NNNNNN.left.{jpg, depth.png, seg.png, json}) into the same `YCBFrame`
    structure the YCB-Video evaluator consumes — object poses come from
    the per-frame json (camera-frame location in cm + xyzw quaternion),
    masks from the seg image's segmentation_class_id values remapped to
    contiguous class ids.
  * `convert_to_ycb_layout`: writes frames out in the YCB-Video directory
    layout (image_sets/classes.txt, keyframe.txt, data/scene/frame-*.png
    + -meta.mat) so `YCBVideoDataset` (eval/ycb.py) and the CLI run on
    FAT scenes with zero further code.
  * `export_coco`: minimal COCO-annotation export (images, categories,
    per-instance bbox/area + uncompressed RLE masks) — the contract the
    reference's converter feeds to MaskRCNN training.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.eval.ycb import YCBFrame
from perception_tpu_torch.io.images import read_grey, read_rgb, write_png

FAT_DEPTH_FACTOR = 10000.0   # 16-bit png, 0.1 mm units
_CM = 0.01                   # FAT locations are centimetres


def _quat_xyzw_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n < 1e-12 else 2.0 / n
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return np.array([
        [1 - yy - zz, xy - wz, xz + wy],
        [xy + wz, 1 - xx - zz, yz - wx],
        [xz - wy, yz + wx, 1 - xx - yy]])


@dataclasses.dataclass
class FATScene:
    path: str
    classes: list[str]                 # exported_object_classes
    seg_ids: dict[str, int]           # class -> segmentation_class_id
    camera: CameraIntrinsics


class FATDataset:
    """Reader for one or more FAT scene directories."""

    def __init__(self, root: str, scenes: list[str] | None = None,
                 camera_name: str = "left"):
        self.root = root
        self.camera_name = camera_name
        if scenes is None:
            scenes = sorted(
                d for d in os.listdir(root)
                if os.path.isfile(os.path.join(root, d,
                                               "_object_settings.json")))
        self.scenes = {s: self._load_scene(os.path.join(root, s))
                       for s in scenes}
        # Union class list in first-seen order (classes.txt contract).
        self.classes: list[str] = []
        for sc in self.scenes.values():
            for name in sc.classes:
                if name not in self.classes:
                    self.classes.append(name)

    def _load_scene(self, path: str) -> FATScene:
        with open(os.path.join(path, "_object_settings.json")) as f:
            objs = json.load(f)
        with open(os.path.join(path, "_camera_settings.json")) as f:
            cams = json.load(f)
        cam_entry = next(
            c for c in cams["camera_settings"]
            if c.get("name", "left") == self.camera_name)
        intr = cam_entry["intrinsic_settings"]
        size = cam_entry["captured_image_size"]
        camera = CameraIntrinsics(
            fx=float(intr["fx"]), fy=float(intr["fy"]),
            cx=float(intr["cx"]), cy=float(intr["cy"]),
            width=int(size["width"]), height=int(size["height"]))
        seg_ids = {o["class"]: int(o["segmentation_class_id"])
                   for o in objs["exported_objects"]}
        return FATScene(path=path,
                        classes=list(objs["exported_object_classes"]),
                        seg_ids=seg_ids, camera=camera)

    def frames(self, scene: str) -> list[str]:
        sc = self.scenes[scene]
        suffix = f".{self.camera_name}.json"
        out = []
        for f in sorted(os.listdir(sc.path)):
            if f.endswith(suffix) and not f.startswith("_"):
                out.append(f[:-len(suffix)])
        return out

    def load_frame(self, scene: str, frame: str) -> YCBFrame:
        sc = self.scenes[scene]
        base = os.path.join(sc.path, f"{frame}.{self.camera_name}")
        color = read_rgb(base + ".jpg" if os.path.exists(base + ".jpg")
                         else base + ".png")
        depth = read_grey(base + ".depth.png")
        seg = read_grey(base + ".seg.png")
        with open(base + ".json") as f:
            meta = json.load(f)

        # Remap segmentation_class_id pixels -> contiguous 1-based ids in
        # self.classes order (the label-image convention of YCBFrame).
        label = np.zeros(seg.shape, np.uint8)
        for name, sid in sc.seg_ids.items():
            if name in self.classes:
                label[seg == sid] = self.classes.index(name) + 1

        gt = {}
        for obj in meta["objects"]:
            name = obj["class"]
            mat = np.eye(4)
            mat[:3, :3] = _quat_xyzw_to_matrix(
                np.asarray(obj["quaternion_xyzw"], np.float64))
            mat[:3, 3] = np.asarray(obj["location"], np.float64) * _CM
            gt[name] = mat
        return YCBFrame(scene=scene, frame=frame, color=color,
                        depth=depth, label=label, gt_poses=gt,
                        intrinsics=sc.camera, class_list=self.classes)


def convert_to_ycb_layout(fat: FATDataset, out_root: str) -> int:
    """Write all frames in the YCB-Video directory layout; returns the
    frame count. The output is directly loadable by YCBVideoDataset."""
    from scipy.io import savemat

    os.makedirs(os.path.join(out_root, "image_sets"), exist_ok=True)
    with open(os.path.join(out_root, "image_sets", "classes.txt"), "w") as f:
        f.write("\n".join(fat.classes) + "\n")

    count = 0
    keyframes = []
    for scene in fat.scenes:
        scene_dir = os.path.join(out_root, "data", scene)
        os.makedirs(scene_dir, exist_ok=True)
        for frame in fat.frames(scene):
            fr = fat.load_frame(scene, frame)
            base = os.path.join(scene_dir, frame)
            write_png(base + "-color.png", fr.color)
            write_png(base + "-depth.png", fr.depth.astype(np.uint16))
            write_png(base + "-label.png", fr.label)
            cls_idx = []
            mats = []
            for name, mat in fr.gt_poses.items():
                if name in fat.classes:
                    cls_idx.append(fat.classes.index(name) + 1)
                    mats.append(mat[:3, :])
            cam = fr.intrinsics
            savemat(base + "-meta.mat", {
                "cls_indexes": np.asarray(cls_idx, np.int32).reshape(-1, 1),
                "poses": (np.stack(mats, axis=-1)
                          if mats else np.zeros((3, 4, 0))),
                "intrinsic_matrix": np.array([
                    [cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]]),
                "factor_depth": np.array([[FAT_DEPTH_FACTOR]]),
            })
            keyframes.append(f"{scene}/{frame}")
            count += 1
    with open(os.path.join(out_root, "image_sets", "keyframe.txt"), "w") as f:
        f.write("\n".join(keyframes) + "\n")
    return count


def _rle_encode(mask: np.ndarray) -> dict:
    """COCO uncompressed RLE (column-major counts, starting with zeros)."""
    flat = np.asarray(mask, bool).T.ravel()
    edges = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    counts = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"counts": counts, "size": list(mask.shape)}


def export_coco(fat: FATDataset, out_path: str) -> dict:
    """Minimal COCO annotations (images/categories/annotations with bbox,
    area, uncompressed-RLE segmentation) over all frames."""
    images, annotations = [], []
    categories = [{"id": i + 1, "name": n, "supercategory": "object"}
                  for i, n in enumerate(fat.classes)]
    ann_id = 1
    img_id = 1
    for scene in fat.scenes:
        for frame in fat.frames(scene):
            fr = fat.load_frame(scene, frame)
            h, w = fr.label.shape
            images.append({"id": img_id, "width": w, "height": h,
                           "file_name": f"{scene}/{frame}"})
            for ci, name in enumerate(fat.classes):
                mask = fr.label == ci + 1
                if not mask.any():
                    continue
                ys, xs = np.nonzero(mask)
                bbox = [int(xs.min()), int(ys.min()),
                        int(xs.max() - xs.min() + 1),
                        int(ys.max() - ys.min() + 1)]
                annotations.append({
                    "id": ann_id, "image_id": img_id,
                    "category_id": ci + 1,
                    "bbox": bbox, "area": int(mask.sum()),
                    "iscrowd": 0,
                    "segmentation": _rle_encode(mask),
                })
                ann_id += 1
            img_id += 1
    out = {"images": images, "annotations": annotations,
           "categories": categories}
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out
