"""External-detection mask ingestion: PoseCNN `.mat` files and COCO-style
MaskRCNN detection JSON.

The port's own copy of `perception_tpu/io/masks.py`. The reference consumes
CNN detections as first-class mask modes (fat_pose_image.py:1322
`get_posecnn_mask` reads `results_PoseCNN_RSS2018/<id>.mat`;
`get_gt_mask`:1375 decodes COCO annotations). Each loader returns per-object
binary masks plus the combined 1-based instance `label_mask` +
`segmented_object_names` pair that `RecognitionInput` consumes.

No pycocotools or OpenCV: polygon segmentations rasterise by a numpy
even-odd scanline (the JAX package's fallback when cv2 is missing) and both
uncompressed and compressed COCO RLE are decoded natively.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class MaskDetections:
    """Per-image detection set in a normalized form.

    names[i], masks[i] ([H, W] bool), boxes[i] = (cmin, rmin, cmax, rmax)
    and centroids[i] = (cx, cy) follow the reference's get_*_mask return
    contract (fat_pose_image.py:1370-1373).
    """

    names: list[str]
    masks: list[np.ndarray]
    boxes: list[tuple[float, float, float, float]]
    centroids: list[tuple[float, float]]
    scores: list[float] = dataclasses.field(default_factory=list)

    def label_mask(self, required_objects: list[str] | None = None
                   ) -> tuple[np.ndarray, list[str]]:
        """Combined 1-based instance mask + name order for RecognitionInput.

        With required_objects, keeps only those names (best-scoring instance
        each) and orders the output to match; otherwise detection order.
        Later masks overwrite earlier ones on overlap (reference
        overall_binary_mask composition, fat_pose_image.py:1546-1567).
        """
        order: list[int] = []
        if required_objects is not None:
            for name in required_objects:
                idxs = [i for i, n in enumerate(self.names) if n == name]
                if not idxs:
                    continue
                if self.scores:
                    idxs.sort(key=lambda i: -self.scores[i])
                order.append(idxs[0])
        else:
            order = list(range(len(self.names)))
        if not order:
            raise ValueError("no detections match the requested objects")
        h, w = self.masks[order[0]].shape
        out = np.zeros((h, w), np.int32)
        names = []
        for slot, i in enumerate(order):
            out[self.masks[i] > 0] = slot + 1
            names.append(self.names[i])
        return out, names


def _bbox_and_centroid(mask: np.ndarray):
    args = np.argwhere(mask > 0)
    if args.size == 0:
        return (0.0, 0.0, 0.0, 0.0), (0.0, 0.0)
    rmin, cmin = args.min(axis=0)
    rmax, cmax = args.max(axis=0)
    return ((float(cmin), float(rmin), float(cmax), float(rmax)),
            (float(cmin + cmax) / 2.0, float(rmin + rmax) / 2.0))


def load_posecnn_mat(
    path: str,
    class_list: list[str],
    centroid_type: str = "roi",
) -> MaskDetections:
    """PoseCNN results `.mat` -> detections (get_posecnn_mask parity).

    The file carries `labels` ([H, W] class-id image, 1-based into
    class_list) and `rois` ([K, >=6] rows
    [batch, class_id, cmin, rmin, cmax, rmax, ...], fat_pose_image.py:
    1283-1300). centroid_type: "roi" uses the ROI box centre; "mask" the
    mask bbox centre.
    """
    from scipy.io import loadmat

    meta = loadmat(path)
    overall = np.asarray(meta["labels"])
    rois = np.asarray(meta.get("rois", np.zeros((0, 6))))
    if rois.ndim == 1:
        rois = rois.reshape(0, 6)

    names, masks, boxes, cents = [], [], [], []
    if rois.shape[0]:
        item_ids = rois[:, 1].astype(int)
    else:
        item_ids = np.unique(overall)
        item_ids = item_ids[item_ids > 0].astype(int)

    for idx, itemid in enumerate(item_ids):
        if itemid < 1 or itemid > len(class_list):
            continue
        mask = overall == itemid
        if not mask.any():
            continue
        names.append(class_list[itemid - 1])
        masks.append(mask)
        if centroid_type == "roi" and rois.shape[0] and rois.shape[1] >= 6:
            cmin = float(rois[idx, 2]) + 1
            rmin = float(rois[idx, 3]) + 1
            cmax = float(rois[idx, 4]) - 1
            rmax = float(rois[idx, 5]) - 1
            boxes.append((cmin, rmin, cmax, rmax))
            cents.append(((cmin + cmax) / 2.0, (rmin + rmax) / 2.0))
        else:
            box, cen = _bbox_and_centroid(mask)
            boxes.append(box)
            cents.append(cen)
    return MaskDetections(names=names, masks=masks, boxes=boxes,
                          centroids=cents)


# -- COCO segmentation decoding (no pycocotools) ---------------------------

def _decode_uncompressed_rle(counts, h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        c = int(c)
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    # COCO RLE is column-major.
    return flat.reshape((w, h)).T.astype(bool)


def _decode_compressed_rle(counts: str | bytes, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE string -> mask (maskApi.c rleFrString scheme:
    LEB128-style varints with sign folding and delta coding from the
    count two steps back)."""
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    out = []
    i = 0
    while i < len(counts):
        x = 0
        k = 0
        more = True
        while more:
            c = counts[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return _decode_uncompressed_rle(out, h, w)


def _polygon_mask(polys, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill of COCO polygons, sampled at pixel centres."""
    mask = np.zeros((h, w), np.uint8)
    ys = np.arange(h) + 0.5
    for p in polys:
        p = np.asarray(p, np.float64).reshape(-1, 2)
        if len(p) < 3:
            continue
        x0, y0 = p[:, 0], p[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        for yi, y in enumerate(ys):
            crosses = ((y0 <= y) & (y1 > y)) | ((y1 <= y) & (y0 > y))
            if not crosses.any():
                continue
            xs = x0[crosses] + (y - y0[crosses]) / (y1[crosses] - y0[crosses]) \
                * (x1[crosses] - x0[crosses])
            xs = np.sort(xs)
            for a, b in zip(xs[::2], xs[1::2]):
                mask[yi, int(np.ceil(a - 0.5)):int(np.floor(b - 0.5)) + 1] = 1
    return mask.astype(bool)


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """COCO `segmentation` field (polygon list / RLE dict) -> [H, W] bool."""
    if isinstance(seg, dict):
        sh, sw = seg["size"]
        counts = seg["counts"]
        if isinstance(counts, (list, tuple)):
            return _decode_uncompressed_rle(counts, sh, sw)
        return _decode_compressed_rle(counts, sh, sw)
    return _polygon_mask(seg, h, w)


def load_coco_detections(
    path: str,
    class_list: list[str] | None = None,
    image_id: int | None = None,
    file_name: str | None = None,
    height: int | None = None,
    width: int | None = None,
    score_threshold: float = 0.0,
) -> MaskDetections:
    """COCO-style detections JSON -> detections for one image.

    Accepts either a full COCO dict ({images, annotations, categories}) or a
    bare list of detection records (the MaskRCNN-results convention:
    {image_id, category_id, segmentation, bbox, score}). Category names come
    from the file's `categories` when present, else `class_list` (1-based
    category ids).
    """
    with open(path) as f:
        data = json.load(f)

    cat_names: dict[int, str] = {}
    anns = data
    if isinstance(data, dict):
        for c in data.get("categories", []):
            cat_names[int(c["id"])] = c["name"]
        images = {int(im["id"]): im for im in data.get("images", [])}
        if image_id is None and file_name is not None:
            for iid, im in images.items():
                if os.path.basename(im.get("file_name", "")) == \
                        os.path.basename(file_name):
                    image_id = iid
                    break
        if image_id is not None and image_id in images:
            height = height or int(images[image_id]["height"])
            width = width or int(images[image_id]["width"])
        anns = data.get("annotations", [])
    if class_list is not None:
        for i, n in enumerate(class_list):
            cat_names.setdefault(i + 1, n)

    names, masks, boxes, cents, scores = [], [], [], [], []
    for ann in anns:
        if image_id is not None and int(ann.get("image_id", -1)) != image_id:
            continue
        score = float(ann.get("score", 1.0))
        if score < score_threshold:
            continue
        cid = int(ann["category_id"])
        name = cat_names.get(cid)
        if name is None:
            continue
        seg = ann.get("segmentation")
        if seg is None:
            if height is None or width is None:
                raise ValueError("bbox-only detections need height/width")
            x, y, bw, bh = ann["bbox"]
            mask = np.zeros((height, width), bool)
            mask[int(y):int(y + bh) + 1, int(x):int(x + bw) + 1] = True
        else:
            if isinstance(seg, dict):
                mask = decode_segmentation(seg, 0, 0)
            else:
                if height is None or width is None:
                    raise ValueError("polygon detections need height/width")
                mask = decode_segmentation(seg, height, width)
        if not mask.any():
            continue
        names.append(name)
        masks.append(mask)
        box, cen = _bbox_and_centroid(mask)
        if "bbox" in ann:
            x, y, bw, bh = ann["bbox"]
            box = (float(x), float(y), float(x + bw), float(y + bh))
            cen = (float(x + bw / 2.0), float(y + bh / 2.0))
        boxes.append(box)
        cents.append(cen)
        scores.append(score)
    return MaskDetections(names=names, masks=masks, boxes=boxes,
                          centroids=cents, scores=scores)
