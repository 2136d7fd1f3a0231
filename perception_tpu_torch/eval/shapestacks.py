"""ShapeStacks -> COCO instance-segmentation converter.

The port's copy of `perception_tpu/eval/shapestacks.py` (host NumPy; the
mask PNGs through `io/images.py`, without OpenCV). It replaces the
reference's one-off conversion script
(sbpl_perception/src/scripts/tools/convert_shapestacks_coco.py): the
ShapeStacks recordings lay out each scenario as a directory of
`rgb-<base>-r=<r>-mono-0.png` camera frames plus one binary mask PNG per
block, `vseg-<base>-seg-<k>.png`; the scenario name encodes the block
count as `n=<k>`. The converter walks a scenario list (the dataset's
eval/train JSON split files), pairs every kept RGB frame with its
per-block masks, and emits a COCO instances JSON (single `jenga_block`
category, uncompressed-RLE segmentations via the same encoder the FAT
converter uses) that MaskRCNN-style trainers and this framework's
`io/masks.py` ingestion both read.

Differences from the reference script by design: no half-split
hard-coding (callers pass `limit`), no hard-coded camera exclusions
(`skip_cams`), pure-numpy RLE instead of pycococreator's polygon
tolerance fitting, and mirrored-scenario (`*_r`) skipping kept as a flag.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from perception_tpu_torch.eval.fat import _rle_encode
from perception_tpu_torch.io.images import read_png

CLASS_ID = 1
CATEGORIES = [{"id": CLASS_ID, "name": "jenga_block",
               "supercategory": "shape"}]


def _grey(img: np.ndarray) -> np.ndarray:
    """A mask PNG as one channel: an RGB(A) one by libpng's truncating
    rgb_to_gray (the 0.299 / 0.587 / 0.114 weights in 15-bit fixed point),
    which is what cv2.IMREAD_ANYDEPTH reads from it."""
    if img.ndim == 2:
        return img
    r, g, b = (img[..., c].astype(np.int64) for c in range(3))
    grey = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (r == b), r, grey)


def block_count(scenario_name: str) -> int:
    """Block count from the `n=<k>` token of a scenario name."""
    m = re.search(r"n=(\d+)", scenario_name)
    if not m:
        raise ValueError(f"no n=<k> token in scenario {scenario_name!r}")
    return int(m.group(1))


def seg_file_for(rgb_file: str, block: int) -> str:
    """Mask filename for `block` of an `rgb-*-mono-0.png` frame
    (reference naming: strip the rgb- prefix and the -r=<r>-mono-0
    render suffix, then vseg-<base>-seg-<k>.png)."""
    base = os.path.basename(rgb_file)
    base = base[len("rgb-"):] if base.startswith("rgb-") else base
    base = re.sub(r"-r=\d+-mono-0\.png$", "", base)
    return f"vseg-{base}-seg-{block}.png"


def iter_frames(img_dir: str, scenarios: list[str], *,
                skip_mirrored: bool = True,
                skip_cams: tuple[str, ...] = ()):
    """Yield (scenario, rgb_path, [mask_path per block]) for every kept
    frame."""
    for scenario in scenarios:
        if skip_mirrored and scenario.endswith("_r"):
            continue
        sdir = os.path.join(img_dir, scenario)
        if not os.path.isdir(sdir):
            continue
        n = block_count(scenario)
        for f in sorted(os.listdir(sdir)):
            if not (f.startswith("rgb-") and f.endswith("-mono-0.png")):
                continue
            if any(cam in f for cam in skip_cams):
                continue
            masks = [os.path.join(sdir, seg_file_for(f, b))
                     for b in range(n)]
            yield scenario, os.path.join(sdir, f), masks


def convert_shapestacks_coco(
    img_dir: str,
    scenarios: list[str],
    out_path: str | None = None,
    *,
    skip_mirrored: bool = True,
    skip_cams: tuple[str, ...] = ("cam_1-",),
    limit: int | None = None,
) -> dict:
    """Convert ShapeStacks scenario recordings to a COCO instances dict
    (written to ``out_path`` when given). Frames whose masks are all
    empty are dropped, matching the reference script."""
    images, annotations = [], []
    img_id, ann_id = 1, 1
    kept = 0
    for scenario, rgb_path, mask_paths in iter_frames(
            img_dir, scenarios, skip_mirrored=skip_mirrored,
            skip_cams=skip_cams):
        if limit is not None and kept >= limit:
            break
        frame_anns = []
        h = w = None
        for mask_path in mask_paths:
            if not os.path.exists(mask_path):
                continue
            mask = _grey(read_png(mask_path)) > 0
            h, w = mask.shape
            if not mask.any():
                continue
            ys, xs = np.nonzero(mask)
            frame_anns.append({
                "id": ann_id, "image_id": img_id,
                "category_id": CLASS_ID,
                "bbox": [int(xs.min()), int(ys.min()),
                         int(xs.max() - xs.min() + 1),
                         int(ys.max() - ys.min() + 1)],
                "area": int(mask.sum()), "iscrowd": 0,
                "segmentation": _rle_encode(mask),
            })
            ann_id += 1
        if not frame_anns:
            continue
        images.append({
            "id": img_id, "width": w, "height": h,
            "file_name": os.path.join(scenario,
                                      os.path.basename(rgb_path)),
        })
        annotations.extend(frame_anns)
        img_id += 1
        kept += 1

    out = {"info": {"description": "ShapeStacks -> COCO"},
           "licenses": [], "categories": CATEGORIES,
           "images": images, "annotations": annotations}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f)
    return out


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("img_dir", help="recordings root (scenario dirs)")
    ap.add_argument("scenario_list",
                    help="JSON list of scenario names (eval.json)")
    ap.add_argument("out", help="output COCO JSON path")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    with open(args.scenario_list) as f:
        scenarios = json.load(f)
    out = convert_shapestacks_coco(args.img_dir, scenarios, args.out,
                                   limit=args.limit)
    print(f"wrote {args.out}: {len(out['images'])} images, "
          f"{len(out['annotations'])} annotations")


if __name__ == "__main__":
    main()
