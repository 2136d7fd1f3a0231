"""Per-workload experiment entry points.

The port's copy of `perception_tpu/eval/workloads.py`: the reference
driver's workload functions (fat_pose_image.py: run_on_image:3540,
run_sameshape_gpu:3017, run_roman_crate_gpu:2582, run_on_conveyor:4007) as
thin compositions over the recogniser. `eval/ycb.py`'s evaluate_frame /
run_dataset cover run_ycb_6d; this module adds the single image, the
same-shape multi-instance scene (crate) and the conveyor (a frame sequence
with warm-started candidates).
"""

from __future__ import annotations

import os

import numpy as np

from perception_tpu_torch.eval.ycb import (
    FrameResult,
    YCBFrame,
    frame_masks,
    generate_candidates,
    localize_and_score,
)


def run_on_image(recognizer, depth: np.ndarray, label_mask: np.ndarray,
                 object_names: list[str], intrinsics,
                 color: np.ndarray | None = None,
                 depth_factor: float = 10000.0,
                 num_samples: int = 60,
                 output_dir: str | None = None):
    """Single-image localisation with no ground truth (run_on_image):
    returns the recogniser's LocalizationResult."""
    from perception_tpu_torch.pipeline.env import RecognitionInput

    rin = RecognitionInput(
        depth_image=depth.astype(np.float64),
        color_image=(color.astype(np.float32) if color is not None
                     else None),
        label_mask=label_mask,
        depth_factor=depth_factor,
        cam_to_world=np.eye(4),
        segmented_object_names=object_names,
        use_external_pose_list=True)
    pose_lists = generate_candidates(
        depth, label_mask, object_names, intrinsics,
        depth_factor=depth_factor, num_samples=num_samples)
    return recognizer.localize_objects_greedy_render(
        rin, pose_lists, output_dir=output_dir)


def run_sameshape(recognizer, depth: np.ndarray, label_mask: np.ndarray,
                  model_name: str, num_instances: int, intrinsics,
                  color: np.ndarray | None = None,
                  depth_factor: float = 10000.0,
                  num_samples: int = 60,
                  output_dir: str | None = None):
    """Several instances of ONE model (run_sameshape_gpu / crate): instance
    mask id k becomes a segment named `<model>#<k>` backed by the same mesh
    (ModelBank.index_of strips the suffix), so the greedy argmin places
    every instance on its own. label_mask carries instance ids
    1..num_instances."""
    names = [f"{model_name}#{k + 1}" for k in range(num_instances)]
    return run_on_image(
        recognizer, depth, label_mask, names, intrinsics, color=color,
        depth_factor=depth_factor, num_samples=num_samples,
        output_dir=output_dir)


run_crate = run_sameshape   # run_roman_crate_gpu is the same-shape case
                            # with crate-specific data (reference:2582).


def run_on_conveyor(recognizer, frames: list[YCBFrame],
                    object_names: list[str] | None = None,
                    num_samples: int = 60,
                    warm_start: bool = True,
                    output_root: str | None = None) -> list[FrameResult]:
    """Frame-sequence workload (run_on_conveyor): evaluate the frames in
    order; with warm_start, each frame's candidates gain the previous
    frame's detected poses (the conveyor moves smoothly, so the last pose
    is a strong prior; the reference seeds its sweep the same way)."""
    results: list[FrameResult] = []
    prev_poses: dict[str, np.ndarray] | None = None
    for frame in frames:
        out_dir = (os.path.join(output_root, frame.scene, frame.frame)
                   if output_root else None)
        res = _evaluate_with_extra_candidates(
            recognizer, frame, prev_poses if warm_start else None,
            object_names, num_samples, out_dir)
        results.append(res)
        prev_poses = res.detected_poses
    return results


def _evaluate_with_extra_candidates(recognizer, frame, extra_poses,
                                    object_names, num_samples, output_dir
                                    ) -> FrameResult:
    """evaluate_frame (GT masks) with extra candidate rows appended per
    object."""
    instance_mask, names = frame_masks(recognizer, frame, object_names)
    pose_lists = generate_candidates(
        frame.depth, instance_mask, names, frame.intrinsics,
        num_samples=num_samples)
    for name, rows in (extra_poses or {}).items():
        if name in pose_lists:
            pose_lists[name] = np.vstack([pose_lists[name], rows])
    return localize_and_score(recognizer, frame, instance_mask, names,
                              pose_lists, output_dir)
