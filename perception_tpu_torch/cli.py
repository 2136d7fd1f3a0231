"""Command-line entry point of the port: pose estimation on one scene, the
`perch_fat` contract of the JAX package's CLI (`perception_tpu/cli.py`).

    python -m perception_tpu_torch.cli localize --config scene.json \\
        --output out/ [--device cuda|cpu]

The config has the JAX CLI's schema (paths relative to the config file
unless absolute):

    camera: {fx, fy, cx, cy, width, height}
    input:
      depth_image: depth.png          # 16-bit
      color_image: rgb.png            # optional
      label_mask: mask.png            # instance mask (6-DoF)
      posecnn_mat / detections_json   # or external detections (io.masks)
      depth_factor: 10000             # sensor units per metre
      cam_to_world: [[...4x4...]]     # optional, default identity
      segmented_object_names: [...]
      x_min, x_max, y_min, y_max      # 3-DoF search region (m, world)
      table_height                    # 3-DoF support surface (m)
    model_bank:
      - {name: 003_cracker_box, path: models/003/textured.ply,
         flipped: false, symmetric: false, symmetry_mode: 1}
    mesh_in_mm: false
    mesh_scaling_factor: 0.001
    rendered_root_dir: poses_dir      # <obj>/poses.txt candidate files
    perch_params: {...}               # PerchConfig keys
    env_params: {...}                 # EnvConfig keys, kernel_backend too
    mode: greedy | tree | greedy_icp

A `.json` config is read with `json`; a `.yaml` / `.yml` one with `yaml`
where that module is installed. Images are PNG (`io.images`). "greedy"
localises the candidates of `rendered_root_dir` (6-DoF, with the instance
mask); "tree" (the tree search) and "greedy_icp" (the brute-force ICP
baseline) search the 3-DoF grid over the input's region. As in the JAX CLI,
"greedy_icp" loads the models for 3-DoF (base at z = 0) and the other modes
follow `use_external_pose_list` (default 1), and the input is 3-DoF when
`use_external_pose_list` is 0 or the mode is "greedy_icp". The scene runs on
the card unless `--device cpu`. The run writes `output_poses.txt`,
`output_stats.txt` and (greedy, greedy_icp) `cost_dump.json` into the output
directory and prints one JSON summary line, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from perception_tpu_torch.core.config import load_config


def _resolve(base: str, path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(base, path)


def cmd_localize(args: argparse.Namespace) -> int:
    from perception_tpu_torch.core.config import (
        CameraIntrinsics,
        EnvConfig,
        PerchConfig,
    )
    from perception_tpu_torch.io.images import read_png
    from perception_tpu_torch.pipeline.env import RecognitionInput
    from perception_tpu_torch.pipeline.recognizer import (
        ModelSpec,
        ObjectRecognizer,
    )

    cfg = load_config(args.config)
    base = os.path.dirname(os.path.abspath(args.config))
    mode = cfg.get("mode", "greedy")
    if mode not in ("greedy", "tree", "greedy_icp"):
        print(f"unknown mode {mode}", file=sys.stderr)
        return 2

    cam = CameraIntrinsics(**cfg["camera"])
    perch = PerchConfig.from_yaml_dict(cfg)
    env_cfg = EnvConfig.from_yaml_dict({**cfg.get("env_params", {}),
                                        "width": cam.width,
                                        "height": cam.height})
    specs = [ModelSpec(
        name=m["name"], path=_resolve(base, m["path"]),
        flipped=m.get("flipped", False),
        symmetric=m.get("symmetric", False),
        symmetry_mode=m.get("symmetry_mode", 0))
        for m in cfg["model_bank"]]
    use_external = (mode != "greedy_icp"
                    and bool(cfg.get("use_external_pose_list", 1)))

    t0 = time.perf_counter()
    recognizer = ObjectRecognizer(
        specs, cam, perch, env_cfg,
        mesh_in_mm=cfg.get("mesh_in_mm", False),
        mesh_scaling_factor=cfg.get("mesh_scaling_factor", 0.001),
        use_external_pose_list=use_external,
        target_triangles=env_cfg.max_triangles_per_model,
        device=args.device)
    print(f"model bank loaded in {time.perf_counter() - t0:.2f}s "
          f"({len(specs)} models)")

    inp = cfg["input"]
    depth = read_png(_resolve(base, inp["depth_image"]))
    color = (read_png(_resolve(base, inp["color_image"]))
             if inp.get("color_image") else None)
    label = (read_png(_resolve(base, inp["label_mask"]))
             if inp.get("label_mask") else None)
    cam_to_world = np.asarray(
        inp.get("cam_to_world", np.eye(4).tolist()), np.float64)
    seg_names = inp.get("segmented_object_names", [s.name for s in specs])
    # External-detection mask modes (reference mask_type posecnn /
    # mask_rcnn): a PoseCNN results .mat or a COCO detections json supplies
    # the instance mask and the per-object names.
    if inp.get("posecnn_mat") or inp.get("detections_json"):
        from perception_tpu_torch.io import masks

        class_list = inp.get("class_list", [s.name for s in specs])
        if inp.get("posecnn_mat"):
            det = masks.load_posecnn_mat(_resolve(base, inp["posecnn_mat"]),
                                         class_list)
        else:
            det = masks.load_coco_detections(
                _resolve(base, inp["detections_json"]),
                class_list=class_list,
                image_id=inp.get("detections_image_id"),
                file_name=inp.get("color_image"),
                height=depth.shape[0], width=depth.shape[1],
                score_threshold=float(inp.get("detection_threshold", 0.0)))
        label, seg_names = det.label_mask(required_objects=seg_names)

    rin = RecognitionInput(
        depth_image=depth.astype(np.float64),
        color_image=None if color is None else color.astype(np.float32),
        label_mask=None if label is None else label.astype(np.int32),
        depth_factor=float(inp.get("depth_factor", 100.0)),
        cam_to_world=cam_to_world,
        segmented_object_names=seg_names,
        x_min=inp.get("x_min", -1.0), x_max=inp.get("x_max", 1.0),
        y_min=inp.get("y_min", -1.0), y_max=inp.get("y_max", 1.0),
        table_height=inp.get("table_height", 0.0),
        use_external_pose_list=use_external)
    if mode == "greedy":
        pose_lists = recognizer.read_pose_lists(
            _resolve(base, cfg["rendered_root_dir"]))
        result = recognizer.localize_objects_greedy_render(
            rin, pose_lists, output_dir=args.output)
    elif mode == "greedy_icp":
        result = recognizer.localize_objects_greedy_icp(
            rin, output_dir=args.output)
    else:
        result = recognizer.localize_objects(rin, output_dir=args.output)

    stats = recognizer.env.stats
    print(json.dumps({
        "detected": result.names,
        "poses": [[p.x, p.y, p.z, *p.quaternion()] for p in result.poses],
        "scenes_rendered": stats.scenes_rendered,
        "expands": stats.expands,
        "time": round(stats.time, 3),
        "output_dir": args.output,
    }))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="perception_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    loc = sub.add_parser("localize", help="run pose estimation on one scene")
    loc.add_argument("--config", required=True)
    loc.add_argument("--output", required=True)
    loc.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    loc.set_defaults(func=cmd_localize)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
