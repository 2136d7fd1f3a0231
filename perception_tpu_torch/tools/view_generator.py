"""Tessellated-sphere view generator (the reference's view_generator.cpp).

The port's copy of `perception_tpu/tools/view_generator.py`. For every mesh
in a models directory it renders depth views from the vertices of a
subdivided icosahedron (PCL RenderViewsTesselatedSphere with
setUseVertices(true): 12 / 42 / 162 / 642 views at levels 0-3) and writes
per-model .npz view banks: organised clouds, camera poses and a visibility
"entropy" per view (the visible surface fraction; the reference stores
PCL's occlusion entropy). These banks feed the VFH trainer (eval/vfh.py)
and any view-matching baseline. All views of a model render in one
`ops/rasterizer.render_pose_batch` call: the direct raster kernel on the
card.

Usage: python3 -m perception_tpu_torch.tools.view_generator <models_dir>
       <output_dir> [--level=1] [--resolution=150] [--distance=0.8]
       [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def icosphere_vertices(level: int) -> np.ndarray:
    """Unit vertices of an icosahedron subdivided `level` times."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts[0])
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    verts = [v for v in verts]
    cache: dict[tuple, int] = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = (verts[a] + verts[b]) / 2.0
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(m)
        return cache[key]

    for _ in range(level):
        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c],
                          [ab, bc, ca]]
        faces = np.asarray(new_faces, np.int64)
    return np.asarray(verts)


def look_at_pose(viewpoint: np.ndarray, distance: float) -> np.ndarray:
    """Model->camera [4, 4]: camera at `distance` along `viewpoint`,
    looking at the model origin (+z into the scene)."""
    z_axis = -viewpoint / np.linalg.norm(viewpoint)   # camera forward
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z_axis)) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    x_axis = np.cross(up, z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    # Object at the model origin -> camera: rows are the camera axes and
    # the origin lands `distance` ahead on the optical axis.
    pose = np.eye(4)
    pose[:3, :3] = np.stack([x_axis, y_axis, z_axis])
    pose[:3, 3] = [0.0, 0.0, distance]
    return pose


def generate_views(model, camera, *, level: int = 1, distance: float = 0.8,
                   stride: int = 2, backend: str = "auto",
                   device: str | torch.device = "cuda"):
    """(clouds, poses, entropies) for one MeshModel, rendered on `device`.

    clouds: list of [Pi, 3] camera-frame points; poses [V, 4, 4]
    model->camera; entropy = visible surface fraction in [0, 1]
    (visible pixel area x z^2 proxy over the max across views).
    """
    from perception_tpu_torch.core.mesh import ModelBank
    from perception_tpu_torch.ops.rasterizer import render_pose_batch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the view generator renders on "
                           "the card unless given device='cpu'")

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    bank = ModelBank.from_models([model])
    views = icosphere_vertices(level)
    poses = np.stack([look_at_pose(v, distance) for v in views]).astype(
        np.float32)
    out = render_pose_batch(
        dev(bank.tri_verts, torch.float32),
        dev(bank.tri_colors, torch.float32), dev(bank.tri_valid, torch.bool),
        dev(poses, torch.float32),
        torch.zeros(len(poses), dtype=torch.int64, device=device),
        dev(camera.projection(), torch.float32),
        width=camera.width, height=camera.height, stride=stride,
        backend=backend, bank_backface=dev(bank.backface_cull, torch.bool))
    depth = out.depth.cpu().numpy()     # [V, h, w] int cm

    clouds, areas = [], []
    for i in range(len(views)):
        ys, xs = np.nonzero(depth[i] > 0)
        z = depth[i][ys, xs] / 100.0
        x = (xs * stride - camera.cx) / camera.fx * z
        y = (ys * stride - camera.cy) / camera.fy * z
        clouds.append(np.stack([x, y, z], axis=1).astype(np.float32))
        # Pixel count x z^2 ~ visible surface area (orthographic proxy).
        areas.append(float((z * z).sum()))
    areas = np.asarray(areas)
    entropy = areas / max(areas.max(), 1e-9)
    return clouds, poses, entropy


def main(argv: list[str] | None = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv[:-1]:     # "--device cpu", as the other CLIs
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    args = [a for a in argv if not a.startswith("--")]
    if len(args) < 2:
        print(__doc__)
        return 1
    models_dir, output_dir = args[0], args[1]

    def flag(name, default):
        for a in argv:
            if a.startswith(f"--{name}="):
                return type(default)(a.split("=", 1)[1])
        return default

    level = flag("level", 1)
    resolution = flag("resolution", 150)
    distance = flag("distance", 0.8)
    device = flag("device", device)

    from perception_tpu_torch.core.config import CameraIntrinsics
    from perception_tpu_torch.core.mesh import load_model

    # Reference camera: resolution x resolution window, 57 deg horizontal
    # FoV (view_generator.cpp setResolution/setViewAngle).
    f = resolution / (2.0 * np.tan(np.radians(57.0) / 2.0))
    camera = CameraIntrinsics(fx=f, fy=f, cx=resolution / 2.0,
                              cy=resolution / 2.0, width=resolution,
                              height=resolution)

    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for fname in sorted(os.listdir(models_dir)):
        if not fname.lower().endswith((".ply", ".obj")):
            continue
        path = os.path.join(models_dir, fname)
        name = os.path.splitext(fname)[0]
        print(f"Generating views for: {path}", flush=True)
        model = load_model(path, name=name)
        clouds, poses, entropy = generate_views(
            model, camera, level=level, distance=distance, stride=1,
            device=device)
        np.savez_compressed(
            os.path.join(output_dir, f"{name}-views.npz"),
            poses=poses, entropy=entropy,
            **{f"cloud_{i}": c for i, c in enumerate(clouds)})
        count += 1
    print(f"wrote {count} view banks to {output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
