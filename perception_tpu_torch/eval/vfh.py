"""Viewpoint-Feature-Histogram nearest-neighbour pose baseline.

The port's copy of `perception_tpu/eval/vfh.py`, replacing the reference's
VFH estimator (perception_utils/src/vfh/vfh_pose_estimator.cpp: train on
rendered views of each model, recognise a segmented cluster by FLANN
nearest neighbour over VFH descriptors). The descriptor is the standard VFH
layout, computed with numpy: four 45-bin extended-FPFH angle histograms
(alpha, phi, theta, distance) about the centroid-normal frame plus a
128-bin viewpoint component, matched by cKDTree L2 on normalised
histograms.

The training views come from the env's own renderer (`render_composite`,
the direct raster kernel on the card) with k-NN normals from
`ops/icp.cloud_normals` on the env's device; the reference uses its OpenGL
simulator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def compute_vfh(points: np.ndarray, normals: np.ndarray,
                viewpoint: np.ndarray | None = None) -> np.ndarray:
    """VFH descriptor [308] of a cloud with normals (camera frame)."""
    pts = np.asarray(points, dtype=np.float64)
    nrm = np.asarray(normals, dtype=np.float64)
    if viewpoint is None:
        viewpoint = np.zeros(3)
    centroid = pts.mean(axis=0)
    ncentroid = nrm.mean(axis=0)
    ncentroid /= max(np.linalg.norm(ncentroid), 1e-12)

    # Darboux frame about (centroid, ncentroid) vs every point.
    d = pts - centroid
    dist = np.linalg.norm(d, axis=1)
    dn = d / np.maximum(dist[:, None], 1e-12)

    u = ncentroid
    v = np.cross(dn, u)
    vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    w = np.cross(u, vn)

    alpha = (vn * nrm).sum(axis=1)                   # cos of normal vs v
    phi = dn @ u                                     # cos of direction vs u
    theta = np.arctan2((w * nrm).sum(axis=1), nrm @ u)

    def hist(vals, lo, hi, bins=45):
        h, _ = np.histogram(vals, bins=bins, range=(lo, hi))
        s = h.sum()
        return h / s if s else h.astype(np.float64)

    max_dist = dist.max() if len(dist) else 1.0
    features = np.concatenate([
        hist(alpha, -1, 1),
        hist(phi, -1, 1),
        hist(theta, -np.pi, np.pi),
        hist(dist / max(max_dist, 1e-12), 0, 1),
    ])

    # Viewpoint component: histogram of the angle between each normal and
    # the central viewpoint direction.
    vp_dir = viewpoint - centroid
    vp_dir /= max(np.linalg.norm(vp_dir), 1e-12)
    cos_vp = nrm @ vp_dir
    vp_hist, _ = np.histogram(cos_vp, bins=128, range=(-1, 1))
    s = vp_hist.sum()
    vp_hist = vp_hist / s if s else vp_hist.astype(np.float64)
    return np.concatenate([features, vp_hist])


@dataclasses.dataclass
class VFHEntry:
    name: str
    roll: float
    pitch: float
    yaw: float
    descriptor: np.ndarray


class VFHPoseEstimator:
    """Train on rendered views; estimate (model, orientation) by NN. The
    env's input must be set (its cam_to_world places the views)."""

    def __init__(self, env):
        self.env = env
        self.entries: list[VFHEntry] = []
        self._tree = None

    def _view_cloud(self, state):
        from perception_tpu_torch.ops.icp import cloud_normals

        depth, _, _ = self.env.render_composite([state])
        stride = max(2, int(self.env.perch.gpu_stride))
        d = depth[::stride, ::stride]
        cam = self.env.camera
        ys, xs = np.nonzero(d > 0)
        if len(xs) < 16:
            return None, None
        z = d[ys, xs] / self.env.env.gpu_depth_factor
        x = (xs * stride - cam.cx) / cam.fx * z
        y = (ys * stride - cam.cy) / cam.fy * z
        pts = np.stack([x, y, z], axis=1).astype(np.float32)
        dev = self.env.device
        nrm = cloud_normals(
            torch.as_tensor(pts[None], device=dev),
            torch.ones((1, len(pts)), dtype=torch.bool, device=dev),
            k=min(8, len(pts) - 1))[0].cpu().numpy()
        return pts, nrm

    def train(self, num_views: int = 30, distance: float = 0.8) -> int:
        """Render fibonacci-sphere views of every model and bank their VFH
        descriptors (vfh_pose_estimator trainView loop)."""
        from perception_tpu_torch.core.pose import ContPose
        from perception_tpu_torch.core.state import ObjectState
        from perception_tpu_torch.eval.sampling import sphere_fibonacci_grid

        views = sphere_fibonacci_grid(num_views)
        for mid, model in enumerate(self.env.bank.models):
            for vp in views:
                # Euler angles pointing the object's z at the viewpoint.
                pitch = float(np.arcsin(np.clip(-vp[1], -1, 1)))
                yaw = float(np.arctan2(vp[0], vp[2]))
                pose = ContPose.from_euler(0.0, 0.0, distance, 0.0, pitch, yaw)
                state = ObjectState(id=mid, symmetric=model.symmetric,
                                    pose=pose, segmentation_label_id=1)
                pts, nrm = self._view_cloud(state)
                if pts is None:
                    continue
                self.entries.append(VFHEntry(
                    name=model.name, roll=0.0, pitch=pitch, yaw=yaw,
                    descriptor=compute_vfh(pts, nrm)))
        if self.entries:
            from scipy.spatial import cKDTree

            self._tree = cKDTree(np.stack([e.descriptor
                                           for e in self.entries]))
        return len(self.entries)

    def estimate(self, points: np.ndarray, normals: np.ndarray,
                 k: int = 1) -> list[VFHEntry]:
        """Nearest trained views for a segmented cluster."""
        if self._tree is None:
            raise RuntimeError("call train() first")
        q = compute_vfh(points, normals)
        _, idx = self._tree.query(q, k=k)
        idx = np.atleast_1d(idx)
        return [self.entries[i] for i in idx]
