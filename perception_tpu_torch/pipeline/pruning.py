"""Successor pruning for 3-DoF candidates: the colour-histogram and the
occupancy (octomap-like) filters.

Counterpart of `perception_tpu/pipeline/pruning.py`, with the reference's
semantics (kUseHistogramPruning / kUseOctomapPruning, IsValidHistogram):

  * histogram: crop the candidate's render and the observed colour image to
    the render's bounding box and compare their 50x60 hue-saturation
    histograms (min-max normalised) by Bhattacharyya distance; keep below
    0.85;
  * occupancy: voxelise at 2 cm and count the rendered points in voxels the
    observed cloud leaves empty; keep while that count over the observed
    cloud's size stays below 0.8.

Every `batch` candidates render in one call of the env's `render_strided`
(its `kernel_backend`, the full bank, full frame at `gpu_stride`); the two
tests are vectorised NumPy on the host.
"""

from __future__ import annotations

import numpy as np


def rgb_to_hs(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """RGB [..., 3] (0..255) -> OpenCV-convention hue (0..180) and
    saturation (0..255)."""
    rgb = rgb.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-9) * 255.0, 0.0)
    safe = np.maximum(delta, 1e-9)
    h = np.where(
        maxc == r, (g - b) / safe % 6.0,
        np.where(maxc == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = np.where(delta > 0, h * 30.0, 0.0)   # x 60 degrees / 2
    return h, s


def hs_histogram(rgb: np.ndarray, mask: np.ndarray,
                 h_bins: int = 50, s_bins: int = 60) -> np.ndarray:
    """Min-max-normalised HS histogram over the masked pixels."""
    h, s = rgb_to_hs(rgb[mask])
    hist, _, _ = np.histogram2d(
        h, s, bins=(h_bins, s_bins), range=((0, 180), (0, 256)))
    lo, hi = hist.min(), hist.max()
    if hi > lo:
        hist = (hist - lo) / (hi - lo)
    return hist.astype(np.float64)


def bhattacharyya(h1: np.ndarray, h2: np.ndarray) -> float:
    """OpenCV's HISTCMP_BHATTACHARYYA (lower = more similar)."""
    s1, s2 = h1.sum(), h2.sum()
    if s1 <= 0 or s2 <= 0:
        return 1.0
    bc = np.sum(np.sqrt(h1 * h2)) / np.sqrt(s1 * s2)
    return float(np.sqrt(max(0.0, 1.0 - bc)))


def histogram_scores(rendered_color: np.ndarray, rendered_depth: np.ndarray,
                     observed_color: np.ndarray,
                     h_bins: int = 50, s_bins: int = 60) -> np.ndarray:
    """Bhattacharyya distance per candidate between the rendered object's
    bounding-box crop and the observed image's same crop (every pixel of
    the box). rendered_color [N, h, w, 3], rendered_depth [N, h, w] (0 =
    empty), observed_color [h, w, 3] on the same strided grid; 1 for an
    empty render."""
    out = np.ones(rendered_color.shape[0])
    for i in range(len(out)):
        mask = rendered_depth[i] > 0
        if not mask.any():
            continue
        ys, xs = np.nonzero(mask)
        box = np.s_[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        full = np.ones(mask[box].shape, bool)
        h_obs = hs_histogram(observed_color[box], full, h_bins, s_bins)
        h_ren = hs_histogram(rendered_color[i][box], full, h_bins, s_bins)
        out[i] = bhattacharyya(h_obs, h_ren)
    return out


def voxel_keys(points: np.ndarray, resolution: float) -> np.ndarray:
    """int64 voxel keys of [P, 3] points."""
    cells = np.floor(points / resolution).astype(np.int64) + (1 << 20)
    return (cells[:, 0] << 42) | (cells[:, 1] << 21) | cells[:, 2]


def voxel_changed_fraction(rendered_points_world: list[np.ndarray],
                           observed_points_world: np.ndarray,
                           resolution: float = 0.02) -> np.ndarray:
    """Per candidate: its rendered points in voxels the observed cloud does
    not occupy, over the observed cloud's size (1 for an empty render)."""
    occupied = np.unique(voxel_keys(observed_points_world, resolution))
    denom = max(1, len(observed_points_world))
    out = np.zeros(len(rendered_points_world))
    for i, pts in enumerate(rendered_points_world):
        if len(pts) == 0:
            out[i] = 1.0
            continue
        new = ~np.isin(voxel_keys(pts, resolution), occupied)
        out[i] = float(new.sum()) / denom
    return out


def prune_successors(env, states: list, *,
                     use_histogram: bool = False,
                     use_voxels: bool = False,
                     histogram_threshold: float = 0.85,
                     voxel_resolution: float = 0.02,
                     max_changed_fraction: float = 0.8,
                     batch: int = 256) -> list:
    """The candidate ObjectStates that pass every enabled test, in order.
    Without an observed colour image the histogram test keeps everything."""
    if not states or not (use_histogram or use_voxels):
        return list(states)
    cam, stride = env.camera, int(env.perch.gpu_stride)
    observed_color = None
    if use_histogram:
        if env._input is None or env._input.color_image is None:
            return list(states)
        observed_color = np.asarray(
            env._input.color_image)[::stride, ::stride]
    c2w = env._input.cam_to_world
    keep: list = []
    for lo in range(0, len(states), batch):
        chunk = states[lo:lo + batch]
        out = env.render_strided(chunk)
        depth = out.depth.cpu().numpy()
        ok = np.ones(len(chunk), bool)
        if use_histogram:
            dist = histogram_scores(out.color.cpu().numpy(), depth,
                                    observed_color)
            ok &= dist < histogram_threshold
        if use_voxels:
            ys, xs = np.mgrid[0:depth.shape[1], 0:depth.shape[2]]
            clouds = []
            for d in depth:
                m = d > 0
                z = d[m] / env.env.gpu_depth_factor
                x = (xs[m] * stride - cam.cx) * z / cam.fx
                y = (ys[m] * stride - cam.cy) * z / cam.fy
                pts_cam = np.stack([x, y, z], axis=1)
                clouds.append(pts_cam @ c2w[:3, :3].T + c2w[:3, 3])
            frac = voxel_changed_fraction(clouds, env._world_points,
                                          voxel_resolution)
            ok &= frac < max_changed_fraction
        keep.extend(s for s, k in zip(chunk, ok) if k)
    return keep
