"""Pose-accuracy metrics: ADD / ADD-S / AUC / rotation / translation error.

The port's copy of `perception_tpu/eval/metrics.py` (NumPy and SciPy, host
code as there). Re-implementation of the reference evaluation stack
(fat_dataset/lib/utils/pose_error.py:72-137 add/adi/re/te and
fat_pose_image.py:3793-3833 compute_pose_metrics, which follows the
YCB_Video_toolbox plot_accuracy_keyframe.m protocol).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.spatial import cKDTree


def transform_pts(pts: np.ndarray, rot: np.ndarray, t: np.ndarray) -> np.ndarray:
    return pts @ np.asarray(rot).T + np.asarray(t).reshape(1, 3)


def add_err(r_est, t_est, r_gt, t_gt, pts: np.ndarray) -> float:
    """Average distance of model points (ADD), Hinterstoisser et al."""
    e = np.linalg.norm(
        transform_pts(pts, r_est, t_est) - transform_pts(pts, r_gt, t_gt),
        axis=1)
    return float(e.mean())


def adi_err(r_est, t_est, r_gt, t_gt, pts: np.ndarray) -> float:
    """ADD-S: nearest-point average distance (indistinguishable views)."""
    est = transform_pts(pts, r_est, t_est)
    gt = transform_pts(pts, r_gt, t_gt)
    nn_dists, _ = cKDTree(est).query(gt, k=1)
    return float(nn_dists.mean())


def rot_err_deg(r_est: np.ndarray, r_gt: np.ndarray) -> float:
    """Rotation geodesic error in degrees (pose_error.py `re`)."""
    cos = 0.5 * (np.trace(r_est @ np.linalg.inv(r_gt)) - 1.0)
    cos = min(1.0, max(-1.0, cos))
    return float(math.degrees(math.acos(cos)))


def trans_err(t_est, t_gt) -> float:
    return float(np.linalg.norm(np.asarray(t_est) - np.asarray(t_gt)))


def compute_pose_metrics(rec: np.ndarray, max_auc_dist: float = 0.1,
                         max_pose_dist: float = 0.02) -> dict:
    """AUC of the accuracy-threshold curve + %-under-2cm.

    Byte-compatible with fat_pose_image.py:3793-3833 (which itself follows
    YCB_Video_toolbox/plot_accuracy_keyframe.m).
    """
    rec = np.array(rec, dtype=np.float64)
    rec_mean = float(np.mean(rec)) if rec.size else float("nan")
    rec_less_perc = (
        float((rec < max_pose_dist).sum()) / rec.shape[0] * 100.0
        if rec.size else 0.0)

    rec = rec.copy()
    rec[rec > max_auc_dist] = np.inf
    rec = np.sort(rec)
    prec = np.arange(0, rec.shape[0], 1) / rec.shape[0]
    prec = np.array(prec[1:].tolist() + [1])

    index = np.isfinite(rec)
    rec = rec[index]
    prec = prec[index]
    if rec.size == 0:
        return {"auc": 0.0, "pose_error_less_perc": rec_less_perc,
                "mean_pose_error": rec_mean, "pose_count": 0}

    mrec = np.array([0] + rec.tolist() + [0.1])
    mpre = np.array([0] + prec.tolist() + [prec[-1]])
    args = np.where(mrec[:-1] != mrec[1:])[0]
    ap = np.sum((mrec[args + 1] - mrec[args]) * mpre[args + 1]) * 10

    return {
        "auc": float(ap * 100.0),
        "pose_error_less_perc": rec_less_perc,
        "mean_pose_error": rec_mean,
        "pose_count": int(rec.shape[0]),
    }
