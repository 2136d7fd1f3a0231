"""Host-side poses and SO(3) / SE(3) helpers (numpy).

The port's own copy of `perception_tpu/core/pose.py`, with the reference
`ContPose` conventions (object_state.cpp:17-115): quaternions stored
(qx, qy, qz, qw); euler construction R = Rz(yaw) @ Ry(pitch) @ Rx(roll);
an all-zero quaternion means the euler angles are authoritative.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def quat_to_matrix(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """Unit-normalised quaternion -> 3x3 rotation matrix."""
    n = math.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    if n == 0.0:
        return np.eye(3)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return np.array([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ], dtype=np.float64)


def matrix_to_quat(rot: np.ndarray) -> tuple[float, float, float, float]:
    """3x3 rotation matrix -> quaternion (qx, qy, qz, qw), qw >= 0."""
    rot = np.asarray(rot, dtype=np.float64)
    t = np.trace(rot)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (rot[2, 1] - rot[1, 2]) / s
        qy = (rot[0, 2] - rot[2, 0]) / s
        qz = (rot[1, 0] - rot[0, 1]) / s
    elif rot[0, 0] > rot[1, 1] and rot[0, 0] > rot[2, 2]:
        s = math.sqrt(1.0 + rot[0, 0] - rot[1, 1] - rot[2, 2]) * 2
        qw = (rot[2, 1] - rot[1, 2]) / s
        qx = 0.25 * s
        qy = (rot[0, 1] + rot[1, 0]) / s
        qz = (rot[0, 2] + rot[2, 0]) / s
    elif rot[1, 1] > rot[2, 2]:
        s = math.sqrt(1.0 + rot[1, 1] - rot[0, 0] - rot[2, 2]) * 2
        qw = (rot[0, 2] - rot[2, 0]) / s
        qx = (rot[0, 1] + rot[1, 0]) / s
        qy = 0.25 * s
        qz = (rot[1, 2] + rot[2, 1]) / s
    else:
        s = math.sqrt(1.0 + rot[2, 2] - rot[0, 0] - rot[1, 1]) * 2
        qw = (rot[1, 0] - rot[0, 1]) / s
        qx = (rot[0, 2] + rot[2, 0]) / s
        qy = (rot[1, 2] + rot[2, 1]) / s
        qz = 0.25 * s
    if qw < 0:
        qx, qy, qz, qw = -qx, -qy, -qz, -qw
    return float(qx), float(qy), float(qz), float(qw)


def euler_xyz_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (Eigen extrinsic XYZ)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def make_transform(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = rot
    out[:3, 3] = np.asarray(trans, dtype=np.float64)
    return out


@dataclasses.dataclass(frozen=True)
class ContPose:
    """A continuous 6-DoF pose: translation + quaternion (or euler angles)."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    qx: float = 0.0
    qy: float = 0.0
    qz: float = 0.0
    qw: float = 0.0
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0

    @classmethod
    def from_euler(cls, x, y, z, roll, pitch, yaw) -> "ContPose":
        return cls(x=x, y=y, z=z, roll=roll, pitch=pitch, yaw=yaw)

    @classmethod
    def from_quat(cls, x, y, z, qx, qy, qz, qw) -> "ContPose":
        return cls(x=x, y=y, z=z, qx=qx, qy=qy, qz=qz, qw=qw)

    @classmethod
    def from_matrix(cls, mat: np.ndarray) -> "ContPose":
        qx, qy, qz, qw = matrix_to_quat(mat[:3, :3])
        return cls(x=float(mat[0, 3]), y=float(mat[1, 3]), z=float(mat[2, 3]),
                   qx=qx, qy=qy, qz=qz, qw=qw)

    @property
    def uses_euler(self) -> bool:
        return self.qx == 0 and self.qy == 0 and self.qz == 0 and self.qw == 0

    def rotation(self) -> np.ndarray:
        if self.uses_euler:
            return euler_xyz_to_matrix(self.roll, self.pitch, self.yaw)
        return quat_to_matrix(self.qx, self.qy, self.qz, self.qw)

    def transform(self) -> np.ndarray:
        """4x4 homogeneous transform (reference ContPose::GetTransform)."""
        return make_transform(self.rotation(), [self.x, self.y, self.z])

    def quaternion(self) -> tuple[float, float, float, float]:
        if self.uses_euler:
            return matrix_to_quat(self.rotation())
        n = math.sqrt(self.qx**2 + self.qy**2 + self.qz**2 + self.qw**2)
        return (self.qx / n, self.qy / n, self.qz / n, self.qw / n)


# Camera "body" frame (x forward) to the optical frame (z forward), as the
# reference applies at every render dispatch (search_env.cpp:1536-1541).
CAM_TO_BODY = np.array([
    [0.0, 0.0, 1.0, 0.0],
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def world_to_optical_cam(cam_to_world: np.ndarray) -> np.ndarray:
    """World -> optical-camera matrix that brings poses into the render
    frame: (cam_to_world @ CAM_TO_BODY)^-1 (search_env.cpp:1535-1541)."""
    return np.linalg.inv(cam_to_world @ CAM_TO_BODY)
