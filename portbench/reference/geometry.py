"""Poses, mesh preparation and the padded model bank, in NumPy.

The plain reference works out again what the program's set-up derives from
the benchmark's meshes: the preprocessing shift, the outward winding, the
morton triangle order, the padded bank, the ICP surface samples and the
radii of the validity tests. These are frozen copies of the port's host
code (`core/pose.py`, `core/mesh.py`) at the time the benchmark was written,
with no decimation: both configurations render every triangle
(`render_lod` 0), so the bank is the meshes as given.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Additive inflation of the validity radii (m).
MESH_ADDITIVE_INFLATION = 0.01
# The camera body frame (x forward) to the optical frame (z forward).
CAM_TO_BODY = np.array([
    [0.0, 0.0, 1.0, 0.0],
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
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
    """3x3 rotation -> (qx, qy, qz, qw) with qw >= 0."""
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


def euler_xyz_to_matrix(roll, pitch, yaw) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


@dataclasses.dataclass(frozen=True)
class Pose:
    """A world-frame pose: translation and quaternion, or euler angles when
    the quaternion is all zero (the program's convention)."""

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
    def from_matrix(cls, mat: np.ndarray) -> "Pose":
        qx, qy, qz, qw = matrix_to_quat(mat[:3, :3])
        return cls(x=float(mat[0, 3]), y=float(mat[1, 3]), z=float(mat[2, 3]),
                   qx=qx, qy=qy, qz=qz, qw=qw)

    def rotation(self) -> np.ndarray:
        if self.qx == 0 and self.qy == 0 and self.qz == 0 and self.qw == 0:
            return euler_xyz_to_matrix(self.roll, self.pitch, self.yaw)
        return quat_to_matrix(self.qx, self.qy, self.qz, self.qw)

    def transform(self) -> np.ndarray:
        out = np.eye(4)
        out[:3, :3] = self.rotation()
        out[:3, 3] = [self.x, self.y, self.z]
        return out


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One object placement: model index, pose, 1-based segment label."""

    model: int
    pose: Pose
    label: int = 1


def preprocess(verts: np.ndarray, six_dof: bool) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Shift the vertices (metres): 6-DoF centres the vertex mean, 3-DoF
    puts the lowest z at 0 over the (x, y) mean. -> (verts, transform)."""
    verts = np.asarray(verts, np.float64)
    centroid = verts.mean(axis=0)
    z_t = centroid[2] if six_dof else verts.min(axis=0)[2]
    transform = np.eye(4)
    transform[:3, 3] = [-centroid[0], -centroid[1], -z_t]
    return verts + transform[:3, 3], transform


def orient_faces(verts: np.ndarray, faces: np.ndarray) -> tuple[bool,
                                                               np.ndarray]:
    """(watertight and consistently wound, faces wound outward): every
    directed edge once and its reverse once; most normals inward flips all."""
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0:
        return False, faces
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], axis=0)
    keys = edges[:, 0] * (verts.shape[0] + 1) + edges[:, 1]
    uniq, counts = np.unique(keys, return_counts=True)
    if (counts != 1).any():
        return False, faces
    rev = edges[:, 1] * (verts.shape[0] + 1) + edges[:, 0]
    if not np.isin(rev, uniq).all():
        return False, faces
    tri = verts[faces]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    outward = ((tri.mean(axis=1) - verts.mean(axis=0)) * normals).sum(axis=1)
    if np.sign(outward).sum() < 0:
        faces = faces[:, [0, 2, 1]]
    return True, faces


@dataclasses.dataclass
class Model:
    name: str
    tri_verts: np.ndarray        # [T, 3, 3] float32, model frame
    preprocessing: np.ndarray    # [4, 4]
    cullable: bool
    symmetric: bool = False

    @property
    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        v = self.tri_verts.reshape(-1, 3)
        return v.min(axis=0), v.max(axis=0)

    @property
    def inscribed_radius(self) -> float:
        lo, hi = self.bounds
        return float(min(hi[0] - lo[0], hi[1] - lo[1]) / 2.0)

    @property
    def circumscribed_radius(self) -> float:
        lo, hi = self.bounds
        return float(max(hi[0] - lo[0], hi[1] - lo[1]) / 2.0)

    @property
    def circumscribed_radius_3d(self) -> float:
        lo, hi = self.bounds
        return float(max(hi - lo) / 2.0)

    @property
    def inflation_factor(self) -> float:
        r = self.inscribed_radius
        return 1.0 if r < 1e-5 else 1.0 + MESH_ADDITIVE_INFLATION / r

    def corners(self) -> np.ndarray:
        """[8, 3] corners of the model-frame bounding box."""
        lo, hi = self.bounds
        return np.array([[x, y, z] for x in (lo[0], hi[0])
                         for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                        np.float64)

    def footprint_hull(self) -> np.ndarray:
        return convex_hull_2d(self.tri_verts.reshape(-1, 3)[:, :2])


def make_model(name: str, verts, faces, six_dof: bool,
               symmetric: bool = False) -> Model:
    """A bank model from a mesh in metres."""
    verts, pre = preprocess(verts, six_dof)
    cullable, faces = orient_faces(verts, faces)
    return Model(name=name, tri_verts=verts[faces].astype(np.float32),
                 preprocessing=pre, cullable=cullable, symmetric=symmetric)


def morton_order(centroids: np.ndarray, bits: int = 10) -> np.ndarray:
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.minimum(((centroids - lo) / span * (2**bits - 1)).astype(np.uint64),
                   2**bits - 1)
    code = np.zeros(len(centroids), dtype=np.uint64)
    for b in range(bits):
        for d in range(3):
            code |= ((q[:, d] >> b) & 1) << np.uint64(3 * b + d)
    return np.argsort(code, kind="stable")


@dataclasses.dataclass
class Bank:
    models: list[Model]
    tri_verts: np.ndarray      # [M, T, 3, 3] float32
    tri_valid: np.ndarray      # [M, T] bool
    cullable: np.ndarray       # [M] bool

    @classmethod
    def build(cls, models: list[Model]) -> "Bank":
        t_cap = max(len(m.tri_verts) for m in models)
        m_count = len(models)
        verts = np.zeros((m_count, t_cap, 3, 3), np.float32)
        valid = np.zeros((m_count, t_cap), bool)
        for i, m in enumerate(models):
            t = len(m.tri_verts)
            order = morton_order(m.tri_verts.mean(axis=1))
            verts[i, :t] = m.tri_verts[order]
            valid[i, :t] = True
        return cls(models, verts, valid,
                   np.asarray([m.cullable for m in models], bool))

    def surface_samples(self, k: int = 256) -> tuple[np.ndarray, np.ndarray]:
        """Area-stratified surface samples [M, k, 3] and face normals."""
        m_count = self.tri_valid.shape[0]
        pts = np.zeros((m_count, k, 3), np.float32)
        nrm = np.zeros((m_count, k, 3), np.float32)
        for i in range(m_count):
            tv = self.tri_verts[i][self.tri_valid[i]]
            cross = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
            area = 0.5 * np.linalg.norm(cross, axis=1)
            n = cross / np.maximum(np.linalg.norm(cross, axis=1,
                                                  keepdims=True), 1e-12)
            cum = np.cumsum(area)
            total = max(cum[-1], 1e-12)
            ticks = (np.arange(k) + 0.5) / k * total
            sel = np.searchsorted(cum, ticks).clip(0, len(tv) - 1)
            j = np.arange(k)
            u = np.mod(j * 0.7548776662466927, 1.0)
            v = np.mod(j * 0.5698402909980532, 1.0)
            over = u + v > 1.0
            u[over], v[over] = 1.0 - u[over], 1.0 - v[over]
            t = tv[sel]
            pts[i] = (t[:, 0] * (1 - u - v)[:, None] + t[:, 1] * u[:, None]
                      + t[:, 2] * v[:, None])
            nrm[i] = n[sel]
        return pts, nrm


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull, counter-clockwise."""
    pts = np.unique(points[:, :2], axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        hull: list[np.ndarray] = []
        for p in seq:
            while len(hull) >= 2:
                a, b = hull[-1] - hull[-2], p - hull[-2]
                if a[0] * b[1] - a[1] * b[0] > 0:
                    break
                hull.pop()
            hull.append(p)
        return hull

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def projection(fx, fy, cx, cy, width, height, near=10.0,
               far=10000.0) -> np.ndarray:
    """The renderer's OpenGL-style projection (render units: cm)."""
    w, h = float(width), float(height)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 2 * fx / w
    p[0, 2] = 2 * cx / w - 1.0
    p[1, 1] = -2 * fy / h
    p[1, 2] = 1.0 - 2 * cy / h
    p[2, 2] = (far + near) / (far - near)
    p[2, 3] = -2 * far * near / (far - near)
    p[3, 2] = 1.0
    return p
