"""Mesh loading, preprocessing, decimation and the padded model bank.

The port's own copy of the host-side parts of `perception_tpu/core/mesh.py`:
`read_mesh` (through the C++ loader), `preprocess_model`, the two decimators
behind one switch (`decimate_mode`: the argument, else `$PT_DECIMATE`, else
"qem"; QEM edge collapse in C++, or `decimate_vertex_clustering`),
`MeshModel`, `ModelBank` (morton-ordered, padded triangle arrays; the
render-LOD re-decimation; surface samples), `mesh_model_from_arrays` and
`load_model`; the 3-DoF footprint and containment helpers of the search
modes (`convex_hull_2d`, `points_in_convex_poly`,
`MeshModel.circumscribed_radius`, `footprint_hull`, `points_inside`,
`points_inside_footprint`); and the ADD / ADD-S point sampler
`MeshModel.sample_surface_points`, host NumPy as in the JAX package. The
same inputs and switch give the same arrays as the JAX package: parsing and
QEM run in the same C++ implementation (`csrc/mesh_loader.cpp`, built by
`core/native.py`), clustering is a copy of the JAX package's NumPy code, and
the bank's triangle cap is the port's raster constant `MAX_TRIS`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from perception_tpu_torch.core import native
from perception_tpu_torch.ops.rasterizer import MAX_TRIS

# Additive inflation applied to radii when validating poses
# (object_model.cpp:43 kMeshAdditiveInflation).
MESH_ADDITIVE_INFLATION = 0.01


def read_mesh(path: str):
    """Read a .ply / .obj mesh through the C++ loader -> (verts [V,3] f64,
    faces [F,3] i64 (polygons fan-triangulated), colors [V,3] u8 | None)."""
    if not path.endswith((".ply", ".obj")):
        raise ValueError(f"unsupported mesh format: {path}")
    return native.load_mesh(path)


def preprocess_model(verts: np.ndarray, mesh_in_mm: bool = False,
                     scaling_factor: float = 0.001, flipped: bool = False,
                     use_external_pose_list: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Shift / scale / flip model vertices (reference PreprocessModel,
    object_model.cpp:49-129) -> (new_verts, preprocessing_transform) with
    new = T @ old. 6-DoF mode centres the centroid; 3-DoF mode puts the
    minimum z at 0."""
    verts = np.asarray(verts, dtype=np.float64)
    centroid = verts.mean(axis=0)
    flip = np.eye(4)
    if flipped:
        flip[2, 2] = -1.0
        verts = verts @ flip[:3, :3].T
    vmin = verts.min(axis=0)
    x_t, y_t = centroid[0], centroid[1]
    z_t = centroid[2] if use_external_pose_list else vmin[2]
    scale = scaling_factor if mesh_in_mm else 1.0
    x_t, y_t, z_t = x_t * scale, y_t * scale, z_t * scale
    transform = np.eye(4)
    transform[:3, :3] *= scale
    transform[:3, 3] = [-x_t, -y_t, -z_t]
    return verts * scale + transform[:3, 3], transform @ flip


def decimate_vertex_clustering(verts, faces, colors, target_triangles: int):
    """Vertex-clustering decimation to <= target_triangles, as the JAX
    package's: snap vertices to a uniform grid (binary search on the cells
    along the longest axis, 2-512), merge each cell's vertices at their
    mean (colours alike, truncated to uint8), drop faces that collapse and
    duplicate faces (orientation kept; `np.unique` sorts the survivors)."""
    if len(faces) <= target_triangles:
        return verts, faces, colors
    extent = float((verts.max(axis=0) - verts.min(axis=0)).max())
    lo_cells, hi_cells = 2, 512

    def cluster(num_cells: int):
        cell = extent / num_cells
        keys = np.floor((verts - verts.min(axis=0)) / cell).astype(np.int64)
        # The inverse's shape for axis=0 differs between NumPy 2.x releases.
        _, inverse = np.unique(keys, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        n_clusters = inverse.max() + 1
        sums = np.zeros((n_clusters, 3))
        counts = np.zeros(n_clusters)
        np.add.at(sums, inverse, verts)
        np.add.at(counts, inverse, 1)
        new_verts = sums / counts[:, None]
        new_colors = None
        if colors is not None:
            csums = np.zeros((n_clusters, 3))
            np.add.at(csums, inverse, colors.astype(np.float64))
            new_colors = (csums / counts[:, None]).astype(np.uint8)
        new_faces = inverse[faces]
        keep = ((new_faces[:, 0] != new_faces[:, 1])
                & (new_faces[:, 1] != new_faces[:, 2])
                & (new_faces[:, 0] != new_faces[:, 2]))
        return new_verts, np.unique(new_faces[keep], axis=0), new_colors

    best = None
    while lo_cells <= hi_cells:
        mid = (lo_cells + hi_cells) // 2
        nv, nf, nc = cluster(mid)
        if len(nf) <= target_triangles:
            best = (nv, nf, nc)
            lo_cells = mid + 1
        else:
            hi_cells = mid - 1
    if best is None:
        best = cluster(2)
        if len(best[1]) > target_triangles:
            best = (best[0], best[1][:target_triangles], best[2])
    return best


def decimate_qem(verts, faces, colors, target_triangles: int):
    """QEM edge-collapse decimation (Garland-Heckbert, in
    `csrc/mesh_loader.cpp`: the C++ implementation the JAX package's
    `decimate` prefers)."""
    if len(faces) <= target_triangles:
        return verts, np.asarray(faces, np.int64), colors
    return native.decimate_qem(verts, faces, colors, target_triangles)


DECIMATE_MODES = ("qem", "cluster")


def decimate_mode(mode: str | None = None) -> str:
    """The one resolver of the decimator: mode, else $PT_DECIMATE, else
    "qem" (an empty variable counts as unset). Every decimation and the
    model cache's key go through it, so an unset variable and
    PT_DECIMATE=qem build and hash alike. Where the JAX package clusters
    for any other value, the port raises."""
    mode = mode or os.environ.get("PT_DECIMATE") or "qem"
    if mode not in DECIMATE_MODES:
        raise ValueError(f"unknown decimator {mode!r}; one of "
                         f"{DECIMATE_MODES}")
    return mode


def decimate(verts, faces, colors, target_triangles: int,
             mode: str | None = None):
    """Decimate to <= target_triangles with the decimator `decimate_mode`
    resolves: "qem" (`decimate_qem`) or "cluster"
    (`decimate_vertex_clustering`)."""
    if decimate_mode(mode) == "qem":
        return decimate_qem(verts, faces, colors, target_triangles)
    return decimate_vertex_clustering(verts, faces, colors, target_triangles)


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull of 2D points, CCW, no repeated endpoint."""
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


def points_in_convex_poly(points: np.ndarray, hull: np.ndarray) -> np.ndarray:
    """Point-in-convex-polygon mask (CCW hull), on or left of every edge."""
    if len(hull) < 3:
        return np.zeros(len(points), dtype=bool)
    edge = np.roll(hull, -1, axis=0) - hull                 # [E, 2]
    rel = points[:, None, :2] - hull[None, :, :]            # [P, E, 2]
    cross = edge[None, :, 0] * rel[:, :, 1] - edge[None, :, 1] * rel[:, :, 0]
    return (cross >= -1e-12).all(axis=1)


@dataclasses.dataclass
class MeshModel:
    """One preprocessed object model as a flat triangle soup (metres)."""

    name: str
    tri_verts: np.ndarray          # [T, 3, 3] float32, model frame
    tri_colors: np.ndarray         # [T, 3] uint8 (per-face colour)
    preprocessing_transform: np.ndarray  # [4, 4]
    symmetric: bool = False
    symmetry_mode: int = 0         # 0 none, 1 semi (pi), 2 full yaw symmetry
    full_tri_verts: np.ndarray | None = None  # pre-decimation (for metrics)
    search_resolution: float = 0.0
    num_original_triangles: int = 0
    backface_cullable: bool = False   # watertight + consistently wound

    @property
    def num_triangles(self) -> int:
        return len(self.tri_verts)

    @property
    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        v = self.tri_verts.reshape(-1, 3)
        return v.min(axis=0), v.max(axis=0)

    # Radii follow object_model.cpp:460-470 (bbox-derived).
    @property
    def inscribed_radius(self) -> float:
        vmin, vmax = self.bounds
        return float(min(vmax[0] - vmin[0], vmax[1] - vmin[1]) / 2.0)

    @property
    def circumscribed_radius(self) -> float:
        """Half the larger side of the (x, y) bounding box."""
        vmin, vmax = self.bounds
        return float(max(vmax[0] - vmin[0], vmax[1] - vmin[1]) / 2.0)

    @property
    def circumscribed_radius_3d(self) -> float:
        vmin, vmax = self.bounds
        return float(max(vmax - vmin) / 2.0)

    @property
    def inflation_factor(self) -> float:
        r = self.inscribed_radius
        if r < 1e-5:
            return 1.0
        return 1.0 + MESH_ADDITIVE_INFLATION / r

    def footprint_hull(self) -> np.ndarray:
        """Convex hull [E, 2] of the model's (x, y) vertices, CCW."""
        return convex_hull_2d(self.tri_verts.reshape(-1, 3)[:, :2])

    def sample_surface_points(self, max_points: int = 4096) -> np.ndarray:
        """Vertices of the (undecimated) mesh, subsampled — for ADD/ADD-S."""
        src = (self.full_tri_verts if self.full_tri_verts is not None
               else self.tri_verts)
        pts = np.unique(src.reshape(-1, 3), axis=0)
        if len(pts) > max_points:
            step = int(np.ceil(len(pts) / max_points))
            pts = pts[::step]
        return pts.astype(np.float32)

    def points_inside(self, points: np.ndarray,
                      transform: np.ndarray | None = None,
                      inflation: float = 1.0) -> np.ndarray:
        """Mask of points [P, 3] enclosed by the mesh surface: the parity of
        +z ray crossings through the (optionally [4, 4]-transformed,
        inflation-scaled) triangle soup, the reference's PointsInsideMesh.
        Exact for closed meshes. Points are nudged by a sub-micron constant
        so that no ray passes through a shared edge."""
        tv = self.tri_verts.astype(np.float64) * inflation     # [T, 3, 3]
        if transform is not None:
            tv = tv @ np.asarray(transform)[:3, :3].T + transform[:3, 3]
        p = np.asarray(points, np.float64).copy()
        p[:, 0] += 1.172e-7
        p[:, 1] += 2.387e-7
        a, b, c = tv[:, 0], tv[:, 1], tv[:, 2]
        # (x, y) barycentric containment, broadcast [P, T].
        d = ((b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0])
             + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1]))
        safe = np.where(np.abs(d) > 1e-15, d, 1.0)
        px = p[:, 0:1] - c[None, :, 0]
        py = p[:, 1:2] - c[None, :, 1]
        l1 = ((b[:, 1] - c[:, 1]) * px + (c[:, 0] - b[:, 0]) * py) / safe
        l2 = ((c[:, 1] - a[:, 1]) * px + (a[:, 0] - c[:, 0]) * py) / safe
        l3 = 1.0 - l1 - l2
        hit = (np.abs(d) > 1e-15) & (l1 >= 0) & (l2 >= 0) & (l3 >= 0)
        z_int = l1 * a[:, 2] + l2 * b[:, 2] + l3 * c[:, 2]
        crossings = (hit & (z_int > p[:, 2:3])).sum(axis=1)
        return (crossings % 2).astype(bool)

    def points_inside_footprint(self, points_xy: np.ndarray,
                                yaw_cos_sin: tuple[float, float] = (1.0, 0.0),
                                xy: tuple[float, float] = (0.0, 0.0),
                                ) -> np.ndarray:
        """Mask of 2D points inside the footprint hull rotated by the yaw
        (cos, sin) and moved to xy (the reference's PointsInsideFootprint);
        either winding of the hull is accepted."""
        cy, sy = yaw_cos_sin
        rot = np.array([[cy, -sy], [sy, cy]])
        hull = self.footprint_hull() @ rot.T + np.asarray(xy)
        p = np.asarray(points_xy, np.float64)
        edge = np.roll(hull, -1, axis=0) - hull              # [E, 2]
        rel = p[:, None, :] - hull[None, :, :]               # [P, E, 2]
        cross = edge[:, 0] * rel[..., 1] - edge[:, 1] * rel[..., 0]
        return (cross >= -1e-12).all(axis=1) | (cross <= 1e-12).all(axis=1)


def analyze_winding(verts: np.ndarray, faces: np.ndarray
                    ) -> tuple[bool, np.ndarray]:
    """(watertight_and_consistent, faces_oriented_outward): every directed
    edge appears once and its reverse once; inward-wound meshes (most
    normals towards the centroid) come back flipped."""
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


def _face_colors(vcolors, faces) -> np.ndarray:
    if vcolors is None:
        return np.full((len(faces), 3), 128, dtype=np.uint8)
    return (np.asarray(vcolors, np.float64)[faces].mean(axis=1)
            .clip(0, 255).astype(np.uint8))


def load_model(path: str, name: str | None = None, mesh_in_mm: bool = False,
               scaling_factor: float = 0.001, flipped: bool = False,
               use_external_pose_list: bool = False,
               target_triangles: int = 1024, symmetric: bool = False,
               symmetry_mode: int = 0) -> MeshModel:
    """Read, preprocess, decimate and orient one mesh file."""
    verts, faces, colors = read_mesh(path)
    verts, pre_transform = preprocess_model(
        verts, mesh_in_mm, scaling_factor, flipped, use_external_pose_list)
    full_tris = verts[faces].astype(np.float32)
    dverts, dfaces, dcolors = decimate(verts, faces, colors, target_triangles)
    cullable, dfaces = analyze_winding(dverts, dfaces)
    if dcolors is not None:
        tri_colors = (dcolors[dfaces].astype(np.float32).mean(axis=1)
                      .astype(np.uint8))
    else:
        tri_colors = np.full((len(dfaces), 3), 128, dtype=np.uint8)
    return MeshModel(
        name=name or path, tri_verts=dverts[dfaces].astype(np.float32),
        tri_colors=tri_colors, preprocessing_transform=pre_transform,
        symmetric=symmetric, symmetry_mode=symmetry_mode,
        full_tri_verts=full_tris, num_original_triangles=len(faces),
        backface_cullable=cullable)


def mesh_model_from_arrays(name: str, verts: np.ndarray, faces: np.ndarray,
                           colors: np.ndarray | None = None,
                           symmetric: bool = False, symmetry_mode: int = 0,
                           target_triangles: int | None = None,
                           **preprocess_kwargs) -> MeshModel:
    """A MeshModel from in-memory arrays (synthetic scenes, tests);
    target_triangles decimates as the file path does."""
    verts, pre_transform = preprocess_model(np.asarray(verts, np.float64),
                                            **preprocess_kwargs)
    faces = np.asarray(faces, np.int64)
    num_original = len(faces)
    full_tris = verts[faces].astype(np.float32)
    vcolors = np.asarray(colors, np.float64) if colors is not None else None
    if target_triangles is not None and len(faces) > target_triangles:
        verts, faces, vcolors = decimate(verts, faces, vcolors,
                                         target_triangles)
    cullable, faces = analyze_winding(verts, faces)
    return MeshModel(name=name, tri_verts=verts[faces].astype(np.float32),
                     tri_colors=_face_colors(vcolors, faces),
                     preprocessing_transform=pre_transform,
                     symmetric=symmetric, symmetry_mode=symmetry_mode,
                     full_tri_verts=full_tris,
                     num_original_triangles=num_original,
                     backface_cullable=cullable)


def _morton_order(centroids: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order sort of 3D points (interleaved quantised coordinates)."""
    if len(centroids) == 0:
        return np.arange(0)
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
class ModelBank:
    """All scene models stacked into padded arrays; padding triangles are
    invalid and never drawn."""

    models: list[MeshModel]
    tri_verts: np.ndarray      # [M, T_cap, 3, 3] float32
    tri_colors: np.ndarray     # [M, T_cap, 3] float32 (0..255)
    tri_valid: np.ndarray      # [M, T_cap] bool
    backface_cull: np.ndarray  # [M] bool (watertight, outward-wound)

    @classmethod
    def from_models(cls, models: list[MeshModel],
                    t_cap: int | None = None) -> "ModelBank":
        """Stack models, each model's triangles in morton order of their
        centroids. t_cap may not exceed the raster key's MAX_TRIS."""
        if t_cap is None:
            t_cap = max(m.num_triangles for m in models)
        if t_cap > MAX_TRIS:
            raise ValueError(
                f"t_cap={t_cap} exceeds the raster key's triangle capacity "
                f"MAX_TRIS={MAX_TRIS}; decimate the models harder")
        m_count = len(models)
        tri_verts = np.zeros((m_count, t_cap, 3, 3), dtype=np.float32)
        tri_colors = np.zeros((m_count, t_cap, 3), dtype=np.float32)
        tri_valid = np.zeros((m_count, t_cap), dtype=bool)
        for i, m in enumerate(models):
            if m.num_triangles > t_cap:
                raise ValueError(f"model {m.name} has {m.num_triangles} "
                                 f"triangles > cap {t_cap}")
            t = m.num_triangles
            order = _morton_order(m.tri_verts[:t].mean(axis=1))
            tri_verts[i, :t] = m.tri_verts[:t][order]
            tri_colors[i, :t] = m.tri_colors[:t][order]
            tri_valid[i, :t] = True
        return cls(models=models, tri_verts=tri_verts, tri_colors=tri_colors,
                   tri_valid=tri_valid,
                   backface_cull=np.asarray(
                       [m.backface_cullable for m in models], dtype=bool))

    def decimated(self, target_triangles: int) -> "ModelBank":
        """Render-LOD bank: every model re-decimated to <= target_triangles
        (face colours become vertex colours, and back)."""
        lod_models = []
        for m in self.models:
            soup = m.tri_verts[:m.num_triangles].astype(np.float64)
            verts, inv = np.unique(soup.reshape(-1, 3).round(decimals=7),
                                   axis=0, return_inverse=True)
            faces = inv.reshape(-1, 3)
            vcol = np.full((len(verts), 3), 128.0)
            for c in range(3):
                vcol[faces[:, c]] = m.tri_colors[:m.num_triangles]
            dverts, dfaces, dcol = decimate(verts, faces, vcol,
                                            target_triangles)
            cullable, dfaces = analyze_winding(dverts, dfaces)
            tri_colors = (dcol[dfaces].mean(axis=1) if dcol is not None
                          else np.full((len(dfaces), 3), 128.0))
            lod_models.append(dataclasses.replace(
                m, tri_verts=dverts[dfaces].astype(np.float32),
                tri_colors=tri_colors.astype(np.uint8),
                backface_cullable=bool(cullable and m.backface_cullable)))
        return ModelBank.from_models(lod_models, t_cap=target_triangles)

    @property
    def names(self) -> list[str]:
        return [m.name for m in self.models]

    def index_of(self, name: str) -> int:
        """Model index by name; `name#k` instance names resolve to the base
        model."""
        names = self.names
        if name in names:
            return names.index(name)
        return names.index(name.split("#", 1)[0])

    def surface_samples(self, k: int = 256) -> tuple[np.ndarray, np.ndarray]:
        """Deterministic area-weighted surface samples [M, k, 3] with their
        face normals [M, k, 3]: stratified along the cumulative area, with
        R2 low-discrepancy barycentric jitter."""
        m_count = self.tri_valid.shape[0]
        pts = np.zeros((m_count, k, 3), np.float32)
        nrm = np.zeros((m_count, k, 3), np.float32)
        for i in range(m_count):
            tv = self.tri_verts[i][self.tri_valid[i]]     # [t, 3, 3]
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
