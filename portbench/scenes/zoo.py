"""The procedural evaluation meshes (vertex for vertex the port's
`eval/model_zoo.py` shapes at resolution 1: a mug with a handle loop, a
bowl, an L bracket, a pipe elbow, a cracker box and a soup can, 20-504
triangles, with per-vertex colour texture), frozen here so that the
benchmark makes its inputs without the program.

Every generator returns (verts [V, 3] float64 metres, faces [F, 3] int,
colors [V, 3] uint8), wound outward where the shape is closed.
"""

from __future__ import annotations

import numpy as np


def _revolve(profile_rz: np.ndarray, n_seg: int, *, close_bottom=True,
             close_top=True):
    """Surface of revolution around +z from an [K, 2] (r, z) profile.

    Adjacent profile rows are connected by quad rings split into
    triangles; optional bottom/top center caps close the shape.
    """
    prof = np.asarray(profile_rz, np.float64)
    k = len(prof)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ca, sa = np.cos(ang), np.sin(ang)
    verts = []
    for r, z in prof:
        verts.append(np.c_[r * ca, r * sa, np.full(n_seg, z)])
    verts = np.vstack(verts)
    faces = []
    for i in range(k - 1):
        a0, b0 = i * n_seg, (i + 1) * n_seg
        for j in range(n_seg):
            jn = (j + 1) % n_seg
            # Outward winding for a profile walked bottom-up with r>0.
            faces.append([a0 + j, a0 + jn, b0 + j])
            faces.append([a0 + jn, b0 + jn, b0 + j])
    extra = []
    if close_bottom:
        c = len(verts)
        extra.append([0.0, 0.0, prof[0, 1]])
        for j in range(n_seg):
            faces.append([c, (j + 1) % n_seg, j])
    if close_top:
        c = len(verts) + len(extra)
        extra.append([0.0, 0.0, prof[-1, 1]])
        top0 = (k - 1) * n_seg
        for j in range(n_seg):
            faces.append([c, top0 + j, top0 + (j + 1) % n_seg])
    if extra:
        verts = np.vstack([verts, np.asarray(extra)])
    return verts, np.asarray(faces, np.int64)


def _tube(path: np.ndarray, radius: float, n_seg: int = 10,
          cap: bool = True):
    """Closed tube swept along a 3D polyline (parallel-transport frames)."""
    path = np.asarray(path, np.float64)
    n = len(path)
    # Parallel transport an initial frame along the path.
    t0 = path[1] - path[0]
    t0 /= np.linalg.norm(t0)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, t0)) > 0.9:
        up = np.array([1.0, 0.0, 0.0])
    u = np.cross(t0, up)
    u /= np.linalg.norm(u)
    frames = []
    prev_t = t0
    for i in range(n):
        if 0 < i < n - 1:
            t = path[i + 1] - path[i - 1]
        elif i == 0:
            t = path[1] - path[0]
        else:
            t = path[-1] - path[-2]
        t = t / np.linalg.norm(t)
        # Rotate u to stay perpendicular (project out the new tangent).
        u = u - np.dot(u, t) * t
        u /= np.linalg.norm(u)
        v = np.cross(t, u)
        frames.append((u.copy(), v))
        prev_t = t
    del prev_t
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    verts = []
    for i in range(n):
        u, v = frames[i]
        ring = (path[i][None, :]
                + radius * (np.outer(np.cos(ang), u)
                            + np.outer(np.sin(ang), v)))
        verts.append(ring)
    verts = np.vstack(verts)
    faces = []
    for i in range(n - 1):
        a0, b0 = i * n_seg, (i + 1) * n_seg
        for j in range(n_seg):
            jn = (j + 1) % n_seg
            faces.append([a0 + j, b0 + j, a0 + jn])
            faces.append([a0 + jn, b0 + j, b0 + jn])
    if cap:
        c0 = len(verts)
        verts = np.vstack([verts, path[0][None, :], path[-1][None, :]])
        for j in range(n_seg):
            jn = (j + 1) % n_seg
            faces.append([c0, j, jn])
            top0 = (n - 1) * n_seg
            faces.append([c0 + 1, top0 + jn, top0 + j])
    return verts, np.asarray(faces, np.int64)


def _merge(parts):
    verts, faces = [], []
    off = 0
    for v, f in parts:
        verts.append(v)
        faces.append(np.asarray(f) + off)
        off += len(v)
    return np.vstack(verts), np.vstack(faces)


# ---------------------------------------------------------------------------
# Colour textures (per-vertex).


def _checker(verts, cell=0.02, c0=(220, 60, 50), c1=(245, 235, 210)):
    idx = np.floor(verts / cell).sum(axis=1).astype(int) % 2
    return np.where(idx[:, None] == 0, np.array(c0), np.array(c1)).astype(
        np.uint8)


def _bands(verts, axis=2, period=0.03, c0=(40, 90, 200), c1=(240, 200, 40)):
    idx = np.floor(verts[:, axis] / period).astype(int) % 2
    return np.where(idx[:, None] == 0, np.array(c0), np.array(c1)).astype(
        np.uint8)


def _gradient(verts, axis=2, c0=(30, 160, 90), c1=(230, 240, 235)):
    z = verts[:, axis]
    t = ((z - z.min()) / max(float(np.ptp(z)), 1e-9))[:, None]
    return ((1 - t) * np.array(c0) + t * np.array(c1)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Shapes.


def _densify_profile(prof: np.ndarray, res: float) -> np.ndarray:
    """Insert ceil(res)-1 interpolated rows between profile rows, so hires
    revolved surfaces gain rings (curvature detail) not just segments."""
    k = max(1, int(round(res)))
    if k == 1:
        return prof
    rows = [prof[0]]
    for i in range(1, len(prof)):
        for j in range(1, k + 1):
            rows.append(prof[i - 1] + (prof[i] - prof[i - 1]) * j / k)
    return np.asarray(rows)


def mug(r=0.042, h=0.10, wall=0.007, handle_r=0.026, res=1.0):
    """Open-top mug with a handle loop: concave interior + genus-1 handle."""
    prof = np.array([
        [1e-4, 0.0], [r, 0.0], [r, h],             # outer wall
        [r - wall, h], [r - wall, wall],           # inner wall down
        [1e-4, wall],                              # inner bottom
    ])
    body = _revolve(_densify_profile(prof, res), int(round(22 * res)),
                    close_bottom=False, close_top=False)
    # Handle: half-ellipse tube sticking out of the wall.
    ang = np.linspace(-0.45 * np.pi, 0.45 * np.pi, int(round(9 * res)))
    path = np.c_[r - 0.004 + handle_r * np.cos(ang),
                 np.zeros_like(ang),
                 h / 2 + handle_r * 1.05 * np.sin(ang)]
    handle = _tube(path, 0.007, n_seg=int(round(8 * res)))
    verts, faces = _merge([body, handle])
    return verts, faces, _checker(verts, cell=0.024)


def bowl(r=0.065, h=0.042, wall=0.006, res=1.0):
    """Open hemispherical shell: strong concavity, axial symmetry."""
    # Radius grows with sqrt(z): a shallow spherical-cap profile.
    zs = np.linspace(0.0, h, int(round(6 * res)))
    router = r * np.sqrt(np.clip(zs / h, 1e-4, 1.0))
    rinner = np.clip(router - wall, 1e-4, None)
    prof = np.vstack([
        np.c_[router, zs],                       # outer, bottom-up
        np.c_[rinner[::-1], np.clip(zs[::-1], wall, None)],  # inner, top-down
    ])
    verts, faces = _revolve(prof, int(round(20 * res)),
                            close_bottom=True, close_top=True)
    return verts, faces, _bands(verts, period=0.016,
                                c0=(200, 80, 160), c1=(240, 240, 240))


def l_bracket(w=0.10, d=0.05, h=0.10, t=0.03, res=1.0):
    """L-shaped extrusion: non-convex, no rotational symmetry."""
    # 2D L outline in (x, z), extruded along y.
    outline = np.array([
        [0, 0], [w, 0], [w, t], [t, t], [t, h], [0, h]], np.float64)
    n = len(outline)
    front = np.c_[outline[:, 0], np.full(n, 0.0), outline[:, 1]]
    back = np.c_[outline[:, 0], np.full(n, d), outline[:, 1]]
    verts = np.vstack([front, back])
    # Fan-triangulate the (convex-decomposed) L: two rectangles.
    quads2d = [(0, 1, 2, 3), (0, 3, 4, 5)]

    faces = []
    for (a, b, c, e) in quads2d:
        faces += [[a, c, b], [a, e, c]]               # front (-y, wound out)
        faces += [[n + a, n + b, n + c], [n + a, n + c, n + e]]  # back
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + i], [j, n + j, n + i]]   # side walls
    faces = np.asarray(faces, np.int64)
    for _ in range(int(np.log2(max(res, 1)))):
        verts, faces = _subdivide(verts, faces)
    return verts, faces, _checker(verts, cell=0.02,
                                  c0=(60, 60, 70), c1=(250, 190, 40))


def elbow(r=0.022, leg=0.09, res=1.0):
    """90-degree bent tube (pipe elbow)."""
    path = np.array(
        [[leg, 0, 0], [0.04, 0, 0], [0.015, 0, 0.004], [0.004, 0, 0.015],
         [0, 0, 0.04], [0, 0, leg]])
    path = _densify_profile(path, res)   # works for 3D polylines too
    verts, faces = _tube(path, r, n_seg=int(round(12 * res)))
    return verts, faces, _gradient(verts, axis=0,
                                   c0=(200, 120, 40), c1=(90, 200, 220))


def cracker_box(w=0.06, d=0.158, h=0.21, res=1.0):
    """YCB cracker-box-like cuboid with checker texture."""
    x, y = w / 2, d / 2
    verts = np.array([
        [-x, -y, 0], [x, -y, 0], [x, y, 0], [-x, y, 0],
        [-x, -y, h], [x, -y, h], [x, y, h], [-x, y, h]], np.float64)
    faces = np.array([
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int64)
    # Subdivide for colour resolution (per-vertex colours need vertices).
    for _ in range(2 + int(np.log2(max(res, 1)))):
        verts, faces = _subdivide(verts, faces)
    return verts, faces, _checker(verts, cell=0.035,
                                  c0=(200, 40, 40), c1=(250, 245, 235))


def soup_can(r=0.033, h=0.10, res=1.0):
    """Cylindrical can with label bands (axially symmetric)."""
    zs = np.linspace(0.0, h, int(round(9 * res)))
    prof = np.c_[np.full(len(zs), r), zs]   # ring per band step
    verts, faces = _revolve(prof, int(round(28 * res)))
    colors = _bands(verts, period=0.025,
                    c0=(190, 30, 40), c1=(245, 245, 245))
    return verts, faces, colors


def _subdivide(verts, faces):
    """One round of edge-midpoint subdivision (flat)."""
    verts = list(map(np.asarray, verts))
    edge_mid = {}
    out = []
    verts = [v for v in verts]

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            edge_mid[key] = len(verts)
            verts.append((verts[a] + verts[b]) / 2.0)
        return edge_mid[key]

    for (a, b, c) in faces:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(out, np.int64)


_ZOO = {
    # name -> (generator, symmetric)
    "mug": (mug, False),
    "bowl": (bowl, True),
    "l_bracket": (l_bracket, False),
    "elbow": (elbow, False),
    "cracker_box": (cracker_box, False),
    "soup_can": (soup_can, True),
}


def zoo_raw_geometry(name: str
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """(verts, faces, colors, symmetric) of one zoo shape."""
    gen, symmetric = _ZOO[name]
    v, f, c = gen()
    return v, f, c, symmetric
