"""A configuration's meshes and a run's frames, made from the seed.

Nothing here comes from the program: the meshes are the frozen zoo shapes
(`zoo.py`) or bumpy spheres, the frames are rendered by the reference's
plain rasteriser, a 3-DoF frame is degraded by a frozen copy of the Kinect
model (`sensor.py`), and the 6-DoF candidate rows follow PERCH 2.0's rule
(the mask's centroid unprojected at depth layers 2 cm apart, crossed with
fibonacci-sphere rotations by the object's symmetry), frozen here.

A 6-DoF frame holds three distinct models drawn from the six, as the
dataset generator draws them, and each object gets as many depth layers as
its mask's depth spans: the seed changes the models, their poses and with
them the number of candidate rows. A 3-DoF frame holds the configuration's
three models, placed by the table scene's rule. A configuration's other
`scene.kind` is a file of its own beside this one (`kind`).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from portbench import load_file
from portbench.reference.geometry import (
    CAM_TO_BODY,
    Bank,
    euler_xyz_to_matrix,
    make_model,
    matrix_to_quat,
    projection,
    quat_to_matrix,
)
from portbench.reference.raster import render
from portbench.scenes import sensor, zoo

SCENES = Path(__file__).resolve().parent
# (whole sphere, in-plane mode) by YCB name (PERCH 2.0's name_sym_dict).
YCB_SYMMETRY = {
    "002_master_chef_can": (0, 0), "003_cracker_box": (0, 0),
    "004_sugar_box": (0, 3), "005_tomato_soup_can": (0, 0),
    "006_mustard_bottle": (0, 0), "007_tuna_fish_can": (0, 0),
    "008_pudding_box": (0, 1), "009_gelatin_box": (0, 0),
    "010_potted_meat_can": (0, 0), "011_banana": (1, 0),
    "019_pitcher_base": (0, 0), "021_bleach_cleanser": (0, 0),
    "024_bowl": (1, 0), "025_mug": (0, 1), "035_power_drill": (0, 7),
    "036_wood_block": (0, 0), "037_scissors": (0, 2),
    "040_large_marker": (1, 0), "051_large_clamp": (0, 7),
    "052_extra_large_clamp": (0, 7), "061_foam_brick": (0, 0),
}


# -- meshes -----------------------------------------------------------------

def bumpy_sphere(rng: np.random.Generator, radius: float, n_seg: int = 32,
                 n_rings: int = 18):
    """A closed, non-convex, star-shaped blob of 2 n_seg (n_rings - 2)
    triangles (1024 by default): a UV sphere under a smooth radial field of
    three random sinusoids, wound outward."""
    lat = np.linspace(0, np.pi, n_rings)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([np.outer(np.sin(lat), np.cos(lon)),
                     np.outer(np.sin(lat), np.sin(lon)),
                     np.repeat(np.cos(lat)[:, None], n_seg, axis=1)], -1)
    v = np.vstack([[0, 0, 1.0], ring.reshape(-1, 3), [0, 0, -1.0]])
    bottom = len(v) - 1
    faces = []
    for j in range(n_seg):
        jn = (j + 1) % n_seg
        faces.append([0, 1 + j, 1 + jn])
    for i in range(n_rings - 3):
        a, b = 1 + i * n_seg, 1 + (i + 1) * n_seg
        for j in range(n_seg):
            jn = (j + 1) % n_seg
            faces.append([a + j, b + j, a + jn])
            faces.append([a + jn, b + j, b + jn])
    last = 1 + (n_rings - 3) * n_seg
    for j in range(n_seg):
        jn = (j + 1) % n_seg
        faces.append([bottom, last + jn, last + j])
    freq = rng.uniform(1.5, 3.5, (3, 3))
    phase = rng.uniform(0, 2 * np.pi, 3)
    r = 1.0 + 0.22 * np.sum([np.sin(v @ freq[i] + phase[i])
                             for i in range(3)], axis=0) / 3
    return v * (radius * r[:, None]), np.asarray(faces, np.int64)


def meshes(config: dict, seed: int) -> list[dict]:
    """The configuration's models: name, verts (m), faces, vertex colours
    and symmetry."""
    spec = config["models"]
    if spec["kind"] == "zoo":
        out = []
        for name, shape in spec["names"].items():
            v, f, c, sym = zoo.zoo_raw_geometry(shape)
            out.append(dict(name=name, verts=v, faces=f, colors=c,
                            symmetric=sym))
        return out
    if spec["kind"] == "bumpy":
        rng = np.random.default_rng([seed, 1])
        out = []
        for name, radius in zip(spec["names"], spec["radii"]):
            v, f = bumpy_sphere(rng, radius, spec["n_seg"], spec["n_rings"])
            out.append(dict(name=name, verts=v, faces=f,
                            colors=rng.uniform(40, 220, (len(v), 3)),
                            symmetric=False))
        return out
    raise ValueError(f"unknown model kind {spec['kind']!r}")


def reference_bank(config: dict, mesh_list: list[dict],
                   scenes: Path = SCENES) -> Bank:
    six_dof = kind(config, scenes)[0]
    return Bank.build([make_model(m["name"], m["verts"], m["faces"],
                                  six_dof, m["symmetric"])
                       for m in mesh_list])


# -- rendering --------------------------------------------------------------

def render_scene(bank: Bank, camera: dict, cam_to_world: np.ndarray,
                 placed: list[tuple[int, np.ndarray]], device):
    """Full-resolution depth (m, 0 empty) and 1-based instance labels of
    the placed (model, world transform) objects, the nearest surface per
    pixel."""
    dev = torch.device(device)
    t = lambda a, d: torch.as_tensor(np.ascontiguousarray(a), dtype=d,
                                     device=dev)
    poses = np.stack([(np.linalg.inv(cam_to_world) @ tf
                       @ bank.models[m].preprocessing).astype(np.float32)
                      for m, tf in placed])
    out = render(t(bank.tri_verts, torch.float32),
                 t(bank.tri_valid, torch.bool), t(poses, torch.float32),
                 t([m for m, _ in placed], torch.int64),
                 t(projection(**camera), torch.float32),
                 width=camera["width"], height=camera["height"], stride=1)
    w = out.w.double().cpu().numpy()
    depth = np.where(w > 0, 0.01 / np.where(w > 0, w, 1.0), np.inf)
    near = depth.argmin(axis=0)
    d = np.take_along_axis(depth, near[None], axis=0)[0]
    label = np.where(np.isfinite(d), near + 1, 0).astype(np.int32)
    return np.where(np.isfinite(d), d, 0.0), label


def _in_view(camera: dict, cam_to_world, xyz) -> bool:
    x, y, z = (np.linalg.inv(cam_to_world) @ [*xyz, 1.0])[:3]
    if z <= 0:
        return False
    u = camera["fx"] * x / z + camera["cx"]
    v = camera["fy"] * y / z + camera["cy"]
    return 0 <= u < camera["width"] and 0 <= v < camera["height"]


# -- 6-DoF ------------------------------------------------------------------

def rotation_samples(name: str, num_samples: int) -> np.ndarray:
    """Euler (roll, pitch, yaw) rotations: fibonacci viewpoints (half the
    sphere unless whole-sphere symmetric) by the in-plane mode."""
    whole, inplane = YCB_SYMMETRY.get(name, (0, 0))
    half = whole == 0
    increment = math.pi * (3.0 - math.sqrt(5.0))
    offset = 2.0 / num_samples
    count = round(num_samples / 2) if half else num_samples
    rots = []
    for i in range(count):
        y = i * offset - 1 + offset / 2
        r = math.sqrt(max(0.0, 1 - y * y))
        phi_s = ((i + 1) % num_samples) * increment
        v = (math.cos(phi_s) * r, y, math.sin(phi_s) * r)
        norm = math.sqrt(sum(c * c for c in v))
        theta = math.pi / 2 - math.acos(max(-1.0, min(1.0, v[2] / norm)))
        phi = math.atan2(v[1], v[0])
        if inplane == 1:
            rots += [[-phi, yaw, theta] for yaw in np.arange(0, math.pi,
                                                             math.pi / 2)]
        elif inplane == 0:
            rots.append([-phi, theta, 0.0])
        else:
            raise ValueError(f"in-plane mode {inplane} is not used here")
    return np.asarray(rots, np.float64)


def candidates(depth_m, label, names, camera, cam_to_world, rule) -> dict:
    """Per object, rows (x y z qx qy qz qw): the mask's pixel centroid
    unprojected at the mask's nearest to farthest depth, `resolution`
    apart, crossed with the rotation samples (`generate_candidates`)."""
    out = {}
    for i, name in enumerate(names):
        mask = label == i + 1
        nz = depth_m[mask & (depth_m > 0)]
        ys, xs = np.nonzero(mask)
        centroid = np.array([xs.mean(), ys.mean()])
        quats = [matrix_to_quat(euler_xyz_to_matrix(*r))
                 for r in rotation_samples(name, rule["num_samples"])]
        res = rule["resolution"]
        rows = []
        for d in np.arange(nz.min(), nz.max() + res, res):
            x = (centroid[0] - camera["cx"]) / camera["fx"] * d
            y = (centroid[1] - camera["cy"]) / camera["fy"] * d
            p = cam_to_world @ [x, y, d, 1.0]
            rows += [[p[0], p[1], p[2], *q] for q in quats]
        out[name] = np.asarray(rows)
    return out


def place_6dof(config, bank: Bank, rng: np.random.Generator, device):
    """One 6-DoF scene: `num_objects` distinct models drawn from the bank,
    placed at random positions and orientations until each is in view and
    shows `min_visible_pixels`. -> (placed (model, world transform), depth
    (m, 0 empty), 1-based labels, the models' names in label order)."""
    sc, cam = config["scene"], config["camera"]
    names = [m.name for m in bank.models]
    while True:
        trio = [names[i] for i in rng.choice(len(names),
                                             size=sc["num_objects"],
                                             replace=False)]
        placed, xy = [], []
        for name in trio:
            for _ in range(100):
                pos = np.array([rng.uniform(*sc["x_range"]),
                                rng.uniform(*sc["y_range"]),
                                rng.uniform(*sc["z_range"])])
                if all(np.linalg.norm(pos[:2] - p) >= sc["min_separation"]
                       for p in xy):
                    break
            else:
                break
            xy.append(pos[:2])
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            tf = np.eye(4)
            tf[:3, :3] = quat_to_matrix(*q)
            tf[:3, 3] = pos
            placed.append((names.index(name), tf))
        if len(placed) < len(trio) or not all(
                _in_view(cam, CAM_TO_BODY, tf[:3, 3]) for _, tf in placed):
            continue
        depth, label = render_scene(bank, cam, CAM_TO_BODY, placed, device)
        if all((label == i + 1).sum() >= sc["min_visible_pixels"]
               for i in range(len(placed))):
            return placed, depth, label, trio


def request_6dof(config, mode: str, depth_mm, label, trio) -> dict:
    """A 6-DoF frame's request: depth in mm, the masks, and each object's
    candidate rows from the depth it is sent with."""
    rows = candidates(depth_mm / 1000.0, label, trio, config["camera"],
                      CAM_TO_BODY, config["candidates"])
    return {
        "mode": mode, "depth_image": depth_mm.astype(np.int64),
        "label_mask": label, "depth_factor": 1000.0,
        "cam_to_world": CAM_TO_BODY, "segmented_object_names": trio,
        "pose_lists": rows}


def frames_6dof(config, traffic, bank: Bank, seed: int, device) -> list:
    rng = np.random.default_rng([seed, 2])
    out = []
    for _ in range(traffic["frames"]):
        _, depth, label, trio = place_6dof(config, bank, rng, device)
        out.append(request_6dof(config, traffic["mode"],
                                np.rint(depth * 1000.0), label, trio))
    return out


# -- 3-DoF ------------------------------------------------------------------

def camera_to_world(pitch: float) -> np.ndarray:
    rot = np.eye(4)
    rot[:3, :3] = euler_xyz_to_matrix(0.0, pitch, 0.0)
    return rot @ CAM_TO_BODY


def frames_3dof(config, traffic, bank: Bank, seed: int, device) -> list:
    sc, cam, env = config["scene"], config["camera"], config["env"]
    rng = np.random.default_rng([seed, 3])
    c2w = camera_to_world(sc["camera_pitch"])
    region = sc["region"]
    res, theta_res = env["res"], env["theta_res"]
    n_theta = int(round(2 * np.pi / theta_res))
    out = []
    for _ in range(traffic["frames"]):
        while True:
            placed, xy = [], []
            for mid in range(len(bank.models)):
                for _ in range(100):
                    gx = region["x_min"] + res * rng.integers(
                        *[round((v - region["x_min"]) / res)
                          for v in sc["cell_x"]], endpoint=True)
                    gy = region["y_min"] + res * rng.integers(
                        *[round((v - region["y_min"]) / res)
                          for v in sc["cell_y"]], endpoint=True)
                    ang = rng.uniform(0, 2 * np.pi)
                    off = rng.uniform(*sc["offset_m"])
                    pos = np.array([gx + off * np.cos(ang),
                                    gy + off * np.sin(ang)])
                    if all(np.linalg.norm(pos - p) >= sc["min_separation"]
                           for p in xy):
                        break
                else:
                    break
                xy.append(pos)
                yaw = (rng.integers(n_theta) * theta_res
                       + rng.choice([-1.0, 1.0])
                       * np.radians(rng.uniform(*sc["yaw_off_deg"])))
                tf = np.eye(4)
                tf[:3, :3] = euler_xyz_to_matrix(0.0, 0.0, yaw)
                tf[:3, 3] = [pos[0], pos[1], sc["table_height"]]
                placed.append((mid, tf))
            if len(placed) < len(bank.models):
                continue
            depth, label = render_scene(bank, cam, c2w, placed, device)
            if all((label == i + 1).sum() >= sc["min_visible_pixels"]
                   for i in range(len(placed))):
                break
        depth = sensor.KINECT.apply_depth(depth, rng)
        out.append({
            "mode": traffic["mode"],
            "depth_image": np.rint(depth * 1000.0).astype(np.int64),
            "depth_factor": 1000.0, "cam_to_world": c2w,
            "table_height": sc["table_height"], **region})
    return out


# -- scene kinds ------------------------------------------------------------

KINDS = {"6dof": (True, frames_6dof), "3dof": (False, frames_3dof)}


def kind(config: dict, scenes: Path = SCENES):
    """(six_dof, make) of the configuration's `scene.kind`: "6dof" and
    "3dof" are this file's; any other kind is `scenes/<kind>.py`, which sets
    `SIX_DOF` (the models' preprocessing and the program's external pose
    list) and `make(config, traffic, bank, seed, device)`."""
    name = config["scene"]["kind"]
    if name in KINDS:
        return KINDS[name]
    mod = load_file(Path(scenes) / f"{name}.py", "portbench_scene")
    return mod.SIX_DOF, mod.make


def make_frames(config, traffic, bank: Bank, seed: int, device,
                scenes: Path = SCENES) -> list:
    """The traffic's distinct frames as request payloads, their images and
    rows as arrays (`encode` turns one into the request's bytes)."""
    return kind(config, scenes)[1](config, traffic, bank, seed, device)


def encode(frame: dict) -> bytes:
    """The JSON body of a frame's request (arrays as nested lists)."""
    return json.dumps(frame, default=lambda a: a.tolist()).encode()
