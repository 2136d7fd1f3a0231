"""The reference's answer to one request: the observed scene, candidate
validity, scoring, and the mode's choice (greedy 6-DoF argmin, greedy ICP
over the 3-DoF grid, or the 3-DoF tree search).

Frozen copies of the port's host logic (`pipeline/env.py`,
`pipeline/recognizer.py`, `pipeline/search.py` at their defaults), written
against the plain scorer of this package. `Reference.answer(frame)` returns,
for every object the mode reports, its world pose and, for the greedy
modes, every scored candidate with its adjusted world pose and costs, so
that an answer of the program can be located among them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.spatial import cKDTree

from portbench.reference.cloud import observed_cloud
from portbench.reference.geometry import Candidate, Pose
from portbench.reference.icp import cloud_normals
from portbench.reference.raster import render
from portbench.reference.scorer import Scene, Work, score_batch


@dataclasses.dataclass
class Scored:
    cand: Candidate
    cost: int
    target: int
    source: int
    world: np.ndarray            # [4, 4] adjusted world transform of the
                                 # original mesh frame (ContPose semantics)


@dataclasses.dataclass
class Answer:
    names: list[str]
    poses: list[np.ndarray]      # world transforms, in reply order
    keys: list[tuple]            # (model, label) per detection
    scored: dict[tuple, list[Scored]]   # greedy modes: every candidate by key
    best: dict[tuple, Scored]    # greedy modes: the chosen candidate by key


class Reference:
    """cfg: the configuration file's `perch`, `env` and `camera` blocks
    merged with the bank (geometry.Bank), on `device`. A configuration's
    `reference` may name a module that subclasses this one and swaps
    `score_batch` alone (same arguments, returns `scorer.Scores`)."""

    score_batch = staticmethod(score_batch)

    def __init__(self, bank, camera: dict, perch: dict, env: dict,
                 device: str = "cuda", quant=None, batch: int = 1100):
        self.bank, self.camera = bank, camera
        self.perch, self.envc = perch, env
        self.device = torch.device(device)
        self.quant = quant
        self.batch = batch
        self.work = Work()
        dev = self._t
        from portbench.reference.geometry import projection
        self.proj = dev(projection(**camera), torch.float32)
        samp, snrm = bank.surface_samples(env["icp_model_samples"])
        self.tensors = dict(
            tri_verts=dev(bank.tri_verts, torch.float32),
            tri_valid=dev(bank.tri_valid, torch.bool),
            cullable=dev(bank.cullable, torch.bool),
            icp_samples=dev(samp, torch.float32),
            icp_normals=dev(snrm, torch.float32))
        models = bank.models
        self.circ = np.array([m.circumscribed_radius for m in models])
        self.cyl = np.array([m.inflation_factor * m.circumscribed_radius
                             for m in models])
        self.footprints = [m.footprint_hull() for m in models]
        self.grid_rad = float(np.hypot(env["res"] / 2, env["res"] / 2))

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    # -- the observed scene ------------------------------------------------

    def strided(self, img):
        s = int(self.perch["gpu_stride"])
        rows, cols = self.camera["height"] // s, self.camera["width"] // s
        return img[..., :rows * s:s, :cols * s:s]

    def set_input(self, frame: dict) -> None:
        cam, env, dev = self.camera, self.envc, self._t
        self.frame = frame
        self.six_dof = frame.get("label_mask") is not None
        depth = np.asarray(frame["depth_image"], np.float64)
        h, w = depth.shape
        c2w = np.asarray(frame["cam_to_world"], np.float64)
        self.c2w = c2w
        if self.six_dof:
            label = np.asarray(frame["label_mask"], np.int32)
            bounds = None
        else:
            label = np.ones((h, w), np.int32)
            bounds = dev([frame["x_max"], frame["x_min"], frame["y_max"],
                          frame["y_min"], frame["table_height"] + 2.0,
                          frame["table_height"] - 0.01], torch.float32)
        stride = int(self.perch["gpu_stride"])
        obs = observed_cloud(
            dev(depth, torch.float32), dev(label, torch.int32),
            fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
            width=cam["width"], height=cam["height"], stride=stride,
            depth_factor=float(frame["depth_factor"]),
            max_points=env["max_observed_points"],
            seg_cap=env["max_points_per_label"], num_labels=env["max_labels"],
            use_label_filter=self.six_dof, bounds=bounds,
            cam_to_world=dev(c2w.astype(np.float32)))
        seg_normals = cloud_normals(obs.seg_xyz, obs.seg_valid, k=10)
        division = float(frame["depth_factor"]) / env["gpu_depth_factor"]
        src = self.strided(depth).astype(np.float64) / division
        self.scene = Scene(
            seg_xyz=obs.seg_xyz, seg_valid=obs.seg_valid,
            seg_normals=seg_normals,
            source_depth=dev(src.astype(np.int32), torch.int32),
            source_label=dev(self.strided(label), torch.int32))
        self.seg_count = obs.seg_count.cpu().numpy().astype(np.float32)
        valid = obs.valid.cpu().numpy()
        xyz = obs.xyz.cpu().numpy()[valid]
        labels = obs.label.cpu().numpy()[valid]
        self.world_points = xyz @ c2w[:3, :3].T + c2w[:3, 3]
        self.world_tree = (cKDTree(self.world_points)
                           if len(self.world_points) else None)
        self.seg_trees = []
        for lab in range(env["max_labels"]):
            seg = self.world_points[labels == lab]
            self.seg_trees.append(cKDTree(seg) if len(seg) else None)

    # -- poses -------------------------------------------------------------

    def to_camera(self, c: Candidate) -> np.ndarray:
        pre = self.bank.models[c.model].preprocessing
        return (np.linalg.inv(self.c2w) @ c.pose.transform()
                @ pre).astype(np.float32)

    def to_world(self, mat_cam: np.ndarray, model: int) -> np.ndarray:
        m = self.c2w @ mat_cam @ np.linalg.inv(
            self.bank.models[model].preprocessing)
        return Pose.from_matrix(m).transform()

    # -- validity ----------------------------------------------------------

    def valid_6dof(self, c: Candidate) -> bool:
        model = self.bank.models[c.model]
        rad = max(model.inflation_factor * model.circumscribed_radius_3d,
                  self.grid_rad)
        tree = None
        if 0 <= c.label - 1 < len(self.seg_trees):
            tree = self.seg_trees[c.label - 1]
        tree = tree if tree is not None else self.world_tree
        if tree is None:
            return False
        p = np.array([c.pose.x, c.pose.y, c.pose.z])
        return (len(tree.query_ball_point(p, rad))
                >= self.perch["min_neighbor_points_for_valid_pose"])

    def _projected_counts(self, xy, rad):
        pts = self.world_points[:, :2]
        out = np.zeros(len(xy), np.int64)
        step = max(1, (1 << 22) // max(len(pts), 1))
        for lo in range(0, len(xy), step):
            d2 = ((pts[None] - xy[lo:lo + step, None]) ** 2).sum(axis=2)
            r = rad[lo:lo + step]
            out[lo:lo + step] = (d2 <= (r * r)[:, None]).sum(axis=1)
        return out

    def valid_3dof(self, cands: list[Candidate]) -> np.ndarray:
        ok = np.zeros(len(cands), bool)
        if self.world_tree is None or not cands:
            return ok
        ids = np.array([c.model for c in cands])
        xy = np.array([[c.pose.x, c.pose.y] for c in cands], np.float64)
        rad = np.maximum(self.circ[ids], self.grid_rad)
        ok = (self._projected_counts(xy, rad)
              >= self.perch["min_neighbor_points_for_valid_pose"])
        tol = self.perch["footprint_tolerance"]
        f = self.frame
        groups: dict[tuple, list[int]] = {}
        for i, c in enumerate(cands):
            groups.setdefault((c.model, c.pose.yaw), []).append(i)
        for idx in groups.values():
            c = cands[idx[0]]
            base = self.footprints[c.model] @ c.pose.rotation()[:2, :2].T
            fp = base[None] + xy[idx][:, None, :]
            out = ((fp[..., 0] < f["x_min"] - tol).any(axis=1)
                   | (fp[..., 0] > f["x_max"] + tol).any(axis=1)
                   | (fp[..., 1] < f["y_min"] - tol).any(axis=1)
                   | (fp[..., 1] > f["y_max"] + tol).any(axis=1))
            ok[idx] &= ~out
        return ok

    def grid_3dof(self) -> list[Candidate]:
        f, env = self.frame, self.envc
        out = []
        for mid, model in enumerate(self.bank.models):
            n_theta = 1 if model.symmetric else max(
                1, int(round(2 * np.pi / env["theta_res"])))
            x = f["x_min"]
            while x <= f["x_max"] + 1e-9:
                y = f["y_min"]
                while y <= f["y_max"] + 1e-9:
                    for k in range(n_theta):
                        out.append(Candidate(mid, Pose(
                            x=x, y=y, z=f["table_height"],
                            yaw=k * env["theta_res"]), 1))
                    y += env["res"]
                x += env["res"]
        return out

    def successors_3dof(self) -> list[Candidate]:
        grid = self.grid_3dof()
        return [c for c, keep in zip(grid, self.valid_3dof(grid)) if keep]

    # -- scoring -----------------------------------------------------------

    def scorer_config(self, do_icp: bool) -> dict:
        cam, perch, env = self.camera, self.perch, self.envc
        stride = int(perch["gpu_stride"])
        roi = None
        if env["roi_size"]:
            roi = (min(env["roi_size"], cam["height"] // stride),
                   min(env["roi_size"], cam["width"] // stride))
        return dict(
            **{k: cam[k] for k in ("fx", "fy", "cx", "cy", "width",
                                   "height")},
            stride=stride, roi_shape=roi,
            max_points_per_pose=env["max_points_per_pose"],
            icp_downsample=env["icp_downsample"],
            icp_crop_targets=env["icp_crop_targets"],
            cost_crop_targets=env["cost_crop_targets"],
            icp_max_iterations=min(perch["max_icp_iterations"], 60),
            icp_max_correspondence=perch["icp_max_correspondence"],
            icp_nn_every=env["icp_nn_every"],
            icp_rotation_epsilon=2e-3, icp_transformation_epsilon=5e-4,
            icp_stagnation_streak=env["icp_stagnation_streak"],
            sensor_resolution=perch["sensor_resolution"],
            occlusion_threshold=perch["gpu_occlusion_threshold"],
            use_segmentation_label=self.six_dof,
            use_tree_occlusion=perch["use_tree_occlusion"])

    def totals(self, cands: list[Candidate]) -> np.ndarray:
        if self.six_dof:
            return self.seg_count[[max(c.label - 1, 0) for c in cands]]
        if self.perch["use_cylinder_observed"]:
            rad = self.cyl[[c.model for c in cands]]
            xy = np.array([[c.pose.x, c.pose.y] for c in cands], np.float64)
            return self._projected_counts(xy, rad).astype(np.float32)
        return np.full(len(cands), float(len(self.world_points)), np.float32)

    def score(self, cands: list[Candidate], do_icp: bool,
              scene: Scene | None = None) -> list[Scored]:
        """Every candidate scored, in blocks of `batch`, with no padding."""
        cfg = self.scorer_config(do_icp)
        scene = scene or self.scene
        dev = self._t
        out: list[Scored] = []
        for lo in range(0, len(cands), self.batch):
            chunk = cands[lo:lo + self.batch]
            poses = np.stack([self.to_camera(c) for c in chunk])
            s = self.score_batch(
                self.tensors, dev(poses, torch.float32),
                dev([c.model for c in chunk], torch.int64),
                dev([max(c.label - 1, 0) for c in chunk], torch.int64),
                dev(self.totals(chunk), torch.float32), self.proj, scene,
                cfg, do_icp, quant=self.quant)
            self.work.add(s.work)
            total = s.total.cpu().numpy()
            rendered = s.rendered.cpu().numpy()
            observed = s.observed.cpu().numpy()
            adjusted = s.adjusted.cpu().numpy()
            for i, c in enumerate(chunk):
                out.append(Scored(c, int(total[i]), int(rendered[i]),
                                  int(observed[i]),
                                  self.to_world(adjusted[i], c.model)))
        return out

    # -- the modes ---------------------------------------------------------

    def answer(self, frame: dict) -> Answer:
        self.set_input(frame)
        mode = frame.get("mode", "greedy")
        if mode == "greedy":
            return self._greedy(frame)
        if mode == "greedy_icp":
            return self._greedy_icp()
        return self._tree()

    def _name(self, key) -> str:
        names = self.frame.get("segmented_object_names") or []
        if self.six_dof and 1 <= key[1] <= len(names):
            return names[key[1] - 1]
        return self.bank.models[key[0]].name

    def _greedy(self, frame) -> Answer:
        names = frame["segmented_object_names"]
        bank_names = [m.name for m in self.bank.models]
        cands = []
        for model_name, rows in frame["pose_lists"].items():
            mid = bank_names.index(model_name)
            label = names.index(model_name) + 1 if model_name in names else 1
            for row in rows:
                c = Candidate(mid, Pose(*row[:7]), label)
                if self.valid_6dof(c):
                    cands.append(c)
        scored = self.score(cands, do_icp=True)
        by_key: dict[tuple, list[Scored]] = {}
        best: dict[tuple, Scored] = {}
        for su in scored:
            if su.cost in (-1, -2) or abs(su.target - su.source) >= 30:
                continue
            key = (su.cand.model, su.cand.label)
            by_key.setdefault(key, []).append(su)
            if key not in best or su.cost < best[key].cost:
                best[key] = su
        keys = sorted(best)
        return Answer([self._name(k) for k in keys],
                      [best[k].world for k in keys], keys, by_key, best)

    def _greedy_icp(self) -> Answer:
        scored = self.score(self.successors_3dof(), do_icp=True)
        by_key: dict[tuple, list[Scored]] = {}
        best: dict[tuple, Scored] = {}
        for su in scored:
            if su.cost < 0:
                continue
            key = (su.cand.model, 1)
            by_key.setdefault(key, []).append(su)
            if key not in best or su.target < best[key].target:
                best[key] = su
        keys = sorted(best)
        return Answer([self._name(k) for k in keys],
                      [best[k].world for k in keys], keys, by_key, best)

    # -- the tree search ---------------------------------------------------

    def _single_depth(self, c: Candidate, cache: dict) -> np.ndarray:
        """The strided depth of one object rendered alone at stride 1 (the
        search's composition render; no backface cull)."""
        key = (c.model, round(c.pose.x, 6), round(c.pose.y, 6),
               round(c.pose.z, 6), round(c.pose.roll, 6),
               round(c.pose.pitch, 6), round(c.pose.yaw, 6))
        if key not in cache:
            t, cam = self.tensors, self.camera
            out = render(t["tri_verts"], t["tri_valid"],
                         self._t(self.to_camera(c)[None], torch.float32),
                         self._t([c.model], torch.int64), self.proj,
                         width=cam["width"], height=cam["height"], stride=1,
                         quant=self.quant)
            cache[key] = self.strided(
                out.depth[0].cpu().numpy()).astype(np.int32)
        return cache[key]

    def _tree(self, beam_width: int = 2, max_per_model: int = 512) -> Answer:
        per_model: dict[int, list[Candidate]] = {}
        for c in self.successors_3dof():
            per_model.setdefault(c.model, []).append(c)
        for mid in per_model:
            per_model[mid] = per_model[mid][:max_per_model]
        root_depth = self.scene.source_depth.cpu().numpy().astype(np.int32)
        # A node: (placed candidates, g, source depth, source label, ids).
        frontier = [((), 0, root_depth, np.zeros_like(root_depth),
                     frozenset())]
        cache: dict = {}
        if not per_model:
            return Answer([], [], [], {}, {})
        for _ in range(len(per_model)):
            expansions = []
            for node in frontier:
                cands = [c for mid in per_model if mid not in node[4]
                         for c in per_model[mid]]
                if not cands:
                    continue
                scene = dataclasses.replace(
                    self.scene,
                    source_depth=self._t(node[2], torch.int32),
                    source_label=self._t(node[3], torch.int32))
                for su in self.score(cands, do_icp=False, scene=scene):
                    if su.cost >= 0:
                        expansions.append((node, su))
            if not expansions:
                break
            expansions.sort(key=lambda e: e[0][1] + e[1].cost)
            new_frontier = []
            seen = set()
            for node, su in expansions:
                if len(new_frontier) >= beam_width:
                    break
                c = su.cand
                key = (node[4], c.model, round(c.pose.x, 3),
                       round(c.pose.y, 3))
                if key in seen:
                    continue
                seen.add(key)
                d = self._single_depth(c, cache)
                closer = (d > 0) & ((node[2] == 0) | (d < node[2]))
                new_frontier.append((
                    node[0] + (c,), node[1] + su.cost,
                    np.where(closer, d, node[2]).astype(np.int32),
                    np.where(closer, c.model + 1, node[3]).astype(np.int32),
                    node[4] | {c.model}))
            if not new_frontier:
                break
            frontier = new_frontier
        placed = min(frontier, key=lambda n: n[1])[0]
        keys = [(c.model, 1) for c in placed]
        return Answer([self.bank.models[c.model].name for c in placed],
                      [c.pose.transform() for c in placed], keys, {}, {})
