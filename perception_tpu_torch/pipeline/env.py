"""Recognition environment: observed-input processing and candidate scoring.

Counterpart of `perception_tpu/pipeline/env.py`: `set_input` builds the
observed scene (label-partitioned cloud and its Lab colours, segment normals,
strided source images) on the env's device and the world-frame points and
KD-trees for validity pruning on the host. A 6-DoF input carries an instance
mask and external candidate poses; a 3-DoF (table-top) input carries none:
every observed point inside the search region (`x_min` .. `y_max` above
`table_height`) is one segment, and candidates are an (x, y, yaw) grid
(`generate_successors_3dof`). `score_object_states` runs `score_pose_batch`
in `gpu_batch_size` chunks, cost type 2 / 3 in 6-DoF mode and 0 / 1 in 3-DoF
mode (the CIEDE2000 colour gate when `PerchConfig.use_color_cost` is set);
`compute_greedy_poses` takes the per-(model, segment) argmin with the
|target - source| < 30 filter, or, with `collision_ordering`, the commit
order of the reference's greedy-ICP baseline. With `EnvConfig.fine_stride`
it first re-scores the best `fine_top_k` candidates per (model, segment)
(per model in 3-DoF mode) at their refined poses against a second scene
built at that finer stride; with `pose_refinement_rounds` it re-scores the
winners under small rotations about fibonacci axes and keeps any that score
lower; with `PerchConfig.vis_expanded_states` and a `debug_dir` it writes
the final state's depth and colour renders as PNGs. The env runs on the card
unless given `device="cpu"`.

`EnvConfig.kernel_backend` picks the scoring raster ("auto" and
"pallas_direct": the direct kernel; "pallas": the coefficient-table kernel;
"pallas_bin": the scatter-bin kernel; "xla" raises); the observation
render of `render_composite` always takes the direct kernel, as the JAX env
takes its default backend there.

The observed scene of a stride s lies on the (H // s) x (W // s) grid of
`strided`, also where s does not divide the frame (the JAX env takes every
s-th pixel of the whole frame there, and its scorer then fails on the
mismatched shapes).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Sequence

import numpy as np
import torch
from scipy.spatial import cKDTree

from perception_tpu_torch.core.config import (
    CameraIntrinsics,
    EnvConfig,
    PerchConfig,
)
from perception_tpu_torch.core.mesh import ModelBank
from perception_tpu_torch.core.pose import (
    CAM_TO_BODY,
    ContPose,
    euler_xyz_to_matrix,
)
from perception_tpu_torch.core.state import (
    Discretizer,
    GraphState,
    ObjectState,
)
from perception_tpu_torch.eval.sampling import sphere_fibonacci_grid
from perception_tpu_torch.eval.sensor_model import SensorModel
from perception_tpu_torch.io.images import write_png
from perception_tpu_torch.ops.color import rgb_to_lab
from perception_tpu_torch.ops.cost import (
    COST_TYPE_3DOF_DEPTH,
    COST_TYPE_3DOF_RGBD,
    COST_TYPE_6DOF,
    COST_TYPE_6DOF_RGB,
)
from perception_tpu_torch.ops.icp import cloud_normals
from perception_tpu_torch.ops.pointcloud import observed_cloud_from_depth
from perception_tpu_torch.ops.rasterizer import check_backend, render_pose_batch
from perception_tpu_torch.pipeline.pruning import prune_successors
from perception_tpu_torch.pipeline.scorer import (
    ObservedScene,
    ScorerConfig,
    score_pose_batch,
)
from perception_tpu_torch.utils.debug import save_depth_image
from perception_tpu_torch.utils.stats import NO_SPAN, EnvStats, span


@dataclasses.dataclass
class RecognitionInput:
    """Observed scene input (the JAX RecognitionInput)."""

    depth_image: np.ndarray                 # [H, W] raw sensor units
    color_image: np.ndarray | None = None   # [H, W, 3]
    label_mask: np.ndarray | None = None    # [H, W] int, 1-based instances
    depth_factor: float = 100.0             # sensor units per metre
    cam_to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: CAM_TO_BODY.copy())
    segmented_object_names: list[str] = dataclasses.field(default_factory=list)
    # 3-DoF support-surface search region (world frame).
    x_min: float = -1.0
    x_max: float = 1.0
    y_min: float = -1.0
    y_max: float = 1.0
    table_height: float = 0.0
    use_external_pose_list: bool = True     # 6-DoF mode


@dataclasses.dataclass
class ScoredState:
    """Per-candidate result (reference CostComputationOutput)."""

    state: ObjectState
    cost: int
    target_cost: int
    source_cost: int
    last_level_cost: int
    adjusted_pose_cam: np.ndarray   # [4, 4] model->camera (post-ICP)


class PerceptionEnv:
    def __init__(self, bank: ModelBank, camera: CameraIntrinsics,
                 perch: PerchConfig | None = None,
                 env: EnvConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.bank = bank
        self.camera = camera
        self.perch = perch or PerchConfig()
        self.env = env or EnvConfig(width=camera.width, height=camera.height)
        check_backend(self.env.kernel_backend)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the env runs on the card "
                               "unless given device='cpu'")
        self.stats = EnvStats()
        # The composed ICP refiners' loop iterations since the last
        # set_input, summed over the scored batches (the service's
        # `stats.icp_iterations`; not an EnvStats field, which keep the JAX
        # package's).
        self.icp_iterations = 0
        # Graph-state identity for the search's deduplication; the bounds
        # follow each input's search region (set_input).
        self._disc = Discretizer(res=self.env.res,
                                 theta_res=self.env.theta_res)
        self._input: RecognitionInput | None = None
        self._scene: ObservedScene | None = None
        self._observed = None
        self._scene_fine: ObservedScene | None = None
        self._observed_fine = None
        # The directory of the vis_expanded_states dumps (None: no dumps).
        self.debug_dir: str | None = None
        self._world_kdtree: cKDTree | None = None
        self._seg_kdtrees: list[cKDTree | None] = []
        dev = self._tensor
        self._proj = dev(camera.projection(), torch.float32)
        self._bank_tri_verts = dev(bank.tri_verts, torch.float32)
        self._bank_tri_colors = dev(bank.tri_colors, torch.float32)
        self._bank_tri_valid = dev(bank.tri_valid, torch.bool)
        self._bank_backface = dev(bank.backface_cull, torch.bool)
        # Per-model 3-DoF geometry for the batched validity tests and
        # cylinder totals: footprint hull, radii, inflated cylinder radius.
        self._footprints = [m.footprint_hull() for m in bank.models]
        self._circ_radius = np.array([m.circumscribed_radius
                                      for m in bank.models])
        self._insc_radius = np.array([m.inscribed_radius
                                      for m in bank.models])
        self._cyl_radius = np.array([m.inflation_factor
                                     * m.circumscribed_radius
                                     for m in bank.models])
        # The 6-DoF validity radius, before the grid cell's (_valid_6dof).
        self._ball_radius = np.array([m.inflation_factor
                                      * m.circumscribed_radius_3d
                                      for m in bank.models])
        samp, snrm = bank.surface_samples(self.env.icp_model_samples)
        self._bank_icp_samples = dev(samp, torch.float32)
        self._bank_icp_normals = dev(snrm, torch.float32)
        lod = self.env.render_lod
        rb = (bank.decimated(lod) if lod and lod < bank.tri_valid.shape[1]
              else bank)
        self._render_bank = (dev(rb.tri_verts, torch.float32),
                             dev(rb.tri_colors, torch.float32),
                             dev(rb.tri_valid, torch.bool),
                             dev(rb.backface_cull, torch.bool))
        # The render bank's face colours in CIELAB, converted once for the
        # colour-gated cost.
        self._render_bank_lab = rgb_to_lab(rb.tri_colors).to(self.device)

    def _tensor(self, a, dtype: torch.dtype | None = None) -> torch.Tensor:
        """A host array as a tensor on the env's device."""
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------------
    # Input processing
    # ------------------------------------------------------------------

    def _build_scene(self, rin: RecognitionInput, stride: int):
        """The observed scene at a pixel stride; the point capacities grow
        with the pixel density ((gpu_stride // stride)^2), so a finer
        stride does not truncate the clouds."""
        cam, env = self.camera, self.env
        cap_scale = max(1, (int(self.perch.gpu_stride) // stride) ** 2)
        h, w = rin.depth_image.shape
        if (h, w) != (cam.height, cam.width):
            raise ValueError(f"depth image {w}x{h} != camera "
                             f"{cam.width}x{cam.height}")
        six_dof = bool(rin.use_external_pose_list)
        if six_dof:
            if rin.label_mask is None:
                raise ValueError("6-DoF mode needs an instance mask")
            label = rin.label_mask
            bounds = None
        else:
            # 3-DoF: one scene-wide segment, cut to the search region.
            label = np.ones((h, w), np.int32)
            bounds = self._tensor([
                rin.x_max, rin.x_min, rin.y_max, rin.y_min,
                rin.table_height + 2.0, rin.table_height - 0.01],
                torch.float32)
        color = (rin.color_image if rin.color_image is not None
                 else np.zeros((h, w, 3), np.float32))
        dev = self._tensor
        observed = observed_cloud_from_depth(
            dev(rin.depth_image, torch.float32), dev(color, torch.float32),
            dev(label, torch.int32),
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            width=cam.width, height=cam.height, stride=stride,
            depth_factor=float(rin.depth_factor),
            max_points=env.max_observed_points * cap_scale,
            seg_cap=env.max_points_per_label * cap_scale,
            num_labels=env.max_labels,
            use_label_filter=six_dof, use_bounds_filter=not six_dof,
            bounds=bounds,
            cam_to_world=dev(rin.cam_to_world.astype(np.float32)))
        seg_normals = cloud_normals(observed.seg_xyz, observed.seg_valid, k=10)
        # Strided source images in render units (int cm) for the occlusion
        # pass, on the render's grid.
        division = float(rin.depth_factor) / env.gpu_depth_factor
        src = (self.strided(rin.depth_image, stride).astype(np.float64)
               / division)
        # The organised observed map of the projective ICP: each observed
        # point, its label and its normal (k-NN over the whole cloud) at its
        # strided pixel. The normals are computed over the valid points
        # alone, padded with invalid zero points to more than k: the same
        # neighbours in the same order (invalid points are never nearer, and
        # weigh 0), so the same normals as over every cloud slot, for a
        # fraction of the k-NN work.
        npix = src.shape[0] * src.shape[1]
        valid = observed.valid
        sel = observed.pixel[valid].long()
        pts = observed.xyz[valid]
        n_valid = pts.shape[0]
        pad = max(0, 11 - n_valid)
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
        pts_valid = torch.arange(n_valid + pad, device=self.device) < n_valid
        whole_normals = cloud_normals(pts[None], pts_valid[None],
                                      k=10)[0, :n_valid]
        map_xyz = torch.zeros((npix, 3), dtype=torch.float32,
                              device=self.device)
        map_normals = torch.zeros_like(map_xyz)
        map_valid = torch.zeros((npix,), dtype=torch.bool, device=self.device)
        map_label = torch.full((npix,), -1, dtype=torch.int32,
                               device=self.device)
        map_xyz[sel] = observed.xyz[valid]
        map_normals[sel] = whole_normals
        map_valid[sel] = True
        map_label[sel] = observed.label[valid].to(torch.int32)
        scene = ObservedScene(
            seg_xyz=observed.seg_xyz, seg_rgb=observed.seg_rgb,
            seg_lab=rgb_to_lab(observed.seg_rgb),
            seg_valid=observed.seg_valid, seg_normals=seg_normals,
            map_xyz=map_xyz, map_normals=map_normals, map_valid=map_valid,
            map_label=map_label,
            source_depth=dev(src.astype(np.int32), torch.int32),
            source_label=dev(self.strided(label, stride), torch.int32))
        return scene, observed

    def strided(self, img, stride: int | None = None):
        """img [..., H, W] sampled on the render's strided grid: every
        `stride`-th pixel (default gpu_stride) of the first (H // stride)
        rows and (W // stride) columns, also where the stride does not
        divide the frame (the observed cloud samples the same grid)."""
        s = int(stride or self.perch.gpu_stride)
        rows, cols = self.camera.height // s, self.camera.width // s
        return img[..., :rows * s:s, :cols * s:s]

    def set_input(self, rin: RecognitionInput) -> None:
        with span("env.set_input") as sp:
            t0 = time.perf_counter()
            self._input = rin
            self.icp_iterations = 0
            self._disc = Discretizer(
                x_min=rin.x_min, x_max=rin.x_max, y_min=rin.y_min,
                y_max=rin.y_max, res=self.env.res,
                theta_res=self.env.theta_res)
            stride = int(self.perch.gpu_stride)
            with span("env.set_input.scene"):
                self._scene, self._observed = self._build_scene(rin, stride)
                # The finer-stride scene of the coarse-to-fine re-score.
                self._scene_fine = self._observed_fine = None
                if self.env.fine_stride and self.env.fine_stride < stride:
                    self._scene_fine, self._observed_fine = (
                        self._build_scene(rin, int(self.env.fine_stride)))
                valid = self._observed.valid.cpu().numpy()
                xyz = self._observed.xyz.cpu().numpy()[valid]
                labels = self._observed.label.cpu().numpy()[valid]
            # Host-side world-frame KD-trees for validity checks.
            with span("env.set_input.kdtree"):
                pts_world = (xyz @ rin.cam_to_world[:3, :3].T
                             + rin.cam_to_world[:3, 3])
                self._world_points = pts_world
                self._world_labels = labels
                self._world_kdtree = (cKDTree(pts_world) if len(pts_world)
                                      else None)
                self._seg_kdtrees = []
                for l in range(self.env.max_labels):
                    seg = pts_world[labels == l]
                    self._seg_kdtrees.append(cKDTree(seg) if len(seg)
                                             else None)
            sp.add("points", len(pts_world))
            self.stats.input_time = time.perf_counter() - t0

    def set_observation_from_states(self, states: Sequence[ObjectState],
                                    rng: np.random.Generator | None = None,
                                    sensor: SensorModel | None = None) -> None:
        """Simulated ground-truth input: render the given scene state and use
        it as the observation. `sensor` degrades the rendered depth and
        colour with draws from `rng` (default seed 0) as a physical camera
        would; dropped pixels keep their instance label."""
        depth, color, label = self.render_composite(states)
        depth_m = depth.astype(np.float64) / self.env.gpu_depth_factor
        if sensor is not None:
            rng = rng or np.random.default_rng(0)
            depth_m, color = sensor.apply(depth_m, color, rng)
        self.set_input(RecognitionInput(
            depth_image=depth_m * 100.0, color_image=color, label_mask=label,
            depth_factor=100.0, cam_to_world=CAM_TO_BODY.copy(),
            segmented_object_names=[self.bank.models[s.id].name
                                    for s in states],
            use_external_pose_list=True))

    def render_composite(self, states: Sequence[ObjectState]):
        """Render a multi-object scene into one depth / colour / label image
        at full stride-1 resolution (the states' `render_full`)."""
        out = self.render_full(states)
        depths = out.depth.cpu().numpy()
        colors = out.color.cpu().numpy()
        big = np.iinfo(np.int32).max
        depths_inf = np.where(depths == 0, big, depths)
        winner = depths_inf.argmin(axis=0)
        depth = np.take_along_axis(depths_inf, winner[None], axis=0)[0]
        depth = np.where(depth == big, 0, depth)
        color = np.take_along_axis(colors, winner[None, ..., None], axis=0)[0]
        label = np.where(depth > 0, winner + 1, 0).astype(np.int32)
        return depth, color, label

    def render_full(self, states: Sequence[ObjectState]):
        """Each state alone at stride 1 through the direct raster, without
        the backface cull (the observation's render), on the env's device."""
        return self._render_states(states, stride=1)

    def render_strided(self, states: Sequence[ObjectState]):
        """Each state alone at gpu_stride through `kernel_backend` with the
        bank's backface cull (no ROI, no occlusion pass), on the device."""
        return self._render_states(
            states, stride=int(self.perch.gpu_stride),
            backend=self.env.kernel_backend,
            bank_backface=self._bank_backface)

    def _render_states(self, states: Sequence[ObjectState], **kwargs):
        ids = np.asarray([s.id for s in states], np.int64)
        return render_pose_batch(
            self._bank_tri_verts, self._bank_tri_colors, self._bank_tri_valid,
            self._tensor(self.poses_to_camera(states)), self._tensor(ids),
            self._proj, width=self.camera.width, height=self.camera.height,
            **kwargs)

    # ------------------------------------------------------------------
    # Pose transforms
    # ------------------------------------------------------------------

    def pose_to_camera(self, state: ObjectState) -> np.ndarray:
        """World-frame ContPose -> model->camera matrix incl. preprocessing."""
        return self.poses_to_camera([state])[0]

    def poses_to_camera(self, states: Sequence[ObjectState]) -> np.ndarray:
        """[N, 4, 4] float32 model->camera matrices of the states' world
        poses, preprocessing included: the camera's world pose (CAM_TO_BODY
        before any input) inverted once, then each state's product in
        float64, rounded once."""
        cam_to_world = (self._input.cam_to_world if self._input is not None
                        else CAM_TO_BODY)
        inv = np.linalg.inv(cam_to_world)
        models = self.bank.models
        out = np.empty((len(states), 4, 4), np.float32)
        for i, s in enumerate(states):
            out[i] = (inv @ s.pose.transform()
                      @ models[s.id].preprocessing_transform)
        return out

    def camera_to_world_pose(self, mat_cam: np.ndarray, model_id: int,
                             remove_preprocessing: bool = True) -> ContPose:
        m = self._input.cam_to_world @ mat_cam
        if remove_preprocessing:
            m = m @ np.linalg.inv(
                self.bank.models[model_id].preprocessing_transform)
        return ContPose.from_matrix(m)


    # ------------------------------------------------------------------
    # Validity pruning (the reference's IsValidPose)
    # ------------------------------------------------------------------

    def is_valid_pose(self, state: ObjectState,
                      placed: GraphState | None = None,
                      after_refinement: bool = False) -> bool:
        """6-DoF: enough observed points of the pose's segment within the
        model's inflated radius. 3-DoF: enough observed points within the
        circumscribed radius in the (x, y) plane, no inscribed-circle
        collision with the objects of `placed`, and the footprint inside the
        search region (+- footprint_tolerance). after_refinement drops the
        grid cell's half diagonal from the radius."""
        return bool(self.valid_poses([state], placed, after_refinement)[0])

    def valid_poses(self, states: Sequence[ObjectState],
                    placed: GraphState | None = None,
                    after_refinement: bool = False) -> np.ndarray:
        """is_valid_pose of every state, as a bool array, batched over the
        states: 6-DoF per (model, label), 3-DoF over them all (`_valid_3dof`
        with the states grouped by model and full rotation)."""
        grid_rad = self._grid_rad(after_refinement)
        if self._input is not None and self._input.use_external_pose_list:
            ok = np.zeros(len(states), bool)
            groups: dict[tuple[int, int], list[int]] = {}
            for i, s in enumerate(states):
                groups.setdefault((s.id, s.segmentation_label_id),
                                  []).append(i)
            for (mid, label_id), idx in groups.items():
                centres = np.array([[states[i].pose.x, states[i].pose.y,
                                     states[i].pose.z] for i in idx])
                ok[idx] = self._valid_6dof(mid, label_id, centres, grid_rad)
            return ok
        ids = np.zeros(len(states), np.int64)
        xy = np.zeros((len(states), 2), np.float64)
        group = np.zeros(len(states), np.int64)
        keys: dict[tuple, int] = {}
        rots: list[np.ndarray] = []
        for i, s in enumerate(states):
            p = s.pose
            key = (s.id, p.qx, p.qy, p.qz, p.qw, p.roll, p.pitch, p.yaw)
            if key not in keys:
                keys[key] = len(rots)
                rots.append(p.rotation()[:2, :2])
            ids[i], xy[i], group[i] = s.id, (p.x, p.y), keys[key]
        return self._valid_3dof(ids, xy, group, rots, placed, grid_rad)

    def _grid_rad(self, after_refinement: bool) -> float:
        """The grid cell's half diagonal, or 0 after refinement."""
        return (0.0 if after_refinement
                else float(np.hypot(self.env.res / 2, self.env.res / 2)))

    def _valid_6dof(self, mid: int, label_id: int, centres: np.ndarray,
                    grid_rad: float, sp=NO_SPAN) -> np.ndarray:
        """The 6-DoF rule for poses of model `mid` in segment `label_id`
        centred at centres [K, 3]: at least min_neighbor_points_for_valid_pose
        observed points of the segment (of the whole world where the segment
        has no tree) within the model's inflated 3-D radius, at least
        grid_rad. One ball query for the K poses, counted on `sp`."""
        tree = None
        if 0 <= label_id - 1 < len(self._seg_kdtrees):
            tree = self._seg_kdtrees[label_id - 1]
        if tree is None:
            tree = self._world_kdtree
        if tree is None:
            return np.zeros(len(centres), bool)
        rad = max(self._ball_radius[mid], grid_rad)
        sp.add("queries", 1)
        count = tree.query_ball_point(centres, rad, return_length=True)
        return count >= self.perch.min_neighbor_points_for_valid_pose

    def _projected_counts(self, xy: np.ndarray, rad: np.ndarray,
                          sp=NO_SPAN) -> np.ndarray:
        """Observed world points within rad[i] of xy[i] in the (x, y) plane
        (float64 d^2 <= rad^2), for every i: counted once per distinct
        (x, y, rad), in chunks of [C, P], the number counted on `sp`."""
        pts = self._world_points[:, :2]
        key = np.column_stack([xy, rad])
        order = np.lexsort(key.T[::-1])
        first = np.ones(len(key), bool)
        first[1:] = (key[order[1:]] != key[order[:-1]]).any(axis=1)
        rows = key[order[first]]
        inverse = np.empty(len(key), np.int64)
        inverse[order] = np.cumsum(first) - 1
        sp.add("counted", len(rows))
        out = np.zeros(len(rows), np.int64)
        step = max(1, (1 << 22) // max(len(pts), 1))
        for lo in range(0, len(rows), step):
            d2 = ((pts[None] - rows[lo:lo + step, None, :2]) ** 2).sum(axis=2)
            r = rows[lo:lo + step, 2]
            out[lo:lo + step] = (d2 <= (r * r)[:, None]).sum(axis=1)
        return out[inverse]

    def _valid_3dof(self, ids: np.ndarray, xy: np.ndarray, group: np.ndarray,
                    rots: Sequence[np.ndarray], placed: GraphState | None,
                    grid_rad: float, sp=NO_SPAN) -> np.ndarray:
        """The 3-DoF rule over rows of model ids [N], float64 (x, y) [N, 2]
        and rotation groups [N]: the rows of group g share one model and
        the 2x2 rotation rots[g]. Points counted once per distinct
        (x, y, radius), on `sp`."""
        ok = np.zeros(len(ids), bool)
        if self._world_kdtree is None or not len(ids):
            return ok
        rad = np.maximum(self._circ_radius[ids], grid_rad)
        ok = (self._projected_counts(xy, rad, sp)
              >= self.perch.min_neighbor_points_for_valid_pose)
        if placed is not None:
            r1 = self._insc_radius[ids]
            for other in placed.object_states:
                r2 = self._insc_radius[other.id]
                dx = xy[:, 0] - other.pose.x
                dy = xy[:, 1] - other.pose.y
                ok &= ~(dx * dx + dy * dy < (r1 + r2) ** 2)
        # The posed footprint hull inside the region: the hull is rotated
        # once per (model, rotation) group, then shifted to each of the
        # group's rows still valid.
        tol = self.perch.footprint_tolerance
        rin = self._input
        live = np.flatnonzero(ok)
        for g in np.unique(group[live]).tolist():
            idx = live[group[live] == g]
            base = self._footprints[ids[idx[0]]] @ rots[g].T
            fp = base[None] + xy[idx][:, None, :]           # [g, E, 2]
            out = ((fp[..., 0] < rin.x_min - tol).any(axis=1)
                   | (fp[..., 0] > rin.x_max + tol).any(axis=1)
                   | (fp[..., 1] < rin.y_min - tol).any(axis=1)
                   | (fp[..., 1] > rin.y_max + tol).any(axis=1))
            ok[idx] &= ~out
        return ok

    # ------------------------------------------------------------------
    # Scoring
    # ------------------------------------------------------------------

    def _scorer_config(self, do_icp: bool | None = None,
                       stride: int | None = None) -> ScorerConfig:
        """The scorer's configuration at `stride` (default gpu_stride): the
        ROI keeps its extent in pixels of the frame and the cloud cap its
        share of the strided pixels."""
        cam, perch, env = self.camera, self.perch, self.env
        six_dof = self._input.use_external_pose_list
        if six_dof:
            cost_type = (COST_TYPE_6DOF_RGB if perch.use_color_cost
                         else COST_TYPE_6DOF)
        else:
            cost_type = (COST_TYPE_3DOF_RGBD if perch.use_color_cost
                         else COST_TYPE_3DOF_DEPTH)
        if do_icp is None:
            do_icp = perch.icp_type == 3
        stride = int(stride or perch.gpu_stride)
        roi = None
        if env.roi_size:
            scale = int(perch.gpu_stride) // stride
            roi = (min(env.roi_size * scale, cam.height // stride),
                   min(env.roi_size * scale, cam.width // stride))
        cap_scale = max(1, (int(perch.gpu_stride) // stride) ** 2)
        icp_mode = "fused" if env.icp_mode == "auto" else env.icp_mode
        return ScorerConfig(
            width=cam.width, height=cam.height, stride=stride,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            max_points_per_pose=env.max_points_per_pose * cap_scale,
            cost_type=cost_type,
            sensor_resolution=perch.sensor_resolution,
            color_distance_threshold=perch.color_distance_threshold,
            occlusion_threshold=perch.gpu_occlusion_threshold,
            use_segmentation_label=six_dof,
            use_tree_occlusion=perch.use_tree_occlusion,
            do_icp=do_icp,
            icp_mode=icp_mode,
            icp_max_iterations=perch.max_icp_iterations,
            icp_max_correspondence=perch.icp_max_correspondence,
            icp_downsample=env.icp_downsample,
            icp_render_scale=env.icp_render_scale,
            icp_crop_targets=env.icp_crop_targets,
            icp_crop_mode=env.icp_crop_mode,
            cost_crop_targets=env.cost_crop_targets,
            icp_source=env.icp_source,
            cost_cloud=env.cost_cloud,
            cost_aug_samples=env.cost_aug_samples,
            icp_gicp_epsilon=env.icp_gicp_epsilon,
            icp_d2d_symmetric=env.icp_d2d_symmetric,
            icp_nn_every=env.icp_nn_every,
            icp_assoc_trigger=env.icp_assoc_trigger,
            icp_crop_share=env.icp_crop_share,
            icp_gather=env.icp_gather,
            icp_exact_nn_every=env.icp_exact_nn_every,
            icp_stagnation_streak=env.icp_stagnation_streak,
            depth_factor=env.gpu_depth_factor,
            roi_shape=roi,
            backend=env.kernel_backend,
            use_clutter_mode=perch.use_clutter_mode,
            clutter_regularizer=perch.clutter_regularizer,
        )

    def _observed_totals(self, chunk: Sequence[ObjectState],
                         labels: np.ndarray, observed) -> np.ndarray:
        """[N] float32 observed points each pose is scored against: its
        segment's count in `observed` (6-DoF); in 3-DoF mode the points
        inside the pose's inflated circumscribing cylinder
        (use_cylinder_observed, over the gpu_stride cloud) or all of
        `observed`."""
        if self._input.use_external_pose_list:
            seg_count = observed.seg_count.cpu().numpy()
            return seg_count.astype(np.float32)[labels]
        if self.perch.use_cylinder_observed:
            rad = self._cyl_radius[[s.id for s in chunk]]
            xy = np.array([[s.pose.x, s.pose.y] for s in chunk], np.float64)
            return self._projected_counts(xy, rad).astype(np.float32)
        total = float(observed.count.item())
        return np.full(len(chunk), total, np.float32)

    def score_object_states(self, states: Sequence[ObjectState],
                            do_icp: bool | None = None, fine: bool = False,
                            source: tuple | None = None) -> list[ScoredState]:
        """Score single-object placements in gpu_batch_size chunks (the last
        chunk padded to the full batch, padding dropped); fine=True scores
        against the fine_stride scene. `source`, a (depth, label) pair of
        host images on the scene's strided grid, replaces the scene's source
        images for this call (the tree search's composed source); the env's
        scene is left as it is."""
        if self._scene is None:
            raise RuntimeError("call set_input first")
        if fine:
            if self._scene_fine is None:
                raise RuntimeError("fine scoring needs EnvConfig.fine_stride "
                                   "finer than gpu_stride")
            cfg = self._scorer_config(do_icp, stride=self.env.fine_stride)
            cloud, scene = self._observed_fine, self._scene_fine
        else:
            cfg = self._scorer_config(do_icp)
            cloud, scene = self._observed, self._scene
        if source is not None:
            scene = dataclasses.replace(
                scene, source_depth=self._tensor(source[0], torch.int32),
                source_label=self._tensor(source[1], torch.int32))
        results: list[ScoredState] = []
        batch = int(self.perch.gpu_batch_size)
        rb_verts, rb_colors, rb_valid, rb_backface = self._render_bank
        with span("env.score") as sp:
            for start in range(0, len(states), batch):
                with span("scorer.prepare"):
                    chunk = list(states[start:start + batch])
                    n = len(chunk)
                    poses = self.poses_to_camera(chunk)
                    if n < batch:
                        chunk = chunk + [chunk[0]] * (batch - n)
                        poses = np.concatenate(
                            [poses, np.repeat(poses[:1], batch - n, axis=0)])
                    ids = np.asarray([s.id for s in chunk], np.int64)
                    labels = np.asarray(
                        [max(s.segmentation_label_id - 1, 0) for s in chunk],
                        np.int64)
                    totals = self._observed_totals(chunk, labels, cloud)
                dev = self._tensor
                with span("scorer.batch"):
                    t0 = time.perf_counter()
                    counters: dict = {}
                    scores = score_pose_batch(
                        rb_verts, rb_colors, rb_valid,
                        dev(poses), dev(ids), dev(labels),
                        dev(totals, torch.float32), self._proj,
                        scene, cfg, bank_backface=rb_backface,
                        bank_icp_samples=self._bank_icp_samples,
                        bank_icp_normals=self._bank_icp_normals,
                        bank_tri_lab=self._render_bank_lab, counters=counters)
                    total = scores.total_cost.cpu().numpy()
                    rendered = scores.rendered_cost.cpu().numpy()
                    observed = scores.observed_cost.cpu().numpy()
                    diff = scores.points_diff_cost.cpu().numpy()
                    adjusted = scores.adjusted_poses.cpu().numpy()
                    self.stats.gpu_time += time.perf_counter() - t0
                self.stats.scenes_rendered += n
                self.icp_iterations += counters["icp_iterations"]
                sp.add("poses", n)
                sp.add("batches", 1)
                sp.add("slots", batch)
                with span("scorer.results"):
                    for i, st in enumerate(chunk[:n]):
                        # (100, 100) degenerate diff rule.
                        d = diff[i]
                        if int(rendered[i]) == 100 and int(observed[i]) == 100:
                            d = 100.0
                        results.append(ScoredState(
                            state=st, cost=int(total[i]),
                            target_cost=int(rendered[i]),
                            source_cost=int(observed[i]),
                            last_level_cost=int(d),
                            adjusted_pose_cam=adjusted[i]))
        return results

    # ------------------------------------------------------------------
    # Greedy recognition
    # ------------------------------------------------------------------

    def compute_greedy_poses(
        self, candidates: Sequence[ObjectState], do_icp: bool | None = None,
        collision_ordering: bool = False,
    ) -> tuple[GraphState, list[ScoredState]]:
        """Argmin over scored candidates with the |target - source| < 30
        filter: per (model, segment) in 6-DoF mode, per model in 3-DoF mode.
        collision_ordering (3-DoF) takes the commit order of the reference's
        greedy-ICP baseline instead (`_commit_with_collisions`), so two
        models cannot claim one physical object. With fine_stride, the
        argmin runs over the fine re-scores of the best fine_top_k
        candidates per key; with pose_refinement_rounds, the winners then go
        through `_refine_winners`."""
        t0 = time.perf_counter()
        scored = self.score_object_states(candidates, do_icp)
        if self._scene_fine is not None:
            groups = self._greedy_groups(scored)
            top: list[ScoredState] = []
            for key in sorted(groups):
                per = sorted(groups[key], key=lambda su: su.cost)
                top.extend(per[:self.env.fine_top_k])
            if top:
                # The refined poses, re-scored at the fine stride without a
                # second ICP.
                fine_states = [dataclasses.replace(
                    su.state, pose=self.camera_to_world_pose(
                        su.adjusted_pose_cam, su.state.id)) for su in top]
                scored = self.score_object_states(fine_states, do_icp=False,
                                                  fine=True)
        with span("env.argmin"):
            if collision_ordering and not self._input.use_external_pose_list:
                best = self._commit_with_collisions(scored)
            else:
                best = {key: min(group, key=lambda su: su.cost)
                        for key, group in self._greedy_groups(scored).items()}
        if self.env.pose_refinement_rounds and best:
            best = self._refine_winners(best, do_icp)
        state = GraphState()
        chosen = []
        for key in sorted(best):
            su = best[key]
            adj_state = ObjectState(
                id=su.state.id, symmetric=su.state.symmetric,
                pose=self.camera_to_world_pose(su.adjusted_pose_cam,
                                               su.state.id),
                segmentation_label_id=su.state.segmentation_label_id)
            state = state.append(adj_state)
            chosen.append(dataclasses.replace(su, state=adj_state))
        self.stats.time = time.perf_counter() - t0
        if (self.perch.vis_expanded_states and self.debug_dir
                and state.num_objects):
            # The final greedy state's renders (the reference's PrintStateGPU
            # at the end of ComputeGreedyRenderPoses).
            depth, color, _ = self.render_composite(state.object_states)
            save_depth_image(depth, f"{self.debug_dir}/depth_greedy_state.png")
            write_png(f"{self.debug_dir}/color_greedy_state.png",
                      color.astype(np.uint8))
        self.stats.scenes_valid = sum(1 for s in scored if s.cost >= 0)
        return state, chosen

    def _greedy_groups(self, scored: Sequence[ScoredState]
                       ) -> dict[tuple, list[ScoredState]]:
        """The candidates the greedy rule admits, in order, under their key:
        (model, segment) in 6-DoF mode, (model,) in 3-DoF mode. The rule
        drops an invalid pose (cost -1, the only negative cost the scorer
        gives) and |target - source| >= 30."""
        six_dof = self._input.use_external_pose_list
        groups: dict[tuple, list[ScoredState]] = {}
        for su in scored:
            if su.cost < 0 or abs(su.target_cost - su.source_cost) >= 30:
                continue
            key = ((su.state.id, su.state.segmentation_label_id) if six_dof
                   else (su.state.id,))
            groups.setdefault(key, []).append(su)
        return groups

    def _refine_winners(self, best: dict, do_icp) -> dict:
        """pose_refinement_rounds rounds around the greedy winners: each
        round scores every winner rotated in the camera frame about its own
        origin by pose_refinement_angle and a third of it about each of
        pose_refinement_axes fibonacci axes (ICP on every one), and keeps a
        candidate that passes the |target - source| < 30 filter at a lower
        cost than its key's winner. The rotations are Rodrigues' formula in
        float64."""
        axes = sphere_fibonacci_grid(self.env.pose_refinement_axes)
        mags = (self.env.pose_refinement_angle,
                self.env.pose_refinement_angle / 3.0)

        def rodrigues(axis, angle):
            k = np.asarray([[0, -axis[2], axis[1]],
                            [axis[2], 0, -axis[0]],
                            [-axis[1], axis[0], 0]])
            return (np.eye(3) + np.sin(angle) * k
                    + (1 - np.cos(angle)) * (k @ k))

        for _ in range(self.env.pose_refinement_rounds):
            cands: list[ObjectState] = []
            for key in sorted(best):
                su = best[key]
                a = su.adjusted_pose_cam
                for axis in axes:
                    for mag in mags:
                        m = a.copy()
                        m[:3, :3] = rodrigues(axis, mag) @ a[:3, :3]
                        cands.append(ObjectState(
                            id=su.state.id, symmetric=su.state.symmetric,
                            pose=self.camera_to_world_pose(m, su.state.id),
                            segmentation_label_id=(
                                su.state.segmentation_label_id)))
            if not cands:
                break
            scored = self.score_object_states(cands, do_icp)
            for key, group in self._greedy_groups(scored).items():
                su = min(group, key=lambda su: su.cost)
                if key in best and su.cost < best[key].cost:
                    best[key] = su
        return best

    def _commit_with_collisions(self, scored: Sequence[ScoredState]) -> dict:
        """The reference greedy-ICP baseline's commit order
        (ComputeGreedyICPPoses): over every permutation of the models (the
        cheapest-first one beyond 5 models), each model commits its
        cheapest candidate whose post-ICP world pose does not collide with
        those already committed; a model that cannot commit pays 200
        (costs are <= 200). The cheapest total wins."""
        per_model = self._greedy_groups(scored)
        for group in per_model.values():
            group.sort(key=lambda su: su.cost)
        adj_world: dict[int, ObjectState] = {}

        def world_state(su: ScoredState) -> ObjectState:
            if id(su) not in adj_world:
                adj_world[id(su)] = dataclasses.replace(
                    su.state, pose=self.camera_to_world_pose(
                        su.adjusted_pose_cam, su.state.id))
            return adj_world[id(su)]

        keys = sorted(per_model)
        miss_penalty = 200
        orders = (itertools.permutations(keys) if len(keys) <= 5
                  else [tuple(sorted(
                      keys, key=lambda k: per_model[k][0].cost))])
        best_total, best_sel = None, {}
        for order in orders:
            placed = GraphState()
            sel: dict[tuple, ScoredState] = {}
            total = 0
            for key in order:
                chosen = None
                for su in per_model[key]:
                    if self.is_valid_pose(world_state(su), placed=placed,
                                          after_refinement=True):
                        chosen = su
                        break
                if chosen is None:
                    total += miss_penalty
                    continue
                total += chosen.cost
                sel[key] = chosen
                placed = placed.append(world_state(chosen))
            if best_total is None or total < best_total:
                best_total, best_sel = total, sel
        return best_sel

    # ------------------------------------------------------------------
    # Successor generation
    # ------------------------------------------------------------------

    def generate_successors_6dof(self, pose_lists: dict[str, np.ndarray]
                                 ) -> list[ObjectState]:
        """Candidate object states from per-object pose arrays [K, 7]
        (x y z qx qy qz qw), validity-pruned as `is_valid_pose` prunes
        them; on a 6-DoF input by `_valid_6dof` once per object, with states
        built for the survivors alone, rows in order."""
        out = []
        names = self._input.segmented_object_names
        six_dof = self._input.use_external_pose_list
        grid_rad = self._grid_rad(False)
        with span("env.candidates") as sp:
            for model_name, arr in pose_lists.items():
                mid = self.bank.index_of(model_name)
                symmetric = self.bank.models[mid].symmetric
                label_id = (names.index(model_name) + 1
                            if model_name in names else 1)
                rows = np.asarray(arr)
                sp.add("rows", len(rows))
                if not len(rows):
                    continue

                def state(ext_id: int) -> ObjectState:
                    return ObjectState(
                        id=mid, symmetric=symmetric,
                        pose=ContPose.from_quat(*rows[ext_id, :7]),
                        segmentation_label_id=label_id,
                        external_pose_id=ext_id)

                if six_dof:
                    keep = self._valid_6dof(mid, label_id, rows[:, :3],
                                            grid_rad, sp)
                    out += [state(i) for i in np.flatnonzero(keep).tolist()]
                else:
                    # A 3-DoF input: the 3-DoF rule over every row's state.
                    states = [state(i) for i in range(len(rows))]
                    keep = self.valid_poses(states)
                    out += [s for s, ok in zip(states, keep) if ok]
            sp.add("valid", len(out))
        return out

    def generate_successors_3dof(self) -> list[ObjectState]:
        """The grid of `grid_3dof` validity-pruned on arrays by the rule of
        `valid_poses`, with states built for the valid rows alone, in the
        grid's order; then the histogram / voxel pruning the EnvConfig
        enables."""
        env = self.env
        with span("env.candidates") as sp:
            with span("env.candidates.grid"):
                xs, ys, yaws = self._grid_axes()
                # Rows (model, x index, y index, yaw index) in the grid's
                # order; a rotation group per (model, yaw).
                mids, ix, iy, k = np.concatenate([np.vstack([
                    np.full(len(xs) * len(ys) * len(m_yaws), mid),
                    *np.indices((len(xs), len(ys), len(m_yaws))).reshape(3, -1)
                ]) for mid, m_yaws in enumerate(yaws)], axis=1)
                group = np.cumsum([0] + [len(m) for m in yaws])[mids] + k
                rots = [euler_xyz_to_matrix(0.0, 0.0, yaw)[:2, :2]
                        for m_yaws in yaws for yaw in m_yaws]
                xy = np.column_stack([np.array(xs, np.float64)[ix],
                                      np.array(ys, np.float64)[iy]])
            with span("env.candidates.valid"):
                ok = self._valid_3dof(mids, xy, group, rots, None,
                                      self._grid_rad(False), sp)
                keep = np.flatnonzero(ok)
                out = [self._grid_state(m, xs[a], ys[b], yaws[m][c])
                       for m, a, b, c in zip(mids[keep].tolist(),
                                             ix[keep].tolist(),
                                             iy[keep].tolist(),
                                             k[keep].tolist())]
            if env.histogram_pruning or env.voxel_pruning:
                out = prune_successors(self, out,
                                       use_histogram=env.histogram_pruning,
                                       use_voxels=env.voxel_pruning)
            sp.add("rows", len(mids))
            sp.add("valid", len(out))
        return out

    def grid_3dof(self) -> list[ObjectState]:
        """The (x, y, yaw) grid over the search region at `res` and
        `theta_res` (one yaw for a symmetric model), standing on the table,
        before any pruning."""
        xs, ys, yaws = self._grid_axes()
        return [self._grid_state(mid, x, y, yaw)
                for mid, m_yaws in enumerate(yaws)
                for x in xs for y in ys for yaw in m_yaws]

    def _grid_axes(self) -> tuple[list, list, list[list[float]]]:
        """The 3-DoF grid's x and y values, each accumulated from the
        region's minimum in steps of `res` up to its maximum (+ 1e-9), as
        the reference walks them, and each model's yaws k * theta_res (one
        for a symmetric model)."""
        rin, env = self._input, self.env

        def axis(lo, hi):
            values, v = [], lo
            while v <= hi + 1e-9:
                values.append(v)
                v += env.res
            return values

        n_theta = max(1, int(round(2 * np.pi / env.theta_res)))
        yaws = [[k * env.theta_res for k in range(1 if m.symmetric
                                                  else n_theta)]
                for m in self.bank.models]
        return axis(rin.x_min, rin.x_max), axis(rin.y_min, rin.y_max), yaws

    def _grid_state(self, mid: int, x, y, yaw) -> ObjectState:
        """The grid's state of model `mid` at (x, y, yaw) on the table."""
        return ObjectState(
            id=mid, symmetric=self.bank.models[mid].symmetric,
            pose=ContPose.from_euler(x, y, self._input.table_height,
                                     0.0, 0.0, yaw),
            segmentation_label_id=1)
