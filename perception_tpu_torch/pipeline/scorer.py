"""Candidate-pose scoring: render -> cloud -> ICP -> fused cost.

Counterpart of `perception_tpu/pipeline/scorer.py`, for the 6-DoF
configuration (cost types 2 / 3, each pose against its segment) and the
3-DoF one (cost types 0 / 1, without segmentation labels: every pose against
the one scene-wide segment; with `use_tree_occlusion` a pose that renders in
front of its source is flagged and scores -1):

    raster by `backend` (the direct kernel for "auto" / "pallas_direct", the
    coefficient-table kernel for "pallas", the scatter-bin kernel for
    "pallas_bin"; ROI or full frame) + occlusion pass
      -> depth_to_cloud_roi / depth_to_cloud_batch
      -> ICP on the downsampled cloud, by `icp_mode`:
           "fused" / "fused_d2d" / "fused_d2d_exact": label-shared "near"
             target crop + pack_targets, the fused ICP kernel in point-to-
             plane, d2d (symmetric with icp_d2d_symmetric) or exact mode,
             with source normals for sym and exact;
           "nn" / "gicp": the composed refiners against the pose's segment
             with a per-pose "near" crop, 1-NN association every iteration;
      -> the cloud moved by the ICP delta, plus explain-only surface samples
      -> fused cost, depth only or colour-gated (CIEDE2000) -> total cost.

The same `ScorerConfig` (field names and defaults as the JAX one) selects the
path; every branch that is not ported raises NotImplementedError. As in the
JAX scorer, the backend changes only the raster: ICP and cost run the same
kernels under every backend.

The colour-gated cost (types 1 / 3, with `bank_tri_lab`) compares Lab
colours: on the ROI path the cost kernel looks up each point's rendered Lab
from its winning face id; on the full-frame path the raster draws the Lab
face colours, so the cloud's colour channel holds Lab.
"""

from __future__ import annotations

import dataclasses

import torch

from perception_tpu_torch.ops.cost import COST_TYPE_6DOF, compute_costs_fused
from perception_tpu_torch.ops.icp import (
    cloud_normals,
    crop_targets,
    icp_gicp_batch,
    icp_point_to_plane_batch,
    rotate_points,
)
from perception_tpu_torch.ops.icp_fused import icp_fused, pack_targets
from perception_tpu_torch.ops.pointcloud import (
    depth_to_cloud_batch,
    depth_to_cloud_roi,
)
from perception_tpu_torch.ops.rasterizer import render_pose_batch


@dataclasses.dataclass
class ObservedScene:
    """Observed-scene tensors the scorer reads, built once per frame."""

    seg_xyz: torch.Tensor        # [L, S, 3] label-partitioned observed cloud
    seg_rgb: torch.Tensor        # [L, S, 3] float32 0..255
    seg_lab: torch.Tensor        # [L, S, 3] CIELAB of seg_rgb (ops.color)
    seg_valid: torch.Tensor      # [L, S] bool
    seg_normals: torch.Tensor    # [L, S, 3]
    source_depth: torch.Tensor   # [h_s, w_s] int32 render units
    source_label: torch.Tensor   # [h_s, w_s] int32 1-based


@dataclasses.dataclass(frozen=True)
class ScorerConfig:
    """Pipeline parameters; the same fields and defaults as the JAX
    ScorerConfig (see perception_tpu/pipeline/scorer.py for each field)."""

    width: int = 640
    height: int = 480
    stride: int = 8
    fx: float = 1066.778
    fy: float = 1067.487
    cx: float = 312.9869
    cy: float = 241.3109
    max_points_per_pose: int = 1024
    cost_type: int = COST_TYPE_6DOF
    sensor_resolution: float = 0.01
    color_distance_threshold: float = 15.0
    occlusion_threshold: float = 1.0
    use_segmentation_label: bool = True
    use_tree_occlusion: bool = False
    do_icp: bool = True
    icp_mode: str = "nn"
    icp_max_iterations: int = 30
    icp_max_correspondence: float = 0.05
    icp_rotation_epsilon: float = 2e-3
    icp_transformation_epsilon: float = 5e-4
    icp_downsample: int = 4
    icp_crop_targets: int = 256
    icp_crop_mode: str = "near"
    icp_render_scale: int = 1
    icp_exact_nn_every: int = 1
    icp_nn_every: int = 2
    icp_assoc_trigger: float = 0.004
    icp_crop_share: str = "label"
    icp_gather: str = "take"
    icp_stagnation_streak: int = 8
    icp_gicp_epsilon: float = 0.05
    icp_d2d_rotation_epsilon: float | None = None
    icp_d2d_transformation_epsilon: float | None = None
    icp_d2d_symmetric: bool = False
    cost_aug_samples: int = 0
    cost_cloud: str = "transform"
    icp_source: str = "render"
    cost_crop_targets: int = 256
    raster_tile: int = 256
    knn_ref_tile: int = 512
    depth_factor: float = 100.0
    roi_shape: tuple[int, int] | None = None
    backend: str = "auto"
    use_clutter_mode: bool = False
    clutter_regularizer: float = 0.1

    def d2d_epsilons(self) -> tuple[float, float]:
        """Step-norm thresholds for the D2D solvers (gicp / fused_d2d)."""
        rot = self.icp_d2d_rotation_epsilon
        trn = self.icp_d2d_transformation_epsilon
        return (rot if rot is not None else self.icp_rotation_epsilon * 0.1,
                trn if trn is not None
                else self.icp_transformation_epsilon * 0.1)


ICP_MODES = ("fused", "fused_d2d", "fused_d2d_exact", "nn", "gicp")


@dataclasses.dataclass
class PoseScores:
    total_cost: torch.Tensor        # [N] int32; -1 invalid
    rendered_cost: torch.Tensor     # [N] float32
    observed_cost: torch.Tensor     # [N] float32
    points_diff_cost: torch.Tensor  # [N] float32
    adjusted_poses: torch.Tensor    # [N, 4, 4] post-ICP model->camera
    pose_occluded: torch.Tensor     # [N] int32
    point_count: torch.Tensor       # [N] float32 rendered points per pose


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet")


def _check_config(cfg: ScorerConfig) -> None:
    if cfg.cost_type not in (0, 1, 2, 3):
        raise ValueError(f"unknown cost_type {cfg.cost_type}")
    if cfg.do_icp:
        if cfg.icp_mode == "projective":
            raise _unported("icp_mode='projective' (organised map tensors)")
        if cfg.icp_mode not in ICP_MODES:
            raise ValueError(f"unknown icp_mode {cfg.icp_mode!r}")
        if cfg.icp_source != "render":
            raise _unported(f"icp_source={cfg.icp_source!r}")
        if cfg.icp_render_scale > 1:
            raise _unported("icp_render_scale > 1")
        if cfg.cost_cloud != "transform":
            raise _unported(f"cost_cloud={cfg.cost_cloud!r}")


def _render_and_cloud(bank_tri_verts, bank_tri_colors, bank_tri_valid, poses,
                      model_ids, proj, scene: ObservedScene, pose_labels,
                      cfg: ScorerConfig, bank_backface):
    out = render_pose_batch(
        bank_tri_verts, bank_tri_colors, bank_tri_valid, poses, model_ids,
        proj, width=cfg.width, height=cfg.height, stride=cfg.stride,
        source_depth=scene.source_depth, source_label=scene.source_label,
        pose_labels=pose_labels, occlusion_threshold=cfg.occlusion_threshold,
        use_segmentation_label=cfg.use_segmentation_label,
        use_tree_occlusion=cfg.use_tree_occlusion, roi_shape=cfg.roi_shape,
        bank_backface=bank_backface, backend=cfg.backend)
    cam = dict(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, width=cfg.width,
               height=cfg.height, stride=cfg.stride,
               depth_factor=cfg.depth_factor)
    if cfg.roi_shape is not None:
        cloud = depth_to_cloud_roi(out.depth, out.color, out.anchors, **cam)
    else:
        cloud = depth_to_cloud_batch(out.depth, out.color,
                                     max_points=cfg.max_points_per_pose, **cam)
    return out, cloud


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for [N, 4, 4] transforms, summed in a fixed order as
    rotate_points."""
    return (a[:, :, 0:1] * b[:, 0:1] + a[:, :, 1:2] * b[:, 1:2]
            + a[:, :, 2:3] * b[:, 2:3] + a[:, :, 3:4] * b[:, 3:4])


def _pad_points(x: torch.Tensor, p: int, fill) -> torch.Tensor:
    """x [N, K, ...] padded with `fill` to p entries along dim 1."""
    if x.shape[1] >= p:
        return x
    pad = torch.full((x.shape[0], p - x.shape[1], *x.shape[2:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def _icp_targets(scene: ObservedScene, labels: torch.Tensor,
                 cfg: ScorerConfig) -> torch.Tensor:
    """[N, k, 8] packed ICP targets: one "near" crop per segment around its
    valid centroid, shared by every pose of that segment."""
    s = scene.seg_xyz.shape[1]
    k = min(cfg.icp_crop_targets or 256, s)
    seg_pk = pack_targets(scene.seg_xyz, scene.seg_valid, scene.seg_normals)
    if k >= s:
        return seg_pk[labels]
    if cfg.icp_crop_share != "label":
        raise _unported(f"icp_crop_share={cfg.icp_crop_share!r}")
    valid = scene.seg_valid
    # Float64 sum, so the f32 centroid does not depend on the device's
    # summation order.
    segc = ((scene.seg_xyz.double() * valid[..., None]).sum(dim=1)
            / torch.clamp(valid.sum(dim=1), min=1)[:, None]).float()
    cidx = crop_targets(scene.seg_xyz, valid, segc, k, mode=cfg.icp_crop_mode)
    cropped = torch.gather(seg_pk, 1, cidx[..., None].expand(-1, -1, 8))
    return cropped[labels]


def _refine(src_xyz: torch.Tensor, src_valid: torch.Tensor,
            scene: ObservedScene, labels: torch.Tensor,
            cfg: ScorerConfig) -> torch.Tensor:
    """ICP deltas [N, 4, 4] by cfg.icp_mode, as the JAX scorer dispatches."""
    if cfg.icp_mode in ("nn", "gicp"):
        tgt = (scene.seg_xyz[labels], scene.seg_valid[labels],
               scene.seg_normals[labels])
        common = dict(max_iterations=cfg.icp_max_iterations,
                      max_correspondence=cfg.icp_max_correspondence,
                      crop_k=cfg.icp_crop_targets)
        if cfg.icp_mode == "nn":
            return icp_point_to_plane_batch(
                src_xyz, src_valid, *tgt,
                rotation_epsilon=cfg.icp_rotation_epsilon,
                transformation_epsilon=cfg.icp_transformation_epsilon,
                **common).delta
        rot_eps, trn_eps = cfg.d2d_epsilons()
        return icp_gicp_batch(
            src_xyz, src_valid, cloud_normals(src_xyz, src_valid), *tgt,
            rotation_epsilon=rot_eps, transformation_epsilon=trn_eps,
            gicp_epsilon=cfg.icp_gicp_epsilon, **common).delta
    exact = cfg.icp_mode == "fused_d2d_exact"
    d2d = cfg.icp_mode != "fused"
    src_nrm = None
    if exact or (d2d and cfg.icp_d2d_symmetric):
        # Source covariances from k-NN normals of the rendered cloud, as
        # fast_gicp estimates them.
        src_nrm = cloud_normals(src_xyz, src_valid)
    if d2d:
        rot_eps, trn_eps = cfg.d2d_epsilons()
    else:
        rot_eps = cfg.icp_rotation_epsilon
        trn_eps = cfg.icp_transformation_epsilon
    return icp_fused(
        src_xyz, src_valid, _icp_targets(scene, labels, cfg), src_nrm,
        max_iterations=cfg.icp_max_iterations,
        max_correspondence=cfg.icp_max_correspondence,
        nn_every=cfg.icp_exact_nn_every if exact else cfg.icp_nn_every,
        rotation_epsilon=rot_eps, transformation_epsilon=trn_eps,
        stagnation_streak=cfg.icp_stagnation_streak,
        d2d_epsilon=cfg.icp_gicp_epsilon if d2d else 0.0, exact=exact,
        assoc_trigger=cfg.icp_assoc_trigger)


def score_pose_batch(
    bank_tri_verts: torch.Tensor,   # [M, T, 3, 3]
    bank_tri_colors: torch.Tensor,  # [M, T, 3]
    bank_tri_valid: torch.Tensor,   # [M, T]
    poses: torch.Tensor,            # [N, 4, 4] model->camera (m)
    model_ids: torch.Tensor,        # [N] int
    pose_labels: torch.Tensor,      # [N] int 0-based segment labels
    observed_total: torch.Tensor,   # [N] float32 observed points per pose
    proj: torch.Tensor,             # [4, 4]
    scene: ObservedScene,
    cfg: ScorerConfig,
    bank_backface: torch.Tensor | None = None,     # [M] bool
    bank_icp_samples: torch.Tensor | None = None,  # [M, K, 3]
    bank_icp_normals: torch.Tensor | None = None,  # [M, K, 3]
    bank_tri_lab: torch.Tensor | None = None,      # [M, T, 3] face Lab
) -> PoseScores:
    """Render, refine and score one batch of candidate poses; pose i scores
    against observed segment pose_labels[i]."""
    _check_config(cfg)
    labels = torch.clamp(pose_labels.long(), 0, scene.seg_xyz.shape[0] - 1)
    ids = model_ids.long()
    s_full = scene.seg_xyz.shape[1]
    sc = min(cfg.cost_crop_targets or s_full, s_full)
    cost_xyz = scene.seg_xyz[:, :sc][labels]
    cost_valid = scene.seg_valid[:, :sc][labels]
    if sc < s_full:
        # The observed denominator counts the same cropped subset the
        # explained numerator can reach.
        observed_total = torch.minimum(
            observed_total, cost_valid.sum(dim=1).to(observed_total.dtype))

    # The fused kernels take any cloud size (the JAX package switches to its
    # composed cost above 2048 points only for the TPU's VMEM). The colour
    # gate compares Lab, so it needs the face Lab table.
    color = cfg.cost_type in (1, 3)
    if color and bank_tri_lab is None:
        raise _unported("the colour cost without bank_tri_lab (the composed "
                        "RGB path)")
    # ROI clouds keep pixel == point order, so the cost kernel looks the
    # rendered Lab up by face id; full-frame clouds are compacted, so the
    # raster draws Lab face colours instead.
    tri_color = color and cfg.roi_shape is not None
    render_colors = (bank_tri_lab if color and not tri_color
                     else bank_tri_colors)
    cost_lab = scene.seg_lab[:, :sc][labels] if color else None

    render, cloud = _render_and_cloud(
        bank_tri_verts, render_colors, bank_tri_valid, poses, ids, proj,
        scene, labels, cfg, bank_backface)

    adjusted = poses
    explain_only = None
    cloud_xyz, cloud_valid = cloud.xyz, cloud.valid
    if cfg.do_icp:
        ds = cfg.icp_downsample
        delta = _refine(cloud.xyz[:, ::ds], cloud.valid[:, ::ds], scene,
                        labels, cfg)
        adjusted = _compose(delta, poses)
        # The cost cloud is the first-pass cloud moved rigidly by the delta.
        moved = (rotate_points(delta[:, :3, :3], cloud.xyz)
                 + delta[:, None, :3, 3])
        cloud_xyz = torch.where(cloud.valid[..., None], moved, cloud.xyz)
        if bank_icp_samples is not None:
            # Explain-only front-hemisphere surface samples at the adjusted
            # pose: they may explain observed points, never count as
            # rendered ones.
            samp = bank_icp_samples[ids]
            snrm = bank_icp_normals[ids]
            if cfg.cost_aug_samples and cfg.cost_aug_samples < samp.shape[1]:
                step = -(-samp.shape[1] // cfg.cost_aug_samples)
                samp, snrm = samp[:, ::step], snrm[:, ::step]
            rot = adjusted[:, :3, :3]
            aug_xyz = rotate_points(rot, samp) + adjusted[:, None, :3, 3]
            n_cam = rotate_points(rot, snrm)
            aug_valid = (n_cam[..., 0] * aug_xyz[..., 0]
                         + n_cam[..., 1] * aug_xyz[..., 1]
                         + n_cam[..., 2] * aug_xyz[..., 2]) < 0.0
            n_b, p_b = cloud.valid.shape
            k_b = aug_xyz.shape[1]
            cloud_xyz = torch.cat([cloud_xyz, aug_xyz], dim=1)
            cloud_valid = torch.cat([cloud.valid, aug_valid], dim=1)
            explain_only = torch.cat(
                [torch.zeros((n_b, p_b), dtype=torch.bool, device=poses.device),
                 torch.ones((n_b, k_b), dtype=torch.bool, device=poses.device)],
                dim=1)

    # The explain-only samples have no face and no rendered colour.
    p_all = cloud_xyz.shape[1]
    tri_kw = {}
    if tri_color:
        tri_id = render.tri_id.reshape(render.tri_id.shape[0], -1)
        tri_kw = dict(cloud_tri_id=_pad_points(tri_id, p_all, -1),
                      model_ids=ids, bank_lab=bank_tri_lab)
    cloud_lab = (_pad_points(cloud.rgb, p_all, 0.0)
                 if color and not tri_color else None)
    costs = compute_costs_fused(
        cloud_xyz, cloud_valid, render.pose_occluded, cost_xyz, cost_valid,
        observed_total, sensor_resolution=cfg.sensor_resolution,
        cloud_lab=cloud_lab, tgt_lab=cost_lab,
        color_distance_threshold=cfg.color_distance_threshold,
        use_color=color, cloud_explain_only=explain_only, **tri_kw)

    invalid = costs.rendered_cost.to(torch.int32) < 0
    total_f = costs.rendered_cost + costs.observed_cost
    if cfg.use_clutter_mode:
        total_f = total_f + cfg.clutter_regularizer * render.clutter_ratio
    total = torch.where(invalid, -1, total_f.to(torch.int32))
    return PoseScores(
        total_cost=total,
        rendered_cost=costs.rendered_cost,
        observed_cost=costs.observed_cost,
        points_diff_cost=costs.points_diff_cost,
        adjusted_poses=adjusted,
        pose_occluded=render.pose_occluded,
        point_count=costs.pose_point_num,
    )
