"""Candidate-pose scoring: render -> cloud -> ICP -> cost.

Counterpart of `perception_tpu/pipeline/scorer.py`, for the 6-DoF
configuration (cost types 2 / 3, each pose against its segment) and the
3-DoF one (cost types 0 / 1, without segmentation labels: every pose against
the one scene-wide segment; with `use_tree_occlusion` a pose that renders in
front of its source is flagged and scores -1). The branches follow the JAX
scorer's order of operations:

    ICP source, one of:
      "render": raster by `backend` (the direct kernel for "auto" /
        "pallas_direct", the coefficient-table kernel for "pallas", the
        scatter-bin kernel for "pallas_bin"; ROI or full frame) + occlusion
        pass -> depth_to_cloud_roi / depth_to_cloud_batch, every
        `icp_downsample`-th point;
      coarse (`icp_render_scale` > 1 with an ROI): the same raster at
        stride * scale over roi // scale, against the source images sampled
        every scale-th pixel, every point;
      "model" (`icp_source`, fused / nn / gicp modes with surface samples):
        no raster; the bank's surface samples at the pose, behind a
        facing-cosine mask, with their exact normals;
    -> ICP by `icp_mode`:
         "fused" / "fused_d2d" / "fused_d2d_exact": a target crop
           (`icp_crop_share` "label": one per segment around its centroid;
           "pose": one per pose around its source centroid; `icp_crop_mode`
           "near" or "spread") packed by pack_targets, the fused ICP kernel
           in point-to-plane, d2d (symmetric with icp_d2d_symmetric) or exact
           mode, with source normals for sym and exact;
         "nn" / "gicp": the composed refiners against the pose's segment
           with a per-pose "near" crop, 1-NN association every iteration;
         "projective": association through the organised observed map;
    -> the cost cloud: with `cost_cloud` "transform" and the rendered source,
       the first-pass cloud moved by the ICP delta plus explain-only surface
       samples; otherwise (`cost_cloud` "render", the model source, the
       coarse pass) a re-render at the adjusted poses
    -> cost: a fused kernel, depth only or colour-gated (CIEDE2000) on Lab;
       for cost types 1 / 3 without the face Lab table or above the colour
       caps, the composed cost (the 1-NN kernel, then the gate on RGB
       converted per point)
    -> total cost.

The same `ScorerConfig` (field names and defaults as the JAX one) selects the
path. As in the JAX scorer, the backend changes only the raster: ICP and cost
run the same kernels under every backend. Backend "xla" raises (in the
raster).

The colour-gated fused cost (types 1 / 3, with `bank_tri_lab`) compares Lab
colours: on the ROI path the cost kernel looks up each point's rendered Lab
from its winning face id (the face ids of the render that made the cost
cloud); on the full-frame path the raster draws the Lab face colours, so the
cloud's colour channel holds Lab. It runs only within the JAX scorer's caps
of its fused cost: a cloud capacity (ROI pixels or `max_points_per_pose`,
plus the explain-only samples) of at most FUSED_MAX_POINTS and at most
FUSED_MAX_TARGETS cost targets. Above them the colour cost is the composed
one on RGB, as in the JAX scorer, and the gate's result is the JAX
package's. The depth-only fused kernel takes any size: its counts equal the
composed depth cost's (tests/test_torch_deploy.py holds it at P > 2048).
"""

from __future__ import annotations

import dataclasses

import torch

from perception_tpu_torch.ops.cost import (
    COST_TYPE_6DOF,
    compute_costs,
    compute_costs_fused,
)
from perception_tpu_torch.ops.icp import (
    cloud_normals,
    crop_targets,
    icp_gicp_batch,
    icp_point_to_plane_batch,
    icp_projective_batch,
    rotate_points,
)
from perception_tpu_torch.ops.icp_fused import icp_fused, pack_targets
from perception_tpu_torch.ops.knn import nn1_batch
from perception_tpu_torch.ops.numerics import dot3_fma, sqrt
from perception_tpu_torch.ops.pointcloud import (
    depth_to_cloud_batch,
    depth_to_cloud_roi,
)
from perception_tpu_torch.ops.rasterizer import render_pose_batch
from perception_tpu_torch.utils.stats import span

# The JAX scorer's caps of its fused cost (perception_tpu/pipeline/
# scorer.py, p_cap and sc): above them it takes the composed cost, on RGB.
FUSED_MAX_POINTS = 2048
FUSED_MAX_TARGETS = 4096


@dataclasses.dataclass
class ObservedScene:
    """Observed-scene tensors the scorer reads, built once per frame."""

    seg_xyz: torch.Tensor        # [L, S, 3] label-partitioned observed cloud
    seg_rgb: torch.Tensor        # [L, S, 3] float32 0..255
    seg_lab: torch.Tensor        # [L, S, 3] CIELAB of seg_rgb (ops.color)
    seg_valid: torch.Tensor      # [L, S] bool
    seg_normals: torch.Tensor    # [L, S, 3]
    map_xyz: torch.Tensor        # [h_s * w_s, 3] organised observed map
    map_normals: torch.Tensor    # [h_s * w_s, 3]
    map_valid: torch.Tensor      # [h_s * w_s] bool
    map_label: torch.Tensor      # [h_s * w_s] int32 0-based (-1 invalid)
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


ICP_MODES = ("fused", "fused_d2d", "fused_d2d_exact", "nn", "gicp",
             "projective")
# The ICP modes that take the render-free model source.
MODEL_SOURCE_MODES = ("fused", "fused_d2d", "fused_d2d_exact", "nn", "gicp")


@dataclasses.dataclass
class PoseScores:
    total_cost: torch.Tensor        # [N] int32; -1 invalid
    rendered_cost: torch.Tensor     # [N] float32
    observed_cost: torch.Tensor     # [N] float32
    points_diff_cost: torch.Tensor  # [N] float32
    adjusted_poses: torch.Tensor    # [N, 4, 4] post-ICP model->camera
    pose_occluded: torch.Tensor     # [N] int32
    point_count: torch.Tensor       # [N] float32 rendered points per pose


def _check_config(cfg: ScorerConfig) -> None:
    if cfg.cost_type not in (0, 1, 2, 3):
        raise ValueError(f"unknown cost_type {cfg.cost_type}")
    if cfg.do_icp and cfg.icp_mode not in ICP_MODES:
        raise ValueError(f"unknown icp_mode {cfg.icp_mode!r}")


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
                 src_xyz: torch.Tensor, src_valid: torch.Tensor,
                 cfg: ScorerConfig) -> torch.Tensor:
    """[N, k, 8] packed ICP targets: the whole segment when it fits in k
    rows; else a crop by cfg.icp_crop_mode, one per segment around its
    valid centroid, shared by every pose of that segment
    (icp_crop_share "label"), or one per pose around its valid source
    centroid (any other share, as the JAX scorer reads it)."""
    s = scene.seg_xyz.shape[1]
    k = min(cfg.icp_crop_targets or 256, s)
    seg_pk = pack_targets(scene.seg_xyz, scene.seg_valid, scene.seg_normals)
    if k >= s:
        return seg_pk[labels]
    # Centroids summed in float64, so the f32 centre does not depend on the
    # device's summation order.
    if cfg.icp_crop_share == "label":
        valid = scene.seg_valid
        segc = ((scene.seg_xyz.double() * valid[..., None]).sum(dim=1)
                / torch.clamp(valid.sum(dim=1), min=1)[:, None]).float()
        cidx = crop_targets(scene.seg_xyz, valid, segc, k,
                            mode=cfg.icp_crop_mode)
        cropped = torch.gather(seg_pk, 1, cidx[..., None].expand(-1, -1, 8))
        return cropped[labels]
    centers = ((src_xyz.double() * src_valid[..., None]).sum(dim=1)
               / torch.clamp(src_valid.sum(dim=1), min=1)[:, None]).float()
    cidx = crop_targets(scene.seg_xyz[labels], scene.seg_valid[labels],
                        centers, k, mode=cfg.icp_crop_mode)
    return torch.gather(seg_pk[labels], 1, cidx[..., None].expand(-1, -1, 8))


def _refine(src_xyz: torch.Tensor, src_valid: torch.Tensor,
            src_nrm: torch.Tensor | None, scene: ObservedScene,
            labels: torch.Tensor, cfg: ScorerConfig
            ) -> tuple[torch.Tensor, int]:
    """(ICP deltas [N, 4, 4] by cfg.icp_mode, as the JAX scorer dispatches;
    the composed refiners' host loop iterations, 0 for the fused kernel).
    src_nrm: the model source's exact normals (None for a rendered source,
    whose normals the modes that need them estimate by k-NN)."""
    if cfg.icp_mode == "projective":
        out = icp_projective_batch(
            src_xyz, src_valid, scene.map_xyz, scene.map_normals,
            scene.map_valid, scene.map_label, labels,
            fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, width=cfg.width,
            height=cfg.height, stride=cfg.stride,
            max_iterations=cfg.icp_max_iterations,
            max_correspondence=cfg.icp_max_correspondence,
            rotation_epsilon=cfg.icp_rotation_epsilon,
            transformation_epsilon=cfg.icp_transformation_epsilon,
            use_labels=cfg.use_segmentation_label)
        return out.delta, out.loops
    if cfg.icp_mode in ("nn", "gicp"):
        tgt = (scene.seg_xyz[labels], scene.seg_valid[labels],
               scene.seg_normals[labels])
        common = dict(max_iterations=cfg.icp_max_iterations,
                      max_correspondence=cfg.icp_max_correspondence,
                      crop_k=cfg.icp_crop_targets)
        if cfg.icp_mode == "nn":
            out = icp_point_to_plane_batch(
                src_xyz, src_valid, *tgt,
                rotation_epsilon=cfg.icp_rotation_epsilon,
                transformation_epsilon=cfg.icp_transformation_epsilon,
                **common)
            return out.delta, out.loops
        rot_eps, trn_eps = cfg.d2d_epsilons()
        if src_nrm is None:
            src_nrm = cloud_normals(src_xyz, src_valid)
        out = icp_gicp_batch(
            src_xyz, src_valid, src_nrm, *tgt,
            rotation_epsilon=rot_eps, transformation_epsilon=trn_eps,
            gicp_epsilon=cfg.icp_gicp_epsilon, **common)
        return out.delta, out.loops
    exact = cfg.icp_mode == "fused_d2d_exact"
    d2d = cfg.icp_mode != "fused"
    fused_nrm = None
    if exact or (d2d and cfg.icp_d2d_symmetric):
        # Source covariances from k-NN normals of the rendered cloud, as
        # fast_gicp estimates them; the model source brings exact ones.
        fused_nrm = (src_nrm if src_nrm is not None
                     else cloud_normals(src_xyz, src_valid))
    if d2d:
        rot_eps, trn_eps = cfg.d2d_epsilons()
    else:
        rot_eps = cfg.icp_rotation_epsilon
        trn_eps = cfg.icp_transformation_epsilon
    return icp_fused(
        src_xyz, src_valid,
        _icp_targets(scene, labels, src_xyz, src_valid, cfg), fused_nrm,
        max_iterations=cfg.icp_max_iterations,
        max_correspondence=cfg.icp_max_correspondence,
        nn_every=cfg.icp_exact_nn_every if exact else cfg.icp_nn_every,
        rotation_epsilon=rot_eps, transformation_epsilon=trn_eps,
        stagnation_streak=cfg.icp_stagnation_streak,
        d2d_epsilon=cfg.icp_gicp_epsilon if d2d else 0.0, exact=exact,
        assoc_trigger=cfg.icp_assoc_trigger), 0


def model_source(poses: torch.Tensor, model_ids: torch.Tensor,
                 bank_icp_samples: torch.Tensor,
                 bank_icp_normals: torch.Tensor,
                 bank_backface: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The render-free ICP source: (points [N, K, 3], facing [N, K] bool,
    normals [N, K, 3]), the bank's surface samples and normals at each pose
    in the camera frame. A sample counts where its normal faces the camera
    by a cosine over 0.2 (n . p < -0.2 |p|: grazing faces have full weight
    among the samples but almost no area in a render), or everywhere on a
    model without backface culling (unsigned normals). The rotations, dot
    products and norm are rounded as XLA's CPU backend rounds them (fused
    multiply-adds in index order), so a grazing sample falls on the same
    side of the threshold as in the JAX scorer."""
    rot = poses[:, None, :3, :3]                               # [N, 1, 3, 3]
    samp = bank_icp_samples[model_ids][:, :, None, :]          # [N, K, 1, 3]
    snrm = bank_icp_normals[model_ids][:, :, None, :]
    p_cam = dot3_fma(rot, samp) + poses[:, None, :3, 3]
    n_cam = dot3_fma(rot, snrm)
    facing = dot3_fma(n_cam, p_cam) < -0.2 * sqrt(dot3_fma(p_cam, p_cam))
    if bank_backface is not None:
        facing = facing | ~bank_backface[model_ids][:, None]
    return p_cam, facing, n_cam


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
    counters: dict | None = None,
) -> PoseScores:
    """Render, refine and score one batch of candidate poses; pose i scores
    against observed segment pose_labels[i]. Given a dict `counters`, its
    "icp_iterations" gets the composed refiner's loop iterations (each one
    association and one host read; 0 on the fused and no-ICP paths).
    The refinement is the `scorer.icp` span (counters `poses`, the batch's
    slots, and `iterations`, that loop count)."""
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

    # The colour gate compares Lab: in a fused kernel with the face Lab
    # table within the JAX caps, else in the composed cost, which converts
    # RGB per point. ROI clouds keep pixel == point order, so the fused
    # kernel looks the rendered Lab up by face id; full-frame clouds are
    # compacted, so the raster draws Lab face colours instead.
    p_cap = (cfg.roi_shape[0] * cfg.roi_shape[1] if cfg.roi_shape
             else cfg.max_points_per_pose)
    if cfg.cost_cloud == "transform" and bank_icp_samples is not None:
        aug_k = bank_icp_samples.shape[1]
        p_cap += min(aug_k, cfg.cost_aug_samples or aug_k)
    color = cfg.cost_type in (1, 3)
    fused_color = (color and bank_tri_lab is not None
                   and p_cap <= FUSED_MAX_POINTS and sc <= FUSED_MAX_TARGETS)
    tri_color = fused_color and cfg.roi_shape is not None
    render_colors = (bank_tri_lab if fused_color and not tri_color
                     else bank_tri_colors)
    cost_rgb = ((scene.seg_lab if fused_color else scene.seg_rgb)
                [:, :sc][labels] if color else None)

    from_model = (cfg.do_icp and cfg.icp_source == "model"
                  and bank_icp_samples is not None
                  and cfg.icp_mode in MODEL_SOURCE_MODES)
    coarse = (cfg.do_icp and cfg.icp_render_scale > 1
              and cfg.roi_shape is not None and not from_model)
    render_args = (bank_tri_verts, render_colors, bank_tri_valid)
    src_nrm = None
    if from_model:
        render = cloud = None
        src_xyz, src_valid, src_nrm = model_source(
            poses, ids, bank_icp_samples, bank_icp_normals, bank_backface)
    elif coarse:
        # The pre-ICP pass feeds only the ICP source: the raster at
        # stride * scale over roi // scale samples the pixels that every
        # scale-th point of the full pass would have kept.
        scale = cfg.icp_render_scale
        coarse_cfg = dataclasses.replace(
            cfg, stride=cfg.stride * scale,
            roi_shape=(cfg.roi_shape[0] // scale, cfg.roi_shape[1] // scale))
        coarse_scene = dataclasses.replace(
            scene, source_depth=scene.source_depth[::scale, ::scale],
            source_label=scene.source_label[::scale, ::scale])
        render, cloud = _render_and_cloud(
            *render_args, poses, ids, proj, coarse_scene, labels, coarse_cfg,
            bank_backface)
        src_xyz, src_valid = cloud.xyz, cloud.valid
    else:
        render, cloud = _render_and_cloud(
            *render_args, poses, ids, proj, scene, labels, cfg, bank_backface)
        ds = cfg.icp_downsample
        src_xyz, src_valid = cloud.xyz[:, ::ds], cloud.valid[:, ::ds]

    adjusted = poses
    explain_only = None
    loops = 0
    if cfg.do_icp:
        with span("scorer.icp") as sp:
            delta, loops = _refine(src_xyz, src_valid, src_nrm, scene, labels,
                                   cfg)
            if sp:
                sp.add("poses", poses.shape[0])
                sp.add("iterations", loops)
        adjusted = _compose(delta, poses)
        if cfg.cost_cloud == "transform" and not from_model and not coarse:
            cloud, explain_only = _moved_cloud(
                cloud, delta, adjusted, ids, bank_icp_samples,
                bank_icp_normals, cfg)
        else:
            # Re-render and re-cloud at the adjusted poses (the reference's
            # own semantics, renderer.cu:1740-1817).
            render, cloud = _render_and_cloud(
                *render_args, adjusted, ids, proj, scene, labels, cfg,
                bank_backface)

    if color and not fused_color:
        dist_sq, idx = nn1_batch(cloud.xyz, cloud.valid, cost_xyz, cost_valid)
        costs = compute_costs(
            dist_sq, idx, cloud.valid, render.pose_occluded, cloud.rgb,
            cost_rgb, observed_total, sensor_resolution=cfg.sensor_resolution,
            color_distance_threshold=cfg.color_distance_threshold,
            cost_type=cfg.cost_type, cloud_explain_only=explain_only)
    else:
        tri_kw = {}
        if tri_color:
            # The explain-only samples have no face.
            tri_id = render.tri_id.reshape(render.tri_id.shape[0], -1)
            tri_kw = dict(
                cloud_tri_id=_pad_points(tri_id, cloud.xyz.shape[1], -1),
                model_ids=ids, bank_lab=bank_tri_lab)
        costs = compute_costs_fused(
            cloud.xyz, cloud.valid, render.pose_occluded, cost_xyz,
            cost_valid, observed_total,
            sensor_resolution=cfg.sensor_resolution,
            cloud_lab=cloud.rgb if fused_color and not tri_color else None,
            tgt_lab=cost_rgb,
            color_distance_threshold=cfg.color_distance_threshold,
            use_color=fused_color, cloud_explain_only=explain_only, **tri_kw)

    if counters is not None:
        counters["icp_iterations"] = loops
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


def _moved_cloud(cloud, delta, adjusted, ids, bank_icp_samples,
                 bank_icp_normals, cfg: ScorerConfig):
    """The cost cloud of cost_cloud="transform": the first-pass cloud moved
    rigidly by the ICP delta and, given the bank's surface samples, their
    front hemisphere at the adjusted pose appended as explain-only points
    (they may explain observed points, never count as rendered ones; their
    colour is 0). Returns (cloud, explain_only [N, P + K] bool or None)."""
    moved = (rotate_points(delta[:, :3, :3], cloud.xyz)
             + delta[:, None, :3, 3])
    xyz = torch.where(cloud.valid[..., None], moved, cloud.xyz)
    if bank_icp_samples is None:
        return dataclasses.replace(cloud, xyz=xyz), None
    samp = bank_icp_samples[ids]
    snrm = bank_icp_normals[ids]
    if cfg.cost_aug_samples and cfg.cost_aug_samples < samp.shape[1]:
        # A strided slice of the area-stratified samples stays uniform.
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
    explain_only = torch.cat(
        [torch.zeros((n_b, p_b), dtype=torch.bool, device=xyz.device),
         torch.ones((n_b, k_b), dtype=torch.bool, device=xyz.device)], dim=1)
    return dataclasses.replace(
        cloud, xyz=torch.cat([xyz, aug_xyz], dim=1),
        rgb=_pad_points(cloud.rgb, p_b + k_b, 0.0),
        valid=torch.cat([cloud.valid, aug_valid], dim=1)), explain_only
