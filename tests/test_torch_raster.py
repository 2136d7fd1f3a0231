"""Parity of the PyTorch port's raster (direct kernel twin + render pass)
with the JAX package, whose direct Pallas kernel runs in interpret mode.

Tolerance: XLA's CPU backend contracts a*b+c into FMAs where PyTorch rounds
each product, so a coverage test can flip on a pixel that lies on a
triangle edge. Keys must agree on >= 99% of pixels; every other pixel must
be on a silhouette (one side empty) or within one triangle's depth (1 cm).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from perception_tpu.core.config import CameraIntrinsics
from perception_tpu.core.mesh import ModelBank, mesh_model_from_arrays
from perception_tpu.core.pose import euler_xyz_to_matrix
from perception_tpu.ops import pallas_raster_direct as jprd
from perception_tpu.ops import rasterizer as jras
from perception_tpu_torch import convert
from perception_tpu_torch.ops import raster_direct as prd
from perception_tpu_torch.ops import rasterizer as pras

from tests.test_core import make_box

CAM = CameraIntrinsics(fx=160.0, fy=160.0, cx=64.0, cy=48.0, width=128,
                       height=96)
INVALID = 2**31 - 1


def _scene(n_poses=6, seed=3):
    rng = np.random.default_rng(seed)
    v1, f1 = make_box(0.15, 0.12, 0.1)
    v2, f2 = make_box(0.08, 0.2, 0.06)
    c1 = np.tile([200.0, 40, 40], (len(v1), 1))
    c2 = np.tile([40.0, 200, 40], (len(v2), 1))
    bank = ModelBank.from_models(
        [mesh_model_from_arrays("a", v1, f1, colors=c1),
         mesh_model_from_arrays("b", v2, f2, colors=c2)], t_cap=16)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_poses, 1, 1))
    for i in range(n_poses):
        poses[i, :3, :3] = euler_xyz_to_matrix(*rng.uniform(-1, 1, 3))
        poses[i, :3, 3] = [rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                           rng.uniform(0.6, 0.8)]
    ids = np.arange(n_poses, dtype=np.int32) % 2
    return bank, poses, ids


def _assert_keys_close(ref, out):
    ref, out = np.asarray(ref), np.asarray(out)
    assert (ref != INVALID).any()
    diff = ref != out
    assert diff.mean() <= 0.01, diff.mean()
    silhouette = (ref[diff] == INVALID) | (out[diff] == INVALID)
    depth_step = np.abs((ref[diff] >> 11) - (out[diff] >> 11)) <= 1
    assert (silhouette | depth_step).all()


def test_pack_bank_verts_matches_jax():
    bank, _, _ = _scene()
    ref = jprd.pack_bank_verts(jnp.asarray(bank.tri_verts),
                               jnp.asarray(bank.tri_valid),
                               jnp.asarray(bank.backface_cull))
    verts, _, valid, cull = convert.bank_tensors(bank)
    out = prd.pack_bank_verts(verts, valid, cull)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("roi", [None, (24, 24)])
def test_raster_keys_match_pallas(roi):
    """Kernel-twin keys == rasterize_direct_pallas(interpret=True), in the
    ROI window and over the full strided frame (tolerance: module doc)."""
    bank, poses, ids = _scene(seed=5)
    proj = CAM.projection()
    v16 = jprd.pack_bank_verts(jnp.asarray(bank.tri_verts),
                               jnp.asarray(bank.tri_valid),
                               jnp.asarray(bank.backface_cull))
    rng = np.random.default_rng(1)
    anchors = (rng.integers(0, 40, (len(poses), 2)).astype(np.int32)
               if roi else np.zeros((len(poses), 2), np.int32))
    kw = dict(width=CAM.width, height=CAM.height, stride=2, roi_shape=roi)
    ref = jprd.rasterize_direct_pallas(
        v16, jnp.asarray(poses), jnp.asarray(ids), jnp.asarray(anchors),
        jnp.asarray(proj), interpret=True, **kw)
    out = prd.rasterize_direct(
        convert.tensor(v16), convert.tensor(poses), convert.tensor(ids),
        convert.tensor(anchors), convert.tensor(proj), **kw)
    assert out.dtype == torch.int32
    _assert_keys_close(ref, out.numpy())


def test_roi_anchors_match_jax():
    bank, poses, ids = _scene(n_poses=12, seed=9)
    proj = CAM.projection()
    centers = np.asarray(bank.tri_verts[..., 0, :].mean(axis=1))
    ref = jras.compute_roi_anchors(
        jnp.asarray(poses), jnp.asarray(proj), CAM.width, CAM.height, 2,
        (20, 28), model_centers=jnp.asarray(centers[ids]))
    out = pras.compute_roi_anchors(
        convert.tensor(poses), convert.tensor(proj), CAM.width, CAM.height,
        2, (20, 28), model_centers=convert.tensor(centers[ids]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("use_label", [True, False])
@pytest.mark.parametrize("roi", [None, (24, 24)])
def test_render_pose_batch_occlusion_matches_jax(use_label, roi):
    """Depth / triangle ids / colours after the occlusion pass, and the
    clutter ratio, against the JAX render with the direct Pallas kernel.
    The source images are a render of other poses, so whole regions are
    occluded; same tolerance as the keys, clutter within 1 percentage
    point."""
    bank, poses, ids = _scene(n_poses=6, seed=13)
    proj = CAM.projection()
    src_bank, src_poses, src_ids = _scene(n_poses=2, seed=21)
    src = jras.render_pose_batch(
        src_bank.tri_verts, src_bank.tri_colors, src_bank.tri_valid,
        src_poses, src_ids, jnp.asarray(proj), width=CAM.width,
        height=CAM.height, stride=2, backend="xla")
    d = np.asarray(src.depth)
    src_depth = np.where(d[0] > 0, d[0], d[1]).astype(np.int32)
    src_depth[src_depth > 0] -= 3     # in front of the candidates
    src_label = np.where(d[0] > 0, 1, np.where(d[1] > 0, 2, 0)).astype(
        np.int32)
    labels = np.asarray([0, 1, 0, 1, 1, 0], np.int32)
    kw = dict(width=CAM.width, height=CAM.height, stride=2,
              occlusion_threshold=1.0, use_segmentation_label=use_label,
              roi_shape=roi)
    ref = jras.render_pose_batch(
        bank.tri_verts, bank.tri_colors, bank.tri_valid, poses, ids,
        jnp.asarray(proj), source_depth=jnp.asarray(src_depth),
        source_label=jnp.asarray(src_label), pose_labels=jnp.asarray(labels),
        bank_backface=jnp.asarray(bank.backface_cull),
        backend="pallas_direct_interpret", **kw)
    verts, colors, valid, cull = convert.bank_tensors(bank)
    out = pras.render_pose_batch(
        verts, colors, valid, convert.tensor(poses), convert.tensor(ids),
        convert.tensor(proj), source_depth=convert.tensor(src_depth),
        source_label=convert.tensor(src_label),
        pose_labels=convert.tensor(labels), bank_backface=cull, **kw)
    np.testing.assert_array_equal(out.anchors.numpy(), np.asarray(ref.anchors))
    r_depth, o_depth = np.asarray(ref.depth), out.depth.numpy()
    assert (r_depth > 0).any()
    r_tri, o_tri = np.asarray(ref.tri_id), out.tri_id.numpy()
    same = (r_depth == o_depth) & (r_tri == o_tri)
    assert same.mean() >= 0.99
    assert ((r_depth[~same] == 0) | (o_depth[~same] == 0)
            | (np.abs(r_depth[~same] - o_depth[~same]) <= 1)).all()
    np.testing.assert_array_equal(
        out.color.numpy()[same], np.asarray(ref.color)[same])
    np.testing.assert_allclose(out.clutter_ratio.numpy(),
                               np.asarray(ref.clutter_ratio), atol=1.0)
    np.testing.assert_array_equal(out.pose_occluded.numpy(),
                                  np.asarray(ref.pose_occluded))
