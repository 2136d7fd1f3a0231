"""Parity of the PyTorch port's ICP parts with the JAX package: k-NN,
eigenvectors, segment normals, the target crop, target packing and the fused
point-to-plane ICP (its kernel twin against icp_fused_pallas in interpret
mode)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from perception_tpu.ops import icp as jicp
from perception_tpu.ops import knn as jknn
from perception_tpu.ops import pallas_icp as jpicp
from perception_tpu.core.pose import euler_xyz_to_matrix
from perception_tpu_torch import convert
from perception_tpu_torch.ops import icp as picp
from perception_tpu_torch.ops import icp_fused as pfused
from perception_tpu_torch.ops import knn as pknn


def _segments(rng, b=2, p=96):
    """Noisy points on two box faces (planar neighbourhoods), some invalid."""
    u = rng.uniform(-0.05, 0.05, (b, p, 2))
    face = rng.random((b, p)) < 0.5
    xyz = np.where(face[..., None],
                   np.stack([u[..., 0], u[..., 1], np.full((b, p), 0.6)], -1),
                   np.stack([np.full((b, p), 0.05), u[..., 0], 0.6 + u[..., 1]
                             + 0.05], -1))
    xyz = xyz + rng.normal(0, 5e-4, xyz.shape)
    valid = rng.random((b, p)) > 0.15
    return xyz.astype(np.float32), valid


def test_knn_self_matches_jax():
    """Same neighbour sets (distance ties: stable order in both); distances
    to 1e-9 m^2 (XLA's fused multiply-adds)."""
    rng = np.random.default_rng(0)
    xyz, valid = _segments(rng)
    ref_d, ref_i = jknn.knn_self(jnp.asarray(xyz), jnp.asarray(valid), k=10)
    d, i = pknn.knn_self(convert.tensor(xyz), convert.tensor(valid), k=10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-9)


def test_smallest_eigenvector_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(20, 3, 3)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1)
    ref = np.asarray(jicp.smallest_eigenvector_3x3(jnp.asarray(cov)))
    out = picp.smallest_eigenvector_3x3(convert.tensor(cov)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_cloud_normals_matches_jax():
    """k=10 covariance normals oriented to the camera: 1e-4 (f32 power
    iteration in a different summation order)."""
    rng = np.random.default_rng(2)
    xyz, valid = _segments(rng)
    ref = np.asarray(jicp.cloud_normals(jnp.asarray(xyz), jnp.asarray(valid)))
    out = picp.cloud_normals(convert.tensor(xyz), convert.tensor(valid)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_crop_targets_near_matches_jax():
    """Exact nearest-k, nearest first, invalid last (JAX's approx_max_k is
    exact on the CPU). Only the order of the invalid tail is free."""
    rng = np.random.default_rng(3)
    tgt = rng.normal(0, 0.05, (3, 300, 3)).astype(np.float32)
    valid = rng.random((3, 300)) > 0.5
    centers = rng.normal(0, 0.02, (3, 3)).astype(np.float32)
    for k in (64, 200):
        ref = np.asarray(jicp.crop_targets(
            jnp.asarray(tgt), jnp.asarray(valid), jnp.asarray(centers), k))
        out = picp.crop_targets(convert.tensor(tgt), convert.tensor(valid),
                                convert.tensor(centers), k).numpy()
        keep = np.take_along_axis(valid, ref, axis=1)
        np.testing.assert_array_equal(np.where(keep, out, -1),
                                      np.where(keep, ref, -1))


def test_pack_targets_matches_jax():
    rng = np.random.default_rng(4)
    xyz, valid = _segments(rng)
    nrm = rng.normal(size=xyz.shape).astype(np.float32)
    ref = np.asarray(jpicp.pack_targets(jnp.asarray(xyz), jnp.asarray(valid),
                                        jnp.asarray(nrm)))
    out = pfused.pack_targets(convert.tensor(xyz), convert.tensor(valid),
                              convert.tensor(nrm)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def _box_corner_problem(rng, n, p=192, s=256):
    """ICP problems on three faces of a cube corner facing the camera (fully
    constrained), sources perturbed by up to 6 mm / 0.03 rad."""
    a = 0.08
    rot = euler_xyz_to_matrix(0.6155, -0.7854, 0.0)   # (1,1,1) towards -z

    def corner_points(m):
        face = rng.integers(0, 3, m)
        uv = rng.uniform(0.0, a, (m, 2))
        pts = np.zeros((m, 3))
        nrm = np.zeros((m, 3))
        for f in range(3):
            sel = np.flatnonzero(face == f)
            others = [c for c in range(3) if c != f]
            pts[np.ix_(sel, others)] = uv[sel]
            nrm[sel, f] = -1.0
        return pts, nrm

    tgt = np.zeros((n, s, 3), np.float32)
    tnrm = np.zeros((n, s, 3), np.float32)
    src = np.zeros((n, p, 3), np.float32)
    for i in range(n):
        pts, nrm = corner_points(s)
        tgt[i] = pts @ rot.T + [0.0, 0.0, 0.6]
        tnrm[i] = nrm @ rot.T
        sp, _ = corner_points(p)
        d = euler_xyz_to_matrix(*rng.uniform(-0.03, 0.03, 3))
        src[i] = (sp - a / 2) @ d.T + a / 2 + rng.uniform(-0.006, 0.006, 3)
        src[i] = src[i] @ rot.T + [0.0, 0.0, 0.6]
    tvalid = rng.random((n, s)) > 0.1
    svalid = rng.random((n, p)) > 0.1
    return src, svalid, tgt, tvalid, tnrm


@pytest.mark.parametrize("nn_every", [1, 2])
def test_icp_fused_matches_pallas(nn_every):
    """Kernel-twin deltas == icp_fused_pallas(interpret=True) to 1e-4
    (rotation entries, metres): the TPU kernel recovers the winning plane
    through a bf16 hi/lo split (exact to ~2^-16) where the port gathers it
    exactly, and the 27 sums are taken in another order."""
    rng = np.random.default_rng(5)
    src, svalid, tgt, tvalid, tnrm = _box_corner_problem(rng, 6)
    svalid[5] = False                       # no correspondences -> identity
    packed = jpicp.pack_targets(jnp.asarray(tgt), jnp.asarray(tvalid),
                                jnp.asarray(tnrm))
    kw = dict(max_iterations=20, max_correspondence=0.05, nn_every=nn_every,
              stagnation_streak=8.0)
    ref = np.asarray(jpicp.icp_fused_pallas(
        jnp.asarray(src), jnp.asarray(svalid), packed, interpret=True, **kw))
    out = pfused.icp_fused(convert.tensor(src), convert.tensor(svalid),
                           convert.tensor(packed), **kw).numpy()
    assert np.abs(ref[:5, :3, 3]).max() > 1e-3       # it did move
    np.testing.assert_array_equal(out[5], np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_icp_fused_twin_is_per_pose():
    """Done poses freeze, so a pose's result does not depend on the batch it
    runs in (one pose at a time == the whole batch, bit for bit)."""
    rng = np.random.default_rng(6)
    src, svalid, tgt, tvalid, tnrm = _box_corner_problem(rng, 4)
    packed = pfused.pack_targets(convert.tensor(tgt), convert.tensor(tvalid),
                                 convert.tensor(tnrm))
    kw = dict(max_iterations=12, nn_every=2, stagnation_streak=2.0)
    s, v = convert.tensor(src), convert.tensor(svalid)
    whole = pfused.icp_fused(s, v, packed, **kw)
    for i in range(4):
        one = pfused.icp_fused(s[i:i + 1], v[i:i + 1], packed[i:i + 1], **kw)
        torch.testing.assert_close(one[0], whole[i], rtol=0, atol=0)


def test_index_mask_matches_jax_padding():
    for s, mask in ((1, 7), (8, 7), (9, 15), (256, 255), (257, 511)):
        assert pfused.index_mask(s) == mask
