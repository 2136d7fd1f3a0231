"""Parity of the PyTorch port's depth -> cloud conversions with the JAX
package. Unprojection is the same f32 arithmetic in both (tolerance 1e-6 m
for XLA's fused multiply-adds); validity, pixel indices, labels and the
stable compaction order must match exactly."""

import numpy as np
import jax.numpy as jnp
import pytest

from perception_tpu.ops import pointcloud as jpc
from perception_tpu_torch import convert
from perception_tpu_torch.ops import pointcloud as ppc

CAMERA = dict(fx=160.0, fy=160.0, cx=64.0, cy=48.0, width=128, height=96)


def _depth_batch(rng, n, h, w):
    depth = rng.integers(40, 90, (n, h, w)).astype(np.int32)
    depth[rng.random((n, h, w)) < 0.6] = 0
    color = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    return depth, color


def _assert_cloud_equal(ref, out):
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.pixel.numpy(), np.asarray(ref.pixel))
    np.testing.assert_array_equal(out.count.numpy(), np.asarray(ref.count))
    np.testing.assert_allclose(out.xyz.numpy(), np.asarray(ref.xyz),
                               atol=1e-6)
    np.testing.assert_array_equal(out.rgb.numpy(), np.asarray(ref.rgb))


def test_depth_to_cloud_roi_matches_jax():
    rng = np.random.default_rng(0)
    depth, color = _depth_batch(rng, 3, 12, 16)
    anchors = rng.integers(0, 30, (3, 2)).astype(np.int32)
    kw = dict(stride=2, depth_factor=100.0, **CAMERA)
    ref = jpc.depth_to_cloud_roi(jnp.asarray(depth), jnp.asarray(color),
                                 jnp.asarray(anchors), **kw)
    out = ppc.depth_to_cloud_roi(convert.tensor(depth), convert.tensor(color),
                                 convert.tensor(anchors), **kw)
    _assert_cloud_equal(ref, out)


@pytest.mark.parametrize("max_points", [256, 4000])
def test_depth_to_cloud_batch_matches_jax(max_points):
    """Full-frame path: stable valid-first compaction, capped (256 drops
    valid points) or not (4000 exceeds the 3072 pixels)."""
    rng = np.random.default_rng(1)
    depth, color = _depth_batch(rng, 2, 48, 64)
    kw = dict(stride=2, depth_factor=100.0, max_points=max_points, **CAMERA)
    ref = jpc.depth_to_cloud_batch(jnp.asarray(depth), jnp.asarray(color),
                                   **kw)
    out = ppc.depth_to_cloud_batch(convert.tensor(depth),
                                   convert.tensor(color), **kw)
    _assert_cloud_equal(ref, out)


def test_interleave_perm_matches_jax():
    for n in (1, 7, 1024, 4096, 8192):
        np.testing.assert_array_equal(ppc._interleave_perm(n),
                                      jpc._interleave_perm(n))


@pytest.mark.parametrize("max_points", [1000, 4096])
def test_observed_cloud_from_depth_matches_jax(max_points):
    """Label partition in interleaved order, including a point cap larger
    than the strided frame (3072 pixels), where JAX's gathers clamp."""
    rng = np.random.default_rng(2)
    h, w = 96, 128
    depth = rng.uniform(50, 90, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.3] = 0
    label = np.zeros((h, w), np.int32)
    label[10:50, 10:60] = 1
    label[40:90, 70:120] = 2
    label[60:80, 20:40] = 3
    color = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    kw = dict(stride=2, depth_factor=100.0, max_points=max_points,
              seg_cap=512, num_labels=4, **CAMERA)
    ref = jpc.observed_cloud_from_depth(
        jnp.asarray(depth), jnp.asarray(color), jnp.asarray(label), **kw)
    out = ppc.observed_cloud_from_depth(
        convert.tensor(depth), convert.tensor(color), convert.tensor(label),
        **kw)
    for name in ("valid", "label", "pixel", "count", "seg_valid",
                 "seg_count", "seg_rgb"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(out.xyz.numpy(), np.asarray(ref.xyz), atol=1e-6)
    np.testing.assert_allclose(out.seg_xyz.numpy(), np.asarray(ref.seg_xyz),
                               atol=1e-6)
    assert (np.asarray(ref.seg_count)[:3] > 50).all()


def test_observed_cloud_bounds_filter_matches_jax():
    rng = np.random.default_rng(3)
    h, w = 96, 128
    depth = rng.uniform(40, 120, (h, w)).astype(np.float32)
    color = np.zeros((h, w, 3), np.float32)
    label = np.ones((h, w), np.int32)
    bounds = np.asarray([0.9, 0.5, 0.1, -0.2, 0.05, -0.05], np.float32)
    cam_to_world = np.asarray([[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0],
                               [0, 0, 0, 1]], np.float32)
    kw = dict(stride=2, depth_factor=100.0, max_points=3072, seg_cap=3072,
              num_labels=1, use_label_filter=False, use_bounds_filter=True,
              **CAMERA)
    ref = jpc.observed_cloud_from_depth(
        jnp.asarray(depth), jnp.asarray(color), jnp.asarray(label),
        bounds=jnp.asarray(bounds), cam_to_world=jnp.asarray(cam_to_world),
        **kw)
    out = ppc.observed_cloud_from_depth(
        convert.tensor(depth), convert.tensor(color), convert.tensor(label),
        bounds=convert.tensor(bounds),
        cam_to_world=convert.tensor(cam_to_world), **kw)
    assert 0 < int(ref.count) < 3072
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.seg_valid.numpy(),
                                  np.asarray(ref.seg_valid))
