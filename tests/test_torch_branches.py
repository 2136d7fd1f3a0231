"""The port's scorer branches beyond the main path, against the JAX package on
the test_pipeline box scene (128x96, stride 2, eight jittered candidates),
beside tests/test_torch_scorer.py::test_unported_scorer_branches_raise
(one case per branch, with the kernels each one calls): the model source
in the exact mode (the bank normals as source normals), the re-render
cost on the colour ROI path (the face ids of the re-render) and the
composed colour cost with the gate rejecting matches.

The JAX side runs its Pallas kernels in interpret mode
(kernel_backend="pallas_direct_interpret", icp_mode="fused" where the
branch takes a fused mode), the port its PyTorch twins on CPU tensors.
Tolerance, as tests/test_torch_scorer.py's slice: total costs equal on >= 75%
of the poses and within 5 everywhere, adjusted translations within 1 mm
(XLA's CPU backend contracts a*b+c into FMAs where PyTorch rounds every
product).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu_torch import convert
from perception_tpu_torch.kernels import build
from perception_tpu_torch.pipeline import scorer as pscorer

from tests.test_pipeline import gt_states, make_env
from tests.test_torch_scorer import (
    _assert_slice_close,
    _box_candidates,
    _score_both,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _box_env(roi_size: int, color: bool = False):
    env = make_env(use_color_cost=color)
    env.env = dataclasses.replace(env.env, icp_mode="fused", roi_size=roi_size,
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    return env


@pytest.fixture(scope="module")
def envs():
    """Box-scene JAX envs by (roi_size, colour), built on first use."""
    cache = {}

    def get(roi_size: int, color: bool = False):
        if (roi_size, color) not in cache:
            cache[roi_size, color] = _box_env(roi_size, color)
        return cache[roi_size, color]
    return get


def _branch(env, change: dict, lab: bool = True, seed: int = 3, scene=None):
    """Score eight candidates with the env's scorer config changed by
    `change`, on both packages, against the env's scene or `scene`; the JAX
    env's face Lab table when `lab`."""
    cands = _box_candidates(8, seed=seed)
    cfg = dataclasses.replace(env._scorer_config(do_icp=True), **change)
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands], np.int32)
    totals = np.asarray(env._observed.seg_count, np.float32)[labels]
    build.reset_counts()
    ref, out = _score_both(
        env._render_bank,
        (jnp.asarray(poses), jnp.asarray(ids), jnp.asarray(labels),
         jnp.asarray(totals), env._proj,
         env._scene if scene is None else scene),
        cfg, env._bank_icp_samples, env._bank_icp_normals,
        bank_lab=env._render_bank_lab if lab else None)
    return ref, out, dict(build.TWIN_CALLS)


def test_model_source_exact_matches_jax(envs):
    """icp_source="model" with icp_mode="fused_d2d_exact", full frame: the
    surface samples behind the facing-cosine mask, their exact bank
    normals as the source normals (no k-NN normals), no pre-ICP raster,
    one render at the adjusted poses."""
    ref, out, twins = _branch(envs(0), dict(icp_source="model",
                                            icp_mode="fused_d2d_exact"))
    assert twins == {"icp_fused": 1, "raster_direct": 1, "cost_fused": 1}
    _assert_slice_close(ref, out)


def test_render_cost_color_roi_matches_jax(envs):
    """cost_cloud="render" on the colour ROI path: the raster twice (the
    pre-ICP pass and the re-render at the adjusted poses), and the tri-id
    colour cost reads the re-render's face ids."""
    ref, out, twins = _branch(envs(20, True), dict(cost_cloud="render"))
    assert twins == {"raster_direct": 2, "icp_fused": 1,
                     "cost_fused_color_tri": 1}
    _assert_slice_close(ref, out)


def test_composed_color_cost_matches_jax(envs):
    """Cost type 3 without the face Lab table, full frame: the composed
    cost (1-NN, CIEDE2000 on RGB converted per point, scatter-max) on both
    sides. Every other observed point of the red box is painted blue, so the
    gate rejects matches (the totals differ from depth-only ones)."""
    env = envs(0, True)
    rgb = np.asarray(env._scene.seg_rgb).copy()
    rgb[0, ::2] = (40.0, 40.0, 200.0)
    scene = env._scene._replace(seg_rgb=jnp.asarray(rgb))
    ref, out, twins = _branch(env, {}, lab=False, scene=scene)
    assert twins == {"raster_direct": 1, "icp_fused": 1, "nn1_batch": 1}
    _assert_slice_close(ref, out)
    cands = _box_candidates(8, seed=3)
    t = convert.tensor
    depth = pscorer.score_pose_batch(
        *[t(a) for a in env._render_bank[:3]],
        t(np.stack([env.pose_to_camera(c) for c in cands])),
        t([c.id for c in cands]),
        t([c.segmentation_label_id - 1 for c in cands]),
        t(np.asarray(env._observed.seg_count, np.float32)[
            [c.segmentation_label_id - 1 for c in cands]]),
        t(env._proj), convert.scene_from_jax(scene),
        dataclasses.replace(
            convert.scorer_config_from_jax(env._scorer_config(do_icp=True)),
            cost_type=2),
        bank_backface=t(env._render_bank[3]),
        bank_icp_samples=t(env._bank_icp_samples),
        bank_icp_normals=t(env._bank_icp_normals))
    assert (depth.total_cost != out.total_cost).any()
