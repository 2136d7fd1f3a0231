"""The ops under the port's scorer and env branches against the JAX package:
the spread ICP crop, projective ICP, the composed cost, the chunked
`knn_self`, the model source's facing mask, `sphere_fibonacci_grid` and the
particle log-likelihood.

Tolerances are stated per test: exact where both sides round alike (crop
indices, knn_self, the facing mask, the composed counts, the fibonacci
grid); projective ICP deltas within 1e-5 (XLA's CPU backend contracts a*b+c
into FMAs); the log-likelihood within 1e-5 relative (float32 sums in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.eval.sampling import sphere_fibonacci_grid as jfib
from perception_tpu.ops import cost as jcost
from perception_tpu.ops import icp as jicp
from perception_tpu.ops import likelihood as jlik
from perception_tpu.pipeline import scorer as jscorer
from perception_tpu_torch import convert
from perception_tpu_torch.eval.sampling import sphere_fibonacci_grid
from perception_tpu_torch.ops import cost as pcost
from perception_tpu_torch.ops import icp as picp
from perception_tpu_torch.ops import knn as pknn
from perception_tpu_torch.ops import likelihood as plik
from perception_tpu_torch.pipeline import scorer as pscorer

from tests.test_pipeline import gt_states, make_env
from tests.test_torch_scorer import _box_candidates

t = convert.tensor


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _crop_problem():
    rng = np.random.default_rng(0)
    n, s = 16, 600
    xyz = rng.normal(size=(n, s, 3)).astype(np.float32) * 0.05
    xyz[:, 300:310] = xyz[:, 290:300]          # exact distance ties
    valid = rng.random((n, s)) > 0.3
    valid[3, 50:] = False                       # fewer valid than 2k
    valid[4] = False                            # none valid
    centers = rng.normal(size=(n, 3)).astype(np.float32) * 0.02
    return xyz, valid, centers


@pytest.mark.parametrize("k", [64, 128, 256])
def test_crop_spread_matches_jax(k):
    """crop_targets(mode="spread") with 2k < S: the same indices as JAX's,
    ties (duplicated points) and the invalid tail included."""
    xyz, valid, centers = _crop_problem()
    ref = np.asarray(jicp.crop_targets(jnp.asarray(xyz), jnp.asarray(valid),
                                       jnp.asarray(centers), k,
                                       mode="spread"))
    out = picp.crop_targets(t(xyz), t(valid), t(centers), k,
                            mode="spread").numpy()
    np.testing.assert_array_equal(out, ref)


def test_crop_spread_whole_segment_matches_jax():
    """2k >= S: JAX's approx_max_k then sorts the whole segment, and that
    sort orders equal distances (duplicated points, the invalid tail)
    otherwise than by index; the port keeps the lower index first. The
    distance at every position is equal (members of a tie group may trade
    places), and no index repeats within a pose."""
    xyz, valid, centers = _crop_problem()
    k = 400
    ref = np.asarray(jicp.crop_targets(jnp.asarray(xyz), jnp.asarray(valid),
                                       jnp.asarray(centers), k,
                                       mode="spread"))
    out = picp.crop_targets(t(xyz), t(valid), t(centers), k,
                            mode="spread").numpy()
    d = ((xyz - centers[:, None]) ** 2).sum(-1)
    d = np.where(valid, d, np.inf)
    np.testing.assert_array_equal(np.take_along_axis(d, out, 1),
                                  np.take_along_axis(d, ref, 1))
    assert all(len(np.unique(o)) == k for o in out)


def test_knn_self_chunks_equal_the_whole_sort(monkeypatch):
    """The row-blocked k-selection returns the whole-matrix stable sort's
    first k (distances and indices), ties on a lattice included, at block
    sizes that split rows unevenly."""
    rng = np.random.default_rng(1)
    xyz = t(rng.integers(0, 4, (3, 200, 3)).astype(np.float32) * 0.01)
    valid = t(rng.random((3, 200)) > 0.2)
    valid[2, 5:] = False
    p = xyz.shape[1]
    diff = xyz[:, :, None, :] - xyz[:, None, :, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
         + diff[..., 2] * diff[..., 2])
    d = torch.where(valid[:, None, :] & ~torch.eye(p, dtype=torch.bool), d,
                    float("inf"))
    ref_d, ref_i = torch.sort(d, dim=-1, stable=True)
    for block in (1 << 24, 1000, 37):
        monkeypatch.setattr(pknn, "KNN_BLOCK", block)
        out_d, out_i = pknn.knn_self(xyz, valid, k=10)
        assert torch.equal(out_i, ref_i[..., :10].to(torch.int32)), block
        assert torch.equal(out_d, ref_d[..., :10]), block


@pytest.fixture(scope="module")
def box_env():
    env = make_env()
    env.env = dataclasses.replace(env.env, icp_mode="fused",
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    return env


def test_model_source_facing_mask_matches_jax(box_env):
    """The model source's points, normals and facing mask equal JAX's
    expressions bit for bit (XLA rounds the rotations, the dot products and
    the norm as fused multiply-add chains), on the box scene's candidates
    and on samples placed across the -0.2 cosine threshold."""
    env = box_env
    cands = _box_candidates(8, seed=2)
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    samp = np.asarray(env._bank_icp_samples)
    nrm = np.asarray(env._bank_icp_normals)
    # Extra samples whose normals meet the view ray near the threshold.
    rng = np.random.default_rng(4)
    m, k = samp.shape[:2]
    ray = samp / np.linalg.norm(samp, axis=-1, keepdims=True)
    tang = np.cross(ray, rng.normal(size=ray.shape))
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    cos = -0.2 + rng.normal(0, 1e-7, (m, k, 1))
    graze = (cos * ray + np.sqrt(1 - cos ** 2) * tang).astype(np.float32)
    samp2 = np.concatenate([samp, samp], axis=1)
    nrm2 = np.concatenate([nrm, graze], axis=1)

    @jax.jit
    def jax_source(poses, ids, samp, snrm, backface):
        # The lines of the JAX scorer's model_source branch.
        s, n = samp[ids], snrm[ids]
        rot = poses[:, :3, :3]
        p_cam = jnp.einsum("nij,nkj->nki", rot, s) + poses[:, None, :3, 3]
        n_cam = jnp.einsum("nij,nkj->nki", rot, n)
        facing = (jnp.sum(n_cam * p_cam, axis=-1)
                  < -0.2 * jnp.linalg.norm(p_cam, axis=-1))
        return p_cam, facing | ~backface[ids][:, None], n_cam

    backface = np.asarray(env._render_bank[3])
    ref = [np.asarray(a) for a in jax_source(poses, ids, samp2, nrm2,
                                             backface)]
    out = pscorer.model_source(t(poses), t(ids).long(), t(samp2), t(nrm2),
                               t(backface))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), r)
    assert 0 < ref[1].mean() < 1


def test_icp_projective_matches_jax(box_env):
    """icp_projective_batch on the box scene's organised map and its
    candidates' rendered clouds (every 2nd point): deltas within 1e-5,
    iteration counts equal."""
    env = box_env
    cfg = dataclasses.replace(env._scorer_config(do_icp=True),
                              icp_mode="projective")
    cands = _box_candidates(8, seed=2)
    poses = jnp.asarray(np.stack([env.pose_to_camera(s) for s in cands]))
    ids = jnp.asarray([s.id for s in cands], jnp.int32)
    labels = jnp.asarray([s.segmentation_label_id - 1 for s in cands],
                         jnp.int32)
    rb = env._render_bank
    _, cloud = jscorer._render_and_cloud(rb[0], rb[1], rb[2], poses, ids,
                                         env._proj, env._scene, labels, cfg,
                                         rb[3])
    src, val = cloud.xyz[:, ::2], cloud.valid[:, ::2]
    sc = env._scene
    kw = dict(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, width=cfg.width,
              height=cfg.height, stride=cfg.stride,
              max_iterations=cfg.icp_max_iterations)
    ref = jicp.icp_projective_batch(src, val, sc.map_xyz, sc.map_normals,
                                    sc.map_valid, sc.map_label, labels, **kw)
    out = picp.icp_projective_batch(
        t(src), t(val), t(sc.map_xyz), t(sc.map_normals), t(sc.map_valid),
        t(sc.map_label), t(labels), **kw)
    np.testing.assert_allclose(out.delta.numpy(), np.asarray(ref.delta),
                               atol=1e-5)
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert (np.abs(np.asarray(ref.delta)[:, :3, 3]).max(axis=1) > 1e-4).any()


@pytest.mark.parametrize("cost_type", [0, 1, 2, 3])
def test_compute_costs_matches_jax(cost_type):
    """The composed cost on seeded inputs (nearest distances around the
    sensor resolution, neighbour indices with repeats, colours that both
    pass and fail the gate, occluded poses, explain-only rows): every
    output equal to JAX's."""
    rng = np.random.default_rng(cost_type)
    n, p, s = 12, 150, 90
    dist = (rng.uniform(0, 2, (n, p)) * 1e-4).astype(np.float32)
    idx = rng.integers(0, s, (n, p)).astype(np.int32)
    valid = rng.random((n, p)) > 0.2
    occ = (rng.random(n) > 0.8).astype(np.int32)
    obs_rgb = rng.uniform(0, 255, (n, s, 3)).astype(np.float32)
    rend = np.take_along_axis(obs_rgb, idx[..., None].astype(np.int64), 1)
    rend = np.clip(rend + rng.normal(0, 12, rend.shape), 0,
                   255).astype(np.float32)
    total = rng.uniform(0, 120, n).astype(np.float32)
    total[0] = 0.0
    aug = np.zeros((n, p), bool)
    aug[:, -30:] = True
    kw = dict(sensor_resolution=0.01, color_distance_threshold=15.0,
              cost_type=cost_type)
    ref = jcost.compute_costs(dist, idx, valid, occ, rend, obs_rgb, total,
                              cloud_explain_only=aug, **kw)
    out = pcost.compute_costs(t(dist), t(idx), t(valid), t(occ), t(rend),
                              t(obs_rgb), t(total), cloud_explain_only=t(aug),
                              **kw)
    for f in ("rendered_cost", "observed_cost", "points_diff_cost",
              "pose_point_num", "observed_explained"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)


def test_sphere_fibonacci_grid_matches_jax():
    for k, half in ((8, False), (12, False), (40, True), (7, True)):
        np.testing.assert_array_equal(sphere_fibonacci_grid(k, half),
                                      jfib(k, half))


@pytest.mark.parametrize("mode", ["gaussian_mixture", "disparity_truncated"])
def test_particle_log_likelihood_matches_jax(mode):
    """Both modes on a rendered-like depth stack with holes, NaN and
    non-positive pixels: within 1e-5 relative of JAX's, the same best
    particle; depth_cm_to_m equal."""
    rng = np.random.default_rng(5)
    obs = rng.uniform(0.5, 2.5, (24, 32)).astype(np.float32)
    obs[rng.random(obs.shape) < 0.1] = 0.0
    obs[0, :3] = np.nan
    rend = obs[None] + rng.normal(0, 0.05, (16, 24, 32)).astype(np.float32)
    rend[rng.random(rend.shape) < 0.2] = -1.0
    rend[3] = obs
    kw = dict(mode=mode, sigma=0.1, floor_ratio=0.5)
    ref = np.asarray(jlik.particle_log_likelihood(jnp.asarray(obs),
                                                  jnp.asarray(rend), **kw))
    out = plik.particle_log_likelihood(t(obs), t(rend), **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert int(plik.best_particle(t(out))) == int(jlik.best_particle(ref))
    cm = rng.integers(0, 300, (4, 5)).astype(np.int32)
    np.testing.assert_array_equal(plik.depth_cm_to_m(t(cm)).numpy(),
                                  np.asarray(jlik.depth_cm_to_m(cm)))


def test_observed_maps_match_jax(box_env):
    """The organised observed map of the projective ICP: points, validity
    and labels equal to the JAX env's; normals within 1e-4 on >= 99% of the
    points and 2e-3 on all (a point whose neighbourhood is nearly
    degenerate, on a box edge, turns by 1e-3 rad under XLA's FMA rounding,
    as the segment normals do), and bit-equal to cloud_normals over every
    slot of the observed cloud, which the port computes over the valid
    points alone."""
    from perception_tpu_torch.ops.icp import cloud_normals

    from tests.test_torch_env_fine import _port_env

    env = _port_env(box_env)
    ref, out = box_env._scene, env._scene
    np.testing.assert_array_equal(out.map_valid.numpy(),
                                  np.asarray(ref.map_valid))
    np.testing.assert_array_equal(out.map_label.numpy(),
                                  np.asarray(ref.map_label))
    np.testing.assert_array_equal(out.map_xyz.numpy(), np.asarray(ref.map_xyz))
    err = np.abs(out.map_normals.numpy() - np.asarray(ref.map_normals))
    assert (err.max(axis=1)[np.asarray(ref.map_valid)] <= 1e-4).mean() >= 0.99
    assert err.max() <= 2e-3
    obs = env._observed
    whole = cloud_normals(obs.xyz[None], obs.valid[None], k=10)[0]
    sel = obs.pixel[obs.valid].long()
    assert torch.equal(out.map_normals[sel], whole[obs.valid])
    assert int(out.map_valid.sum()) == int(obs.valid.sum()) > 100
