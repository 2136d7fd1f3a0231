"""Parity of the PyTorch port's fused depth-only cost with the JAX package
(nn_cost_fused_pallas in interpret mode). The outputs are integer counts and
percentages of them: they must be equal. Random clouds keep every distance
far (relative 1e-6) from the threshold and from a tie, where XLA's fused
multiply-adds could round differently."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from perception_tpu.ops import cost as jcost
from perception_tpu.ops import pallas_cost as jpc
from perception_tpu_torch import convert
from perception_tpu_torch.ops import cost as pcost
from perception_tpu_torch.ops import cost_fused as pcf
from perception_tpu_torch.ops import knn as pknn


def _clouds(seed, n=4, p=300, s=200):
    rng = np.random.default_rng(seed)
    tgt = rng.normal(0, 0.05, (n, s, 3)).astype(np.float32)
    tgt[..., 2] += 0.6
    tvalid = rng.random((n, s)) > 0.25
    # Cloud points near targets (explained) mixed with far ones.
    near = tgt[:, rng.integers(0, s, p)] + rng.normal(0, 0.01, (n, p, 3))
    far = rng.normal(0, 0.08, (n, p, 3)) + [0, 0, 0.6]
    pick = rng.random((n, p, 1)) < 0.6
    cloud = np.where(pick, near, far).astype(np.float32)
    cvalid = rng.random((n, p)) > 0.2
    explain_only = rng.random((n, p)) < 0.3
    return cloud, cvalid, tgt, tvalid, explain_only


@pytest.mark.parametrize("with_explain_only", [False, True])
def test_nn_cost_fused_matches_pallas(with_explain_only):
    cloud, cvalid, tgt, tvalid, eo = _clouds(0)
    eo = eo if with_explain_only else None
    ref = jpc.nn_cost_fused_pallas(
        jnp.asarray(cloud), jnp.asarray(cvalid), jnp.asarray(tgt),
        jnp.asarray(tvalid), sensor_resolution=0.012, interpret=True,
        cloud_explain_only=None if eo is None else jnp.asarray(eo))
    out = pcf.nn_cost_fused(
        convert.tensor(cloud), convert.tensor(cvalid), convert.tensor(tgt),
        convert.tensor(tvalid), 0.012,
        cloud_explain_only=None if eo is None else convert.tensor(eo))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert (np.asarray(ref[2]) > 0).all() and (np.asarray(ref[1]) > 0).all()


def test_cadd_flags_match_jax():
    _, cvalid, _, _, eo = _clouds(1)
    ref = jpc._cadd_flags(jnp.asarray(cvalid), jnp.asarray(eo))
    out = pcf._cadd_flags(convert.tensor(cvalid), convert.tensor(eo))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_compute_costs_fused_matches_jax():
    """Percentages and sentinels: an occluded pose, an empty pose and an
    empty observed segment."""
    cloud, cvalid, tgt, tvalid, eo = _clouds(2)
    cvalid[1] = False                                   # no rendered points
    occluded = np.asarray([0, 0, 1, 0], np.int32)
    totals = np.asarray([150.0, 80.0, 60.0, 0.0], np.float32)
    kw = dict(sensor_resolution=0.012)
    ref = jcost.compute_costs_fused(
        jnp.asarray(cloud), jnp.asarray(cvalid), jnp.asarray(occluded),
        jnp.asarray(tgt), jnp.asarray(tvalid), jnp.asarray(totals),
        interpret=True, cloud_explain_only=jnp.asarray(eo), **kw)
    out = pcost.compute_costs_fused(
        convert.tensor(cloud), convert.tensor(cvalid),
        convert.tensor(occluded), convert.tensor(tgt),
        convert.tensor(tvalid), convert.tensor(totals),
        cloud_explain_only=convert.tensor(eo), **kw)
    for name in ("rendered_cost", "observed_cost", "points_diff_cost",
                 "pose_point_num", "observed_explained"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert float(out.rendered_cost[1]) == -1.0
    assert float(out.rendered_cost[2]) == -1.0
    assert float(out.observed_cost[3]) == 100.0


def test_colour_cost_is_not_ported():
    """The colour cost on RGB, once unported, is the composed
    compute_costs (tests/test_torch_branch_ops.py holds it to JAX's): the
    fused form refuses colour without Lab inputs with a ValueError, and the
    composed form scores the same inputs."""
    cloud, cvalid, tgt, tvalid, _ = _clouds(3, n=1)
    t = convert.tensor
    with pytest.raises(ValueError, match="Lab"):
        pcost.compute_costs_fused(
            t(cloud), t(cvalid), t(np.zeros(1, np.int32)), t(tgt), t(tvalid),
            t(np.ones(1, np.float32)), sensor_resolution=0.01, use_color=True)
    dist, idx = pknn.nn1_batch(t(cloud), t(cvalid), t(tgt), t(tvalid))
    rgb = np.full(cloud.shape, 128.0, np.float32)
    out = pcost.compute_costs(
        dist, idx, t(cvalid), t(np.zeros(1, np.int32)), t(rgb),
        t(np.full(tgt.shape, 128.0, np.float32)), t(np.ones(1, np.float32)),
        sensor_resolution=0.01, cost_type=3)
    depth = pcost.compute_costs(
        dist, idx, t(cvalid), t(np.zeros(1, np.int32)), t(rgb),
        t(np.full(tgt.shape, 128.0, np.float32)), t(np.ones(1, np.float32)),
        sensor_resolution=0.01, cost_type=2)
    # Equal colours pass the gate: the colour cost is the depth cost.
    assert torch.equal(out.rendered_cost, depth.rendered_cost)