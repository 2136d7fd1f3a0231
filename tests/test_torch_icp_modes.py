"""The fused ICP's d2d, symmetric, exact and adaptive modes and the composed
"nn" / "gicp" refiners of the PyTorch port against the JAX package
(icp_fused_pallas in interpret mode; the composed refiners with
backend="pallas_interpret", i.e. nn1_batch_pallas in interpret mode).

Tolerance of the fused modes against JAX: deltas within 1e-4 on every pose
but at most one, and within 3e-3 on that one. XLA's CPU backend contracts
a*b+c into FMAs where the port rounds every product, so a quantised
association key can fall on the other side of a near-tie; the d2d modes use
the matched point itself, and such a pose then takes one different
Gauss-Newton step (typically ~1e-5 elsewhere).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from perception_tpu.core.pose import euler_xyz_to_matrix
from perception_tpu.ops import icp as jicp
from perception_tpu.ops import pallas_icp as jpicp
from perception_tpu_torch import convert
from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import icp as picp
from perception_tpu_torch.ops import icp_fused as pfused
from perception_tpu_torch.pipeline import scorer as pscorer

from tests.test_torch_icp import _box_corner_problem
from tests.test_torch_scorer import _small_problem


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


T = convert.tensor


def _assert_deltas_close(out, ref):
    err = np.abs(out - ref).max(axis=(1, 2))
    assert (err > 1e-4).sum() <= 1, err
    assert err.max() <= 3e-3, err


def _mixed_problem(seed, n=12, p=96):
    """Box-corner problems with an extra shift growing from 0 to 2 cm over
    the poses: easy and hard poses share each group of 8."""
    rng = np.random.default_rng(seed)
    src, svalid, tgt, tvalid, tnrm = _box_corner_problem(rng, n, p=p)
    shift = np.linspace(0.0, 0.02, n)[:, None, None] * np.array(
        [0.6, -0.5, 0.6])
    return (src + shift).astype(np.float32), svalid, tgt, tvalid, tnrm


def _run_both(src, svalid, tgt, tvalid, tnrm, nrm=None, **kw):
    packed = jpicp.pack_targets(jnp.asarray(tgt), jnp.asarray(tvalid),
                                jnp.asarray(tnrm))
    ref = np.asarray(jpicp.icp_fused_pallas(
        jnp.asarray(src), jnp.asarray(svalid), packed,
        None if nrm is None else jnp.asarray(nrm), interpret=True, **kw))
    out = pfused.icp_fused(T(src), T(svalid), T(packed),
                           None if nrm is None else T(nrm), **kw).numpy()
    return ref, out


@pytest.mark.parametrize("mode", ["d2d", "sym", "exact"])
def test_icp_fused_modes_match_pallas(mode):
    """d2d, symmetric and exact (with k-NN source normals) against the TPU
    kernel in interpret mode; one pose has no valid source (identity)."""
    rng = np.random.default_rng(5)
    src, svalid, tgt, tvalid, tnrm = _box_corner_problem(rng, 12, p=96)
    svalid[11] = False
    nrm = (None if mode == "d2d"
           else picp.cloud_normals(T(src), T(svalid)).numpy())
    kw = dict(max_iterations=20, max_correspondence=0.05, d2d_epsilon=0.05,
              nn_every=1 if mode == "exact" else 2, exact=mode == "exact",
              rotation_epsilon=2e-4, transformation_epsilon=5e-5)
    ref, out = _run_both(src, svalid, tgt, tvalid, tnrm, nrm, **kw)
    assert np.abs(ref[:11, :3, 3]).max() > 1e-3       # it did move
    np.testing.assert_array_equal(out[11], np.eye(4, dtype=np.float32))
    _assert_deltas_close(out, ref)


@pytest.mark.parametrize("d2d_epsilon", [0.0, 0.05])
def test_icp_fused_adaptive_matches_pallas_groups(d2d_epsilon):
    """Adaptive association (nn_every=0) with N = 12 (a group of 8 and a
    padded group of 4) and poses of mixed difficulty: the group re-associates
    on its largest active motion bound, so some poses differ from their solo
    refinement, and the port still follows JAX's grouping."""
    src, svalid, tgt, tvalid, tnrm = _mixed_problem(13)
    kw = dict(max_iterations=20, max_correspondence=0.05, nn_every=0,
              assoc_trigger=0.02, d2d_epsilon=d2d_epsilon)
    ref, out = _run_both(src, svalid, tgt, tvalid, tnrm, **kw)
    _assert_deltas_close(out, ref)
    packed = pfused.pack_targets(T(tgt), T(tvalid), T(tnrm))
    solo = np.stack([
        pfused.icp_fused(T(src[i:i + 1]), T(svalid[i:i + 1]),
                         packed[i:i + 1], **kw).numpy()[0]
        for i in range(len(src))])
    assert (np.abs(solo - out).max(axis=(1, 2)) > 1e-6).any()


@pytest.mark.parametrize("d2d_epsilon", [0.0, 0.05])
def test_icp_fused_adaptive_degenerate_triggers(d2d_epsilon):
    """Trigger 0 re-associates every iteration (== nn_every=1) and a huge
    trigger only once (== nn_every=max_iterations), bit for bit."""
    src, svalid, tgt, tvalid, tnrm = _mixed_problem(14, n=10)
    packed = pfused.pack_targets(T(tgt), T(tvalid), T(tnrm))
    args = (T(src), T(svalid), packed)
    kw = dict(max_iterations=15, d2d_epsilon=d2d_epsilon)
    every = pfused.icp_fused(*args, nn_every=1, **kw)
    once = pfused.icp_fused(*args, nn_every=15, **kw)
    assert not torch.equal(every, once)
    torch.testing.assert_close(
        pfused.icp_fused(*args, nn_every=0, assoc_trigger=0.0, **kw), every,
        rtol=0, atol=0)
    torch.testing.assert_close(
        pfused.icp_fused(*args, nn_every=0, assoc_trigger=1e9, **kw), once,
        rtol=0, atol=0)


def _bowl_problem(rng, n=3, p=128, s=256):
    """A curved surface (quadratic bowl) with analytic normals; each pose's
    source is a subset moved by up to 0.15 rad / 2 cm (the JAX test's
    problem), one pose half invalid."""
    uv = rng.uniform(-0.08, 0.08, (s, 2)).astype(np.float32)
    z = 0.6 + 1.2 * (uv[:, 0] ** 2 + 0.6 * uv[:, 1] ** 2)
    tgt1 = np.c_[uv, z].astype(np.float32)
    nrm1 = np.c_[-2.4 * uv[:, 0], -1.44 * uv[:, 1], np.ones(s)]
    nrm1 = (nrm1 / np.linalg.norm(nrm1, axis=1, keepdims=True)).astype(
        np.float32)
    src = np.zeros((n, p, 3), np.float32)
    snrm = np.zeros((n, p, 3), np.float32)
    for i in range(n):
        sel = rng.choice(s, p, replace=False)
        rot = euler_xyz_to_matrix(*rng.uniform(-0.15, 0.15, 3))
        src[i] = tgt1[sel] @ rot.T + rng.uniform(-0.02, 0.02, 3)
        snrm[i] = nrm1[sel] @ rot.T
    svalid = np.ones((n, p), bool)
    svalid[1, p // 2:] = False
    return (src, svalid, snrm, np.tile(tgt1[None], (n, 1, 1)),
            np.ones((n, s), bool), np.tile(nrm1[None], (n, 1, 1)))


def test_icp_fused_exact_matches_port_gicp():
    """exact=True is icp_gicp_batch's Gauss-Newton inside the fused kernel:
    the port's two agree to 2e-4, pose by pose, as the JAX package's own
    test holds its two. (Both track different iterates, best-RMSE against
    last, so they agree where every pose converges before the cap of 40, as
    here.)"""
    src, svalid, snrm, tgt, tvalid, tnrm = _bowl_problem(
        np.random.default_rng(0))
    delta = pfused.icp_fused(
        T(src), T(svalid), pfused.pack_targets(T(tgt), T(tvalid), T(tnrm)),
        T(snrm), max_iterations=40, rotation_epsilon=2e-4,
        transformation_epsilon=5e-5, d2d_epsilon=0.05, exact=True)
    ref = picp.icp_gicp_batch(T(src), T(svalid), T(snrm), T(tgt), T(tvalid),
                              T(tnrm), max_iterations=40, gicp_epsilon=0.05)
    assert ref.delta[:, :3, 3].abs().max() > 1e-2
    assert int(ref.iterations.max()) < 40
    torch.testing.assert_close(delta, ref.delta, rtol=0, atol=2e-4)


def test_icp_fused_exact_without_normals_raises():
    src = torch.zeros((1, 8, 3))
    valid = torch.ones((1, 8), dtype=torch.bool)
    tgt = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError):
        pfused.icp_fused(src, valid, tgt, d2d_epsilon=0.05, exact=True)
    with pytest.raises(ValueError):
        pfused.icp_fused(src, valid, tgt, src, exact=True)


@pytest.mark.parametrize("refiner", ["nn", "gicp"])
def test_composed_refiners_match_jax(refiner):
    """icp_point_to_plane_batch / icp_gicp_batch with a per-pose crop of 128
    against JAX on the 1-NN Pallas kernel in interpret mode: the same
    iteration counts, deltas to 1e-5 (the 6x6 sums in another order)."""
    rng = np.random.default_rng(5)
    src, svalid, tgt, tvalid, tnrm = _box_corner_problem(rng, 8, p=96)
    kw = dict(max_iterations=20, max_correspondence=0.05, crop_k=128)
    if refiner == "nn":
        arrays = (src, svalid, tgt, tvalid, tnrm)
        jfn, pfn = jicp.icp_point_to_plane_batch, picp.icp_point_to_plane_batch
    else:
        snrm = picp.cloud_normals(T(src), T(svalid)).numpy()
        arrays = (src, svalid, snrm, tgt, tvalid, tnrm)
        jfn, pfn = jicp.icp_gicp_batch, picp.icp_gicp_batch
        kw["gicp_epsilon"] = 0.05
    ref = jfn(*map(jnp.asarray, arrays), backend="pallas_interpret", **kw)
    build.reset_counts()
    out = pfn(*map(T, arrays), **kw)
    assert build.TWIN_CALLS["nn1_batch"] == int(out.iterations.max())
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert np.abs(np.asarray(ref.delta)[:, :3, 3]).max() > 1e-3
    np.testing.assert_allclose(out.delta.numpy(), np.asarray(ref.delta),
                               atol=1e-5)
    np.testing.assert_allclose(out.rmse.numpy(), np.asarray(ref.rmse),
                               atol=1e-6)


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(9)
    xi = rng.normal(0, 0.1, (16, 6)).astype(np.float32)
    xi[0, :3] = 0.0
    np.testing.assert_allclose(picp.se3_exp(T(xi)).numpy(),
                               np.asarray(jicp.se3_exp(jnp.asarray(xi))),
                               atol=1e-6)
    a = rng.normal(size=(16, 6, 6)).astype(np.float32)
    h = a @ a.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    g = rng.normal(size=(16, 6)).astype(np.float32)
    np.testing.assert_allclose(
        picp.solve_spd_6x6(T(h), T(g)).numpy(),
        np.asarray(jicp.solve_spd_6x6(jnp.asarray(h), jnp.asarray(g))),
        rtol=1e-5, atol=1e-6)
    m = h[:, :3, :3]
    np.testing.assert_allclose(
        picp._inv_3x3_sym(T(m)).numpy(),
        np.asarray(jicp._inv_3x3_sym(jnp.asarray(m))), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("change,twin", [
    (dict(icp_mode="fused_d2d"), "icp_fused"),
    (dict(icp_mode="fused_d2d", icp_d2d_symmetric=True), "icp_fused"),
    (dict(icp_mode="fused_d2d_exact"), "icp_fused"),
    (dict(icp_nn_every=0), "icp_fused"),
    (dict(icp_mode="nn"), "nn1_batch"),
    (dict(icp_mode="gicp"), "nn1_batch"),
])
def test_cpu_icp_modes_run_their_twins(change, twin):
    """Every ported icp_mode runs on CPU tensors through its kernel's twin
    and launches nothing."""
    args, cfg, kw = _small_problem()
    build.reset_counts()
    out = pscorer.score_pose_batch(*args, dataclasses.replace(cfg, **change),
                                   **kw)
    assert build.TWIN_CALLS[twin] >= 1
    assert set(build.TWIN_CALLS) == {"raster_direct", twin, "cost_fused"}
    assert sum(build.LAUNCHES.values()) == 0
    assert (out.total_cost >= 0).all()
    assert torch.isfinite(out.adjusted_poses).all()


def test_unknown_icp_mode_raises():
    args, cfg, kw = _small_problem()
    with pytest.raises(ValueError):
        pscorer.score_pose_batch(
            *args, dataclasses.replace(cfg, icp_mode="bogus"), **kw)


def test_d2d_epsilons_match_jax():
    from perception_tpu.pipeline.scorer import ScorerConfig

    for kw in ({}, dict(icp_d2d_rotation_epsilon=1e-3),
               dict(icp_d2d_transformation_epsilon=2e-5,
                    icp_rotation_epsilon=1e-2)):
        assert (pscorer.ScorerConfig(**kw).d2d_epsilons()
                == ScorerConfig(**kw).d2d_epsilons())
