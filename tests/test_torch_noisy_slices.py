"""The port's scoring slice in the real-sensor ICP modes against the JAX
package, on `benchmarks/bench_scene.py`'s problem with its observation
degraded by the Kinect sensor model (PT_SENSOR=kinect): the real-sensor
profile ("fused_d2d_exact", source normals + the exact fused ICP), the
composed "gicp" and "nn" refiners (1-NN per iteration) and the split
"fused_d2d". The JAX side runs its Pallas kernels in interpret mode.

Tolerances: the depth slice's (tests/test_torch_scorer.py: validity equal,
totals within 5, translations within 1 mm, >= 75% of totals equal), except
that the two full-covariance modes need only >= 50% of totals equal. On the
noisy observation their Gauss-Newton amplifies rounding: the JAX package's
own gicp delta moves by up to 2.6e-2 between its jitted scorer and the same
refiner called alone on the same inputs, while the port's refiner agrees with
that standalone JAX call to 3e-7. The port lands 0.1-0.9 mm from the JAX
scorer there, and the totals of half the valid poses move by 1-4 points.
"""

import dataclasses

import numpy as np
import pytest
import torch

from perception_tpu.eval import sensor_model as jsensor
from perception_tpu_torch.eval import sensor_model as psensor
from perception_tpu_torch.kernels import build

from tests.test_torch_scorer import _score_both


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("icp_mode,twin,min_equal", [
    ("fused_d2d_exact", "icp_fused", 0.5), ("gicp", "nn1_batch", 0.5),
    ("nn", "nn1_batch", 0.75), ("fused_d2d", "icp_fused", 0.75)])
def test_noisy_slice_matches_jax(monkeypatch, icp_mode, twin, min_equal):
    from benchmarks.bench_scene import build_bench_problem

    monkeypatch.setenv("BENCH_MODELS", "blob")
    monkeypatch.setenv("PT_ICP_MODE", icp_mode)
    monkeypatch.setenv("PT_SENSOR", "kinect")
    env, _, args, cfg = build_bench_problem(n_poses=16)
    assert cfg.icp_mode == icp_mode
    cfg = dataclasses.replace(cfg, backend="pallas_direct_interpret")
    build.reset_counts()
    ref, out = _score_both(env._render_bank, args[3:], cfg,
                           env._bank_icp_samples, env._bank_icp_normals)
    assert build.TWIN_CALLS[twin] >= 1
    r_tot, o_tot = np.asarray(ref.total_cost), out.total_cost.numpy()
    assert (r_tot >= 0).sum() >= 8
    np.testing.assert_array_equal(o_tot < 0, r_tot < 0)
    assert (r_tot == o_tot).mean() >= min_equal, (r_tot, o_tot)
    assert np.abs(r_tot - o_tot).max() <= 5, (r_tot, o_tot)
    np.testing.assert_allclose(out.adjusted_poses.numpy()[:, :3, 3],
                               np.asarray(ref.adjusted_poses)[:, :3, 3],
                               atol=1e-3)


def test_port_bench_problem_with_sensor_matches_jax(monkeypatch):
    """build_bench_problem(icp_mode=..., sensor="kinect") makes the JAX
    benchmark's noisy observation (the same rng draws; the renders differ
    only on silhouette pixels) and its real-sensor configuration."""
    from benchmarks.bench_scene import build_bench_problem
    from perception_tpu_torch.eval.bench_scene import (
        build_bench_problem as port_build,
    )

    monkeypatch.setenv("BENCH_MODELS", "blob")
    monkeypatch.setenv("PT_ICP_MODE", "fused_d2d_exact")
    monkeypatch.setenv("PT_SENSOR", "kinect")
    env, _, _, cfg = build_bench_problem(n_poses=4)
    bp = port_build(n_poses=4, model_kind="blob", icp_mode="fused_d2d_exact",
                    sensor="kinect", device="cpu")
    assert bp.env.env == bp.env.env.noisy_profile()
    assert bp.cfg.icp_mode == cfg.icp_mode
    ref_count = np.asarray(env._observed.seg_count)
    out_count = bp.env._observed.seg_count.numpy()
    np.testing.assert_allclose(out_count, ref_count, rtol=0.02)
    clean = port_build(n_poses=4, model_kind="blob", device="cpu")
    assert (clean.env._observed.seg_count.numpy() != out_count).any()


@pytest.mark.parametrize("name", ["kinect", "kinect2x", "none"])
def test_sensor_model_matches_jax(name):
    """The port's copy degrades depth and colour exactly as the JAX module
    does for the same rng."""
    rng = np.random.default_rng(0)
    depth = np.where(rng.random((48, 64)) > 0.3,
                     rng.uniform(0.4, 1.5, (48, 64)), 0.0)
    color = rng.uniform(0, 255, (48, 64, 3))
    jd, jc = jsensor.by_name(name).apply(depth, color,
                                         np.random.default_rng(7))
    pd, pc = psensor.by_name(name).apply(depth, color,
                                         np.random.default_rng(7))
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pc, jc)
    assert dataclasses.asdict(psensor.by_name(name)) == \
        dataclasses.asdict(jsensor.by_name(name))
