"""The PyTorch port's scoring slice against the JAX package, and the port's
rules: no jax import, the same ScorerConfig, twins on CPU tensors, and a
NotImplementedError for backend "xla", the one branch that is not ported.

The JAX reference runs its main path as a TPU does: the direct raster, fused
ICP and fused cost Pallas kernels in interpret mode
(kernel_backend="pallas_direct_interpret", icp_mode="fused").

Slice tolerance: XLA's CPU backend contracts a*b+c into FMAs where PyTorch
rounds every product, so an ICP association can pick another target at a
quantised near-tie; Gauss-Newton amplifies that along weakly constrained
rotations of near-convex models. Adjusted translations must agree to 1 mm;
total costs (integer percentages) must be equal for >= 75% of the poses and
within 5 everywhere.
"""

import dataclasses
import functools
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from perception_tpu.core.pose import ContPose
from perception_tpu.core.state import ObjectState
from perception_tpu.pipeline import scorer as jscorer
from perception_tpu_torch import convert
from perception_tpu_torch.kernels import build
from perception_tpu_torch.pipeline import scorer as pscorer

from tests.test_pipeline import gt_states, make_env


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent


def _port_modules() -> list[str]:
    import perception_tpu_torch

    return ["perception_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(perception_tpu_torch.__path__,
                                              "perception_tpu_torch.")]


def _assert_slice_close(ref, out):
    r_tot, o_tot = np.asarray(ref.total_cost), out.total_cost.numpy()
    assert (r_tot >= 0).any()
    np.testing.assert_array_equal(o_tot < 0, r_tot < 0)
    assert (r_tot == o_tot).mean() >= 0.75, (r_tot, o_tot)
    assert np.abs(r_tot - o_tot).max() <= 5, (r_tot, o_tot)
    r_adj, o_adj = np.asarray(ref.adjusted_poses), out.adjusted_poses.numpy()
    np.testing.assert_allclose(o_adj[:, :3, 3], r_adj[:, :3, 3], atol=1e-3)


def _score_both(bank_arrays, args, cfg, icp_samples, icp_normals,
                bank_lab=None):
    """Score the same inputs (JAX arrays) with JAX and with the port."""
    verts, colors, valid, backface = bank_arrays
    poses, ids, labels, totals, proj, scene = args
    ref = jscorer.score_pose_batch(
        verts, colors, valid, poses, ids, labels, totals, proj, scene, cfg,
        bank_backface=backface, bank_icp_samples=icp_samples,
        bank_icp_normals=icp_normals, bank_tri_lab=bank_lab)
    t = convert.tensor
    out = pscorer.score_pose_batch(
        t(verts), t(colors), t(valid), t(poses), t(ids), t(labels),
        t(totals), t(proj), convert.scene_from_jax(scene),
        convert.scorer_config_from_jax(cfg), bank_backface=t(backface),
        bank_icp_samples=t(icp_samples), bank_icp_normals=t(icp_normals),
        bank_tri_lab=None if bank_lab is None else t(bank_lab))
    return ref, out


def _box_candidates(n, seed):
    rng = np.random.default_rng(seed)
    gt = gt_states()
    cands = []
    for k in range(n):
        obj = gt[k % 2]
        j = rng.normal(0, 0.003, 3)
        cands.append(ObjectState(
            id=obj.id, symmetric=False,
            pose=ContPose.from_quat(obj.pose.x + j[0], obj.pose.y + j[1],
                                    obj.pose.z + j[2], *obj.pose.quaternion()),
            segmentation_label_id=obj.segmentation_label_id))
    return cands


@pytest.mark.parametrize("roi_size", [0, 20])
def test_score_pose_batch_box_scene_matches_jax(roi_size):
    """The test_pipeline box scene, full frame (roi_size=0, compacted
    clouds) and ROI windows."""
    env = make_env()
    env.env = dataclasses.replace(env.env, icp_mode="fused", roi_size=roi_size,
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    cands = _box_candidates(8, seed=roi_size)
    cfg = env._scorer_config(do_icp=True)
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands], np.int32)
    totals = np.asarray(env._observed.seg_count, np.float32)[labels]
    ref, out = _score_both(
        env._render_bank,
        (jnp.asarray(poses), jnp.asarray(ids), jnp.asarray(labels),
         jnp.asarray(totals), env._proj, env._scene),
        cfg, env._bank_icp_samples, env._bank_icp_normals)
    _assert_slice_close(ref, out)


def test_score_pose_batch_bench_problem_matches_jax(monkeypatch):
    """benchmarks/bench_scene.py's problem at 16 poses (ROI 32, LOD bank,
    label-shared crop, explain-only samples)."""
    from benchmarks.bench_scene import build_bench_problem

    monkeypatch.setenv("BENCH_MODELS", "blob")
    env, _, args, cfg = build_bench_problem(n_poses=16)
    cfg = dataclasses.replace(cfg, icp_mode="fused",
                              backend="pallas_direct_interpret")
    ref, out = _score_both(env._render_bank, args[3:], cfg,
                           env._bank_icp_samples, env._bank_icp_normals)
    _assert_slice_close(ref, out)


def test_port_bench_problem_matches_jax(monkeypatch):
    """The jax-free build_bench_problem makes the same bank, candidates and
    scene: the observations differ only on silhouette pixels (the port
    renders them with the direct kernel, JAX off a TPU with its XLA
    raster)."""
    from benchmarks.bench_scene import build_bench_problem
    from perception_tpu_torch.eval.bench_scene import (
        build_bench_problem as port_build,
    )

    monkeypatch.setenv("BENCH_MODELS", "blob")
    env, cands, args, _ = build_bench_problem(n_poses=12)
    bp = port_build(n_poses=12, model_kind="blob", device="cpu")
    for i in range(8):
        np.testing.assert_array_equal(bp.args[i].numpy(), np.asarray(args[i]),
                                      str(i))
    assert [c.pose.x for c in bp.candidates] == [c.pose.x for c in cands]
    ref_count = np.asarray(env._observed.seg_count)
    out_count = bp.env._observed.seg_count.numpy()
    np.testing.assert_allclose(out_count, ref_count, rtol=0.02)
    assert list(ref_count[[0, 3]]) == [0, 0]    # GT object 0 is out of frame
    np.testing.assert_array_equal(
        bp.env._bank_icp_samples.numpy(), np.asarray(env._bank_icp_samples))


def test_scorer_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jscorer.ScorerConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pscorer.ScorerConfig)}
    assert pf == jf


def test_port_never_imports_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package nor the JAX benchmarks."""
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'perception_tpu', 'benchmarks')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _small_problem():
    env = make_env()
    env.env = dataclasses.replace(env.env, icp_mode="fused",
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    cfg = convert.scorer_config_from_jax(env._scorer_config(do_icp=True))
    cands = _box_candidates(2, seed=1)
    t = convert.tensor
    verts, colors, valid, backface = (t(a) for a in env._render_bank)
    args = (verts, colors, valid,
            t(np.stack([env.pose_to_camera(s) for s in cands])),
            t([s.id for s in cands]), t([0, 1]),
            t(np.asarray(env._observed.seg_count, np.float32)[:2]),
            t(env._proj), convert.scene_from_jax(env._scene))
    kw = dict(bank_backface=backface,
              bank_icp_samples=t(env._bank_icp_samples),
              bank_icp_normals=t(env._bank_icp_normals))
    return args, cfg, kw


def test_cpu_calls_run_the_twins():
    args, cfg, kw = _small_problem()
    build.reset_counts()
    pscorer.score_pose_batch(*args, cfg, **kw)
    assert set(build.TWIN_CALLS) == {"raster_direct", "icp_fused",
                                     "cost_fused"}
    assert sum(build.LAUNCHES.values()) == 0


@functools.lru_cache(maxsize=1)
def _box_jax_env():
    """The box scene's JAX env (fused ICP, interpret-mode kernels)."""
    env = make_env()
    env.env = dataclasses.replace(env.env, icp_mode="fused",
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    return env


def _score_box_both(change: dict, bank_lab: bool = True, seed: int = 4):
    """Eight box-scene candidates (`seed`) scored by JAX and the port with
    the env's scorer config changed by `change` (the face Lab table when
    bank_lab)."""
    env = _box_jax_env()
    cands = _box_candidates(8, seed=seed)
    cfg = dataclasses.replace(env._scorer_config(do_icp=True), **change)
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands], np.int32)
    totals = np.asarray(env._observed.seg_count, np.float32)[labels]
    return _score_both(
        env._render_bank,
        (jnp.asarray(poses), jnp.asarray(ids), jnp.asarray(labels),
         jnp.asarray(totals), env._proj, env._scene),
        cfg, env._bank_icp_samples, env._bank_icp_normals,
        bank_lab=env._render_bank_lab if bank_lab else None)


_DEPTH = {"raster_direct": 1, "icp_fused": 1, "cost_fused": 1}


@pytest.mark.parametrize("change,twins", [
    (dict(icp_mode="projective"), {"raster_direct": 1, "cost_fused": 1}),
    (dict(icp_source="model"), _DEPTH),
    (dict(cost_cloud="render"), {**_DEPTH, "raster_direct": 2}),
    (dict(icp_render_scale=2, roi_shape=(20, 20)),
     {**_DEPTH, "raster_direct": 2}),
    (dict(cost_type=3),
     {"raster_direct": 1, "icp_fused": 1, "nn1_batch": 1}),
    (dict(backend="xla"), None),
    (dict(icp_crop_share="pose"), _DEPTH),
    (dict(icp_crop_mode="spread"), _DEPTH),
], ids=[f"change{i}" for i in range(8)])
def test_unported_scorer_branches_raise(change, twins):
    """The branches the port once refused. Backend "xla" (the JAX package's
    composed raster and XLA 1-NN) still raises; every other now runs, calls
    the kernels (here their twins) of its path, and matches JAX by the
    slice tolerance on eight box-scene candidates: projective ICP (no ICP
    kernel), the model source (no pre-ICP raster), the re-render cost and
    the coarse pass (with an ROI, which it needs; two rasters each), the
    composed colour cost (cost_type 3 without the face Lab table: the 1-NN),
    the per-pose and the spread crops (seed 4; seeds 3 and 5, with the
    per-pose crop's divergent candidates named and excluded:
    test_crop_branches_match_jax_on_seeds_3_and_5;
    tests/test_torch_branch_ops.py compares the crops exactly)."""
    if twins is None:
        args, cfg, kw = _small_problem()
        with pytest.raises(NotImplementedError):
            pscorer.score_pose_batch(*args, dataclasses.replace(cfg, **change),
                                     **kw)
        return
    build.reset_counts()
    ref, out = _score_box_both(change, bank_lab=False)
    assert dict(build.TWIN_CALLS) == twins
    _assert_slice_close(ref, out)


# Seed -> the candidates whose ICP ends more than 1 mm apart in the two
# packages under the per-pose crop.
POSE_CROP_DIVERGENT = {3: (4,), 5: (2, 4)}


@pytest.mark.parametrize("seed", [3, 5])
@pytest.mark.parametrize("change", [dict(icp_crop_share="pose"),
                                    dict(icp_crop_mode="spread")],
                         ids=["pose_crop", "spread_crop"])
def test_crop_branches_match_jax_on_seeds_3_and_5(change, seed):
    """The per-pose and the spread crops on the seeds that
    test_unported_scorer_branches_raise avoids: under the per-pose crop the
    candidates of POSE_CROP_DIVERGENT end more than 1 mm from JAX's (and
    exactly those); every other candidate, and every candidate under the
    spread crop, holds the slice tolerance. Both packages build equal crops
    and each is stable under 1-ulp nudges of its own ICP source (see
    test_pose_crop_divergence_is_not_source_noise): the divergent
    trajectories part on the two ICPs' arithmetic (XLA's fused
    multiply-adds in the JAX kernel)."""
    ref, out = _score_box_both(change, bank_lab=False, seed=seed)
    r_adj = np.asarray(ref.adjusted_poses)[:, :3, 3]
    o_adj = out.adjusted_poses.numpy()[:, :3, 3]
    far = np.nonzero(np.abs(r_adj - o_adj).max(axis=1) > 1e-3)[0]
    expect = POSE_CROP_DIVERGENT[seed] if "icp_crop_share" in change else ()
    assert tuple(far) == expect
    keep = np.setdiff1d(np.arange(8), far)
    _assert_slice_close(
        ref._replace(total_cost=np.asarray(ref.total_cost)[keep],
                     adjusted_poses=np.asarray(ref.adjusted_poses)[keep]),
        dataclasses.replace(out, total_cost=out.total_cost[keep],
                            adjusted_poses=out.adjusted_poses[keep]))


def test_pose_crop_divergence_is_not_source_noise(monkeypatch):
    """Nudge every point of the JAX scorer's rendered cloud (the ICP source,
    the crop centres' input and the cost cloud) by one ulp, each in a seeded
    random direction, on seed 5 under the per-pose crop: JAX's own end
    poses move by under 0.1 mm, also at the candidates that end
    centimetres from the port's."""
    import functools

    import jax

    env = _box_jax_env()
    render_and_cloud = jscorer._render_and_cloud

    def nudged(*args, **kwargs):
        render, cloud = render_and_cloud(*args, **kwargs)
        sign = np.random.default_rng(1).choice([-1.0, 1.0], cloud.xyz.shape)
        return render, cloud._replace(xyz=jnp.nextafter(
            cloud.xyz, cloud.xyz + jnp.asarray(sign, jnp.float32)))

    cands = _box_candidates(8, seed=5)
    cfg = dataclasses.replace(env._scorer_config(do_icp=True),
                              icp_crop_share="pose")
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands], np.int32)
    args = (*env._render_bank[:3], jnp.asarray(poses), jnp.asarray(ids),
            jnp.asarray(labels),
            jnp.asarray(np.asarray(env._observed.seg_count,
                                   np.float32)[labels]),
            env._proj, env._scene, cfg)
    kw = dict(bank_backface=env._render_bank[3],
              bank_icp_samples=env._bank_icp_samples,
              bank_icp_normals=env._bank_icp_normals)
    ref = jscorer.score_pose_batch(*args, **kw)
    monkeypatch.setattr(jscorer, "_render_and_cloud", nudged)
    # A new jit of the same function, traced with the nudge.
    fresh = jax.jit(functools.partial(jscorer.score_pose_batch.__wrapped__),
                    static_argnames=("cfg",))
    moved = fresh(*args, **kw)
    spread = np.abs(np.asarray(moved.adjusted_poses)[:, :3, 3]
                    - np.asarray(ref.adjusted_poses)[:, :3, 3]).max(axis=1)
    assert (spread < 1e-4).all(), spread
    assert (np.asarray(moved.total_cost) != np.asarray(ref.total_cost)
            ).sum() <= 1


def test_tree_occlusion_scores_match_jax():
    """use_tree_occlusion on the box scene without ICP, against a source
    whose upper half of object 0's pixels lies 20 cm further and carries
    object 1's label (as a composed tree source can): object 0's candidates
    render in front of it at a mismatching label and are flagged; flags
    equal JAX's, flagged poses score -1, totals within the slice
    tolerance."""
    env = make_env()
    env.env = dataclasses.replace(env.env, icp_mode="fused",
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    cfg = dataclasses.replace(env._scorer_config(do_icp=False),
                              use_tree_occlusion=True)
    depth = np.asarray(env._scene.source_depth).copy()
    label = np.asarray(env._scene.source_label).copy()
    rows = np.nonzero(label == 1)[0]
    band = (label == 1) & (np.arange(depth.shape[0])[:, None]
                           < (rows.min() + rows.max()) // 2)
    depth[band] += 20
    label[band] = 2
    scene = env._scene._replace(source_depth=jnp.asarray(depth),
                                source_label=jnp.asarray(label))
    cands = _box_candidates(8, seed=5)
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands], np.int32)
    totals = np.asarray(env._observed.seg_count, np.float32)[labels]
    ref, out = _score_both(
        env._render_bank,
        (jnp.asarray(poses), jnp.asarray(ids), jnp.asarray(labels),
         jnp.asarray(totals), env._proj, scene),
        cfg, env._bank_icp_samples, env._bank_icp_normals)
    flags = out.pose_occluded.numpy()
    np.testing.assert_array_equal(flags, np.asarray(ref.pose_occluded))
    np.testing.assert_array_equal(flags, ids == 0)
    assert (out.total_cost.numpy()[flags == 1] == -1).all()
    r_tot, o_tot = np.asarray(ref.total_cost), out.total_cost.numpy()
    assert (r_tot == o_tot).mean() >= 0.75 and np.abs(r_tot - o_tot).max() <= 5


def test_color_score_pose_batch_bench_problem_matches_jax(monkeypatch):
    """benchmarks/bench_scene.py's problem with the colour gate
    (PT_USE_COLOR=1) at 16 poses: the ROI path, where the cost looks each
    point's rendered Lab up by its face id (JAX runs
    nn_cost_fused_color_tri_pallas in interpret mode). Both sides get the
    JAX env's Lab tables. Tolerance as the depth slice; a gate within ~1e-4
    of its threshold may flip (XLA's FMAs, the TPU kernel's bf16 hi/lo Lab
    recovery), which the integer totals absorb."""
    from benchmarks.bench_scene import build_bench_problem

    monkeypatch.setenv("BENCH_MODELS", "blob")
    monkeypatch.setenv("PT_USE_COLOR", "1")
    env, _, args, cfg = build_bench_problem(n_poses=16)
    assert cfg.cost_type == 3 and cfg.roi_shape is not None
    cfg = dataclasses.replace(cfg, icp_mode="fused",
                              backend="pallas_direct_interpret")
    build.reset_counts()
    ref, out = _score_both(env._render_bank, args[3:], cfg,
                           env._bank_icp_samples, env._bank_icp_normals,
                           bank_lab=env._render_bank_lab)
    assert build.TWIN_CALLS["cost_fused_color_tri"] == 1
    _assert_slice_close(ref, out)
    # The gate is on: colour-gated totals differ from depth-only ones.
    depth = pscorer.score_pose_batch(
        *[convert.tensor(a) for a in env._render_bank[:3]],
        *[convert.tensor(a) for a in args[3:8]],
        convert.scene_from_jax(args[8]),
        dataclasses.replace(convert.scorer_config_from_jax(cfg), cost_type=2),
        bank_backface=convert.tensor(env._render_bank[3]),
        bank_icp_samples=convert.tensor(env._bank_icp_samples),
        bank_icp_normals=convert.tensor(env._bank_icp_normals))
    assert (depth.total_cost != out.total_cost).any()


@pytest.mark.parametrize("roi_size", [0, 20])
def test_color_score_pose_batch_box_scene_matches_jax(roi_size):
    """The box scene with the colour gate: the full frame (the raster draws
    Lab face colours; JAX runs nn_cost_fused_color_pallas) and ROI windows
    (face-id lookup)."""
    env = make_env(use_color_cost=True)
    env.env = dataclasses.replace(env.env, icp_mode="fused", roi_size=roi_size,
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    cands = _box_candidates(8, seed=roi_size + 1)
    cfg = env._scorer_config(do_icp=True)
    assert cfg.cost_type == 3
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands], np.int32)
    totals = np.asarray(env._observed.seg_count, np.float32)[labels]
    ref, out = _score_both(
        env._render_bank,
        (jnp.asarray(poses), jnp.asarray(ids), jnp.asarray(labels),
         jnp.asarray(totals), env._proj, env._scene),
        cfg, env._bank_icp_samples, env._bank_icp_normals,
        bank_lab=env._render_bank_lab)
    _assert_slice_close(ref, out)


@pytest.mark.parametrize("cost_type,roi", [(3, None), (1, None),
                                           (3, (20, 20)), (1, (20, 20))])
def test_cpu_color_calls_run_the_color_twins(cost_type, roi):
    """Cost types 1 and 3 (type 1 only through the scorer: the env has no
    3-DoF input yet) reach the colour twin of their path and no kernel."""
    from perception_tpu_torch.ops.color import rgb_to_lab

    args, cfg, kw = _small_problem()
    cfg = dataclasses.replace(cfg, cost_type=cost_type, roi_shape=roi)
    build.reset_counts()
    out = pscorer.score_pose_batch(*args, cfg, **kw,
                                   bank_tri_lab=rgb_to_lab(args[1]))
    expect = "cost_fused_color_tri" if roi else "cost_fused_color"
    assert set(build.TWIN_CALLS) == {"raster_direct", "icp_fused", expect}
    assert sum(build.LAUNCHES.values()) == 0
    assert (out.total_cost >= 0).all()


def test_color_cost_without_lab_bank_raises():
    """Colour cost types without the Lab face table once raised; they take
    the composed cost now (the 1-NN, CIEDE2000 on RGB converted per point),
    as the JAX package does, and match it."""
    build.reset_counts()
    ref, out = _score_box_both(dict(cost_type=3), bank_lab=False)
    assert build.TWIN_CALLS["nn1_batch"] == 1
    assert "cost_fused" not in build.TWIN_CALLS
    _assert_slice_close(ref, out)
