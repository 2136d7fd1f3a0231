"""The port's 3-DoF (table-top) mode against the JAX package.

Scenes as tests/test_3dof.py builds them (128x96, stride 2, box models on a
table, no instance mask, the world-bounds filter): a single crate at a grid
pose, and a crate and a taller post at grid poses. The JAX side runs the
direct raster, fused ICP and fused cost Pallas kernels in interpret mode
(kernel_backend "pallas_direct_interpret", icp_mode "fused"); the port runs
the twins on CPU tensors.

Tolerances: host logic exact (observed cloud, world points, successors and
their order, validity with placed objects, the collision commit order,
pruning); costs within the scorer's slice tolerance (equal
on >= 75% of the poses, within 5 everywhere, adjusted translations within
1 mm); the greedy-ICP baseline's winners the same models within 1 mm.
"""

import dataclasses

import numpy as np
import pytest
import torch

from perception_tpu.core.config import EnvConfig, PerchConfig
from perception_tpu.core.mesh import ModelBank, mesh_model_from_arrays
from perception_tpu.core.pose import (
    CAM_TO_BODY,
    ContPose,
    euler_xyz_to_matrix,
    make_transform,
)
from perception_tpu.core.state import GraphState, ObjectState
from perception_tpu.pipeline.env import PerceptionEnv, RecognitionInput
from perception_tpu.pipeline.pruning import prune_successors as jprune
from perception_tpu_torch import convert
from perception_tpu_torch.core import config as pc
from perception_tpu_torch.core import mesh as pmesh
from perception_tpu_torch.core import state as pstate
from perception_tpu_torch.kernels import build
from perception_tpu_torch.pipeline.env import PerceptionEnv as PortEnv
from perception_tpu_torch.pipeline.pruning import prune_successors

from tests.test_3dof import CAM
from tests.test_core import make_box

TABLE = -0.10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def table_scene(models, gt, region, batch=32, **perch_kw):
    """(JAX env with the observation of `gt` set, its RecognitionInput)."""
    bank = ModelBank.from_models(models, t_cap=16)
    perch = PerchConfig(gpu_stride=2, gpu_batch_size=batch,
                        sensor_resolution=0.02,
                        min_neighbor_points_for_valid_pose=5,
                        max_icp_iterations=10, **perch_kw)
    env_cfg = EnvConfig(width=CAM.width, height=CAM.height, res=0.04,
                        theta_res=np.pi / 4, max_points_per_pose=256,
                        max_observed_points=2048, max_points_per_label=512,
                        max_labels=2, icp_downsample=2, cost_crop_targets=0,
                        icp_mode="fused",
                        kernel_backend="pallas_direct_interpret")
    env = PerceptionEnv(bank, CAM, perch, env_cfg)
    env._input = RecognitionInput(
        depth_image=np.zeros((CAM.height, CAM.width)),
        cam_to_world=CAM_TO_BODY.copy(), use_external_pose_list=False)
    depth, color, _ = env.render_composite(gt)
    rin = RecognitionInput(
        depth_image=depth.astype(np.float64),
        color_image=color.astype(np.float32), depth_factor=100.0,
        cam_to_world=CAM_TO_BODY.copy(), use_external_pose_list=False,
        table_height=TABLE, **region)
    env.set_input(rin)
    return env, rin


def port_env(jax_env, rin=None):
    """The port's env on the CPU over the JAX env's bank and settings, with
    the JAX env's input set."""
    env = PortEnv(
        convert.bank_from_jax(jax_env.bank),
        convert.dataclass_from_jax(CAM, pc.CameraIntrinsics),
        convert.dataclass_from_jax(jax_env.perch, pc.PerchConfig),
        convert.dataclass_from_jax(jax_env.env, pc.EnvConfig,
                                   kernel_backend="auto"), device="cpu")
    env.set_input(convert.input_from_jax(rin or jax_env._input))
    return env


def grid_state(mid, x, y, yaw=0.0):
    return ObjectState(id=mid, symmetric=False,
                       pose=ContPose.from_euler(x, y, TABLE, 0.0, 0.0, yaw),
                       segmentation_label_id=1)


def crate():
    v, f = make_box(w=0.10, d=0.07, h=0.12)
    return mesh_model_from_arrays("crate", v, f,
                                  colors=np.tile([200.0, 40, 40], (len(v), 1)))


def post():
    """A square post, symmetric about z: one yaw per grid cell."""
    v, f = make_box(w=0.06, d=0.06, h=0.16)
    return mesh_model_from_arrays("post", v, f, symmetric=True,
                                  colors=np.tile([40.0, 200, 40], (len(v), 1)))


PAIR_REGION = dict(x_min=0.52, x_max=0.76, y_min=-0.16, y_max=0.12)
PAIR_GT = [grid_state(0, 0.56, -0.12, np.pi / 4),
           dataclasses.replace(grid_state(1, 0.72, 0.08), symmetric=True)]


@pytest.fixture(scope="module")
def pair_scene():
    jenv, _ = table_scene([crate(), post()], PAIR_GT, PAIR_REGION,
                          use_cylinder_observed=True)
    return jenv, port_env(jenv)


def _poses(states):
    return [(s.id, s.pose.x, s.pose.y, s.pose.z, s.pose.yaw) for s in states]


def test_3dof_observed_scene_matches_jax(pair_scene):
    """One scene-wide segment (every label 1) cut to the search region: the
    same cloud, segment, world points and strided source images."""
    jenv, penv = pair_scene
    jo, po = jenv._observed, penv._observed
    assert int(po.count) == int(jo.count) > 50
    np.testing.assert_array_equal(po.seg_count.numpy(),
                                  np.asarray(jo.seg_count))
    assert po.seg_count[0] == po.count
    for name in ("xyz", "valid", "label", "seg_xyz", "seg_valid"):
        np.testing.assert_array_equal(getattr(po, name).numpy(),
                                      np.asarray(getattr(jo, name)), name)
    np.testing.assert_array_equal(penv._world_points, jenv._world_points)
    np.testing.assert_array_equal(penv._scene.source_depth.numpy(),
                                  np.asarray(jenv._scene.source_depth))
    assert (penv._scene.source_label.numpy() == 1).all()
    assert penv._disc == convert.discretizer_from_jax(jenv._disc)
    cfg = penv._scorer_config(do_icp=False)
    assert cfg.cost_type == 0 and not cfg.use_segmentation_label


def test_3dof_successors_match_jax(pair_scene):
    """The (x, y, yaw) grid after validity pruning (one yaw for the
    symmetric post): the same states in the same order."""
    jenv, penv = pair_scene
    ref = jenv.generate_successors_3dof()
    out = penv.generate_successors_3dof()
    assert len({s.pose.yaw for s in out if s.id == 1}) == 1
    assert 20 < len(out) < len(ref) * 2
    assert _poses(out) == _poses(ref)


def test_is_valid_pose_with_placed_matches_jax(pair_scene):
    """Projected counts, the inscribed-circle collision with placed objects
    and the footprint bounds (a footprint over the region's edge), with and
    without the grid cell's radius, state by state and batched."""
    jenv, penv = pair_scene
    rng = np.random.default_rng(3)
    near = np.asarray([[s.pose.x, s.pose.y] for s in PAIR_GT])[
        rng.integers(0, 2, 160)] + rng.normal(0, 0.05, (160, 2))
    jstates = [grid_state(int(m), x, y, yaw) for m, (x, y), yaw in zip(
        rng.integers(0, 2, 160), near, rng.uniform(-3.2, 3.2, 160))]
    pstates = convert.states_from_jax(jstates)
    placed = [GraphState(), GraphState((PAIR_GT[0],)),
              GraphState(tuple(PAIR_GT))]
    for jp in placed:
        pp = pstate.GraphState(tuple(convert.states_from_jax(jp.object_states)))
        for after in (False, True):
            ref = [jenv.is_valid_pose(s, placed=jp, after_refinement=after)
                   for s in jstates]
            assert 5 < sum(ref) < len(ref)
            assert [penv.is_valid_pose(s, placed=pp, after_refinement=after)
                    for s in pstates[:40]] == ref[:40]
            assert penv.valid_poses(pstates, placed=pp,
                                    after_refinement=after).tolist() == ref


def walk(lo, hi, res):
    """A grid axis as the reference walks it: from lo in steps of res, each
    value the previous one plus res, while within hi + 1e-9."""
    values, v = [], lo
    while v <= hi + 1e-9:
        values.append(v)
        v += res
    return values


# Both ends of the region within 1e-9 below an accumulated grid step: the
# last x and y are in the grid only by the walk's 1e-9 allowance.
EDGE_REGION = dict(x_min=0.50, x_max=walk(0.50, 0.75, 0.04)[-1] - 6e-10,
                   y_min=-0.18, y_max=walk(-0.18, 0.11, 0.04)[-1] - 9e-10)


def wedge():
    """A triangular prism: its footprint has no centre of symmetry, so the
    footprint's extent tells a rotation from its inverse."""
    tri = np.array([[0.0, 0.0], [0.12, 0.0], [0.0, 0.08]])
    v = np.concatenate([np.c_[tri, np.zeros(3)], np.c_[tri, np.full(3, 0.1)]])
    f = np.array([[0, 2, 1], [3, 4, 5], [0, 1, 4], [0, 4, 3], [1, 2, 5],
                  [1, 5, 4], [2, 0, 3], [2, 3, 5]])
    return mesh_model_from_arrays("wedge", v, f,
                                  colors=np.tile([40.0, 40, 200], (6, 1)))


WEDGE_GT = [grid_state(0, 0.56, -0.12, np.pi / 4),
            grid_state(1, 0.72, 0.04, 2.0)]

# Regions and grids over the pair scene's observation (or an empty one, or
# the crate and wedge scene's): {name: (region, EnvConfig fields replaced,
# observation)}.
GRID_SCENES = {
    "pair": (PAIR_REGION, {}, "pair"),
    "edge": (EDGE_REGION, {}, "pair"),
    "fine": (dict(x_min=0.50, x_max=0.78, y_min=-0.20, y_max=0.14),
             dict(res=0.03, theta_res=np.pi / 8), "pair"),
    "empty": (PAIR_REGION, {}, "empty"),
    "wedge": (PAIR_REGION, {}, "wedge"),
}


@pytest.fixture(scope="module", params=list(GRID_SCENES))
def grid_scene(request, pair_scene):
    """(name, JAX env, port env) over a GRID_SCENES region, grid and
    observation."""
    region, env_kw, seen = GRID_SCENES[request.param]
    if seen == "wedge":
        base, _ = table_scene([crate(), wedge()], WEDGE_GT, region,
                              use_cylinder_observed=True)
    else:
        base = pair_scene[0]
    jenv = PerceptionEnv(base.bank, CAM, base.perch,
                         dataclasses.replace(base.env, **env_kw))
    rin = dataclasses.replace(base._input, **region)
    if seen == "empty":
        rin = dataclasses.replace(rin, depth_image=np.zeros_like(
            rin.depth_image))
    jenv.set_input(rin)
    return request.param, jenv, port_env(jenv)


def test_grid_successors_match_jax(grid_scene):
    """generate_successors_3dof (the grid and its validity on arrays, states
    for the valid rows alone) against the JAX env's state-by-state loop:
    the same states, field by field, in the same order; and the same as
    `valid_poses` over `grid_3dof`'s states. The grid's axes are the
    reference's accumulated walk, which differs from x_min + i * res."""
    name, jenv, penv = grid_scene
    ref = convert.states_from_jax(jenv.generate_successors_3dof())
    out = penv.generate_successors_3dof()
    assert out == ref
    grid = penv.grid_3dof()
    assert [s for s, ok in zip(grid, penv.valid_poses(grid)) if ok] == out
    rin, res = penv._input, penv.env.res
    xs, ys = walk(rin.x_min, rin.x_max, res), walk(rin.y_min, rin.y_max, res)
    assert sorted({s.pose.x for s in grid}) == xs
    assert sorted({s.pose.y for s in grid}) == ys
    assert xs != [rin.x_min + i * res for i in range(len(xs))]
    per_model = [len(xs) * len(ys) * (1 if m.symmetric else round(
        2 * np.pi / penv.env.theta_res)) for m in penv.bank.models]
    assert [sum(s.id == mid for s in grid)
            for mid in range(len(per_model))] == per_model
    if name == "empty":
        assert out == [] and penv._world_kdtree is None
        return
    for mid, m in enumerate(penv.bank.models):
        n_yaws = len({s.pose.yaw for s in out if s.id == mid})
        assert n_yaws == 1 if m.symmetric else n_yaws > 1
    if name == "edge":
        assert xs[-1] > rin.x_max and ys[-1] > rin.y_max


def test_grid_cylinder_totals_match_jax(grid_scene, monkeypatch):
    """The observed points in each pose's inflated cylinder
    (`_observed_totals`, greedy ICP's scorer.prepare) on a padded batch of
    grid states: the totals the JAX env hands its scorer, exactly."""
    import perception_tpu.pipeline.env as jax_env_module

    _, jenv, penv = grid_scene
    cands = jenv.generate_successors_3dof()[::3][:20] or [
        grid_state(0, 0.56, -0.12), grid_state(1, 0.72, 0.08)]
    seen = []

    class Stop(Exception):
        pass

    def capture(*args, **kwargs):
        seen.append(np.asarray(args[6]))
        raise Stop

    monkeypatch.setattr(jax_env_module, "score_pose_batch", capture)
    with pytest.raises(Stop):
        jenv.score_object_states(cands, do_icp=False)
    batch = int(penv.perch.gpu_batch_size)
    chunk = convert.states_from_jax(cands)
    chunk += [chunk[0]] * (batch - len(chunk))
    assert penv.perch.use_cylinder_observed
    out = penv._observed_totals(chunk, np.zeros(batch, np.int64),
                                penv._observed)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, seen[0])
    assert (out > 0).any() == (penv._world_kdtree is not None)


def _refined_states(rng, n):
    """n JAX states near the pair's ground truth as ICP leaves them: the
    pose a quaternion, tilted by a few hundredths of a radian off the table
    and lifted a few mm, the rotations drawn from a pool of 12 so that
    several states share one."""
    pool = [ContPose.from_matrix(make_transform(euler_xyz_to_matrix(
        *rng.normal(0, 0.03, 2), rng.uniform(-np.pi, np.pi)), np.zeros(3)))
        for _ in range(12)]
    states = []
    for m, r in zip(rng.integers(0, 2, n), rng.integers(0, 12, n)):
        g, q = PAIR_GT[m].pose, pool[r]
        x, y = np.array([g.x, g.y]) + rng.normal(0, 0.04, 2)
        states.append(ObjectState(
            id=int(m), symmetric=bool(m == 1), segmentation_label_id=1,
            pose=ContPose.from_quat(float(x), float(y),
                                    TABLE + float(rng.normal(0, 0.003)),
                                    q.qx, q.qy, q.qz, q.qw)))
    return states


@pytest.mark.parametrize("n_placed", [0, 1, 2])
def test_refined_pose_validity_matches_jax(pair_scene, n_placed):
    """valid_poses(after_refinement=True) and is_valid_pose on post-ICP
    quaternion poses, beside objects placed at post-ICP poses (none, one,
    two): the JAX env's is_valid_pose state by state."""
    jenv, penv = pair_scene
    rng = np.random.default_rng(20 + n_placed)
    jstates = _refined_states(rng, 160)
    jplaced = GraphState(tuple(_refined_states(rng, 2)[:n_placed]))
    pstates = convert.states_from_jax(jstates)
    pplaced = pstate.GraphState(tuple(
        convert.states_from_jax(jplaced.object_states)))
    ref = [jenv.is_valid_pose(s, placed=jplaced, after_refinement=True)
           for s in jstates]
    assert 5 < sum(ref) < len(ref)
    assert penv.valid_poses(pstates, placed=pplaced,
                            after_refinement=True).tolist() == ref
    assert [penv.is_valid_pose(s, placed=pplaced, after_refinement=True)
            for s in pstates[:40]] == ref[:40]


@pytest.mark.parametrize("color,cylinder,icp", [
    (False, False, False), (False, True, False), (True, True, False),
    (False, True, True)])
def test_3dof_scores_match_jax(pair_scene, color, cylinder, icp):
    """score_object_states, cost type 0 or 1 (the colour gate), against all
    observed points or each pose's cylinder: grid candidates without ICP
    (as the tree search scores them), and candidates within 3 mm / 0.05 rad
    of the ground truth with ICP."""
    jenv, penv = pair_scene
    if icp:
        rng = np.random.default_rng(7)
        cands = [grid_state(g.id, g.pose.x + dx, g.pose.y + dy,
                            g.pose.yaw + da)
                 for g in PAIR_GT for dx, dy, da in zip(
                     *rng.normal(0, [[0.003], [0.003], [0.05]], (3, 6)))]
    else:
        cands = jenv.generate_successors_3dof()[::4]
    change = dict(use_color_cost=color, use_cylinder_observed=cylinder)
    saved = jenv.perch, penv.perch
    jenv.perch = dataclasses.replace(jenv.perch, **change)
    penv.perch = dataclasses.replace(penv.perch, **change)
    try:
        ref = jenv.score_object_states(cands, do_icp=icp)
        build.reset_counts()
        out = penv.score_object_states(convert.states_from_jax(cands),
                                       do_icp=icp)
        assert penv._scorer_config().cost_type == (1 if color else 0)
    finally:
        jenv.perch, penv.perch = saved
    assert build.TWIN_CALLS["cost_fused_color" if color else "cost_fused"] > 0
    r = np.asarray([s.cost for s in ref])
    o = np.asarray([s.cost for s in out])
    assert (r >= 0).sum() > 5
    np.testing.assert_array_equal(o < 0, r < 0)
    assert (r == o).mean() >= 0.75, (r, o)
    assert np.abs(r - o).max() <= 5, (r, o)
    np.testing.assert_allclose(
        np.stack([s.adjusted_pose_cam[:3, 3] for s in out]),
        np.stack([s.adjusted_pose_cam[:3, 3] for s in ref]), atol=1e-3)


@pytest.fixture(scope="module")
def commit_scene():
    """test_3dof's two identical crates at two spots: the depth cost cannot
    tell the models apart."""
    v, f = make_box(w=0.10, d=0.07, h=0.12)
    models = [mesh_model_from_arrays(n, v, f) for n in ("crate_a", "crate_b")]
    spots = [(0.52, -0.16), (0.72, 0.16)]
    jenv, _ = table_scene(models, [grid_state(i, x, y)
                                   for i, (x, y) in enumerate(spots)],
                          dict(x_min=0.4, x_max=0.9, y_min=-0.3, y_max=0.3),
                          use_cylinder_observed=True)
    cands = [grid_state(m, x, y) for m in (0, 1) for (x, y) in spots]
    return jenv, port_env(jenv), cands


@pytest.mark.parametrize("ordering", [True, False])
def test_commit_with_collisions_matches_jax(commit_scene, ordering):
    """With the commit order each crate lands on its own spot; the
    independent argmin lets both claim one. Both as in JAX."""
    jenv, penv, cands = commit_scene
    ref, ref_chosen = jenv.compute_greedy_poses(
        cands, do_icp=False, collision_ordering=ordering)
    out, chosen = penv.compute_greedy_poses(
        convert.states_from_jax(cands), do_icp=False,
        collision_ordering=ordering)
    xs = [round(o.pose.x, 2) for o in out.object_states]
    assert (sorted(xs) == [0.52, 0.72]) if ordering else (xs[0] == xs[1])
    assert [o.id for o in out.object_states] == \
        [o.id for o in ref.object_states]
    np.testing.assert_allclose(
        [[o.pose.x, o.pose.y, o.pose.z] for o in out.object_states],
        [[o.pose.x, o.pose.y, o.pose.z] for o in ref.object_states],
        atol=1e-6)
    assert [c.cost for c in chosen] == [c.cost for c in ref_chosen]


def test_greedy_icp_baseline_matches_jax(pair_scene):
    """localize_objects_greedy_icp (the grid scored with ICP, per model the
    lowest rendered cost) against the JAX recogniser's on the same input:
    the same models at the same poses."""
    from perception_tpu.pipeline.recognizer import (
        ObjectRecognizer as JaxRecognizer,
    )
    from perception_tpu_torch.pipeline.recognizer import ObjectRecognizer

    jenv, penv = pair_scene
    jrec = JaxRecognizer.__new__(JaxRecognizer)
    jrec.env, jrec.specs = jenv, []
    ref = jrec.localize_objects_greedy_icp(jenv._input)
    rec = ObjectRecognizer.from_models(penv.bank.models, penv.camera,
                                       penv.perch, penv.env, t_cap=16,
                                       device="cpu")
    build.reset_counts()
    result = rec.localize_objects_greedy_icp(penv._input)
    assert set(build.TWIN_CALLS) == {"raster_direct", "icp_fused",
                                     "cost_fused"}
    assert result.names == [m.name for m in rec.bank.models]
    assert len(ref.poses) == len(result.poses) == 2
    np.testing.assert_allclose(
        [[p.x, p.y, p.z] for p in result.poses],
        [[p.x, p.y, p.z] for p in ref.poses], atol=1e-3)


@pytest.mark.parametrize("mode", ["no_input", "6dof", "3dof"])
def test_poses_to_camera_is_the_stacked_transform(pair_scene, mode):
    """The env's batched camera poses equal, bit for bit, pose_to_camera
    stacked and each state's own product (inverse camera pose @ pose @
    preprocessing in float64, rounded once to float32), for models with a
    preprocessing transform: before any input (CAM_TO_BODY), and on a 6-DoF
    and a 3-DoF input from a tilted, shifted camera."""
    _, penv = pair_scene
    # Shifted boxes, the second flipped: preprocessing that is no identity.
    v, f = make_box(w=0.10, d=0.07, h=0.12)
    bank = pmesh.ModelBank.from_models([pmesh.mesh_model_from_arrays(
        f"box{i}", v + [0.03, -0.02, 0.05 * i], f, flipped=bool(i))
        for i in range(2)], t_cap=16)
    assert all(not np.array_equal(m.preprocessing_transform, np.eye(4))
               for m in bank.models)
    env = PortEnv(bank, penv.camera, penv.perch, penv.env, device="cpu")
    c2w = CAM_TO_BODY
    if mode != "no_input":
        depth, _, label = penv.render_composite(
            convert.states_from_jax(PAIR_GT))
        c2w = make_transform(euler_xyz_to_matrix(0.1, 0.35, -0.2),
                             [0.02, -0.01, 0.3]) @ CAM_TO_BODY
        env.set_input(convert.input_from_jax(RecognitionInput(
            depth_image=depth.astype(np.float64), label_mask=label,
            cam_to_world=c2w, use_external_pose_list=mode == "6dof",
            table_height=TABLE, **PAIR_REGION)))
    rng = np.random.default_rng(7)
    states = convert.states_from_jax([ObjectState(
        id=i % 2, symmetric=False,
        pose=ContPose.from_euler(*rng.uniform(-1.0, 1.0, 6)),
        segmentation_label_id=1) for i in range(40)])
    out = env.poses_to_camera(states)
    assert out.dtype == np.float32 and out.shape == (40, 4, 4)
    own = np.stack([(np.linalg.inv(c2w) @ s.pose.transform()
                     @ env.bank.models[s.id].preprocessing_transform
                     ).astype(np.float32) for s in states])
    assert out.tobytes() == own.tobytes()
    assert out.tobytes() == np.stack(
        [env.pose_to_camera(s) for s in states]).tobytes()
    assert env.poses_to_camera([]).shape == (0, 4, 4)


def test_prune_successors_match_jax(pair_scene):
    """Histogram and occupancy pruning over the grid (renders through the
    env's backend): the same survivors."""
    jenv, penv = pair_scene
    cands = jenv.generate_successors_3dof()[::4]
    far = [grid_state(0, 0.56 + 0.5, -0.12 + 0.5)]
    for kw in (dict(use_voxels=True, max_changed_fraction=0.3),
               dict(use_histogram=True, histogram_threshold=0.5)):
        ref = jprune(jenv, cands + far, **kw)
        out = prune_successors(penv, convert.states_from_jax(cands + far),
                               **kw)
        assert 0 < len(out) < len(cands)
        assert _poses(out) == _poses(ref)
