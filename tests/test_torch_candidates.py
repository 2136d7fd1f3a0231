"""The port's 6-DoF candidate pruning (`generate_successors_6dof`,
`valid_poses`, `is_valid_pose`): one ball query per (model, segment) against
the per-row rule it replaced, written out below, and against the JAX
package's `generate_successors_6dof`, on the box scene of tests/test_pipeline
(JAX's render of the ground truth) with jittered candidate rows."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from perception_tpu_torch import convert
from perception_tpu_torch.core.config import EnvConfig, PerchConfig
from perception_tpu_torch.core.pose import ContPose
from perception_tpu_torch.core.state import ObjectState
from perception_tpu_torch.pipeline.env import PerceptionEnv
from perception_tpu_torch.utils import stats
from perception_tpu_torch.utils.stats import TRACE

from tests.test_pipeline import gt_states, make_env
from tests.test_torch_serve import PCAM


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def envs():
    """The JAX env on the box scene and the port's env on the same input."""
    jax_env = make_env()
    jax_env.set_observation_from_states(gt_states())
    port = PerceptionEnv(
        convert.bank_from_jax(jax_env.bank), PCAM,
        convert.dataclass_from_jax(jax_env.perch, PerchConfig),
        convert.dataclass_from_jax(jax_env.env, EnvConfig, icp_mode="auto",
                                   kernel_backend="auto"),
        device="cpu")
    port.set_input(convert.input_from_jax(jax_env._input))
    return jax_env, port


def _rows(seed: int = 17, n: int = 9) -> dict[str, np.ndarray]:
    """Per model n rows [x y z qx qy qz qw]: the ground truth's centre and
    n - 1 centres jittered by 6 cm, random unit quaternions."""
    rng = np.random.default_rng(seed)
    out = {}
    for st, name in zip(gt_states(), ("red_box", "green_box")):
        centre = np.array([st.pose.x, st.pose.y, st.pose.z])
        xyz = centre + np.concatenate(
            [np.zeros((1, 3)), rng.normal(0.0, 0.06, (n - 1, 3))])
        q = rng.normal(size=(n, 4))
        out[name] = np.concatenate(
            [xyz, q / np.linalg.norm(q, axis=1, keepdims=True)], axis=1)
    return out


def _tree(env, label_id):
    """The tree the 6-DoF rule queries for a label (None: no survivor)."""
    tree = None
    if 0 <= label_id - 1 < len(env._seg_kdtrees):
        tree = env._seg_kdtrees[label_id - 1]
    return tree if tree is not None else env._world_kdtree


def _label(env, name):
    names = env._input.segmented_object_names
    return names.index(name) + 1 if name in names else 1


def _counts(env, name, rows, grid_rad):
    """Each row's count of observed points in the rule's ball (None: no
    tree), one query a row."""
    model = env.bank.models[env.bank.index_of(name)]
    tree = _tree(env, _label(env, name))
    if tree is None:
        return None
    rad = max(model.inflation_factor * model.circumscribed_radius_3d,
              grid_rad)
    return [len(tree.query_ball_point(np.array(r[:3]), rad)) for r in rows]


def per_row(env, pose_lists):
    """The per-row rule: a state built for every row, then one ball query
    each, with the model's radius read from its mesh (on a 3-DoF input,
    `is_valid_pose` each)."""
    grid_rad = float(np.hypot(env.env.res / 2, env.env.res / 2))
    out = []
    for name, arr in pose_lists.items():
        mid = env.bank.index_of(name)
        model = env.bank.models[mid]
        label_id = _label(env, name)
        rows = np.asarray(arr)
        counts = _counts(env, name, rows, grid_rad)
        for ext_id, row in enumerate(rows):
            st = ObjectState(id=mid, symmetric=model.symmetric,
                             pose=ContPose.from_quat(*row[:7]),
                             segmentation_label_id=label_id,
                             external_pose_id=ext_id)
            if not env._input.use_external_pose_list:
                if env.is_valid_pose(st):
                    out.append(st)
            elif (counts is not None and counts[ext_id]
                    >= env.perch.min_neighbor_points_for_valid_pose):
                out.append(st)
    return out


def _fields(states):
    return [(s.id, bool(s.symmetric), s.segmentation_label_id,
             s.external_pose_id,
             *(float(getattr(s.pose, k))
               for k in ("x", "y", "z", "qx", "qy", "qz", "qw")))
            for s in states]


def _case(jax_env, port, name):
    """Shallow copies of both envs with the case's input, settings and
    trees, and the case's rows."""
    lists = _rows()
    names = ("red_box", "green_box")
    perch, env_over, drop_trees, six_dof = {}, {}, False, True
    if name == "segment_without_tree":
        # red_box reads label 4, whose segment holds no point: the world.
        names = ("a", "b", "c", "red_box")
    elif name == "label_beyond_trees":
        # green_box reads label 6, past the env's 4 label trees: the world.
        names = ("a", "b", "c", "d", "e", "green_box")
    elif name == "empty_world":
        drop_trees = True
    elif name == "count_at_threshold":
        grid_rad = float(np.hypot(port.env.res / 2, port.env.res / 2))
        counts = sorted(c for c in _counts(port, "red_box", lists["red_box"],
                                           grid_rad) if c > 0)
        perch["min_neighbor_points_for_valid_pose"] = counts[len(counts) // 2]
    elif name == "radius_below_grid":
        env_over["res"] = 0.16                  # grid_rad 0.113 m
    elif name == "model_without_rows":
        lists = {"red_box": [], "green_box": lists["green_box"]}
    elif name == "three_dof_input":
        six_dof = False
    out = []
    for env in (jax_env, port):
        e = copy.copy(env)
        e._input = dataclasses.replace(env._input,
                                       segmented_object_names=list(names),
                                       use_external_pose_list=six_dof)
        e.perch = dataclasses.replace(env.perch, **perch)
        e.env = dataclasses.replace(env.env, **env_over)
        if drop_trees:
            e._world_kdtree = None
            e._seg_kdtrees = [None] * len(env._seg_kdtrees)
        out.append(e)
    return (*out, lists)


CASES = ["segment_without_tree", "label_beyond_trees", "empty_world",
         "count_at_threshold", "radius_below_grid", "model_without_rows",
         "three_dof_input"]


@pytest.mark.parametrize("name", CASES)
def test_batched_pruning_equals_per_row_rule_and_jax(envs, name):
    jax_env, port, lists = _case(*envs, name)
    stats.set_tracing(True)
    TRACE.clear()
    try:
        got = port.generate_successors_6dof(lists)
        (rec,) = [r for r in TRACE.drain() if r.name == "env.candidates"]
    finally:
        stats.set_tracing(False)
        TRACE.clear()
    want = per_row(port, lists)
    assert got == want
    assert all(type(s.external_pose_id) is int for s in got)
    assert _fields(got) == _fields(jax_env.generate_successors_6dof(lists))
    # One query per (model, segment) that has rows and a tree (6-DoF).
    queries = sum(1 for n, rows in lists.items()
                  if len(rows) and _tree(port, _label(port, n)) is not None
                  and port._input.use_external_pose_list)
    assert rec.counters.get("queries", 0) == queries
    assert rec.counters["rows"] == sum(len(r) for r in lists.values())
    assert rec.counters["valid"] == len(got)
    # What each case is there for.
    grid_rad = float(np.hypot(port.env.res / 2, port.env.res / 2))
    counts = _counts(port, "red_box", lists["red_box"], grid_rad)
    min_pts = port.perch.min_neighbor_points_for_valid_pose
    if name == "empty_world":
        assert got == [] and queries == 0
    else:
        assert 0 < len(got) < rec.counters["rows"]
    if name in ("segment_without_tree", "label_beyond_trees"):
        fell_back = ("red_box" if name == "segment_without_tree"
                     else "green_box")
        assert _tree(port, _label(port, fell_back)) is port._world_kdtree
    if name == "count_at_threshold":
        assert min_pts in counts and min(counts) < min_pts
    if name == "radius_below_grid":
        # Some survivor is kept by the grid cell's radius alone.
        assert port._ball_radius.max() < grid_rad
        alone = _counts(port, "red_box", lists["red_box"], 0.0)
        assert min(alone[s.external_pose_id] for s in got
                   if s.id == port.bank.index_of("red_box")) < min_pts
    if name == "model_without_rows":
        assert {s.id for s in got} == {port.bank.index_of("green_box")}
    if name == "three_dof_input":
        # The 3-DoF rule decides here, and it keeps other rows.
        six = copy.copy(port)
        six._input = dataclasses.replace(port._input,
                                         use_external_pose_list=True)
        assert per_row(six, lists) != got


@pytest.mark.parametrize("name", CASES)
def test_is_valid_pose_agrees_with_the_batch(envs, name):
    """Each row's state through `is_valid_pose` alone, and every row's
    through one `valid_poses` call (mixed models), against the rows that
    `generate_successors_6dof` keeps."""
    _, port, lists = _case(*envs, name)
    kept = {(s.id, s.external_pose_id)
            for s in port.generate_successors_6dof(lists)}
    states, want = [], []
    for n, rows in lists.items():
        mid = port.bank.index_of(n)
        for ext_id, row in enumerate(np.asarray(rows)):
            states.append(ObjectState(
                id=mid, symmetric=port.bank.models[mid].symmetric,
                pose=ContPose.from_quat(*row[:7]),
                segmentation_label_id=_label(port, n),
                external_pose_id=ext_id))
            want.append((mid, ext_id) in kept)
    assert [port.is_valid_pose(s) for s in states] == want
    assert port.valid_poses(states).tolist() == want
    # Interleaved, the groups' answers land on their own states.
    order = np.random.default_rng(5).permutation(len(states))
    assert port.valid_poses([states[i] for i in order]).tolist() == [
        want[i] for i in order]
