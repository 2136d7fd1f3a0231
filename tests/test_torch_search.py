"""The port's tree search and MHA* planner against the JAX package.

The scene is test_torch_3dof's pair scene (a crate and a symmetric post on
a table at grid poses, 128x96 at stride 2, no instance mask); the JAX side
scores with the direct raster and fused cost Pallas kernels in interpret
mode (the search scores without ICP), the port with the twins on CPU
tensors. Tolerance: the same winners (model ids in placement order, poses
equal to 1 mm) and the same number of expansions; composed images equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from perception_tpu.core.state import GraphState
from perception_tpu.pipeline.heuristics import (
    Detection,
    DetectionHeuristicFactory,
)
from perception_tpu.pipeline.mha_star import MHAStarPlanner
from perception_tpu.pipeline.search import TreeSearch
from perception_tpu.pipeline.search import _Node
from perception_tpu_torch import convert
from perception_tpu_torch.core import config as pc
from perception_tpu_torch.kernels import build
from perception_tpu_torch.pipeline import heuristics as pheur
from perception_tpu_torch.pipeline.mha_star import MHAStarPlanner as PortMHA
from perception_tpu_torch.pipeline.search import TreeSearch as PortTree

from tests.test_torch_3dof import (
    PAIR_GT,
    PAIR_REGION,
    crate,
    grid_state,
    one_thread,  # noqa: F401  (autouse)
    port_env,
    post,
    table_scene,
)


@pytest.fixture(scope="module")
def scene():
    jenv, _ = table_scene([crate(), post()], PAIR_GT, PAIR_REGION,
                          use_cylinder_observed=True)
    return jenv, port_env(jenv)


def _assert_same_winners(out, ref):
    assert out.num_objects == ref.num_objects == 2
    assert [o.id for o in out.object_states] == \
        [o.id for o in ref.object_states]
    np.testing.assert_allclose(
        [[o.pose.x, o.pose.y, o.pose.z, o.pose.yaw]
         for o in out.object_states],
        [[o.pose.x, o.pose.y, o.pose.z, o.pose.yaw]
         for o in ref.object_states], atol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"lazy_k": 4}, {"counted_pixels": True}],
                         ids=["plain", "lazy", "counted"])
def test_tree_search_matches_jax(scene, kw):
    """Beam 2 over the env's 3-DoF grid successors."""
    jenv, penv = scene
    ref_search = TreeSearch(jenv, beam_width=2, **kw)
    ref = ref_search.plan()
    search = PortTree(penv, beam_width=2, **kw)
    build.reset_counts()
    out = search.plan()
    assert set(build.TWIN_CALLS) == {"raster_direct", "cost_fused"}
    assert search.stats.expands == ref_search.stats.expands >= 2
    _assert_same_winners(out, ref)


def test_compose_matches_jax_and_rerender(scene):
    """The node images with an object composed on top (a single render at
    full resolution, strided, min depth), from the cache the second time;
    prefetch_singles fills the cache with the same images."""
    jenv, penv = scene
    ref_search, search = TreeSearch(jenv), PortTree(penv)
    jroot = _Node(GraphState(), 0, np.asarray(jenv._scene.source_depth),
                  np.zeros(np.asarray(jenv._scene.source_depth).shape,
                           np.int32), frozenset())
    root = search.root()
    np.testing.assert_array_equal(root.source_depth, jroot.source_depth)
    objs = convert.states_from_jax(PAIR_GT)
    for jobj, obj in zip(PAIR_GT, objs):
        rd, rl = ref_search._compose(jroot, jobj)
        d, l = search._compose(root, obj)
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(l, rl)
    assert search.stats.scenes_rendered == 2
    search._compose(root, objs[0])
    assert search.stats.scenes_rendered == 2
    fresh = PortTree(penv)
    fresh.prefetch_singles(objs + objs)
    assert fresh.stats.scenes_rendered == 2
    for obj in objs:
        key = PortTree._state_key(obj)
        np.testing.assert_array_equal(fresh._render_cache[key],
                                      search._render_cache[key])


def test_composed_source_scores_without_touching_the_scene(scene):
    """score_object_states with a node's composed (depth, label) source
    scores as the env with its scene's source images swapped for them (the
    same costs and adjusted poses, bit for bit), and leaves the env's scene
    object and its tensors as they were."""
    _, penv = scene
    search = PortTree(penv)
    root = search.root()
    # A crate in front of both objects, between them.
    front = convert.states_from_jax([grid_state(0, 0.60, -0.02)])[0]
    depth, label = search._compose(root, front)
    assert (depth != root.source_depth).any()
    cands = penv.generate_successors_3dof()
    kept = penv._scene
    before = {f.name: getattr(kept, f.name).clone()
              for f in dataclasses.fields(kept)}
    out = penv.score_object_states(cands, do_icp=False, source=(depth, label))
    assert penv._scene is kept
    for name, t in before.items():
        assert torch.equal(getattr(kept, name), t), name
    penv._scene = dataclasses.replace(
        kept, source_depth=torch.as_tensor(depth),
        source_label=torch.as_tensor(label))
    try:
        swapped = penv.score_object_states(cands, do_icp=False)
    finally:
        penv._scene = kept
    plain = penv.score_object_states(cands, do_icp=False)
    assert len(out) == len(swapped) == len(cands)

    def fields(su):
        return (su.state, su.cost, su.target_cost, su.source_cost,
                su.last_level_cost, su.adjusted_pose_cam.tobytes())
    assert [fields(su) for su in out] == [fields(su) for su in swapped]
    assert [su.cost for su in out] != [su.cost for su in plain]
    assert any(su.cost >= 0 for su in out)


def _detections(jenv):
    """A detection box around each ground-truth object's projected
    centre."""
    cam = jenv.camera
    dets = []
    for obj in PAIR_GT:
        mat = jenv.pose_to_camera(obj)
        u = cam.fx * mat[0, 3] / mat[2, 3] + cam.cx
        v = cam.fy * mat[1, 3] / mat[2, 3] + cam.cy
        dets.append(Detection(name=jenv.bank.models[obj.id].name,
                              bbox=(u - 12, v - 12, u + 12, v + 12)))
    return dets


@pytest.mark.parametrize("with_heuristic", [False, True],
                         ids=["anchor", "detections"])
def test_mha_star_matches_jax(scene, with_heuristic):
    """MHA* over each model's 6 candidates nearest its detection (the
    detection heuristic's order), with only the anchor queue or with the
    detection queue too."""
    jenv, penv = scene
    names = [m.name for m in jenv.bank.models]
    dets = _detections(jenv)
    jfac = DetectionHeuristicFactory(dets, jenv.camera,
                                     cam_to_world=jenv._input.cam_to_world)
    pfac = pheur.DetectionHeuristicFactory(
        convert.detections_from_jax(dets),
        convert.dataclass_from_jax(jenv.camera, pc.CameraIntrinsics),
        cam_to_world=penv._input.cam_to_world)
    jh, ph = jfac.heuristic(names), pfac.heuristic(names)
    cands = sorted(jenv.generate_successors_3dof(), key=jh)
    kw = dict(w1=2.0, w2=3.0, max_expansions=12, max_successors_per_model=6)
    ref_plan = MHAStarPlanner(jenv, cands,
                              heuristics=[jh] if with_heuristic else [],
                              **kw)
    ref = ref_plan.plan()
    plan = PortMHA(penv, convert.states_from_jax(cands),
                   heuristics=[ph] if with_heuristic else [], **kw)
    out = plan.plan()
    assert plan.stats.expands == ref_plan.stats.expands >= 2
    assert plan.stats.cost == ref_plan.stats.cost
    _assert_same_winners(out, ref)
