"""The port's host logic of the search modes against the JAX package, exact:
the discretiser, discretised poses, state hash keys and the hash manager;
the footprint and containment helpers of `core/mesh.py`; the pruning
statistics (HS histograms, Bhattacharyya, voxel change); the detection
heuristics; and the converters that carry these types over. Inputs are made
from numpy seeds; every comparison is equality."""

import json
import math

import cv2
import numpy as np
import pytest

from perception_tpu.core import mesh as jmesh
from perception_tpu.core import state as jstate
from perception_tpu.core.config import CameraIntrinsics as JCam
from perception_tpu.core.pose import CAM_TO_BODY
from perception_tpu.core.pose import ContPose as JPose
from perception_tpu.pipeline import heuristics as jheur
from perception_tpu.pipeline import pruning as jprune
from perception_tpu_torch import convert
from perception_tpu_torch.core import mesh as pmesh
from perception_tpu_torch.core import state as pstate
from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.core.pose import ContPose
from perception_tpu_torch.io.images import read_png
from perception_tpu_torch.pipeline import heuristics as pheur
from perception_tpu_torch.pipeline import pruning as pprune

from tests.test_core import make_box


def _poses(rng, n):
    """n poses each way: euler (grid-like and arbitrary) and quaternion."""
    out = []
    for k in range(n):
        x, y, z = rng.uniform(-1.2, 1.2, 3)
        if k % 3 == 0:
            args = ("from_euler", x, y, z, 0.0, 0.0,
                    rng.integers(-20, 20) * math.pi / 8)
        elif k % 3 == 1:
            args = ("from_euler", x, y, z, *rng.uniform(-4, 4, 3))
        else:
            q = rng.normal(size=4)
            args = ("from_quat", x, y, z, *(q / np.linalg.norm(q)))
        out.append((getattr(JPose, args[0])(*args[1:]),
                    getattr(ContPose, args[0])(*args[1:])))
    return out


def test_discretizer_and_disc_pose_match_jax():
    rng = np.random.default_rng(0)
    for res, theta_res in ((0.04, math.pi / 8), (0.013, 0.3), (0.1, 1.0)):
        jd = jstate.Discretizer(x_min=-0.7, x_max=0.9, y_min=-0.3,
                                y_max=0.6, res=res, theta_res=theta_res)
        pd = convert.discretizer_from_jax(jd)
        assert pd == pstate.Discretizer(-0.7, 0.9, -0.3, 0.6, res, theta_res)
        vals = rng.uniform(-3, 3, 200)
        for v in vals:
            assert pd.disc_x(v) == jd.disc_x(v)
            assert pd.disc_y(v) == jd.disc_y(v)
            assert pd.disc_angle(v * 3) == jd.disc_angle(v * 3)
        for i in range(-30, 30):
            assert pd.cont_x(i) == jd.cont_x(i)
            assert pd.cont_y(i) == jd.cont_y(i)
            assert pd.cont_angle(i) == jd.cont_angle(i)
        for jp, pp in _poses(rng, 60):
            a = jstate.DiscPose.from_cont(jp, jd)
            b = pstate.DiscPose.from_cont(pp, pd)
            assert (b.x, b.y, b.z, b.roll, b.pitch, b.yaw) == \
                (a.x, a.y, a.z, a.roll, a.pitch, a.yaw)


def test_state_hash_keys_and_manager_match_jax():
    """Object and graph keys (symmetric models ignore yaw; an external
    candidate is its index), order independence, and the id sequence the
    hash manager gives a stream of states with repeats."""
    rng = np.random.default_rng(1)
    jd = jstate.Discretizer(res=0.04, theta_res=math.pi / 8)
    pd = convert.discretizer_from_jax(jd)
    jobjs = []
    for k, (jp, _) in enumerate(_poses(rng, 48)):
        jobjs.append(jstate.ObjectState(
            id=k % 3, symmetric=bool(k % 4 == 0), pose=jp,
            segmentation_label_id=1 + k % 2,
            external_pose_id=k if k % 5 == 0 else -1))
    pobjs = convert.states_from_jax(jobjs)
    for j, p in zip(jobjs, pobjs):
        assert p.hash_key(pd) == j.hash_key(jd)
    jm, pm = jstate.StateHashManager(jd), pstate.StateHashManager(pd)
    for _ in range(80):
        idx = rng.choice(len(jobjs), size=rng.integers(0, 4), replace=False)
        order = rng.permutation(len(idx))
        jg = jstate.GraphState(tuple(jobjs[i] for i in idx))
        pg = pstate.GraphState(tuple(pobjs[i] for i in idx[order]))
        assert pg.hash_key(pd) == jg.hash_key(jd)
        assert pm.get_id(pg) == jm.get_id(jg)
    assert len(pm) == len(jm) > 10
    assert pm.get_state(3).hash_key(pd) == jm.get_state(3).hash_key(jd)


def _model_pairs():
    """The same models in both packages: two boxes and a random convex
    blob, 6-DoF and 3-DoF preprocessing."""
    rng = np.random.default_rng(2)
    meshes = [make_box(0.12, 0.08, 0.10), make_box(0.2, 0.1, 0.1)]
    pts = rng.normal(size=(60, 3)) * [0.05, 0.03, 0.04]
    from scipy.spatial import ConvexHull

    hull = ConvexHull(pts)
    meshes.append((pts, hull.simplices))
    out = []
    for i, (v, f) in enumerate(meshes):
        for six in (True, False):
            jm = jmesh.mesh_model_from_arrays(f"m{i}", v, f,
                                              use_external_pose_list=six)
            out.append((jm, convert.models_from_jax([jm])[0]))
    return out


def test_footprint_helpers_match_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 40, 400):
        pts = rng.normal(size=(n, 3)).round(2)   # duplicates and collinears
        hull_j = jmesh.convex_hull_2d(pts)
        hull_p = pmesh.convex_hull_2d(pts)
        np.testing.assert_array_equal(hull_p, hull_j)
        q = rng.normal(size=(300, 2)) * 1.5
        np.testing.assert_array_equal(pmesh.points_in_convex_poly(q, hull_p),
                                      jmesh.points_in_convex_poly(q, hull_j))
    for jm, pm in _model_pairs():
        assert pm.circumscribed_radius == jm.circumscribed_radius
        assert pm.inscribed_radius == jm.inscribed_radius
        np.testing.assert_array_equal(pm.footprint_hull(), jm.footprint_hull())
        vmin, vmax = jm.bounds
        q = rng.uniform(vmin - 0.05, vmax + 0.05, (500, 3))
        inside = pm.points_inside(q)
        assert 0 < inside.sum() < len(q)
        np.testing.assert_array_equal(inside, jm.points_inside(q))
        t = np.eye(4)
        t[:3, :3] = cv2.Rodrigues(rng.normal(size=3))[0]
        t[:3, 3] = rng.normal(size=3) * 0.1
        qt = q @ t[:3, :3].T + t[:3, 3]
        np.testing.assert_array_equal(
            pm.points_inside(qt, transform=t, inflation=1.15),
            jm.points_inside(qt, transform=t, inflation=1.15))
        yaw = rng.uniform(-3, 3)
        kw = dict(yaw_cos_sin=(np.cos(yaw), np.sin(yaw)), xy=(0.3, -0.2))
        q2 = rng.uniform(-0.2, 0.2, (400, 2)) + [0.3, -0.2]
        a = pm.points_inside_footprint(q2, **kw)
        assert 0 < a.sum() < len(q2)
        np.testing.assert_array_equal(a, jm.points_inside_footprint(q2, **kw))


def test_pruning_statistics_match_jax():
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0, 255, (6, 24, 32, 3)).astype(np.float32)
    rgb[:, :4] = rgb[:, :4, :1]                 # grey rows: zero saturation
    rgb[0, 5, :] = [255.0, 0, 0]
    for a, b in zip(pprune.rgb_to_hs(rgb), jprune.rgb_to_hs(rgb)):
        np.testing.assert_array_equal(a, b)
    depth = np.zeros((6, 24, 32), np.int32)
    for i in range(5):                          # render 5 is empty
        y0, x0 = rng.integers(0, 12, 2)
        depth[i, y0:y0 + 9, x0:x0 + 15] = 60
    obs = rgb[0].copy()
    mask = depth[1] > 0
    np.testing.assert_array_equal(pprune.hs_histogram(obs, mask),
                                  jprune.hs_histogram(obs, mask))
    h1, h2 = (pprune.hs_histogram(rgb[i], depth[1] > 0) for i in (1, 2))
    assert pprune.bhattacharyya(h1, h2) == jprune.bhattacharyya(h1, h2)
    assert pprune.bhattacharyya(h1, 0 * h2) == 1.0
    d = pprune.histogram_scores(rgb, depth, obs)
    np.testing.assert_array_equal(d, jprune.histogram_scores(rgb, depth, obs))
    assert d[5] == 1.0 and d.min() < 1.0
    observed = rng.uniform(-1, 1, (700, 3))
    clouds = [observed[:200] + 0.001, observed[:50] + [5.0, 0, 0],
              np.zeros((0, 3)), rng.uniform(-1, 1, (90, 3))]
    np.testing.assert_array_equal(pprune.voxel_keys(observed, 0.02),
                                  jprune.voxel_keys(observed, 0.02))
    frac = pprune.voxel_changed_fraction(clouds, observed, 0.02)
    np.testing.assert_array_equal(
        frac, jprune.voxel_changed_fraction(clouds, observed, 0.02))
    assert frac[2] == 1.0 and frac[0] < 0.05 < frac[1]


def test_detection_heuristics_match_jax(tmp_path):
    """load_detections (both file forms), the best detection per name, the
    heuristic's values (behind the camera, no detection), prune, and the
    ROI crops save_rois writes (read back by OpenCV)."""
    rng = np.random.default_rng(5)
    raw = [{"name": "red_box", "bbox": [40, 30, 70, 66], "score": 0.4},
           {"category": "red_box", "bbox": [50, 20, 90, 50], "score": 0.9},
           {"name": "green_box", "bbox": [2, 60, 20, 90]}]
    (tmp_path / "a.json").write_text(json.dumps(raw))
    (tmp_path / "b.json").write_text(json.dumps({"detections": raw}))
    for name in ("a.json", "b.json"):
        jd = jheur.load_detections(str(tmp_path / name))
        pd = pheur.load_detections(str(tmp_path / name))
        assert pd == convert.detections_from_jax(jd)
        assert [d.center.tolist() for d in pd] == \
            [d.center.tolist() for d in jd]
    jcam = JCam(fx=160.0, fy=160.0, cx=64.0, cy=48.0, width=128, height=96)
    pcam = convert.dataclass_from_jax(jcam, CameraIntrinsics)
    jf = jheur.DetectionHeuristicFactory(jd, jcam, cam_to_world=CAM_TO_BODY)
    pf = pheur.DetectionHeuristicFactory(pd, pcam, cam_to_world=CAM_TO_BODY)
    assert pf.by_name["red_box"].score == 0.9
    names = ["red_box", "green_box", "blue_box"]
    jobjs = [jstate.ObjectState(
        id=k % 3, symmetric=False,
        pose=JPose.from_euler(*rng.uniform([-0.3, -0.3, -0.3],
                                           [1.0, 0.3, 0.3]), 0, 0, 0))
        for k in range(90)]
    pobjs = convert.states_from_jax(jobjs)
    jh, ph = jf.heuristic(names), pf.heuristic(names)
    values = [ph(p) for p in pobjs]
    assert values == [jh(j) for j in jobjs]
    assert math.inf in values and 0.0 in values
    kept = pf.prune(pobjs, names, max_pixel_dist=60.0)
    assert kept == convert.states_from_jax(
        jf.prune(jobjs, names, max_pixel_dist=60.0))
    assert 0 < len(kept) < len(pobjs)
    color = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    paths = pheur.save_rois(color, pd, str(tmp_path / "rois"))
    assert len(paths) == 3
    for path, d in zip(paths, pd):
        x1, y1, x2, y2 = (int(v) for v in d.bbox)
        crop = color[max(y1, 0):y2, max(x1, 0):x2]
        np.testing.assert_array_equal(read_png(path), crop)
        np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], crop)


def test_input_converter_keeps_the_3dof_region():
    from perception_tpu.pipeline.env import RecognitionInput as JInput

    rin = JInput(depth_image=np.ones((4, 5)), x_min=0.1, x_max=0.9,
                 y_min=-0.4, y_max=0.35, table_height=-0.2,
                 use_external_pose_list=False)
    p = convert.input_from_jax(rin)
    assert (p.x_min, p.x_max, p.y_min, p.y_max, p.table_height) == \
        (0.1, 0.9, -0.4, 0.35, -0.2)
    assert not p.use_external_pose_list
    np.testing.assert_array_equal(p.depth_image, rin.depth_image)


@pytest.mark.parametrize("kind", ["euler", "quat"])
def test_states_converter_keeps_poses(kind):
    rng = np.random.default_rng(6)
    pairs = [p for p in _poses(rng, 30)
             if p[0].uses_euler == (kind == "euler")]
    js = [jstate.ObjectState(id=1, symmetric=True, pose=j,
                             segmentation_label_id=2, external_pose_id=7)
          for j, _ in pairs]
    ps = convert.states_from_jax(js)
    assert [s.pose for s in ps] == [p for _, p in pairs]
    assert all((s.id, s.symmetric, s.segmentation_label_id,
                s.external_pose_id) == (1, True, 2, 7) for s in ps)
