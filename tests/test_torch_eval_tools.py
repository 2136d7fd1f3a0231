"""The port's scene tools and host utilities against the JAX package: the
3-DoF scene config parser, the cloud utilities, the pose metrics, the
rotation sampler, the ADD / ADD-S surface sampler, the model zoo, the
YCB candidate generator, the stage timer, the batch grid and the dataset
generator with its writers.

Host code (NumPy / SciPy in both packages) must give the same arrays: exact
equality with the same inputs and RNG. The dataset generator renders
through each package's env (the port's direct raster twin against JAX's XLA
raster): the same placements, and depth and labels equal except on
silhouette pixels.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from perception_tpu.core import mesh as jmesh
from perception_tpu.core.pose import euler_xyz_to_matrix
from perception_tpu.eval import dataset_gen as jgen
from perception_tpu.eval import metrics as jmetrics
from perception_tpu.eval import model_zoo as jzoo
from perception_tpu.eval import sampling as jsampling
from perception_tpu.eval import ycb as jycb
from perception_tpu.io import config_parser as jparser
from perception_tpu.utils import cloud_utils as jcloud
from perception_tpu.utils import debug as jdebug
from perception_tpu.utils import stats as jstats
from perception_tpu_torch import convert
from perception_tpu_torch.core import mesh as pmesh
from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.eval import dataset_gen as pgen
from perception_tpu_torch.eval import metrics as pmetrics
from perception_tpu_torch.eval import model_zoo as pzoo
from perception_tpu_torch.eval import sampling as psampling
from perception_tpu_torch.eval import ycb as pycb
from perception_tpu_torch.io import config_parser as pparser
from perception_tpu_torch.io.images import read_png
from perception_tpu_torch.utils import cloud_utils as pcloud
from perception_tpu_torch.utils import debug as pdebug
from perception_tpu_torch.utils import stats as pstats

from tests.jax_native import jax_native_qem  # noqa: F401  (fixture)
from tests.test_pipeline import CAM

ZOO = ["mug", "bowl", "l_bracket", "elbow", "cracker_box", "soup_can"]
def _assert_same(a, b):
    """Equal nested results: arrays, lists, tuples, dicts, scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scene_config_parses_like_jax(tmp_path):
    """The reference's 3-DoF text format, byte for byte the same parse."""
    text = ("scene.pcd\n2\nmodels/a.ply\nmodels/b.obj\ntrue\nfalse\n"
            "false\ntrue\n-0.2 0.3\n-0.4 0.5\n0.71\n"
            "1 0 0 0.1\n0 1 0 0.2\n0 0 1 0.3\n0 0 0 1\n")
    path = tmp_path / "scene.txt"
    path.write_text(text)
    ref = jparser.parse_scene_config(str(path), base_dir="/data")
    out = pparser.parse_scene_config(str(path), base_dir="/data")
    assert dataclasses.asdict(out).keys() == dataclasses.asdict(ref).keys()
    _assert_same(dataclasses.asdict(out), dataclasses.asdict(ref))
    assert out.model_names == ["a", "b"] and out.table_height == 0.71


def _table_cloud(seed: int = 0) -> np.ndarray:
    """A noisy table plane with two boxes of points above it."""
    rng = np.random.default_rng(seed)
    table = np.c_[rng.uniform(-0.4, 0.4, (600, 2)),
                  rng.normal(0.0, 0.002, 600)]
    box1 = rng.uniform([0.05, 0.05, 0.02], [0.12, 0.12, 0.1], (150, 3))
    box2 = rng.uniform([-0.2, -0.1, 0.02], [-0.15, -0.02, 0.08], (120, 3))
    return np.vstack([table, box1, box2])


def _depth_frame(seed: int = 1) -> np.ndarray:
    """A 48x64 depth image in mm with holes and two depth layers."""
    rng = np.random.default_rng(seed)
    d = np.full((48, 64), 900.0) + rng.normal(0, 2, (48, 64))
    d[10:30, 20:40] = 600.0
    d[rng.uniform(size=d.shape) < 0.08] = 0.0
    d[40:, :10] = 0.0
    return d.astype(np.uint16)


def _organized(seed: int = 1) -> np.ndarray:
    return jcloud.organized_cloud_from_depth(_depth_frame(seed), 60.0, 60.0,
                                             32.0, 24.0, 1000.0)


CLOUD_CASES = {
    "fit_plane_ransac": lambda m: m.fit_plane_ransac(
        _table_cloud(), 0.01, 50, rng=np.random.default_rng(4)),
    "remove_plane": lambda m: m.remove_plane(
        _table_cloud(), 0.01, max_iterations=50,
        rng=np.random.default_rng(4)),
    "euclidean_clusters": lambda m: m.euclidean_clusters(
        _table_cloud()[600:], tolerance=0.03, min_size=5),
    "voxel_downsample": lambda m: m.voxel_downsample(
        _table_cloud(), 0.05, attributes=np.arange(
            len(_table_cloud()) * 3, dtype=np.float64).reshape(-1, 3)),
    "passthrough_filter": lambda m: m.passthrough_filter(
        _table_cloud(), 2, 0.01, 0.2),
    "statistical_outlier_removal": lambda m: m.statistical_outlier_removal(
        _table_cloud(), k=8, std_ratio=1.0),
    "organized_cloud_from_depth": lambda m: m.organized_cloud_from_depth(
        _depth_frame(), 60.0, 60.0, 32.0, 24.0, 1000.0),
    "inpaint_depth_image": lambda m: m.inpaint_depth_image(
        _organized(), np.ones((48, 64)), 2.0),
    "range_image_planar": lambda m: m.range_image_planar(
        _organized(), 60.0, 60.0, 32.0, 24.0, 64, 48),
    "euclidean_clustering_organized": lambda m: (
        m.euclidean_clustering_organized(_organized(), 0.02, 20)),
}


@pytest.mark.parametrize("name", sorted(CLOUD_CASES))
def test_cloud_utils_match_jax(name, monkeypatch):
    """Each cloud utility on the same inputs and RNG: the same arrays. The
    JAX inpaint runs with cv2 hidden, the path the port always takes."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    ref = CLOUD_CASES[name](jcloud)
    out = CLOUD_CASES[name](pcloud)
    _assert_same(out, ref)
    if name == "inpaint_depth_image":
        assert np.isfinite(out).all() and (out > 0).mean() > 0.95


def test_pose_metrics_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 0.05, (300, 3))
    r_gt = euler_xyz_to_matrix(0.3, -0.2, 0.9)
    r_est = euler_xyz_to_matrix(0.32, -0.18, 0.85)
    t_gt, t_est = np.array([0.1, 0.0, 0.6]), np.array([0.105, -0.003, 0.61])
    for fn in ("add_err", "adi_err"):
        assert getattr(pmetrics, fn)(r_est, t_est, r_gt, t_gt, pts) == \
            getattr(jmetrics, fn)(r_est, t_est, r_gt, t_gt, pts)
    assert pmetrics.rot_err_deg(r_est, r_gt) == jmetrics.rot_err_deg(r_est,
                                                                     r_gt)
    assert pmetrics.trans_err(t_est, t_gt) == jmetrics.trans_err(t_est, t_gt)
    np.testing.assert_array_equal(
        pmetrics.transform_pts(pts, r_gt, t_gt),
        jmetrics.transform_pts(pts, r_gt, t_gt))
    for rec in (rng.uniform(0, 0.15, 40), np.array([0.5, 0.2]),
                np.array([])):
        ref = jmetrics.compute_pose_metrics(rec)
        out = pmetrics.compute_pose_metrics(rec)
        assert out.keys() == ref.keys()
        for k in ref:
            assert (out[k] == ref[k]) or (np.isnan(out[k])
                                          and np.isnan(ref[k])), k


@pytest.mark.parametrize("symmetry", [(0, m) for m in range(10)] + [(1, 0)])
def test_rotation_samples_match_jax(symmetry):
    """Every in-plane mode (and the half sphere): the same euler triplets,
    and the same poses.txt rows from them."""
    ref = jsampling.get_rotation_samples("x", 24, symmetry=symmetry)
    out = psampling.get_rotation_samples("x", 24, symmetry=symmetry)
    np.testing.assert_array_equal(out, ref)
    c = np.array([0.1, -0.2, 0.7])
    np.testing.assert_array_equal(psampling.poses_from_rotations(out, c),
                                  jsampling.poses_from_rotations(ref, c))
    assert psampling.YCB_SYMMETRY == jsampling.YCB_SYMMETRY


@pytest.mark.parametrize("name", ZOO)
def test_zoo_models_match_jax(name, jax_native_qem):
    """Each zoo shape: the same raw geometry at resolution 1 and 2, the same
    MeshModel at resolution 1 (decimated to 96 triangles too, by the C++ QEM
    on both sides), and the same ADD / ADD-S surface points from it."""
    for res in (1.0, 2.0):
        _assert_same(pzoo.zoo_raw_geometry(name, res),
                     jzoo.zoo_raw_geometry(name, res))
    for target in (None, 96):
        (ref,) = jzoo.build_zoo_models([name], target_triangles=target,
                                       use_external_pose_list=True)
        (out,) = pzoo.build_zoo_models([name], target_triangles=target,
                                       use_external_pose_list=True)
        _assert_same(dataclasses.asdict(out),
                     dataclasses.asdict(convert.dataclass_from_jax(
                         ref, pmesh.MeshModel)))
        for k in (4096, 50):
            np.testing.assert_array_equal(out.sample_surface_points(k),
                                          ref.sample_surface_points(k))


def test_generate_candidates_match_jax():
    """The YCB candidate rows of a two-object mask (a symmetric-mode name and
    the scissors' 1 cm layers), with and without cam_to_world."""
    rng = np.random.default_rng(8)
    depth = (rng.uniform(0.55, 0.62, (48, 64)) * 10000).astype(np.uint16)
    mask = np.zeros((48, 64), np.int32)
    mask[5:20, 8:30] = 1
    mask[25:45, 35:60] = 2
    depth[30:33, 40:44] = 0
    cam = CameraIntrinsics(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64,
                           height=48)
    jcam = jycb.CameraIntrinsics(**dataclasses.asdict(cam))
    names = ["025_mug", "037_scissors", "011_banana"]
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, 0.2, 0.3]
    for kw in ({}, {"cam_to_world": c2w}):
        ref = jycb.generate_candidates(depth, mask, names, jcam,
                                       num_samples=12, **kw)
        out = pycb.generate_candidates(depth, mask, names, cam,
                                       num_samples=12, **kw)
        assert list(out) == list(ref) == names[:2]
        _assert_same(out, ref)
    assert pycb.YCB_ADDS_OBJECTS == jycb.YCB_ADDS_OBJECTS
    assert pycb.YCB_DEPTH_FACTOR == jycb.YCB_DEPTH_FACTOR
    assert dataclasses.asdict(pycb.YCB_CAMERA) == dataclasses.asdict(
        jycb.YCB_CAMERA)


def test_stage_timer_counts_like_jax():
    timers = (jstats.StageTimer(), pstats.StageTimer())
    for t in timers:
        for name in ("render", "icp", "render"):
            with t.span(name):
                pass
        with pytest.raises(KeyError):
            with t.span("cost"):
                raise KeyError
    ref, out = timers
    assert out.counts == ref.counts == {"render": 2, "icp": 1, "cost": 1}
    assert list(out.spans) == list(ref.spans)
    assert out.summary().count("s/") == 3


@pytest.mark.parametrize("with_color", [True, False])
def test_batch_grid_matches_jax_outside_labels(tmp_path, with_color):
    """save_batch_grid's tiles equal JAX's (cv2) outside each cell's label
    box; the port's labels are its glyphs of the cost, in white."""
    rng = np.random.default_rng(2)
    depth = rng.uniform(0, 2, (5, 24, 40)) * (rng.uniform(size=(5, 24, 40))
                                              > 0.2)
    color = (rng.uniform(0, 255, (5, 24, 40, 3)) if with_color else None)
    costs = [12, -1, 7.5, 100]
    jdebug.save_batch_grid(depth, str(tmp_path / "j.png"), color, costs,
                           cols=3)
    pdebug.save_batch_grid(depth, str(tmp_path / "p.png"), color, costs,
                           cols=3)
    ref = cv2.imread(str(tmp_path / "j.png"))[..., ::-1]
    out = read_png(str(tmp_path / "p.png"))
    assert out.shape == ref.shape == (48, 120, 3)
    label = np.zeros(out.shape[:2], bool)
    for i in range(len(costs)):
        r, c = divmod(i, 3)
        label[r * 24:r * 24 + 15, c * 40:(c + 1) * 40] = True
    np.testing.assert_array_equal(out[~label], ref[~label])
    # The fifth cell has no cost and no label.
    np.testing.assert_array_equal(out[24:, 40:80], ref[24:, 40:80])
    glyph = np.zeros((24, 40, 3), np.uint8)
    pdebug.draw_label(glyph, "12")
    assert (glyph == 255).all(axis=-1).sum() == (8 + 11) * 4   # 2x2 each
    assert ((out[:24, :40] == 255).all(axis=-1) >= (glyph == 255).all(
        axis=-1)).all()


# ---------------------------------------------------------------------------
# The dataset generator.

@pytest.fixture(scope="module")
def envs():
    """JAX and port envs over three zoo models on the 128x96 test camera
    (the port's a CPU env with the JAX env's bank)."""
    from perception_tpu.core.config import EnvConfig as JEnvConfig
    from perception_tpu.core.config import PerchConfig as JPerchConfig
    from perception_tpu.pipeline.env import PerceptionEnv as JEnv
    from perception_tpu_torch.core.config import EnvConfig, PerchConfig
    from perception_tpu_torch.pipeline.env import PerceptionEnv

    models = jzoo.build_zoo_models(["mug", "l_bracket", "soup_can"],
                                   use_external_pose_list=True)
    bank = jmesh.ModelBank.from_models(models)
    jenv = JEnv(bank, CAM, JPerchConfig(),
                JEnvConfig(width=CAM.width, height=CAM.height))
    penv = PerceptionEnv(convert.bank_from_jax(bank),
                         convert.dataclass_from_jax(CAM, CameraIntrinsics),
                         PerchConfig(), EnvConfig(width=CAM.width,
                                                  height=CAM.height),
                         device="cpu")
    return jenv, penv


def _scenes(envs, seed: int = 3):
    jenv, penv = envs
    kw = dict(num_objects=3, x_range=(0.5, 0.7), y_range=(-0.12, 0.12),
              min_separation=0.09)
    ref = jgen.DatasetGenerator(jenv, np.random.default_rng(seed))
    out = pgen.DatasetGenerator(penv, np.random.default_rng(seed))
    return ([ref.sample_scene(**kw), ref.sample_scene(yaw_only=True, **kw)],
            [out.sample_scene(**kw), out.sample_scene(yaw_only=True, **kw)])


def test_sample_scene_matches_jax(envs):
    """The same seed places the same objects at the same poses (6-DoF and
    yaw-only); the depth and labels of the render equal JAX's except on
    silhouette pixels (<= 2% of the frame), the colour on 99% of the pixels
    where those agree (a pixel on the edge between two faces of one model
    may take either face's colour)."""
    from tests.test_torch_deploy import _silhouette

    refs, outs = _scenes(envs)
    for ref, out in zip(refs, outs):
        assert len(out.states) == len(ref.states) == 3
        for r, o in zip(ref.states, out.states):
            assert (o.id, o.segmentation_label_id, o.symmetric) == \
                (r.id, r.segmentation_label_id, r.symmetric)
            np.testing.assert_array_equal(o.pose.transform(),
                                          r.pose.transform())
        same = (out.depth == ref.depth) & (out.label == ref.label)
        edge = _silhouette(ref.label) | _silhouette(out.label)
        assert (ref.label > 0).sum() > 300
        assert same.mean() >= 0.98
        diff = ~same
        assert (edge[diff] | (np.abs(out.depth[diff] - ref.depth[diff])
                              <= 1)).all()
        assert (out.color[same] == ref.color[same]).all(axis=-1).mean() \
            >= 0.99


def test_write_ply_and_zoo_plys_match_jax(tmp_path):
    """write_ply (with and without colours) and write_zoo_plys: the same
    bytes."""
    v, f, c, _ = jzoo.zoo_raw_geometry("elbow")
    for colors in (c, None):
        jgen.write_ply(str(tmp_path / "j.ply"), v, f, colors)
        pgen.write_ply(str(tmp_path / "p.ply"), v, f, colors)
        assert (tmp_path / "p.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
    name_map = {"024_bowl": "bowl", "025_mug": "mug"}
    ref = jgen.write_zoo_plys(str(tmp_path / "j"), name_map)
    out = pgen.write_zoo_plys(str(tmp_path / "p"), name_map)
    assert list(out) == list(ref)
    for name in name_map:
        assert open(out[name], "rb").read() == open(ref[name], "rb").read()


def _cv2_read(path: str) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


def test_scene_writers_match_jax(envs, tmp_path):
    """write_scene and write_ycb_layout on the same generated scenes (JAX's
    renders, given to both writers): PNGs that decode to the same arrays,
    the same ground-truth JSON, .mat files and keyframe lists."""
    from scipy.io import loadmat

    jenv, penv = envs
    refs, _ = _scenes(envs)
    scenes = [pgen.GeneratedScene(
        states=convert.states_from_jax(s.states), depth=np.asarray(s.depth),
        color=np.asarray(s.color), label=np.asarray(s.label)) for s in refs]
    gen_j = jgen.DatasetGenerator(jenv)
    gen_p = pgen.DatasetGenerator(penv)
    gt_j = gen_j.write_scene(refs[0], str(tmp_path / "j"), "s0")
    gt_p = gen_p.write_scene(scenes[0], str(tmp_path / "p"), "s0")
    assert gt_p == gt_j
    assert json.load(open(tmp_path / "p" / "s0-gt.json")) == gt_j
    for kind in ("depth", "color", "label"):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "p" / f"s0-{kind}.png")),
            _cv2_read(str(tmp_path / "j" / f"s0-{kind}.png")), kind)
    ref_keys = jgen.write_ycb_layout(str(tmp_path / "jy"), jenv, refs)
    out_keys = pgen.write_ycb_layout(str(tmp_path / "py"), penv, scenes)
    assert out_keys == ref_keys == [("0001", "000001"), ("0002", "000001")]
    for rel in ("image_sets/classes.txt", "image_sets/keyframe.txt"):
        assert (tmp_path / "py" / rel).read_text() == \
            (tmp_path / "jy" / rel).read_text()
    for sdir, fid in out_keys:
        base = f"data/{sdir}/{fid}"
        for kind in ("depth", "color", "label"):
            np.testing.assert_array_equal(
                read_png(str(tmp_path / "py" / f"{base}-{kind}.png")),
                _cv2_read(str(tmp_path / "jy" / f"{base}-{kind}.png")))
        ref = loadmat(str(tmp_path / "jy" / f"{base}-meta.mat"))
        out = loadmat(str(tmp_path / "py" / f"{base}-meta.mat"))
        for k in ("cls_indexes", "poses", "intrinsic_matrix",
                  "factor_depth"):
            np.testing.assert_array_equal(out[k], ref[k], k)
