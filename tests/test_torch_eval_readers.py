"""The port's dataset readers, converters and baselines against the JAX
package on identical fixtures: the FAT reader, its YCB-layout round trip
and COCO export (`eval/fat.py`), the ShapeStacks converter, the DOPE and
DenseFusion ingestion, VFH (`eval/vfh.py`), the demo frame's proxy models,
env and frame transforms (`eval/demo_frame.py`), and the baseline JPEG
decoder (`io/images.decode_jpeg`) against `cv2.imread`.

Host code (NumPy / SciPy in both packages) must give the same results; the
JAX side reads images with OpenCV, the port with `io/images.py`. VFH's
training views render through each package's raster (the port's direct
twin against JAX's XLA raster), which differ on silhouette pixels.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from perception_tpu.eval import demo_frame as jdemo
from perception_tpu.eval import densefusion as jdf
from perception_tpu.eval import dope as jdope
from perception_tpu.eval import fat as jfat
from perception_tpu.eval import shapestacks as jss
from perception_tpu.eval import vfh as jvfh
from perception_tpu.eval import ycb as jycb
from perception_tpu_torch import convert
from perception_tpu_torch.core import mesh as pmesh
from perception_tpu_torch.eval import demo_frame as pdemo
from perception_tpu_torch.eval import densefusion as pdf
from perception_tpu_torch.eval import dope as pdope
from perception_tpu_torch.eval import fat as pfat
from perception_tpu_torch.eval import shapestacks as pss
from perception_tpu_torch.eval import vfh as pvfh
from perception_tpu_torch.eval import ycb as pycb
from perception_tpu_torch.io.images import decode_jpeg, read_png, read_rgb

from tests.test_fat import fat_root  # noqa: F401  (fixture)

# VFH descriptors of one view of n points from the same points: a point
# whose normal lands on the other side of a bin edge moves 1/n of the mass
# in up to five histograms (L1 up to 10 / n). At most two such points.
VFH_EDGE_POINTS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_frame(out, ref):
    for f in ("color", "depth", "label"):
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), f)
        assert getattr(out, f).dtype == getattr(ref, f).dtype, f
    assert out.gt_poses.keys() == ref.gt_poses.keys()
    for n in ref.gt_poses:
        np.testing.assert_array_equal(out.gt_poses[n], ref.gt_poses[n])
    assert dataclasses.asdict(out.intrinsics) == dataclasses.asdict(
        ref.intrinsics)
    assert (out.scene, out.frame, out.class_list) == \
        (ref.scene, ref.frame, ref.class_list)


def test_fat_reader_matches_jax(fat_root):  # noqa: F811
    """Scenes, classes, frames and every frame (the colour JPEG decoded to
    cv2's pixels, the label remap, cm -> m poses, intrinsics)."""
    ref, out = jfat.FATDataset(fat_root), pfat.FATDataset(fat_root)
    assert list(out.scenes) == list(ref.scenes) == ["kitchen_0"]
    assert out.classes == ref.classes
    assert out.frames("kitchen_0") == ref.frames("kitchen_0")
    for frame in ref.frames("kitchen_0"):
        _same_frame(out.load_frame("kitchen_0", frame),
                    ref.load_frame("kitchen_0", frame))


def test_fat_png_colour_frames_match_jax(fat_root):  # noqa: F811
    """A scene whose colour frames are PNGs (no .jpg): the same frames."""
    scene = os.path.join(fat_root, "kitchen_0")
    for f in os.listdir(scene):
        if f.endswith(".jpg"):
            img = cv2.imread(os.path.join(scene, f))
            cv2.imwrite(os.path.join(scene, f[:-4] + ".png"), img)
            os.remove(os.path.join(scene, f))
    ref, out = jfat.FATDataset(fat_root), pfat.FATDataset(fat_root)
    _same_frame(out.load_frame("kitchen_0", "000001"),
                ref.load_frame("kitchen_0", "000001"))


def test_fat_ycb_round_trip_matches_jax(fat_root, tmp_path):  # noqa: F811
    """convert_to_ycb_layout: the same files (PNGs that decode alike, the
    same .mat fields and text files), read back alike by both YCB
    readers."""
    from scipy.io import loadmat

    n_ref = jfat.convert_to_ycb_layout(jfat.FATDataset(fat_root),
                                       str(tmp_path / "j"))
    n_out = pfat.convert_to_ycb_layout(pfat.FATDataset(fat_root),
                                       str(tmp_path / "p"))
    assert n_out == n_ref == 2
    for rel in ("image_sets/classes.txt", "image_sets/keyframe.txt"):
        assert (tmp_path / "p" / rel).read_text() == \
            (tmp_path / "j" / rel).read_text()
    for frame in ("000000", "000001"):
        base = f"data/kitchen_0/{frame}"
        for kind in ("color", "depth", "label"):
            ref = cv2.imread(str(tmp_path / "j" / f"{base}-{kind}.png"),
                             cv2.IMREAD_UNCHANGED)
            if ref.ndim == 3:
                ref = ref[..., ::-1]
            np.testing.assert_array_equal(
                read_png(str(tmp_path / "p" / f"{base}-{kind}.png")), ref)
        a = loadmat(str(tmp_path / "j" / f"{base}-meta.mat"))
        b = loadmat(str(tmp_path / "p" / f"{base}-meta.mat"))
        for k in ("cls_indexes", "poses", "intrinsic_matrix",
                  "factor_depth"):
            np.testing.assert_array_equal(b[k], a[k], k)
        _same_frame(
            pycb.YCBVideoDataset(str(tmp_path / "p")).load_frame(
                "kitchen_0", frame),
            jycb.YCBVideoDataset(str(tmp_path / "j")).load_frame(
                "kitchen_0", frame))


def test_fat_coco_export_matches_jax(fat_root, tmp_path):  # noqa: F811
    ref = jfat.export_coco(jfat.FATDataset(fat_root), str(tmp_path / "j"))
    out = pfat.export_coco(pfat.FATDataset(fat_root), str(tmp_path / "p"))
    assert out == ref and len(out["annotations"]) == 4
    assert json.load(open(tmp_path / "p")) == json.load(open(tmp_path / "j"))


@pytest.mark.parametrize("case", ["random", "empty", "full", "first",
                                  "last", "one_row", "zero_size"])
def test_rle_encode_matches_jax(case):
    rng = np.random.default_rng(4)
    mask = {"random": rng.uniform(size=(23, 17)) < 0.3,
            "empty": np.zeros((5, 7), bool),
            "full": np.ones((5, 7), bool),
            "first": np.eye(6, dtype=bool),
            "last": np.arange(36).reshape(6, 6) == 35,
            "one_row": np.array([[0, 1, 1, 0, 1]], bool),
            "zero_size": np.zeros((0, 4), bool)}[case]
    assert pfat._rle_encode(mask) == jfat._rle_encode(mask)


def _shapestacks_fixture(root, colour_mask=False):
    """test_fat.py's ShapeStacks layout: one scenario of two blocks (plus a
    mirrored scenario and an excluded camera)."""
    scen = "env_ccs-easy-h=2-vcom=0-vpsf=0-n=2"
    sdir = root / "rec" / scen
    sdir.mkdir(parents=True)
    h, w = 48, 64
    rgb = np.zeros((h, w, 3), np.uint8)
    cv2.imwrite(str(sdir / f"rgb-{scen}-cam_2-r=1-mono-0.png"), rgb)
    m0 = np.zeros((h, w), np.uint8)
    m0[10:20, 12:30] = 255
    m1 = np.zeros((h, w), np.uint8)
    m1[25:40, 5:15] = 255
    if colour_mask:
        # Faint blue on the block, fainter on its top rows: OpenCV's grey
        # truncates those to 0.
        m1 = np.stack([m1 // 255 * np.uint8(9), np.zeros_like(m1),
                       np.zeros_like(m1)], axis=-1)
        m1[25:32, 5:15, 0] = 8
    cv2.imwrite(str(sdir / f"vseg-{scen}-cam_2-seg-0.png"), m0)
    cv2.imwrite(str(sdir / f"vseg-{scen}-cam_2-seg-1.png"), m1)
    (root / "rec" / (scen + "_r")).mkdir()
    cv2.imwrite(str(sdir / f"rgb-{scen}-cam_1-r=1-mono-0.png"), rgb)
    return scen


@pytest.mark.parametrize("colour_mask", [False, True])
def test_shapestacks_converter_matches_jax(tmp_path, colour_mask):
    """The same COCO instances (a colour mask read as OpenCV's grey), and
    main() writes them."""
    scen = _shapestacks_fixture(tmp_path, colour_mask)
    scenarios = [scen, scen + "_r"]
    rec = str(tmp_path / "rec")
    ref = jss.convert_shapestacks_coco(rec, scenarios, str(tmp_path / "j"))
    out = pss.convert_shapestacks_coco(rec, scenarios, str(tmp_path / "p"))
    assert out == ref and len(out["annotations"]) == 2
    assert pss.block_count(scen) == jss.block_count(scen) == 2
    name = f"rgb-{scen}-cam_2-r=1-mono-0.png"
    assert pss.seg_file_for(name, 1) == jss.seg_file_for(name, 1)
    with pytest.raises(ValueError):
        pss.block_count("no-count")
    (tmp_path / "list.json").write_text(json.dumps(scenarios))
    pss.main([rec, str(tmp_path / "list.json"), str(tmp_path / "m.json")])
    assert json.load(open(tmp_path / "m.json")) == json.loads(
        json.dumps(ref))


def test_dope_ingestion_matches_jax(tmp_path):
    """test_io_eval's DOPE dumps (an exact detection and a decoy, one 3 cm
    off, one missing): the same annotations and protocol metrics."""
    q = [0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)]
    np.testing.assert_array_equal(pdope.quat_xyzw_to_matrix(q),
                                  jdope.quat_xyzw_to_matrix(q))
    pts = np.array([[0.05, 0, 0], [0, 0.05, 0], [0, 0, 0.05],
                    [-0.05, 0, 0]])
    gt_pose = {"category_id": 1, "r": np.eye(3),
               "t": np.array([0.0, 0.0, 0.6])}
    json.dump([{"location": [0.0, 0.0, 60.0],
                "quaternion_xyzw": [0, 0, 0, 1], "category_id": 1, "id": 0},
               {"location": [100.0, 0.0, 60.0],
                "quaternion_xyzw": [0, 0, 0, 1], "category_id": 2, "id": 1},
               {"quaternion_xyzw": [0, 0, 0, 1], "category_id": 1}],
              open(tmp_path / "frame_a.json", "w"))
    json.dump({"annotations": [{"location": [3.0, 0.0, 60.0],
                                "quaternion_xyzw": q, "category_id": 1}]},
              open(tmp_path / "frame_b.json", "w"))
    for f in ("frame_a", "frame_b"):
        ref = jdope.load_dope_annotations(str(tmp_path / f"{f}.json"))
        out = pdope.load_dope_annotations(str(tmp_path / f"{f}.json"))
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    gt = {"frame_a": [gt_pose], "frame_b": [gt_pose], "frame_c": [gt_pose]}
    for sym in (frozenset(), {1}):
        ref = jdope.evaluate_dope_results(str(tmp_path), gt, {1: pts}, sym)
        out = pdope.evaluate_dope_results(str(tmp_path), gt, {1: pts}, sym)
        assert out.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], k)
        assert out["detected"] == 2 and out["errors"][2] == np.inf


def test_densefusion_ingestion_matches_jax(tmp_path):
    """test_io_eval's DenseFusion .mat dumps (exact, decoy, failed row; 3
    cm off; missing): the same detections and protocol metrics."""
    import scipy.io as scio

    q = [np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4)]
    np.testing.assert_array_equal(pdf.quat_wxyz_to_matrix(q),
                                  jdf.quat_wxyz_to_matrix(q))
    pts = np.array([[0.05, 0, 0], [0, 0.05, 0], [0, 0, 0.05],
                    [-0.05, 0, 0]])
    gt_pose = {"category_id": 1, "r": np.eye(3),
               "t": np.array([0.0, 0.0, 0.6])}
    scio.savemat(tmp_path / "0001.mat", {"poses": [
        [1.0, 0, 0, 0, 0.0, 0.0, 0.6], [1.0, 0, 0, 0, 1.0, 0.0, 0.6],
        [0.0] * 7]})
    scio.savemat(tmp_path / "0002.mat", {"poses": [
        [*q, 0.03, 0.0, 0.6]]})
    for ids in ([1, 2], None, [1]):
        ref = jdf.load_densefusion_mat(str(tmp_path / "0001.mat"), ids)
        out = pdf.load_densefusion_mat(str(tmp_path / "0001.mat"), ids)
        assert len(out) == len(ref) == 2
        for a, b in zip(out, ref):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    gt = {"0001": [gt_pose], "0002": [gt_pose], "0003": [gt_pose]}
    for class_ids in ({"0001": [1, 2], "0002": [1]}, None):
        ref = jdf.evaluate_densefusion_results(str(tmp_path), gt, {1: pts},
                                               class_ids)
        out = pdf.evaluate_densefusion_results(str(tmp_path), gt, {1: pts},
                                               class_ids)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], k)


def test_compute_vfh_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.normal(0, 0.05, (300, 3)) + [0, 0, 0.7]
    nrm = rng.normal(size=(300, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    for vp in (None, np.array([0.1, -0.2, 0.0])):
        out = pvfh.compute_vfh(pts, nrm, vp)
        np.testing.assert_array_equal(out, jvfh.compute_vfh(pts, nrm, vp))
        assert out.shape == (308,)
    # A degenerate cloud: one point.
    np.testing.assert_array_equal(pvfh.compute_vfh(pts[:1], nrm[:1]),
                                  jvfh.compute_vfh(pts[:1], nrm[:1]))


def _vfh_envs():
    """test_aux's estimator env (the box scene's models; the camera frame is
    the world frame) and the port's over the same bank and configuration."""
    from perception_tpu.pipeline.env import RecognitionInput as JInput
    from perception_tpu_torch.core.config import (
        CameraIntrinsics,
        EnvConfig,
        PerchConfig,
    )
    from perception_tpu_torch.pipeline.env import PerceptionEnv

    from tests.test_pipeline import make_env

    jenv = make_env()
    jenv._input = JInput(depth_image=np.zeros((96, 128)),
                         cam_to_world=np.eye(4))
    penv = PerceptionEnv(convert.bank_from_jax(jenv.bank),
                         convert.dataclass_from_jax(jenv.camera,
                                                    CameraIntrinsics),
                         convert.dataclass_from_jax(jenv.perch, PerchConfig),
                         convert.dataclass_from_jax(jenv.env, EnvConfig),
                         device="cpu")
    penv._input = convert.input_from_jax(jenv._input)
    return jenv, penv


def test_vfh_estimator_matches_jax(monkeypatch):
    """test_aux's estimator (8 views at 0.7 m) with the port's env rendering
    JAX's views (the same clouds; the normals from each package's k-NN):
    the same views, orientations and descriptors but for the points whose
    normal lands across a bin edge; a training view's own cloud matches
    the same views in both packages."""
    from perception_tpu.core.pose import ContPose
    from perception_tpu.core.state import ObjectState

    jenv, penv = _vfh_envs()
    monkeypatch.setattr(
        penv, "render_composite",
        lambda states: jenv.render_composite([
            ObjectState(id=s.id, symmetric=s.symmetric,
                        segmentation_label_id=s.segmentation_label_id,
                        pose=ContPose.from_quat(s.pose.x, s.pose.y, s.pose.z,
                                                *s.pose.quaternion()))
            for s in states]))
    ref, out = jvfh.VFHPoseEstimator(jenv), pvfh.VFHPoseEstimator(penv)
    with pytest.raises(RuntimeError, match="train"):
        out.estimate(np.zeros((20, 3)), np.ones((20, 3)))
    assert out.train(num_views=8, distance=0.7) == \
        ref.train(num_views=8, distance=0.7) >= 8
    names = jenv.bank.names
    for a, b in zip(out.entries, ref.entries):
        assert (a.name, a.roll, a.pitch, a.yaw) == \
            (b.name, b.roll, b.pitch, b.yaw)
        n = len(ref._view_cloud(ObjectState(
            id=names.index(b.name), symmetric=False, segmentation_label_id=1,
            pose=ContPose.from_euler(0, 0, 0.7, 0, b.pitch, b.yaw)))[0])
        l1 = np.abs(a.descriptor - b.descriptor).sum()
        assert l1 * n <= 10 * VFH_EDGE_POINTS + 1e-6, (b.name, n, l1)
    e = ref.entries[0]
    state = ObjectState(id=1, symmetric=False, segmentation_label_id=1,
                        pose=ContPose.from_euler(0, 0, 0.7, 0, e.pitch,
                                                 e.yaw))
    pts, nrm = ref._view_cloud(state)
    got = out.estimate(pts, nrm, k=3)
    want = ref.estimate(pts, nrm, k=3)
    assert [(m.name, m.yaw) for m in got] == [(m.name, m.yaw) for m in want]
    assert any(m.name == "green_box" for m in got)


def test_vfh_views_render_like_jax():
    """The estimator's view clouds through the port's own render (the
    direct raster twin): JAX's points but for silhouette pixels."""
    from perception_tpu.core.pose import ContPose
    from perception_tpu.core.state import ObjectState

    jenv, penv = _vfh_envs()
    ref, out = jvfh.VFHPoseEstimator(jenv), pvfh.VFHPoseEstimator(penv)
    for mid, (pitch, yaw) in enumerate([(0.3, -0.8), (1.0, 2.0)]):
        state = ObjectState(id=mid, symmetric=False, segmentation_label_id=1,
                            pose=ContPose.from_euler(0, 0, 0.7, 0, pitch,
                                                     yaw))
        pts, nrm = ref._view_cloud(state)
        p_pts, p_nrm = out._view_cloud(convert.states_from_jax([state])[0])
        same = {tuple(p) for p in p_pts.round(6)} & {
            tuple(p) for p in pts.round(6)}
        assert len(same) >= 0.9 * max(len(pts), len(p_pts))
        assert np.isfinite(p_nrm).all()
        np.testing.assert_allclose(np.linalg.norm(p_nrm, axis=1), 1.0,
                                   atol=1e-4)


def test_demo_frame_models_env_and_transforms_match_jax(tmp_path,
                                                        monkeypatch):
    """The proxy models, the env's configuration and bank, the camera pose,
    bounds and optical -> body rotation, and the frame's input from a
    synthetic capture: as JAX's. Where the reference's capture is on disk,
    the search on it lands each proxy within 8 cm of the frozen pseudo-GT
    (JAX's own test)."""
    for ref, out in zip(jdemo.build_models(), pdemo.build_models()):
        a = dataclasses.asdict(out)
        b = dataclasses.asdict(convert.dataclass_from_jax(ref,
                                                          pmesh.MeshModel))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)
    for k in ("CAMERA_POSE", "CAM_TO_BODY"):
        np.testing.assert_array_equal(getattr(pdemo, k), getattr(jdemo, k))
    assert pdemo.BOUNDS == jdemo.BOUNDS
    assert pdemo.available() == jdemo.available()
    assert pdemo.load_pseudo_gt() == jdemo.load_pseudo_gt()
    assert pdemo.PSEUDO_GT_PATH == jdemo.PSEUDO_GT_PATH
    jenv = jdemo.build_env(stride=8, res=0.04, theta_res=np.pi / 4)
    penv = pdemo.build_env(stride=8, res=0.04, theta_res=np.pi / 4,
                           device="cpu")
    assert dataclasses.asdict(penv.perch) == dataclasses.asdict(jenv.perch)
    assert dataclasses.asdict(penv.env) == dataclasses.asdict(jenv.env)
    assert dataclasses.asdict(penv.camera) == dataclasses.asdict(jenv.camera)
    np.testing.assert_array_equal(penv.bank.tri_verts, jenv.bank.tri_verts)

    # A synthetic capture in the reference's layout, fed to both.
    rng = np.random.default_rng(2)
    cv2.imwrite(str(tmp_path / "demo_depth.png"),
                rng.integers(4000, 12000, (480, 640)).astype(np.uint16))
    cv2.imwrite(str(tmp_path / "demo_rgb.png"),
                rng.integers(0, 255, (480, 640, 3)).astype(np.uint8))
    inputs = []
    for mod, env in ((jdemo, jenv), (pdemo, penv)):
        monkeypatch.setattr(mod, "DEMO_DIR", str(tmp_path))
        monkeypatch.setattr(env, "set_input", inputs.append)
        depth, rgb = mod.load_input(env)
        assert depth.dtype == np.uint16 and rgb.shape == (480, 640, 3)
    ref, out = (dataclasses.asdict(r) for r in inputs)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], k)
    monkeypatch.undo()

    gt = pdemo.load_pseudo_gt()
    if pdemo.available() and gt is not None:
        pdemo.load_input(penv)
        state, _ = pdemo.localise(penv)
        assert state.num_objects == 3
        for sel in state.object_states:
            p = gt["poses"][penv.bank.models[sel.id].name]
            assert np.hypot(sel.pose.x - p["x"], sel.pose.y - p["y"]) < 0.08


# ---------------------------------------------------------------------------
# Baseline JPEG against cv2.imread.

def _test_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth colour ramps plus noise: every frequency, every chroma."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 120,
                     (x + y) % 256], axis=-1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("size", [(96, 128), (37, 23)])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_jpeg_matches_cv2(tmp_path, sampling, restart, size):
    """Baseline files that cv2 writes here, each sampling, with and without
    restart markers, at a size that is and one that is not a multiple of
    the MCU: every sample within 1 level of cv2.imread on >= 99% (here,
    all equal)."""
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    params = [cv2.IMWRITE_JPEG_QUALITY, 90,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    path = str(tmp_path / "frame.jpg")
    assert cv2.imwrite(path, _test_image(*size)[..., ::-1], params)
    ref = cv2.imread(path)[..., ::-1]
    out = read_rgb(path)
    assert out.shape == ref.shape and out.dtype == np.uint8
    diff = np.abs(out.astype(np.int64) - ref)
    assert (diff <= 1).mean() >= 0.99
    np.testing.assert_array_equal(out, ref)


def test_jpeg_grey_and_refusals(tmp_path):
    """A greyscale JPEG comes back as three equal channels, as cv2 reads
    it; a progressive file, a truncated one and a non-JPEG raise."""
    path = str(tmp_path / "grey.jpg")
    assert cv2.imwrite(path, _test_image(50, 70)[..., 0])
    np.testing.assert_array_equal(read_rgb(path), cv2.imread(path)[..., ::-1])
    ok, buf = cv2.imencode(".jpg", _test_image(40, 40),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(buf.tobytes())
    ok, buf = cv2.imencode(".jpg", _test_image(40, 40))
    with pytest.raises(ValueError, match="truncated"):
        decode_jpeg(buf.tobytes()[:len(buf) // 2])
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG....")
