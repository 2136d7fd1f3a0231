"""The port's evaluation drivers against the JAX package: the YCB-Video
reader and its keyframe sweep (`eval/ycb.py`), the workloads
(`eval/workloads.py`) and the view generator (`tools/view_generator.py`).

Inputs are the JAX tests' own: the 128x96 dataset that
tests/test_ycb_driver.py generates (three zoo models from PLY files, seed
11, three scenes of two objects), tests/test_workloads.py's box scenes, and
test_aux.py's box for the views. The port runs on the CPU (the PyTorch
twins). Without ICP (PerchConfig.icp_type 0) the two packages score the same
candidates to the same detections, within 1 mm, with per-object errors
equal to 1e-6 m and the same AUC. With ICP on, a few detections follow ICP
trajectories that part between the two packages' arithmetic (ROADMAP.md,
"Divergent ICP trajectories"): they are named in YCB_ICP_DIVERGENT, and
exactly those are more than 1 mm apart.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import chip_smoke  # noqa: E402

from perception_tpu.core.config import EnvConfig as JEnvConfig
from perception_tpu.core.config import PerchConfig as JPerchConfig
from perception_tpu.eval import dataset_gen as jgen
from perception_tpu.eval import workloads as jwork
from perception_tpu.eval import ycb as jycb
from perception_tpu.pipeline.recognizer import ModelSpec as JModelSpec
from perception_tpu.pipeline.recognizer import ObjectRecognizer as JRecognizer
from perception_tpu.tools import view_generator as jviews
from perception_tpu_torch import convert
from perception_tpu_torch.core.config import (
    CameraIntrinsics,
    EnvConfig,
    PerchConfig,
)
from perception_tpu_torch.eval import workloads as pwork
from perception_tpu_torch.eval import ycb as pycb
from perception_tpu_torch.pipeline.recognizer import (
    ModelSpec,
    ObjectRecognizer,
)
from perception_tpu_torch.tools import view_generator as pviews

from tests.test_torch_deploy import _silhouette
from tests.test_ycb_driver import CAM

PCAM = convert.dataclass_from_jax(CAM, CameraIntrinsics)
NAME_MAP = {"003_cracker_box": "cracker_box", "024_bowl": "bowl",
            "005_tomato_soup_can": "soup_can"}
# (scene, object) -> detected more than 1 mm apart in the two packages with
# the fused p2p ICP on (JAX's Pallas kernel in interpret mode): each
# package's winning candidate ends where its own ICP takes it.
YCB_ICP_DIVERGENT = {("0001", "003_cracker_box"),
                     ("0003", "005_tomato_soup_can")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perch(icp_type: int) -> JPerchConfig:
    """test_ycb_driver's PerchConfig, in batches of 128 (a frame's ~100
    candidates in one batch, half the padding of 256; a pose scores the
    same in any batch)."""
    return JPerchConfig(gpu_stride=2, gpu_batch_size=128,
                        sensor_resolution=0.02,
                        min_neighbor_points_for_valid_pose=5,
                        max_icp_iterations=20, icp_type=icp_type)


def _env_cfg(**kw) -> JEnvConfig:
    return JEnvConfig(width=CAM.width, height=CAM.height,
                      max_points_per_pose=512, max_observed_points=4096,
                      max_points_per_label=1024, max_labels=4, **kw)


@pytest.fixture(scope="module")
def ycb(tmp_path_factory):
    """test_generated_ycb_dataset_sweep's dataset, written by the JAX
    generator: (root, model specs, keyframes, scenes)."""
    root = str(tmp_path_factory.mktemp("ycb"))
    paths = jgen.write_zoo_plys(root, NAME_MAP)
    specs = [JModelSpec(name=n, path=p,
                        symmetric=n in ("024_bowl", "005_tomato_soup_can"))
             for n, p in paths.items()]
    rec = JRecognizer(specs, CAM, _perch(3), _env_cfg(),
                      use_external_pose_list=True, target_triangles=1024)
    gen = jgen.DatasetGenerator(rec.env, rng=np.random.default_rng(11))
    scenes = [gen.sample_scene(num_objects=2, yaw_only=True)
              for _ in range(3)]
    keyframes = jgen.write_ycb_layout(root, rec.env, scenes)
    return root, specs, keyframes, scenes


def _recognizers(specs, icp_type: int, **env_kw):
    """The JAX recogniser and the port's (CPU) over the same PLY files and
    configuration."""
    perch, env_cfg = _perch(icp_type), _env_cfg(**env_kw)
    jrec = JRecognizer(specs, CAM, perch, env_cfg,
                       use_external_pose_list=True, target_triangles=1024)
    prec = ObjectRecognizer(
        [ModelSpec(**dataclasses.asdict(s)) for s in specs], PCAM,
        convert.dataclass_from_jax(perch, PerchConfig),
        convert.dataclass_from_jax(env_cfg, EnvConfig, kernel_backend="auto"),
        use_external_pose_list=True, target_triangles=1024, device="cpu")
    np.testing.assert_array_equal(prec.bank.tri_verts, jrec.bank.tri_verts)
    return jrec, prec


def _read_poses(path) -> dict:
    """output_poses.txt -> {name: translation [3]}."""
    lines = open(path).read().split("\n")
    return {lines[i - 1]: np.array(lines[i].split()[1:], float)
            for i, l in enumerate(lines) if l.startswith("translation")}


def _compare_sweeps(ref: dict, out: dict, keyframes, jout, pout,
                    divergent=frozenset()):
    """Detections within 1 mm except `divergent` (which must part by more);
    per-object errors to 1e-6 m and the AUC over the others."""
    far = set()
    for sdir, fid in keyframes:
        a = _read_poses(f"{jout}/{sdir}_{fid}/output_poses.txt")
        b = _read_poses(f"{pout}/{sdir}_{fid}/output_poses.txt")
        assert a.keys() == b.keys() and a
        far |= {(sdir, n) for n in a if np.abs(a[n] - b[n]).max() > 1e-3}
    assert far == set(divergent), far
    assert out.keys() == ref.keys()
    assert out["objects"].keys() == ref["objects"].keys()
    for name, m in ref["objects"].items():
        if any(n == name for _, n in divergent):
            continue
        for k, v in m.items():
            np.testing.assert_allclose(out["objects"][name][k], v, atol=1e-6)
    if not divergent:
        for k, v in ref["overall"].items():
            np.testing.assert_allclose(out["overall"][k], v, atol=1e-6)
    assert json.load(open(f"{pout}/accuracy.json")) == json.loads(
        json.dumps(out))


def test_ycb_reader_matches_jax(ycb):
    """The same classes, keyframes and frames (RGB, 16-bit depth, class-id
    labels, GT poses, intrinsics) as the JAX reader (OpenCV); the depth PNG
    holds the cm render to half a unit."""
    root, _, keyframes, scenes = ycb
    jds, pds = jycb.YCBVideoDataset(root), pycb.YCBVideoDataset(root)
    assert pds.classes == jds.classes == list(NAME_MAP)
    assert pds.keyframes() == jds.keyframes() == keyframes
    for key, scene in zip(keyframes, scenes):
        a, b = jds.load_frame(*key), pds.load_frame(*key)
        for f in ("color", "depth", "label"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
        assert b.color.dtype == np.uint8 and b.depth.dtype == np.uint16
        assert b.gt_poses.keys() == a.gt_poses.keys()
        for n in a.gt_poses:
            np.testing.assert_array_equal(b.gt_poses[n], a.gt_poses[n])
        assert dataclasses.asdict(b.intrinsics) == dataclasses.asdict(
            a.intrinsics)
        assert b.class_list == a.class_list
        np.testing.assert_allclose(b.depth.astype(np.float64) / 100.0,
                                   scene.depth, atol=0.5)
        np.testing.assert_array_equal(
            pycb.mask_from_labels(b.label, [1, 3]),
            jycb.mask_from_labels(a.label, [1, 3]))


@pytest.mark.parametrize("icp", [False, True], ids=["no_icp", "fused_icp"])
def test_run_dataset_matches_jax(ycb, icp, tmp_path):
    """The keyframe sweep (num_samples 16, as the JAX test): without ICP the
    same detections and report; with the fused p2p ICP (JAX's kernel in
    interpret mode) all but YCB_ICP_DIVERGENT."""
    root, specs, keyframes, _ = ycb
    kw = (dict(icp_mode="fused", kernel_backend="pallas_direct_interpret")
          if icp else {})
    jrec, prec = _recognizers(specs, 3 if icp else 0, **kw)
    ref = jycb.run_dataset(jrec, jycb.YCBVideoDataset(root), num_samples=16,
                           output_root=str(tmp_path / "j"))
    out = pycb.run_dataset(prec, pycb.YCBVideoDataset(root), num_samples=16,
                           output_root=str(tmp_path / "p"))
    _compare_sweeps(ref, out, keyframes, tmp_path / "j", tmp_path / "p",
                    YCB_ICP_DIVERGENT if icp else frozenset())
    assert len(out["objects"]) == 3


@pytest.mark.parametrize("mode", ["posecnn", "detections"])
def test_evaluate_frame_mask_modes_match_jax(ycb, mode, tmp_path):
    """The PoseCNN and COCO-detection mask modes on the first keyframe
    (PoseCNN's labels and ROIs, and chip_smoke's COCO file of the label
    image's instances in the ported RLE, made from its GT label image),
    without ICP: the same detections and errors as JAX."""
    root, specs, keyframes, _ = ycb
    jrec, prec = _recognizers(specs, 0)
    scene, fid = keyframes[0]
    frame = pycb.YCBVideoDataset(root).load_frame(scene, fid)
    kw = {}
    if mode == "posecnn":
        from scipy.io import savemat

        rois = []
        for cid in np.unique(frame.label[frame.label > 0]):
            ys, xs = np.nonzero(frame.label == cid)
            rois.append([0, cid, xs.min() - 1, ys.min() - 1, xs.max() + 1,
                         ys.max() + 1])
        savemat(str(tmp_path / f"{int(fid):06d}.mat"),
                {"labels": frame.label.astype(np.int32),
                 "rois": np.asarray(rois, np.float64)})
        kw["posecnn_root"] = str(tmp_path)
    else:
        chip_smoke.coco_detections(frame, tmp_path / "detections.json")
        kw["detections_json"] = str(tmp_path / "detections.json")
    ref = jycb.evaluate_frame(
        jrec, jycb.YCBVideoDataset(root).load_frame(scene, fid),
        num_samples=16, mask_mode=mode, **kw)
    out = pycb.evaluate_frame(prec, frame, num_samples=16, mask_mode=mode,
                              **kw)
    assert out.detected == ref.detected and len(out.detected) == 2
    for name in ref.errors:
        for f in ("errors", "add_errors", "adis_errors"):
            np.testing.assert_allclose(getattr(out, f)[name],
                                       getattr(ref, f)[name], atol=1e-6)
    with pytest.raises(ValueError, match="unknown mask_mode"):
        pycb.evaluate_frame(prec, frame, mask_mode="mrcnn")


# ---------------------------------------------------------------------------
# Workloads (tests/test_workloads.py's box scenes).

@pytest.fixture
def box_envs():
    """test_workloads's box env (JAX, ICP off) and the port's recogniser
    over its model and configuration."""
    from tests.test_workloads import _BoxRecognizer, box_env

    env = box_env.__wrapped__()
    env.perch = dataclasses.replace(env.perch, icp_type=0)
    prec = ObjectRecognizer.from_models(
        convert.models_from_jax(env.bank.models), PCAM,
        convert.dataclass_from_jax(env.perch, PerchConfig),
        convert.dataclass_from_jax(env.env, EnvConfig, icp_mode="nn",
                                   kernel_backend="auto"),
        t_cap=16, device="cpu")
    return env, _BoxRecognizer(env), prec


def _render(env, states):
    from perception_tpu.pipeline.env import RecognitionInput

    env._input = RecognitionInput(
        depth_image=np.zeros((CAM.height, CAM.width)),
        cam_to_world=np.eye(4))
    return env.render_composite(states)


def test_run_sameshape_matches_jax(box_envs):
    """Two instances of one model as `box#1` / `box#2` (40 samples): the
    same two detections."""
    from perception_tpu.core.pose import ContPose
    from perception_tpu.core.state import ObjectState

    env, jrec, prec = box_envs
    gt = [ObjectState(id=0, symmetric=False, segmentation_label_id=k + 1,
                      pose=ContPose.from_quat(x, y, z, 0, 0, 0, 1))
          for k, (x, y, z) in enumerate([(-0.10, 0.0, 0.55),
                                         (0.10, 0.02, 0.60)])]
    depth, _, label = _render(env, gt)
    depth_sensor = depth.astype(np.float64) * 100.0
    ref = jwork.run_sameshape(jrec, depth_sensor, label, "box", 2, CAM,
                              depth_factor=10000.0, num_samples=40)
    out = pwork.run_sameshape(prec, depth_sensor, label, "box", 2, PCAM,
                              depth_factor=10000.0, num_samples=40)
    assert out.names == ["box#1", "box#2"] and len(ref.poses) == 2
    for p, q in zip(out.poses, ref.poses):
        np.testing.assert_allclose(p.transform(), q.transform(), atol=1e-6)
    assert pwork.run_crate is pwork.run_sameshape


def test_run_on_conveyor_matches_jax(box_envs):
    """Two frames with warm start (20 samples): the same detections and
    errors per frame, each frame's detection carried to the next; a
    sparse sweep (4 samples) with the ground truth injected lands on it in
    both packages, with the fused ICP on too."""
    from perception_tpu.core.pose import ContPose
    from perception_tpu.core.state import ObjectState

    env, jrec, prec = box_envs
    pose = ContPose.from_quat(0.02, -0.01, 0.55, 0, 0, 0, 1)
    depth, color, label = _render(env, [ObjectState(
        id=0, symmetric=False, pose=pose, segmentation_label_id=1)])
    gt_raw = pose.transform() @ env.bank.models[0].preprocessing_transform
    jframes, pframes = [], []
    for idx in ("000001", "000002"):
        kw = dict(scene="conv", frame=idx, color=color.astype(np.uint8),
                  depth=(depth.astype(np.float64) * 100.0).astype(np.uint16),
                  label=label.astype(np.uint8), gt_poses={"box": gt_raw},
                  class_list=["box"])
        jframes.append(jycb.YCBFrame(intrinsics=CAM, **kw))
        pframes.append(pycb.YCBFrame(intrinsics=PCAM, **kw))
    ref = jwork.run_on_conveyor(jrec, jframes, object_names=["box"],
                                num_samples=20)
    out = pwork.run_on_conveyor(prec, pframes, object_names=["box"],
                                num_samples=20)
    for a, b in zip(ref, out):
        assert b.detected == a.detected == ["box"]
        np.testing.assert_allclose(b.errors["box"], a.errors["box"],
                                   atol=1e-6)
        np.testing.assert_allclose(b.detected_poses["box"],
                                   a._detected_poses["box"], atol=1e-6)
    assert out[1].errors["box"] <= out[0].errors["box"] + 1e-9

    q = pose.quaternion()
    gt_rows = {"box": np.asarray([[pose.x, pose.y, pose.z, *q]])}
    for icp_type in (0, 3):
        env.perch = dataclasses.replace(env.perch, icp_type=icp_type)
        prec.env.perch = dataclasses.replace(prec.env.perch,
                                             icp_type=icp_type)
        warm = pwork._evaluate_with_extra_candidates(
            prec, pframes[1], gt_rows, ["box"], 4, None)
        ref_warm = jwork._evaluate_with_extra_candidates(
            jrec, jframes[1], gt_rows, ["box"], 4, None)
        np.testing.assert_allclose(warm.errors["box"],
                                   ref_warm.errors["box"], atol=1e-6)
        assert warm.errors["box"] < 0.01


# ---------------------------------------------------------------------------
# The view generator.

def test_generate_views_matches_jax(monkeypatch):
    """test_aux's box at level 0 (12 views, 96x96, stride 2): the same poses
    and view order; the depth of every view equal to JAX's (its XLA raster)
    off the silhouette pixels, where the two rasters may split a pixel
    either way."""
    from perception_tpu.core.mesh import mesh_model_from_arrays
    from perception_tpu.ops import rasterizer as jras
    from perception_tpu_torch.ops import rasterizer as pras

    from tests.test_core import make_box

    for level in range(3):
        np.testing.assert_array_equal(pviews.icosphere_vertices(level),
                                      jviews.icosphere_vertices(level))
        for v in pviews.icosphere_vertices(level):
            np.testing.assert_array_equal(pviews.look_at_pose(v, 0.7),
                                          jviews.look_at_pose(v, 0.7))
    verts, faces = make_box(0.12, 0.1, 0.08)
    model = mesh_model_from_arrays("box", verts, faces)
    from perception_tpu.core.config import CameraIntrinsics as JCam

    jcam = JCam(fx=120.0, fy=120.0, cx=48.0, cy=48.0, width=96, height=96)
    depths = {}

    def capture(mod, key):
        fn = mod.render_pose_batch

        def call(*a, **k):
            out = fn(*a, **k)
            depths[key] = np.asarray(out.depth)
            return out
        monkeypatch.setattr(mod, "render_pose_batch", call)

    capture(jras, "jax")
    capture(pras, "port")
    ref = jviews.generate_views(model, jcam, level=0, distance=0.7, stride=2)
    out = pviews.generate_views(
        convert.models_from_jax([model])[0],
        convert.dataclass_from_jax(jcam, CameraIntrinsics), level=0,
        distance=0.7, stride=2, device="cpu")
    np.testing.assert_array_equal(out[1], ref[1])
    a, b = depths["jax"], depths["port"]
    assert a.shape == b.shape == (12, 48, 48)
    for i in range(12):
        edge = _silhouette((a[i] > 0).astype(np.int32)) | _silhouette(
            (b[i] > 0).astype(np.int32))
        np.testing.assert_array_equal(a[i][~edge], b[i][~edge])
        assert (a[i] > 0).sum() > 10
        assert abs(len(out[0][i]) - len(ref[0][i])) <= edge.sum()
    np.testing.assert_allclose(out[2], ref[2], atol=0.05)
    assert out[2].max() == 1.0 and out[2].min() > 0.0


def test_view_generator_main_writes_jax_banks(tmp_path):
    """`python -m ...tools.view_generator models/ out/ --device cpu` at
    level 0: one <name>-views.npz per PLY with JAX's keys and poses."""
    from tests.test_search_e2e import _write_box_ply

    models = tmp_path / "models"
    models.mkdir()
    _write_box_ply(models / "crate.ply", 0.12, 0.08, 0.10, (200, 40, 40))
    args = [str(models), "--level=0", "--resolution=64", "--distance=0.7"]
    assert jviews.main([args[0], str(tmp_path / "j"), *args[1:]]) == 0
    assert pviews.main([args[0], str(tmp_path / "p"), *args[1:],
                        "--device", "cpu"]) == 0
    ref = np.load(tmp_path / "j" / "crate-views.npz")
    out = np.load(tmp_path / "p" / "crate-views.npz")
    assert sorted(out.files) == sorted(ref.files)
    np.testing.assert_array_equal(out["poses"], ref["poses"])
    assert len(ref["poses"]) == 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pviews.main([args[0], str(tmp_path / "c"), *args[1:]])


def ycb_sweep_agreement() -> None:
    """chip_smoke.py's YCB sweep and conveyor on the CPU: its dataset (the
    generator on the PyTorch twins renders what the card's kernels render),
    run by the port's CPU twins and by JAX (its Pallas kernels in
    interpret mode) over the same files and candidates. Prints one JSON
    line per object and run: the translation error in each package and the
    port's detected translation, which chip_smoke.YCB_REFERENCE_MISSES
    records for the objects JAX puts more than 20 mm off."""
    import tempfile
    from pathlib import Path

    from perception_tpu.eval.ycb import YCB_CAMERA as JYCB_CAMERA

    torch.set_num_threads(8)
    with tempfile.TemporaryDirectory() as tmp:
        data = chip_smoke.make_ycb_dataset(Path(tmp), "cpu")
        prec, ns = data["rec"], data["num_samples"]
        print(json.dumps({"num_samples": ns,
                          "candidates": data["candidates"]}), flush=True)
        cfg = chip_smoke.deploy_config({})
        perch = {k: v for k, v in cfg.items()
                 if k not in ("camera", "model_bank", "env_params")}
        perch["gpu_batch_size"] = prec.env.perch.gpu_batch_size
        jrec = JRecognizer(
            [JModelSpec(name=s.name, path=s.path, symmetric=s.symmetric)
             for s in prec.specs], JYCB_CAMERA, JPerchConfig(**perch),
            JEnvConfig(**dict(cfg["env_params"],
                              kernel_backend="pallas_direct_interpret")),
            use_external_pose_list=True)
        root = str(Path(tmp) / "ycb")
        pframes = [pycb.YCBVideoDataset(root).load_frame(*k)
                   for k in data["keyframes"]]
        jframes = [jycb.YCBVideoDataset(root).load_frame(*k)
                   for k in data["keyframes"]]
        # evaluate_frame with the GT masks; JAX's keeps the detected poses
        # only through the conveyor's helper, which runs the same frame.
        port = {"sweep": [pycb.evaluate_frame(prec, f, num_samples=ns)
                          for f in pframes],
                "conveyor": pwork.run_on_conveyor(prec, pframes,
                                                  num_samples=ns)}
        jax = {"sweep": [jwork._evaluate_with_extra_candidates(
                   jrec, f, None, None, ns, None) for f in jframes],
               "conveyor": jwork.run_on_conveyor(jrec, jframes,
                                                 num_samples=ns)}
        jax = {run: [{n: r[0, :3] for n, r in res._detected_poses.items()}
                     for res in results] for run, results in jax.items()}
        for run in ("sweep", "conveyor"):
            errors = chip_smoke.ycb_errors(data, port[run])
            for f, jt in zip(pframes, jax[run]):
                for name, row in errors[f.scene].items():
                    pre = prec.bank.models[prec.bank.index_of(
                        name)].preprocessing_transform
                    t_gt = (f.gt_poses[name] @ np.linalg.inv(pre))[:3, 3]
                    print(json.dumps({
                        "run": run, "frame": f.scene, "object": name,
                        "visible_share": row["visible_share"],
                        "port_mm": 1e3 * row.get("translation_m", np.nan),
                        "jax_mm": (1e3 * float(np.linalg.norm(jt[name] - t_gt))
                                   if name in jt else None),
                        "port_translation": row.get("translation")}),
                        flush=True)


if __name__ == "__main__":
    ycb_sweep_agreement()
