"""The port's `localize` CLI against the JAX package's, and its jax-free
readers: PNG images (`io.images`) and external-detection masks
(`io.masks`).

The scene is test_search_e2e's CLI scene (two 12-triangle boxes on disk,
the JAX render of the ground truth as 16-bit depth, mask and RGB PNGs
written by OpenCV, GT + 6 jittered candidates per object). The JAX CLI runs
the direct raster, fused ICP and fused cost Pallas kernels in interpret
mode; the port runs the scatter-bin raster ("pallas_bin") on the CPU twins.
Tolerance: the same detections, output translations within 1 mm (the slice
tests' bar).
"""

import json
import struct
import sys
import zlib

import dataclasses

import cv2
import numpy as np
import pytest
import torch

from perception_tpu.cli import main as jax_cli
from perception_tpu.core.pose import CAM_TO_BODY
from perception_tpu.io import masks as jmasks
from perception_tpu_torch import cli, convert
from perception_tpu_torch.io import masks as pmasks
from perception_tpu_torch.io.images import read_png, write_png
from perception_tpu_torch.io.poses_file import read_output_poses
from perception_tpu_torch.kernels import build

from tests.test_pipeline import CAM, gt_states, make_env
from tests.test_search_e2e import _write_box_ply
from tests.test_torch_scorer import _port_modules


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NAMES = ["red_box", "green_box"]


def _config(backend: str) -> dict:
    return {
        "camera": {"fx": CAM.fx, "fy": CAM.fy, "cx": CAM.cx, "cy": CAM.cy,
                   "width": CAM.width, "height": CAM.height},
        "input": {"depth_image": "depth.png", "color_image": "rgb.png",
                  "label_mask": "mask.png", "depth_factor": 1000,
                  "cam_to_world": CAM_TO_BODY.tolist(),
                  "segmented_object_names": NAMES},
        "model_bank": [{"name": n, "path": f"models/{n}.ply"} for n in NAMES],
        "rendered_root_dir": "rendered",
        "mode": "greedy",
        "use_external_pose_list": 1,
        "perch_params": {"gpu_stride": 2, "gpu_batch_size": 16,
                         "sensor_resolution_radius": 0.02,
                         "min_neighbor_points_for_valid_pose": 5,
                         "icp_type": 3, "max_icp_iterations": 10},
        "env_params": {"max_points_per_pose": 512, "max_observed_points": 4096,
                       "max_points_per_label": 1024, "max_labels": 4,
                       "max_triangles_per_model": 16, "icp_mode": "fused",
                       "kernel_backend": backend},
    }


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene's files, and the JAX CLI's output_poses.txt records."""
    import yaml

    root = tmp_path_factory.mktemp("cli_scene")
    (root / "models").mkdir()
    _write_box_ply(root / "models" / "red_box.ply", 0.12, 0.08, 0.10,
                   (200, 40, 40))
    _write_box_ply(root / "models" / "green_box.ply", 0.06, 0.06, 0.16,
                   (40, 200, 40))
    gt = gt_states()
    depth, color, label = make_env().render_composite(gt)
    cv2.imwrite(str(root / "depth.png"),
                (depth.astype(np.float64) * 10).astype(np.uint16))
    cv2.imwrite(str(root / "mask.png"), label.astype(np.uint8))
    cv2.imwrite(str(root / "rgb.png"), color[..., ::-1].astype(np.uint8))
    rng = np.random.default_rng(11)
    for obj, name in zip(gt, NAMES):
        d = root / "rendered" / name
        d.mkdir(parents=True)
        rows = [[obj.pose.x, obj.pose.y, obj.pose.z, *obj.pose.quaternion()]]
        for _ in range(6):
            j = rng.normal(0, 0.02, 3)
            rows.append([obj.pose.x + j[0], obj.pose.y + j[1],
                         obj.pose.z + j[2], *obj.pose.quaternion()])
        np.savetxt(d / "poses.txt", np.asarray(rows))
    (root / "jax.yaml").write_text(
        yaml.safe_dump(_config("pallas_direct_interpret")))
    cfg = _config("pallas_bin")
    (root / "scene.json").write_text(json.dumps(cfg))
    (root / "scene.yaml").write_text(yaml.safe_dump(cfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PT_COMPILATION_CACHE", "0")
        assert jax_cli(["localize", "--config", str(root / "jax.yaml"),
                        "--output", str(root / "jax_out")]) == 0
    return root, read_output_poses(str(root / "jax_out" / "output_poses.txt"))


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_localize_cli_matches_jax(scene, fmt, capsys):
    root, ref = scene
    out_dir = root / f"port_out_{fmt}"
    build.reset_counts()
    rc = cli.main(["localize", "--config", str(root / f"scene.{fmt}"),
                   "--output", str(out_dir), "--device", "cpu"])
    assert rc == 0
    assert build.TWIN_CALLS["raster_bin"] > 0
    assert build.TWIN_CALLS["raster_direct"] == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(summary["detected"]) == sorted(NAMES)
    assert (out_dir / "output_stats.txt").exists()
    assert (out_dir / "cost_dump.json").exists()
    recs = {r["name"]: r for r in read_output_poses(
        str(out_dir / "output_poses.txt"))}
    ref = {r["name"]: r for r in ref}
    assert set(recs) == set(ref) == set(NAMES)
    for name in NAMES:
        np.testing.assert_allclose(recs[name]["location"],
                                   ref[name]["location"], atol=1e-3)
        gt = gt_states()[NAMES.index(name)].pose
        assert np.linalg.norm(np.asarray(recs[name]["location"])
                              - [gt.x, gt.y, gt.z]) < 0.12


@pytest.mark.parametrize("params", [
    {"icp_source": "model", "icp_stagnation_streak": 5,
     "icp_crop_targets": 128},
    {"fine_stride": 1, "pose_refinement_rounds": 1, "cost_cloud": "render",
     "max_observed_points": 1024, "max_points_per_label": 512},
], ids=["fast_profile", "fine_refine_render"])
def test_env_params_reach_the_env(scene, params, capsys, monkeypatch):
    """EnvConfig fields in env_params (the speed profile's; the fine
    re-score, a refinement round and the re-render cost) reach the env the
    CLI builds, which runs them: both objects detected within 12 cm."""
    from perception_tpu_torch.pipeline.env import PerceptionEnv

    root, _ = scene
    cfg = json.loads((root / "scene.json").read_text())
    cfg["env_params"] = {**cfg["env_params"], **params}
    path = root / f"scene_{len(params)}.json"
    path.write_text(json.dumps(cfg))
    seen = []
    greedy = PerceptionEnv.compute_greedy_poses

    def record(self, *args, **kwargs):
        seen.append(self.env)
        return greedy(self, *args, **kwargs)

    monkeypatch.setattr(PerceptionEnv, "compute_greedy_poses", record)
    out_dir = root / f"port_out_{len(params)}"
    rc = cli.main(["localize", "--config", str(path), "--output",
                   str(out_dir), "--device", "cpu"])
    assert rc == 0
    assert seen and all(getattr(seen[0], k) == v for k, v in params.items())
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(summary["detected"]) == sorted(NAMES)
    for r in read_output_poses(str(out_dir / "output_poses.txt")):
        gt = gt_states()[NAMES.index(r["name"])].pose
        assert np.linalg.norm(np.asarray(r["location"])
                              - [gt.x, gt.y, gt.z]) < 0.12


def test_yaml_config_without_the_yaml_module_raises(tmp_path, monkeypatch):
    path = tmp_path / "scene.yaml"
    path.write_text("mode: greedy\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="'yaml' module"):
        cli.load_config(str(path))
    json_path = tmp_path / "scene.json"
    json_path.write_text('{"mode": "greedy"}')
    assert cli.load_config(str(json_path)) == {"mode": "greedy"}


@pytest.fixture(scope="module")
def table_files(tmp_path_factory):
    """test_torch_3dof's pair scene as files: the crate and the post as PLY,
    the observation as a 16-bit depth PNG in mm, the 3-DoF region."""
    from perception_tpu_torch.core.config import (
        CameraIntrinsics,
        EnvConfig,
        PerchConfig,
    )
    from perception_tpu_torch.core.mesh import ModelBank
    from perception_tpu_torch.pipeline.env import (
        PerceptionEnv,
        RecognitionInput,
    )
    from tests.test_torch_3dof import PAIR_GT, PAIR_REGION, TABLE, crate, post

    root = tmp_path_factory.mktemp("cli_table")
    perch = PerchConfig(gpu_stride=2, gpu_batch_size=32,
                        sensor_resolution=0.02,
                        min_neighbor_points_for_valid_pose=5,
                        max_icp_iterations=10, use_cylinder_observed=True)
    env_cfg = EnvConfig(res=0.04, theta_res=np.pi / 4,
                        max_points_per_pose=256, max_observed_points=2048,
                        max_points_per_label=512, max_labels=2,
                        icp_downsample=2, cost_crop_targets=0,
                        icp_mode="fused", kernel_backend="pallas_bin")
    env = PerceptionEnv(
        ModelBank.from_models(convert.models_from_jax([crate(), post()]),
                              t_cap=16),
        convert.dataclass_from_jax(CAM, CameraIntrinsics), perch,
        dataclasses.replace(env_cfg, width=CAM.width, height=CAM.height),
        device="cpu")
    env._input = RecognitionInput(depth_image=None,
                                  cam_to_world=CAM_TO_BODY.copy())
    depth, _, _ = env.render_composite(convert.states_from_jax(PAIR_GT))
    (root / "models").mkdir()
    _write_box_ply(root / "models" / "crate.ply", 0.10, 0.07, 0.12,
                   (200, 40, 40))
    _write_box_ply(root / "models" / "post.ply", 0.06, 0.06, 0.16,
                   (40, 200, 40))
    write_png(str(root / "depth.png"), (depth * 10).astype(np.uint16))
    cfg = _config("auto")
    cfg["input"] = {"depth_image": "depth.png", "depth_factor": 1000,
                    "cam_to_world": CAM_TO_BODY.tolist(),
                    "table_height": TABLE, **PAIR_REGION}
    cfg["model_bank"] = [
        {"name": "crate", "path": "models/crate.ply"},
        {"name": "post", "path": "models/post.ply", "symmetric": True}]
    cfg["use_external_pose_list"] = 0
    cfg["perch_params"] = dataclasses.asdict(perch)
    cfg["env_params"] = {k: v for k, v in dataclasses.asdict(env_cfg).items()
                         if k not in ("width", "height")}
    return root, cfg


@pytest.mark.parametrize("mode", ["tree", "greedy_icp"])
def test_unported_modes_raise(table_files, mode, capsys):
    """The modes that were not ported raised here; they run now. The CLI
    in `mode` on the 3-DoF table files (no instance mask, scored through
    the bin raster) must report what the port's recogniser reports for the
    same files in process, both models placed, and write its outputs."""
    from perception_tpu_torch.core.config import (
        CameraIntrinsics,
        EnvConfig,
        PerchConfig,
    )
    from perception_tpu_torch.pipeline.env import RecognitionInput
    from perception_tpu_torch.pipeline.recognizer import (
        ModelSpec,
        ObjectRecognizer,
    )

    root, cfg = table_files
    cfg = {**cfg, "mode": mode}
    (root / f"{mode}.json").write_text(json.dumps(cfg))
    out_dir = root / f"out_{mode}"
    build.reset_counts()
    rc = cli.main(["localize", "--config", str(root / f"{mode}.json"),
                   "--output", str(out_dir), "--device", "cpu"])
    assert rc == 0
    assert build.TWIN_CALLS["raster_bin"] > 0
    assert (build.TWIN_CALLS["icp_fused"] > 0) == (mode == "greedy_icp")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out_dir / "output_poses.txt").exists()
    assert (out_dir / "output_stats.txt").exists()

    env_cfg = EnvConfig.from_yaml_dict({**cfg["env_params"],
                                        "width": CAM.width,
                                        "height": CAM.height})
    rec = ObjectRecognizer(
        [ModelSpec("crate", str(root / "models" / "crate.ply")),
         ModelSpec("post", str(root / "models" / "post.ply"),
                   symmetric=True)],
        convert.dataclass_from_jax(CAM, CameraIntrinsics),
        PerchConfig.from_yaml_dict(cfg), env_cfg,
        use_external_pose_list=False, target_triangles=16, device="cpu")
    rin = RecognitionInput(
        depth_image=read_png(str(root / "depth.png")).astype(np.float64),
        depth_factor=1000.0, cam_to_world=CAM_TO_BODY.copy(),
        use_external_pose_list=False,
        **{k: cfg["input"][k] for k in ("x_min", "x_max", "y_min", "y_max",
                                        "table_height")})
    ref = (rec.localize_objects(rin) if mode == "tree"
           else rec.localize_objects_greedy_icp(rin))
    assert summary["detected"] == ref.names
    assert sorted(ref.names) == ["crate", "post"]
    np.testing.assert_allclose(
        summary["poses"],
        [[p.x, p.y, p.z, *p.quaternion()] for p in ref.poses], atol=1e-9)
    recs = read_output_poses(str(out_dir / "output_poses.txt"))
    assert [r["name"] for r in recs] == ref.names
    if mode == "tree":
        assert summary["expands"] == rec.env.stats.expands >= 2


def test_cli_and_readers_are_port_modules():
    """The import scans of the port (no jax, no JAX package) reach the CLI
    and the PNG reader."""
    mods = _port_modules()
    for m in ("perception_tpu_torch.cli", "perception_tpu_torch.io.images",
              "perception_tpu_torch.io.masks"):
        assert m in mods


# -- PNG ---------------------------------------------------------------------

def _encode(img: np.ndarray, filters: list[int], ctype: int | None = None,
            interlace: int = 0) -> bytes:
    """A PNG with the given per-row filter types (cycled), by the spec."""
    depth = 16 if img.dtype == np.uint16 else 8
    h = img.shape[0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = (img.astype(">u2") if depth == 16 else img).reshape(h, -1)
    rows = rows.view(np.uint8).astype(np.int64)
    bpp = ch * depth // 8
    prev = np.zeros(rows.shape[1], np.int64)
    out = []
    for y in range(h):
        f, x = filters[y % len(filters)], rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = [0, a, b, (a + b) // 2,
                np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))][f]
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    if ctype is None:
        ctype = {1: 0, 3: 2, 4: 6}[ch]
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0,
                       interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


def _cv2_rgb(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def test_png_reader_equals_opencv_on_its_files(tmp_path):
    """16-bit depth, 8-bit mask and RGB images written by OpenCV (libpng's
    adaptive filters)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:128]
    depth = (5000 + 30 * xx + 7 * yy + rng.integers(0, 9, xx.shape)).astype(
        np.uint16)
    mask = (xx // 40 + 3 * (yy // 50)).astype(np.uint8)
    rgb = np.stack([xx * 2, yy * 2, (xx * yy) % 256], -1).astype(np.uint8)
    for name, img in (("d", depth), ("m", mask), ("c", rgb)):
        path = tmp_path / f"{name}.png"
        cv2.imwrite(str(path), img if img.ndim == 2 else img[..., ::-1])
        out = read_png(str(path))
        assert out.dtype == img.dtype
        np.testing.assert_array_equal(out, _cv2_rgb(path))
        np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("dtype,channels", [
    (np.uint8, 1), (np.uint16, 1), (np.uint8, 3), (np.uint16, 3),
    (np.uint8, 4)])
def test_png_reader_undoes_every_filter(tmp_path, dtype, channels):
    rng = np.random.default_rng(channels)
    shape = (23, 17) if channels == 1 else (23, 17, channels)
    img = rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(
        dtype)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, [0, 1, 2, 3, 4, 4, 3, 1]))
    np.testing.assert_array_equal(read_png(str(path)), img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    out = tmp_path / "w.png"
    write_png(str(out), img)
    np.testing.assert_array_equal(read_png(str(out)), img)
    np.testing.assert_array_equal(_cv2_rgb(out), img)


@pytest.mark.parametrize("ctype,interlace", [(3, 0), (4, 0), (0, 1)])
def test_png_reader_refuses_other_forms(tmp_path, ctype, interlace):
    """Palette, grey + alpha and interlaced images raise."""
    img = np.zeros((4, 4) if ctype != 4 else (4, 4, 2), np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(_encode(img, [0], ctype=ctype, interlace=interlace))
    with pytest.raises(ValueError):
        read_png(str(path))


# -- masks -------------------------------------------------------------------

def _rle_counts(mask: np.ndarray) -> list[int]:
    """Uncompressed COCO RLE: column-major run lengths, zeros first."""
    counts, val, run = [], False, 0
    for v in mask.T.reshape(-1):
        if v != val:
            counts.append(run)
            val, run = v, 0
        run += 1
    return counts + [run]


def _rle_string(counts: list[int]) -> str:
    """COCO's compressed RLE string (maskApi.c rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | (0x20 if more else 0)) + 48))
    return "".join(out)


def _blob_masks(h=40, w=50):
    yy, xx = np.mgrid[0:h, 0:w]
    return [((xx - 15) ** 2 + (yy - 12) ** 2 < 80),
            ((xx > 28) & (yy > 20) & (xx < 45))]


def test_rle_decoding_matches_jax():
    for m in _blob_masks():
        counts = _rle_counts(m)
        for seg in ({"size": list(m.shape), "counts": counts},
                    {"size": list(m.shape), "counts": _rle_string(counts)}):
            out = pmasks.decode_segmentation(seg, 0, 0)
            np.testing.assert_array_equal(out, m)
            np.testing.assert_array_equal(
                out, jmasks.decode_segmentation(seg, 0, 0))


def test_polygons_match_jax_scanline(monkeypatch):
    """The port's one polygon path against the JAX package's numpy
    scanline (its OpenCV branch blocked)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    polys = [[5.2, 4.0, 30.7, 6.5, 22.0, 28.9, 8.1, 20.0],
             [35.0, 30.0, 47.5, 31.0, 41.0, 38.2]]
    out = pmasks.decode_segmentation(polys, 40, 50)
    assert out.sum() > 100
    np.testing.assert_array_equal(out, jmasks.decode_segmentation(polys, 40,
                                                                  50))


def test_coco_detections_and_posecnn_mat_match_jax(tmp_path, monkeypatch):
    from scipy.io import savemat

    monkeypatch.setitem(sys.modules, "cv2", None)
    a, b = _blob_masks()
    anns = [
        {"image_id": 3, "category_id": 1, "score": 0.9,
         "segmentation": {"size": list(a.shape),
                          "counts": _rle_string(_rle_counts(a))}},
        {"image_id": 3, "category_id": 2, "score": 0.8,
         "segmentation": [[30.0, 22.0, 44.0, 22.0, 44.0, 39.0, 30.0, 39.0]]},
        {"image_id": 3, "category_id": 1, "score": 0.4,
         "bbox": [2.0, 3.0, 10.0, 6.0]},
        {"image_id": 4, "category_id": 2, "score": 0.99,
         "bbox": [0.0, 0.0, 4.0, 4.0]}]
    coco = {"images": [{"id": 3, "file_name": "rgb.png", "height": 40,
                        "width": 50}],
            "annotations": anns,
            "categories": [{"id": 1, "name": "red_box"},
                           {"id": 2, "name": "green_box"}]}
    path = tmp_path / "dets.json"
    path.write_text(json.dumps(coco))
    kw = dict(file_name="x/rgb.png", score_threshold=0.3)
    pd = pmasks.load_coco_detections(str(path), **kw)
    jd = jmasks.load_coco_detections(str(path), **kw)
    labels = np.where(a, 1, np.where(b, 2, 0)).astype(np.uint8)
    rois = np.asarray([[0, 1, 5, 3, 26, 22], [0, 2, 28, 20, 45, 40]], float)
    savemat(tmp_path / "r.mat", {"labels": labels, "rois": rois})
    pm = pmasks.load_posecnn_mat(str(tmp_path / "r.mat"), NAMES)
    jm = jmasks.load_posecnn_mat(str(tmp_path / "r.mat"), NAMES)
    for p, j in ((pd, jd), (pm, jm)):
        assert p.names == j.names and len(p.names) >= 2
        assert p.boxes == j.boxes and p.centroids == j.centroids
        for x, y in zip(p.masks, j.masks):
            np.testing.assert_array_equal(x, y)
        for req in (None, ["green_box", "red_box"]):
            (pl, pn), (jl, jn) = p.label_mask(req), j.label_mask(req)
            np.testing.assert_array_equal(pl, jl)
            assert pn == jn
