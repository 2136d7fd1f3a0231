"""The port's deployment surface against the JAX package: the scorer's
colour route above the fused cost's caps, the service's status page and
pose overlay, `serve.main` from a JSON config, and the frame-watch camera
loop.

Scenes from tests/test_pipeline.py (two boxes, 128x96, gpu_stride 2). The
JAX side runs its Pallas kernels in interpret mode
(kernel_backend="pallas_direct_interpret"); the port runs the PyTorch twins
on CPU tensors.
"""

import dataclasses
import functools
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.core.pose import CAM_TO_BODY
from perception_tpu.core.state import GraphState as JGraphState
from perception_tpu_torch import convert
from perception_tpu_torch.camera_loop import FrameWatcher
from perception_tpu_torch.core.config import (
    CameraIntrinsics,
    EnvConfig,
    PerchConfig,
)
from perception_tpu_torch.core.state import GraphState
from perception_tpu_torch.io.images import decode_png, read_png, write_png
from perception_tpu_torch.kernels import build
from perception_tpu_torch.pipeline import scorer as pscorer
from perception_tpu_torch.pipeline.recognizer import ObjectRecognizer
from perception_tpu_torch.serve import LocalizerService, serve, status_page

from tests.test_pipeline import CAM, gt_states, make_env
from tests.test_torch_scorer import _box_candidates, _score_both

REPO = Path(__file__).resolve().parent.parent
PCAM = convert.dataclass_from_jax(CAM, CameraIntrinsics)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The scorer above the fused cost's caps.

@functools.lru_cache(maxsize=2)
def _roi48_env(color: bool):
    """The box scene at ROI 48x48 (2304 pixels per pose: above the fused
    cost's 2048-point cap), with or without the colour gate."""
    env = make_env(use_color_cost=color)
    env.env = dataclasses.replace(env.env, icp_mode="fused", roi_size=48,
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    return env


def _score_roi48(color: bool):
    """Eight box-scene candidates (seed 6) at ROI 48x48, scored without ICP
    by JAX and by the port, both given the face Lab table."""
    env = _roi48_env(color)
    cfg = env._scorer_config(do_icp=False)
    assert cfg.roi_shape == (48, 48) and cfg.cost_type == (3 if color else 2)
    cands = _box_candidates(8, seed=6)
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands],
                        np.int32)
    totals = np.asarray(env._observed.seg_count, np.float32)[labels]
    build.reset_counts()
    ref, out = _score_both(
        env._render_bank,
        (jnp.asarray(poses), jnp.asarray(ids), jnp.asarray(labels),
         jnp.asarray(totals), env._proj, env._scene),
        cfg, env._bank_icp_samples, env._bank_icp_normals,
        bank_lab=env._render_bank_lab)
    return ref, out, dict(build.TWIN_CALLS)


def _assert_costs_equal(ref, out):
    """Without ICP the two packages score the same clouds: every total and
    both percentages equal, to 1e-4 (float32 sums in another order)."""
    r_tot = np.asarray(ref.total_cost)
    assert (r_tot > 0).sum() >= 4, r_tot
    np.testing.assert_array_equal(out.total_cost.numpy(), r_tot)
    for field in ("rendered_cost", "observed_cost"):
        np.testing.assert_allclose(getattr(out, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   atol=1e-4, err_msg=field)


def test_color_above_the_caps_takes_the_composed_cost():
    """Cost type 3 at 2304 points per pose (plus the explain-only samples):
    as the JAX scorer, the port takes the composed cost (the 1-NN, then the
    CIEDE2000 gate on RGB converted per point), not a fused colour kernel,
    and its costs equal JAX's."""
    assert pscorer.FUSED_MAX_POINTS == 2048
    ref, out, twins = _score_roi48(color=True)
    assert twins == {"raster_direct": 1, "nn1_batch": 1}, twins
    _assert_costs_equal(ref, out)


def test_depth_above_the_caps_keeps_the_fused_cost():
    """The depth-only twin of the case above: the port keeps its fused
    depth cost (any size), JAX takes its composed cost above its caps, and
    the costs are equal."""
    ref, out, twins = _score_roi48(color=False)
    assert twins == {"raster_direct": 1, "cost_fused": 1}, twins
    _assert_costs_equal(ref, out)


# ---------------------------------------------------------------------------
# The service: overlay, status page, main.

@pytest.fixture(scope="module")
def jax_env():
    env = make_env(use_color_cost=True)
    env.env = dataclasses.replace(env.env, icp_mode="fused",
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    return env


def _port_recognizer(jenv) -> ObjectRecognizer:
    """The port's recogniser over the JAX env's models and configuration,
    on the CPU."""
    return ObjectRecognizer.from_models(
        convert.models_from_jax(jenv.bank.models), PCAM,
        convert.dataclass_from_jax(jenv.perch, PerchConfig),
        convert.dataclass_from_jax(jenv.env, EnvConfig, icp_mode="auto",
                                   kernel_backend="auto"),
        t_cap=16, device="cpu")


def _silhouette(label: np.ndarray) -> np.ndarray:
    """Pixels whose 3x3 neighbourhood holds another label (or background)."""
    pad = np.pad(label, 1, mode="edge")
    h, w = label.shape
    edge = np.zeros(label.shape, bool)
    for dy in range(3):
        for dx in range(3):
            edge |= pad[dy:dy + h, dx:dx + w] != label
    return edge


@pytest.mark.parametrize("with_color", [True, False])
def test_render_overlay_matches_jax(jax_env, with_color):
    """The overlay of detections 3 mm off the ground truth over the
    observation's colour image, or over its colourised depth: JAX's
    render_overlay (its XLA raster) and the port's (the direct kernel's
    twin) equal except on silhouette pixels of either render."""
    from perception_tpu.serve import LocalizerService as JaxService

    from tests.test_serve import _FakeRecognizer

    dets = _box_candidates(2, seed=3)
    rin = jax_env._input
    obs = {"depth": np.asarray(rin.depth_image, np.float64),
           "color": (np.asarray(rin.color_image, np.float32) if with_color
                     else None),
           "depth_factor": rin.depth_factor}
    fake = _FakeRecognizer(jax_env)
    fake.last_state = JGraphState(tuple(dets))
    ref_service = JaxService(fake)
    ref_service.last_observation = obs
    ref = ref_service.render_overlay()

    rec = _port_recognizer(jax_env)
    service = LocalizerService(rec)
    assert service.render_overlay() is None
    rec.env.set_input(convert.input_from_jax(rin))
    rec.last_state = GraphState(tuple(convert.states_from_jax(dets)))
    service.last_observation = obs
    out = service.render_overlay()
    assert out.dtype == np.uint8 and out.shape == ref.shape == (96, 128, 3)
    _, _, ref_label = jax_env.render_composite(dets)
    _, _, out_label = rec.env.render_composite(rec.last_state.object_states)
    edge = _silhouette(ref_label) | _silhouette(out_label)
    assert (ref_label > 0).sum() > 500
    np.testing.assert_array_equal(out[~edge], ref[~edge])
    assert (out != ref).any(axis=-1).mean() <= 0.02


def _drop_frame(spool: Path, key: str, jenv, pose_lists: dict,
                color: bool = False) -> None:
    """One frame in the camera loop's contract, depth in cm (factor 100)."""
    rin = jenv._input
    write_png(str(spool / f"{key}-depth.png"),
              np.asarray(rin.depth_image).astype(np.uint16))
    write_png(str(spool / f"{key}-labels.png"),
              np.asarray(rin.label_mask).astype(np.uint8))
    if color:
        write_png(str(spool / f"{key}-color.png"),
                  np.asarray(rin.color_image).astype(np.uint8))
    with open(spool / f"{key}-request.json", "w") as f:
        json.dump({"depth_factor": 100.0,
                   "cam_to_world": CAM_TO_BODY.tolist(),
                   "segmented_object_names": ["red_box", "green_box"],
                   "pose_lists": pose_lists}, f)


def _gt_pose_lists() -> dict:
    gt = gt_states()
    return {name: [[s.pose.x, s.pose.y, s.pose.z, *s.pose.quaternion()]]
            for name, s in zip(("red_box", "green_box"), gt)}


def _get(url: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def test_status_page_and_overlay_over_http(jax_env):
    """Before any request `/` says so and /overlay.png answers 404; after a
    /localize request `/` lists each detected object and links the
    overlay, whose PNG decodes to the service's render_overlay."""
    rec = _port_recognizer(jax_env)
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, page = _get(f"{url}/")
        assert code == 200 and b"No localisation served yet" in page
        assert _get(f"{url}/index.html")[1] == page
        assert _get(f"{url}/overlay.png")[0] == 404
        rin = jax_env._input
        payload = {"depth_image": np.asarray(rin.depth_image).tolist(),
                   "label_mask": np.asarray(rin.label_mask).tolist(),
                   "color_image": np.asarray(rin.color_image).tolist(),
                   "depth_factor": 100.0, "cam_to_world": CAM_TO_BODY.tolist(),
                   "segmented_object_names": ["red_box", "green_box"],
                   "pose_lists": _gt_pose_lists()}
        req = urllib.request.Request(f"{url}/localize",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        code, page = _get(f"{url}/")
        code_png, png = _get(f"{url}/overlay.png")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert code == 200
    for det in out["detections"]:
        assert f"<td>{det['name']}</td>".encode() in page
    assert b'<img src="/overlay.png"' in page
    assert page.decode() == status_page(
        type("S", (), {"last_response": out})())
    assert code_png == 200
    service = LocalizerService(rec)
    service.last_response = out
    service.last_observation = {
        "depth": np.asarray(rin.depth_image, np.float64),
        "color": np.asarray(rin.color_image, np.float32),
        "depth_factor": 100.0}
    np.testing.assert_array_equal(decode_png(png), service.render_overlay())


def _write_config(tmp_path: Path, jenv) -> Path:
    """Box PLY models and a JSON config in serve.main's schema with the JAX
    env's camera, perch keys and env_params."""
    from tests.test_search_e2e import _write_box_ply

    _write_box_ply(tmp_path / "red.ply", 0.12, 0.08, 0.10, (200, 40, 40))
    _write_box_ply(tmp_path / "green.ply", 0.06, 0.06, 0.16, (40, 200, 40))
    perch = {k: v for k, v in dataclasses.asdict(jenv.perch).items()
             if isinstance(v, (int, float, bool))}
    env = {k: getattr(jenv.env, k) for k in (
        "max_points_per_pose", "max_observed_points", "max_points_per_label",
        "max_labels", "icp_downsample", "icp_mode")}
    cfg = {"camera": dataclasses.asdict(CAM),
           "model_bank": [{"name": "red_box", "path": str(tmp_path / "red.ply")},
                          {"name": "green_box",
                           "path": str(tmp_path / "green.ply")}],
           **perch, "env_params": env}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return path


def test_config_reads_like_the_jax_flow(jax_env, tmp_path):
    """The JSON config read by JAX's serve.main flow (yaml.safe_load, the
    from_yaml_dicts) gives the port's configurations, and
    load_yaml_config the same as JAX's."""
    import yaml

    from perception_tpu.core import config as jconfig
    from perception_tpu_torch.core import config as pconfig
    from perception_tpu_torch.serve import recognizer_from_config

    path = _write_config(tmp_path, jax_env)
    with open(path) as f:
        raw = yaml.safe_load(f)
    rec = recognizer_from_config(str(path), device="cpu")
    assert rec.env.camera == convert.dataclass_from_jax(
        jconfig.CameraIntrinsics(**raw["camera"]), CameraIntrinsics)
    assert rec.env.perch == convert.dataclass_from_jax(
        jconfig.PerchConfig.from_yaml_dict(raw), PerchConfig)
    assert rec.env.env == convert.dataclass_from_jax(
        jconfig.EnvConfig.from_yaml_dict(raw.get("env_params", {})),
        EnvConfig)
    assert [s.name for s in rec.specs] == ["red_box", "green_box"]
    perch, env = pconfig.load_yaml_config(str(path))
    jperch, jenv = jconfig.load_yaml_config(str(path))
    assert perch == convert.dataclass_from_jax(jperch, PerchConfig)
    assert env == convert.dataclass_from_jax(jenv, EnvConfig)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args: list[str], ready: str, timeout: float = 120):
    """A `python -m` subprocess; returns it once a stdout line contains
    `ready` (raises if it exits first or the timeout passes)."""
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: list[str] = []
    done = threading.Event()

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if ready in line:
                done.set()
        done.set()

    threading.Thread(target=pump, daemon=True).start()
    if not done.wait(timeout) or proc.poll() is not None:
        proc.kill()
        raise AssertionError("".join(lines))
    return proc


def test_serve_main_answers_a_request(depth_env, tmp_path):
    """`python -m perception_tpu_torch.serve --config cfg.json --port P
    --device cpu` on box PLY models: its ready line, one /localize request
    with both objects within 5 mm of the ground truth, terminated."""
    path = _write_config(tmp_path, depth_env)
    port = _free_port()
    proc = _start(["perception_tpu_torch.serve", "--config", str(path),
                   "--port", str(port), "--device", "cpu"],
                  f"localizer on :{port}")
    try:
        rin = depth_env._input
        payload = {"depth_image": np.asarray(rin.depth_image).tolist(),
                   "label_mask": np.asarray(rin.label_mask).tolist(),
                   "depth_factor": 100.0, "cam_to_world": CAM_TO_BODY.tolist(),
                   "segmented_object_names": ["red_box", "green_box"],
                   "pose_lists": _gt_pose_lists()}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/localize",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    dets = {d["name"]: d for d in out["detections"]}
    assert set(dets) == {"red_box", "green_box"}
    for name, gt in zip(("red_box", "green_box"), gt_states()):
        assert np.linalg.norm(np.asarray(dets[name]["translation"])
                              - [gt.pose.x, gt.pose.y, gt.pose.z]) < 5e-3


def test_camera_loop_main_localises_a_frame(depth_env, tmp_path):
    """`python -m perception_tpu_torch.camera_loop --spool DIR --config
    cfg.json --device cpu` (the in-process recogniser) localises a dropped
    frame, writes its detections and overlay, and is terminated. Both
    objects within 20 mm, the served paths' bar: the frame's 16-bit depth
    PNG holds whole centimetres."""
    path = _write_config(tmp_path, depth_env)
    spool = tmp_path / "spool"
    spool.mkdir()
    _drop_frame(spool, "f0", depth_env, _gt_pose_lists())
    proc = _start(["perception_tpu_torch.camera_loop", "--spool", str(spool),
                   "--config", str(path), "--device", "cpu",
                   "--poll-seconds", "0.1"], "localised frame f0")
    proc.terminate()
    proc.wait(timeout=30)
    out = json.loads((spool / "f0-detections.json").read_text())
    dets = {d["name"]: d for d in out["detections"]}
    for name, gt in zip(("red_box", "green_box"), gt_states()):
        assert np.linalg.norm(np.asarray(dets[name]["translation"])
                              - [gt.pose.x, gt.pose.y, gt.pose.z]) < 0.02
    assert read_png(str(spool / "f0-overlay.png")).shape == (96, 128, 3)


def test_service_and_loop_default_to_the_card(tmp_path):
    """serve.main and camera_loop.main take --device with "cuda" as the
    default: without a card the service's recogniser raises."""
    from perception_tpu_torch import camera_loop
    from perception_tpu_torch.serve import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = _write_config(tmp_path, make_env())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", str(path), "--port", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        camera_loop.main(["--spool", str(tmp_path), "--config", str(path)])


# ---------------------------------------------------------------------------
# The camera loop (tests/test_camera_loop.py's cases, on the port).

@pytest.fixture(scope="module")
def depth_env():
    env = make_env()
    env.env = dataclasses.replace(env.env, icp_mode="fused",
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    return env


@pytest.fixture(scope="module")
def port_service(depth_env):
    return LocalizerService(_port_recognizer(depth_env))


def test_in_process_frame_localisation(tmp_path, depth_env, port_service):
    gt = gt_states()
    _drop_frame(tmp_path, "frame0001", depth_env,
                {"red_box": _gt_pose_lists()["red_box"]})
    w = FrameWatcher(str(tmp_path), service=port_service, depth_factor=100.0)
    assert w.pending_keys() == ["frame0001"]
    assert w.scan_once() == ["frame0001"]
    out = json.load(open(tmp_path / "frame0001-detections.json"))
    assert out["frame"] == "frame0001" and out["latency_s"] >= 0
    names = [d["name"] for d in out["detections"]]
    det = out["detections"][names.index("red_box")]
    np.testing.assert_allclose(
        det["translation"], [gt[0].pose.x, gt[0].pose.y, gt[0].pose.z],
        atol=5e-3)
    overlay = read_png(str(tmp_path / "frame0001-overlay.png"))
    assert overlay.shape == (CAM.height, CAM.width, 3)
    np.testing.assert_array_equal(overlay, port_service.render_overlay())
    # Restart safety: the detections file marks the frame processed.
    assert w.pending_keys() == []
    assert FrameWatcher(str(tmp_path), service=port_service).scan_once() == []


def test_http_dispatch(tmp_path, depth_env, port_service):
    server = serve(port_service.recognizer, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        _drop_frame(tmp_path, "f2", depth_env,
                    {"red_box": _gt_pose_lists()["red_box"]})
        url = f"http://127.0.0.1:{server.server_address[1]}/localize"
        w = FrameWatcher(str(tmp_path), url=url, depth_factor=100.0)
        result = w.process("f2")
        assert [d["name"] for d in result["detections"]].count("red_box") == 1
        assert result["latency_s"] >= 0
        assert not (tmp_path / "f2-overlay.png").exists()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_requires_exactly_one_dispatcher(tmp_path):
    with pytest.raises(ValueError):
        FrameWatcher(str(tmp_path))
    with pytest.raises(ValueError):
        FrameWatcher(str(tmp_path), service=object(), url="http://x")


def test_bad_frame_recorded_not_fatal(tmp_path, depth_env, port_service):
    (tmp_path / "bad-depth.png").write_bytes(b"not a png")
    _drop_frame(tmp_path, "good", depth_env,
                {"red_box": _gt_pose_lists()["red_box"]})
    w = FrameWatcher(str(tmp_path), service=port_service, depth_factor=100.0)
    # First failing poll: the frame may be mid-write, so it is retried.
    assert w.scan_once() == ["good"]
    assert not (tmp_path / "bad-detections.json").exists()
    # Second poll with the file unchanged: the failure is terminal.
    assert w.scan_once() == ["bad"]
    bad = json.load(open(tmp_path / "bad-detections.json"))
    assert bad["detections"] == [] and "error" in bad
    assert json.load(open(tmp_path / "good-detections.json"))["detections"]
    assert w.pending_keys() == []


def test_partial_write_retried_then_succeeds(tmp_path, depth_env,
                                             port_service):
    (tmp_path / "slow-depth.png").write_bytes(b"partial")
    w = FrameWatcher(str(tmp_path), service=port_service, depth_factor=100.0)
    assert w.scan_once() == []
    _drop_frame(tmp_path, "slow", depth_env,
                {"red_box": _gt_pose_lists()["red_box"]})
    assert w.scan_once() == ["slow"]
    assert "error" not in json.load(open(tmp_path / "slow-detections.json"))


@pytest.mark.parametrize("label_bits", [8, 16])
def test_build_payload_matches_jax(tmp_path, jax_env, label_bits):
    """The same spool (written by io.images) read by JAX's build_payload
    (cv2) and the port's (io.images): equal payloads, with a colour image
    and 8- or 16-bit labels."""
    pytest.importorskip("cv2")
    from perception_tpu.camera_loop import FrameWatcher as JaxWatcher
    _drop_frame(tmp_path, "k", jax_env, _gt_pose_lists(), color=True)
    if label_bits == 16:
        label = np.asarray(jax_env._input.label_mask).astype(np.uint16) * 300
        write_png(str(tmp_path / "k-labels.png"), label)
    ref = JaxWatcher(str(tmp_path), url="http://x").build_payload("k")
    out = FrameWatcher(str(tmp_path), url="http://x").build_payload("k")
    assert out == ref
    assert len(out["color_image"][0][0]) == 3
    assert max(map(max, out["label_mask"])) == (600 if label_bits == 16
                                                 else 2)


def test_new_modules_import_without_cv2_yaml_pil():
    """Each module of this slice imports with cv2, yaml and PIL unavailable
    (None in sys.modules) and loads neither jax nor the JAX package."""
    mods = ["perception_tpu_torch.serve", "perception_tpu_torch.camera_loop",
            "perception_tpu_torch.core.config",
            "perception_tpu_torch.io.config_parser",
            "perception_tpu_torch.utils.cloud_utils",
            "perception_tpu_torch.utils.stats",
            "perception_tpu_torch.utils.debug",
            "perception_tpu_torch.eval.metrics",
            "perception_tpu_torch.eval.sampling",
            "perception_tpu_torch.eval.model_zoo",
            "perception_tpu_torch.eval.ycb",
            "perception_tpu_torch.eval.dataset_gen"]
    code = ("import importlib, sys\n"
            "for m in ('cv2', 'yaml', 'PIL'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'perception_tpu', 'benchmarks')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def deploy_scene_agreement() -> None:
    """chip_smoke.py's deploy scenes (zoo PLYs, seed 42, three objects,
    ~2048 candidates per frame, 640x480 at stride 8, ROI 32, p2p) localised
    on the CPU by the port (CPU twins) and by the JAX package
    (interpret-mode kernels), the latter twice: on the port's frame and
    candidates (the spool's), and on its own render of the scene with the
    candidates drawn from it. One JSON line per object with the three
    translation errors (mm) against the ground truth and the port's
    detected translation (m)."""
    import tempfile

    import jax

    import chip_smoke as cs
    from perception_tpu.core.config import CameraIntrinsics as JCamera
    from perception_tpu.core.config import EnvConfig as JEnvConfig
    from perception_tpu.core.config import PerchConfig as JPerchConfig
    from perception_tpu.eval.dataset_gen import DatasetGenerator
    from perception_tpu.pipeline.env import RecognitionInput as JInput
    from perception_tpu.pipeline.recognizer import ModelSpec as JSpec
    from perception_tpu.pipeline.recognizer import ObjectRecognizer as JRec
    from perception_tpu_torch.eval.dataset_gen import write_zoo_plys
    from perception_tpu_torch.serve import recognizer_from_config

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        spool = root / "spool"
        spool.mkdir()
        paths = write_zoo_plys(str(root), {n: n for n in cs.ZOO_NAMES})
        cfg = cs.deploy_config(paths)
        (root / "deploy.json").write_text(json.dumps(cfg))
        rec = recognizer_from_config(str(root / "deploy.json"), "cpu")
        frames = cs.make_frames(rec, root, spool)
        watcher = FrameWatcher(str(spool), service=LocalizerService(rec))
        jrec = JRec([JSpec(name=m["name"], path=m["path"])
                     for m in cfg["model_bank"]], JCamera(**cfg["camera"]),
                    JPerchConfig.from_yaml_dict(cfg),
                    JEnvConfig.from_yaml_dict(
                        {**cfg["env_params"],
                         "kernel_backend": "pallas_direct_interpret"}))
        jgen = DatasetGenerator(jrec.env, np.random.default_rng(cs.DEPLOY_SEED))

        def jax_localize(depth_mm, label, names, cands) -> dict:
            res = jrec.localize_objects_greedy_render(JInput(
                depth_image=depth_mm.astype(np.float64),
                label_mask=np.asarray(label, np.int32), depth_factor=1000.0,
                cam_to_world=CAM_TO_BODY.copy(),
                segmented_object_names=names), cands)
            return {n: np.array([p.x, p.y, p.z])
                    for n, p in zip(res.names, res.poses)}

        for f in frames:
            jscene = jgen.sample_scene(**cs.DEPLOY_PLACEMENT)
            req = json.loads((spool / f"{f['key']}-request.json").read_text())
            depth_mm = (np.asarray(jscene.depth) * 10).astype(np.uint16)
            cands, _, _ = cs.deploy_candidates(
                depth_mm, np.asarray(jscene.label), f["names"],
                rec.env.camera)
            jdets = jax_localize(depth_mm, jscene.label, f["names"], cands)
            port_depth = (f["scene"].depth * 10).astype(np.uint16)
            jport = jax_localize(
                port_depth, f["scene"].label, f["names"],
                {k: np.asarray(v) for k, v in req["pose_lists"].items()})
            out = watcher.process(f["key"])
            pdets = {d["name"]: np.asarray(d["translation"])
                     for d in out["detections"]}

            def err_mm(dets: dict, name: str, gt: np.ndarray):
                return (None if name not in dets
                        else float(np.linalg.norm(dets[name] - gt) * 1e3))

            for state, name, share in zip(f["scene"].states, f["names"],
                                          f["visible_share"]):
                gt = np.array([state.pose.x, state.pose.y, state.pose.z])
                print(json.dumps({
                    "frame": f["key"], "object": name,
                    "visible_share": share,
                    "candidates": len(req["pose_lists"].get(name, [])),
                    "jax_candidates": len(cands.get(name, [])),
                    "port_translation_mm": err_mm(pdets, name, gt),
                    "jax_on_port_frame_translation_mm": err_mm(jport, name,
                                                               gt),
                    "jax_translation_mm": err_mm(jdets, name, gt),
                    "port_translation_m": None if name not in pdets
                    else pdets[name].tolist()}),
                    flush=True)


if __name__ == "__main__":
    deploy_scene_agreement()
