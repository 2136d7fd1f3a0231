"""The PyTorch port's greedy recognition and HTTP service against the JAX
package on the test_search_e2e box scene (GT + jittered candidates per
object, as test_cli_localize_greedy builds them).

The JAX reference runs the TPU main path (direct raster, fused ICP and fused
cost Pallas kernels in interpret mode). Both packages see the same
observation (JAX's render of the ground truth). Tolerance: the same winners,
costs within 2 (integer percentages; XLA's fused multiply-adds round the
ICP association differently), output translations within 1 mm.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from perception_tpu.core.pose import CAM_TO_BODY
from perception_tpu.io.poses_file import read_output_poses
from perception_tpu_torch import convert
from perception_tpu_torch.kernels import build
from perception_tpu_torch.core.config import CameraIntrinsics, EnvConfig, PerchConfig
from perception_tpu_torch.pipeline.env import PerceptionEnv, RecognitionInput
from perception_tpu_torch.pipeline.recognizer import ModelSpec, ObjectRecognizer
from perception_tpu_torch.serve import LocalizerService, serve

from tests.test_pipeline import CAM, gt_states, make_env
from tests.test_search_e2e import _write_box_ply, jittered_candidates


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BATCH = 16


@pytest.fixture(scope="module")
def jax_env():
    env = make_env()
    env.env = dataclasses.replace(env.env, icp_mode="fused",
                                  kernel_backend="pallas_direct_interpret")
    env.perch = dataclasses.replace(env.perch, gpu_batch_size=BATCH)
    env.set_observation_from_states(gt_states())
    return env


PCAM = convert.dataclass_from_jax(CAM, CameraIntrinsics)


@pytest.fixture(scope="module")
def jax_color_env():
    """The box scene with the CIEDE2000 colour gate (cost type 3, full
    frame: the JAX side runs nn_cost_fused_color_pallas in interpret
    mode)."""
    env = make_env(use_color_cost=True)
    env.env = dataclasses.replace(env.env, icp_mode="fused",
                                  kernel_backend="pallas_direct_interpret")
    env.perch = dataclasses.replace(env.perch, gpu_batch_size=BATCH)
    env.set_observation_from_states(gt_states())
    return env


def _port_env(jax_env):
    env_cfg = convert.dataclass_from_jax(jax_env.env, EnvConfig,
                                         icp_mode="auto", kernel_backend="auto")
    return PerceptionEnv(convert.bank_from_jax(jax_env.bank), PCAM,
                         convert.dataclass_from_jax(jax_env.perch, PerchConfig),
                         env_cfg, device="cpu")


def _port_recognizer(jax_env):
    env = _port_env(jax_env)
    return ObjectRecognizer.from_models(
        convert.models_from_jax(jax_env.bank.models), PCAM, env.perch,
        env.env, t_cap=16, device="cpu")


def _payload(jax_env, pose_lists):
    return {
        "depth_image": np.asarray(jax_env._input.depth_image).tolist(),
        "label_mask": np.asarray(jax_env._input.label_mask).tolist(),
        "depth_factor": 100.0,
        "cam_to_world": CAM_TO_BODY.tolist(),
        "segmented_object_names": ["red_box", "green_box"],
        "pose_lists": {k: np.asarray(v).tolist()
                       for k, v in pose_lists.items()},
        "mode": "greedy",
    }


def _pose_lists(seed=11):
    cands = jittered_candidates(gt_states(), np.random.default_rng(seed),
                                n=6, sigma=0.02)
    out = {"red_box": [], "green_box": []}
    for c in cands:
        name = "red_box" if c.id == 0 else "green_box"
        out[name].append([c.pose.x, c.pose.y, c.pose.z, *c.pose.quaternion()])
    return out


def test_greedy_winners_match_jax(jax_env):
    cands = jittered_candidates(gt_states(), np.random.default_rng(11),
                                n=6, sigma=0.02)
    ref_state, ref_chosen = jax_env.compute_greedy_poses(cands)
    env = _port_env(jax_env)
    rin = jax_env._input
    env.set_input(RecognitionInput(
        depth_image=rin.depth_image, color_image=rin.color_image,
        label_mask=rin.label_mask, depth_factor=rin.depth_factor,
        cam_to_world=rin.cam_to_world,
        segmented_object_names=rin.segmented_object_names))
    state, chosen = env.compute_greedy_poses(cands)
    assert state.num_objects == ref_state.num_objects == 2
    for r, o in zip(ref_chosen, chosen):
        assert (o.state.id, o.state.segmentation_label_id) == \
            (r.state.id, r.state.segmentation_label_id)
        assert abs(o.cost - r.cost) <= 2, (o.cost, r.cost)
        np.testing.assert_allclose(
            [o.state.pose.x, o.state.pose.y, o.state.pose.z],
            [r.state.pose.x, r.state.pose.y, r.state.pose.z], atol=1e-3)
        np.testing.assert_allclose(o.adjusted_pose_cam[:3, 3],
                                   r.adjusted_pose_cam[:3, 3], atol=1e-3)


def test_localize_round_trip_matches_jax(jax_env):
    """The port's HTTP service (real server thread) returns the detections
    the JAX LocalizerService returns for the same request."""
    from perception_tpu.serve import LocalizerService as JaxService

    from tests.test_serve import _FakeRecognizer

    payload = _payload(jax_env, _pose_lists())
    ref = JaxService(_FakeRecognizer(jax_env)).handle(payload)

    rec = _port_recognizer(jax_env)
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(
            f"{url}/localize", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        with urllib.request.urlopen(f"{url}/status", timeout=30) as resp:
            assert json.loads(resp.read()) == out
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    ref_dets = {d["name"]: d for d in ref["detections"]}
    dets = {d["name"]: d for d in out["detections"]}
    assert set(dets) == set(ref_dets) == {"red_box", "green_box"}
    for name, d in dets.items():
        np.testing.assert_allclose(d["translation"],
                                   ref_dets[name]["translation"], atol=1e-3)
    assert out["stats"]["scenes_rendered"] == 14


def test_overlay_and_unknown_mode_answer_like_jax(jax_env):
    """/overlay.png answers 404 before the first localisation and a PNG
    after it (as the JAX service); an unknown mode is an error (500). The
    "tree" and "greedy_icp" modes run: test_search_modes_round_trip."""
    rec = _port_recognizer(jax_env)
    service = LocalizerService(rec)
    with pytest.raises(ValueError, match="unknown mode"):
        service.handle({**_payload(jax_env, {}), "mode": "beam"})
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        body = {**_payload(jax_env, {}), "mode": "beam"}
        req = urllib.request.Request(f"{url}/localize",
                                     data=json.dumps(body).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 500
        assert "unknown mode" in json.loads(err.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{url}/overlay.png", timeout=30)
        assert err.value.code == 404
        req = urllib.request.Request(
            f"{url}/localize",
            data=json.dumps(_payload(jax_env, _pose_lists())).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert json.loads(resp.read())["detections"]
        with urllib.request.urlopen(f"{url}/overlay.png", timeout=30) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "image/png"
            assert resp.read().startswith(b"\x89PNG")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _table_recognizer():
    """A port recogniser over test_torch_3dof's pair scene models and
    settings, and that scene's observation rendered by it."""
    from tests.test_torch_3dof import PAIR_GT, crate, post

    perch = PerchConfig(gpu_stride=2, gpu_batch_size=32,
                        sensor_resolution=0.02,
                        min_neighbor_points_for_valid_pose=5,
                        max_icp_iterations=10, use_cylinder_observed=True)
    env_cfg = EnvConfig(width=CAM.width, height=CAM.height, res=0.04,
                        theta_res=np.pi / 4, max_points_per_pose=256,
                        max_observed_points=2048, max_points_per_label=512,
                        max_labels=2, icp_downsample=2, cost_crop_targets=0,
                        icp_mode="fused")
    rec = ObjectRecognizer.from_models(
        convert.models_from_jax([crate(), post()]), PCAM, perch, env_cfg,
        t_cap=16, device="cpu")
    rec.env._input = RecognitionInput(depth_image=None,
                                      cam_to_world=CAM_TO_BODY.copy())
    depth, _, _ = rec.env.render_composite(convert.states_from_jax(PAIR_GT))
    return rec, depth.astype(np.float64)


@pytest.mark.parametrize("mode", ["tree", "greedy_icp"])
def test_search_modes_round_trip(mode):
    """POST /localize in `mode` with a 3-DoF payload (no label_mask, the
    search region and table height) over the port's HTTP service: the
    detections the recogniser gives for the same input in process."""
    from tests.test_torch_3dof import PAIR_REGION, TABLE

    rec, depth = _table_recognizer()
    payload = {"depth_image": depth.tolist(), "depth_factor": 100.0,
               "cam_to_world": CAM_TO_BODY.tolist(), "table_height": TABLE,
               "mode": mode, **PAIR_REGION}
    rin = RecognitionInput(depth_image=depth, depth_factor=100.0,
                           cam_to_world=CAM_TO_BODY.copy(),
                           use_external_pose_list=False,
                           table_height=TABLE, **PAIR_REGION)
    ref = (rec.localize_objects(rin) if mode == "tree"
           else rec.localize_objects_greedy_icp(rin))
    assert sorted(ref.names) == ["crate", "post"]
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/localize"
    try:
        build.reset_counts()
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert (build.TWIN_CALLS["icp_fused"] > 0) == (mode == "greedy_icp")
    assert not rec.env._input.use_external_pose_list
    assert rec.env._input.x_min == PAIR_REGION["x_min"]
    assert [d["name"] for d in out["detections"]] == ref.names
    np.testing.assert_allclose(
        [d["translation"] for d in out["detections"]],
        [[p.x, p.y, p.z] for p in ref.poses], atol=1e-9)
    assert (out["stats"]["expands"] >= 2) == (mode == "tree")


def test_recognizer_from_mesh_files_writes_outputs(jax_env, tmp_path):
    """The ModelSpec (mesh file) constructor, and output_poses.txt /
    cost_dump.json written as the JAX recogniser writes them."""
    _write_box_ply(tmp_path / "red.ply", 0.12, 0.08, 0.10, (200, 40, 40))
    _write_box_ply(tmp_path / "green.ply", 0.06, 0.06, 0.16, (40, 200, 40))
    rec = ObjectRecognizer(
        [ModelSpec("red_box", str(tmp_path / "red.ply")),
         ModelSpec("green_box", str(tmp_path / "green.ply"))],
        PCAM, _port_env(jax_env).perch, _port_env(jax_env).env,
        use_external_pose_list=True, target_triangles=16, device="cpu")
    rin = jax_env._input
    out_dir = tmp_path / "out"
    result = rec.localize_objects_greedy_render(
        RecognitionInput(depth_image=rin.depth_image,
                         label_mask=rin.label_mask,
                         cam_to_world=rin.cam_to_world,
                         segmented_object_names=["red_box", "green_box"]),
        {k: np.asarray(v) for k, v in _pose_lists().items()},
        output_dir=str(out_dir))
    assert sorted(result.names) == ["green_box", "red_box"]
    recs = read_output_poses(str(out_dir / "output_poses.txt"))
    assert {r["name"] for r in recs} == {"red_box", "green_box"}
    assert (out_dir / "cost_dump.json").exists()
    for r in recs:
        gt = gt_states()[0 if r["name"] == "red_box" else 1].pose
        assert np.linalg.norm(np.asarray(r["location"])
                              - [gt.x, gt.y, gt.z]) < 0.12


def _served_detections(rec, payload) -> dict:
    """POST /localize with `payload` to `rec` behind the port's HTTP
    service: {name: detection}."""
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/localize"
    try:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            out = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    return {d["name"]: d for d in out["detections"]}


@pytest.mark.parametrize("change", [
    dict(kernel_backend="xla"), dict(fine_stride=1),
    dict(pose_refinement_rounds=1),
])
def test_unported_env_options_raise(jax_env, change):
    """The env options the port once refused. kernel_backend "xla" still
    raises; fine_stride and pose_refinement_rounds now run: given as
    env_params (EnvConfig.from_yaml_dict, as the CLI and a served
    recogniser read them), a greedy /localize request gives JAX's
    detections within 1 mm. The fine-stride scene runs at a quarter of
    make_env's point capacities (JAX's knn_self holds [L, 4 cap, 4 cap]
    distances on the CPU)."""
    from perception_tpu.serve import LocalizerService as JaxService

    from tests.test_serve import _FakeRecognizer

    env = _port_env(jax_env)
    env_cfg = dataclasses.replace(env.env, **change)
    if change.get("kernel_backend") == "xla":
        with pytest.raises(NotImplementedError):
            PerceptionEnv(env.bank, PCAM, env.perch, env_cfg, device="cpu")
        return
    jenv = make_env()
    caps = (dict(max_observed_points=1024, max_points_per_label=512)
            if "fine_stride" in change else {})
    jenv.env = dataclasses.replace(
        jenv.env, icp_mode="fused", kernel_backend="pallas_direct_interpret",
        **caps, **change)
    jenv.perch = dataclasses.replace(jenv.perch, gpu_batch_size=BATCH)
    payload = _payload(jax_env, _pose_lists())
    ref = {d["name"]: d for d in
           JaxService(_FakeRecognizer(jenv)).handle(payload)["detections"]}
    params = {**dataclasses.asdict(env.env), **caps, **change}
    rec = ObjectRecognizer.from_models(
        convert.models_from_jax(jax_env.bank.models), PCAM, env.perch,
        EnvConfig.from_yaml_dict(params), t_cap=16, device="cpu")
    for key, value in {**caps, **change}.items():
        assert getattr(rec.env.env, key) == value
    dets = _served_detections(rec, payload)
    assert set(dets) == set(ref) == {"red_box", "green_box"}
    for name, d in dets.items():
        np.testing.assert_allclose(d["translation"], ref[name]["translation"],
                                   atol=1e-3)


def test_unported_inputs_raise(jax_env):
    """The 3-DoF input (no instance mask) was not ported and raised; now
    set_input takes it: one segment of every observed point inside the
    search region, the JAX package's observed_cloud_from_depth on the same
    frame with its bounds filter."""
    import jax.numpy as jnp

    from perception_tpu.ops.pointcloud import observed_cloud_from_depth

    env = _port_env(jax_env)
    rin = jax_env._input
    region = dict(x_min=0.5, x_max=0.7, y_min=-0.05, y_max=0.3,
                  table_height=-0.2)
    env.set_input(RecognitionInput(depth_image=rin.depth_image,
                                   cam_to_world=rin.cam_to_world,
                                   use_external_pose_list=False, **region))
    cam, e = env.camera, env.env
    ref = observed_cloud_from_depth(
        jnp.asarray(rin.depth_image, jnp.float32),
        jnp.zeros((cam.height, cam.width, 3), jnp.float32),
        jnp.ones((cam.height, cam.width), jnp.int32),
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
        height=cam.height, stride=env.perch.gpu_stride,
        depth_factor=rin.depth_factor, max_points=e.max_observed_points,
        seg_cap=e.max_points_per_label, num_labels=e.max_labels,
        use_label_filter=False, use_bounds_filter=True,
        bounds=jnp.asarray([0.7, 0.5, 0.3, -0.05, 1.8, -0.21], jnp.float32),
        cam_to_world=jnp.asarray(rin.cam_to_world, jnp.float32))
    obs = env._observed
    assert 0 < int(obs.count) < int((rin.depth_image > 0).sum())
    assert int(obs.count) == int(ref.count) == int(obs.seg_count[0])
    np.testing.assert_array_equal(obs.seg_xyz.numpy(), np.asarray(ref.seg_xyz))
    assert env._scorer_config().cost_type == 0


def test_render_composite_matches_jax(jax_env):
    """The full-frame stride-1 observation render through the direct kernel
    twin against the JAX render (its XLA raster off a TPU): depth and labels
    equal except on <= 1% of pixels, which lie on a silhouette (a 3x3
    neighbourhood with another label or background in the reference: an
    edge covered by one raster and missed by the other shows what lies
    behind it) or within 1 cm (the direct kernel's quantised inverse
    depth)."""
    env = _port_env(jax_env)
    ref_d, ref_c, ref_l = jax_env.render_composite(gt_states())
    d, c, l = env.render_composite(gt_states())
    assert (ref_d > 0).sum() > 1000
    same = (d == ref_d) & (l == ref_l)
    assert same.mean() >= 0.99
    pad = np.pad(ref_l, 1, mode="edge")
    h, w = ref_l.shape
    edge = np.zeros_like(same)
    for dy in range(3):
        for dx in range(3):
            edge |= pad[dy:dy + h, dx:dx + w] != ref_l
    diff = ~same
    assert (edge[diff] | (np.abs(d[diff] - ref_d[diff]) <= 1)).all()
    np.testing.assert_array_equal(c[same], ref_c[same])


def test_warmup_localises_its_own_scene(jax_env):
    rec = _port_recognizer(jax_env)
    assert rec.warmup() > 0
    assert rec.last_state.num_objects == 2
    for obj in rec.last_state.object_states:
        y = 0.12 * (obj.id - 0.5)
        assert np.linalg.norm([obj.pose.x - 0.58, obj.pose.y - y,
                               obj.pose.z + 0.02]) < 0.02


def test_color_greedy_winners_match_jax(jax_color_env):
    """Greedy recognition with the colour gate: the same winners as JAX,
    costs within 2, translations within 1 mm."""
    cands = jittered_candidates(gt_states(), np.random.default_rng(11),
                                n=6, sigma=0.02)
    ref_state, ref_chosen = jax_color_env.compute_greedy_poses(cands)
    env = _port_env(jax_color_env)
    rin = jax_color_env._input
    env.set_input(RecognitionInput(
        depth_image=rin.depth_image, color_image=rin.color_image,
        label_mask=rin.label_mask, depth_factor=rin.depth_factor,
        cam_to_world=rin.cam_to_world,
        segmented_object_names=rin.segmented_object_names))
    assert env._scorer_config().cost_type == 3
    build.reset_counts()
    state, chosen = env.compute_greedy_poses(cands)
    assert set(build.TWIN_CALLS) == {"raster_direct", "icp_fused",
                                     "cost_fused_color"}
    assert state.num_objects == ref_state.num_objects == 2
    for r, o in zip(ref_chosen, chosen):
        assert (o.state.id, o.state.segmentation_label_id) == \
            (r.state.id, r.state.segmentation_label_id)
        assert abs(o.cost - r.cost) <= 2, (o.cost, r.cost)
        np.testing.assert_allclose(o.adjusted_pose_cam[:3, 3],
                                   r.adjusted_pose_cam[:3, 3], atol=1e-3)


def test_color_localize_round_trip_matches_jax(jax_color_env):
    """POST /localize carrying a color_image over the port's HTTP service:
    the colour reaches set_input (the observed Lab differs from a
    colourless request's), the colour twin scores, and the detections are
    the JAX service's within 1 mm."""
    from perception_tpu.serve import LocalizerService as JaxService

    from tests.test_serve import _FakeRecognizer

    payload = _payload(jax_color_env, _pose_lists())
    payload["color_image"] = np.asarray(
        jax_color_env._input.color_image).tolist()
    ref = JaxService(_FakeRecognizer(jax_color_env)).handle(payload)

    rec = _port_recognizer(jax_color_env)
    server = serve(rec, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/localize"
    try:
        build.reset_counts()
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert build.TWIN_CALLS["cost_fused_color"] == 1
    assert out["stats"]["decode_time"] > 0
    np.testing.assert_array_equal(
        rec.env._scene.seg_rgb.numpy(),
        np.asarray(jax_color_env._scene.seg_rgb))
    assert rec.env._scene.seg_lab.abs().sum() > 0
    ref_dets = {d["name"]: d for d in ref["detections"]}
    dets = {d["name"]: d for d in out["detections"]}
    assert set(dets) == set(ref_dets) == {"red_box", "green_box"}
    for name, d in dets.items():
        np.testing.assert_allclose(d["translation"],
                                   ref_dets[name]["translation"], atol=1e-3)
