"""The port's switches and host API against the JAX package: the decimator
(`PT_DECIMATE`, vertex clustering), the model cache's key and directory
(`PT_MODEL_CACHE_DIR`), the fused ICP's early-exit knob (the port's
`EnvConfig.icp_stagnation_streak`, set to what JAX's `PT_ICP_NO_EARLY_EXIT`
/ `PT_ICP_STREAK` resolve to), the direct raster's area cull on clustered
banks, and `world_to_optical_cam`.

Meshes, banks and cache keys are held to JAX exactly. The scored batch
under the switches takes `tests/test_torch_scorer.py`'s slice tolerance
(translations within 1 mm, totals equal on >= 75% and within 5), since
XLA's CPU backend contracts a*b+c into FMAs and PyTorch does not. Small
sizes: the 128x96 box scene of tests/test_pipeline.py, a few poses, one
PyTorch thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import bench_scene as jbench
from perception_tpu.core import mesh as jmesh
from perception_tpu.core import pose as jpose
from perception_tpu.eval import model_zoo as jzoo
from perception_tpu.io import model_cache as jcache
from perception_tpu.native import loader as jnative
from perception_tpu.pipeline import env as jenv_mod
from perception_tpu_torch import convert
from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.core import mesh as pmesh
from perception_tpu_torch.core import native as pnative
from perception_tpu_torch.core import pose as ppose
from perception_tpu_torch.eval import bench_scene as pbench
from perception_tpu_torch.eval import model_zoo as pzoo
from perception_tpu_torch.io import model_cache as pcache
from perception_tpu_torch.ops import raster_direct as prd

from tests.test_pipeline import gt_states, make_env
from tests.test_search_e2e import _write_box_ply
from tests.test_torch_env_fine import _port_env
from tests.test_torch_host import BANK_ARRAYS, _write_binary_ply
from tests.test_torch_scorer import (
    _assert_slice_close,
    _box_candidates,
    _score_both,
)

ZOO = tuple(pzoo._ZOO)
SWITCHES = ("PT_DECIMATE", "PT_MODEL_CACHE_DIR", "PT_ICP_NO_EARLY_EXIT",
            "PT_ICP_STREAK")
BENCH_CAM = dict(fx=1066.778, fy=1067.487, cx=312.9869, cy=241.3109,
                 width=640, height=480)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    """Every case starts with the four switches unset."""
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)


def _assert_same(out_p, out_j):
    assert len(out_p) == len(out_j)
    for a, b in zip(out_p, out_j):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _bumpy_source():
    """The first bench model's icosphere before decimation (5120 faces):
    what `bumpy_blob` hands the decimator."""
    seen = {}
    saved = jmesh.decimate

    def record(v, f, colors, target, mode=None):
        seen["mesh"] = (v, f)
        return saved(v, f, colors, target, mode)

    jmesh.decimate = record
    try:
        jbench.bumpy_blob(np.random.default_rng(0), radius=0.05)
    finally:
        jmesh.decimate = saved
    return seen["mesh"]


@pytest.mark.parametrize("target", [256, 128, 64])
@pytest.mark.parametrize("source", ZOO + ("bumpy1024",))
def test_vertex_clustering_matches_jax(source, target):
    """Vertices, face order and colours exactly equal to JAX's
    decimate_vertex_clustering (zoo shapes at four times their tessellation,
    with their vertex colours; the bench's bumpy icosphere without)."""
    if source == "bumpy1024":
        v, f = _bumpy_source()
        colors = None
    else:
        v, f, colors, _ = jzoo.zoo_raw_geometry(source, 4.0)
        vp, fp, cp, _ = pzoo.zoo_raw_geometry(source, 4.0)
        _assert_same((vp, fp, cp), (v, f, colors))
    assert len(f) > target
    out_p = pmesh.decimate_vertex_clustering(v, f, colors, target)
    out_j = jmesh.decimate_vertex_clustering(v, f, colors, target)
    _assert_same(out_p, out_j)
    assert 0 < len(out_p[1]) <= target


@pytest.mark.parametrize("setting", [None, "", "qem", "cluster"])
def test_decimate_mode_and_dispatch_match_jax(monkeypatch, setting):
    """PT_DECIMATE unset, "qem" and "cluster": the same resolved mode as
    JAX and the same mesh; QEM (unset or "qem") is the C++ decimator as
    before; an explicit mode beats the variable. An empty variable counts
    as unset (JAX's resolver returns "" there, which its dispatch takes
    for "cluster")."""
    if setting is not None:
        monkeypatch.setenv("PT_DECIMATE", setting)
    assert pmesh.decimate_mode() == (setting or "qem")
    assert jmesh.decimate_mode() == ("" if setting == "" else
                                     setting or "qem")
    assert pmesh.decimate_mode("qem") == "qem"
    rng = np.random.default_rng(3)
    v, f = jbench.convex_blob(rng, radius=0.05, n_pts=800)
    cols = rng.uniform(0, 255, (len(v), 3))
    out_p = pmesh.decimate(v, f, cols, 150)
    _assert_same(out_p, jmesh.decimate(v, f, cols, 150,
                                       mode="qem" if setting == "" else None))
    if setting == "cluster":
        _assert_same(out_p, pmesh.decimate_vertex_clustering(v, f, cols, 150))
    else:
        _assert_same(out_p, pnative.decimate_qem(v, f, cols, 150))
    _assert_same(pmesh.decimate(v, f, cols, 150, mode="qem"),
                 pnative.decimate_qem(v, f, cols, 150))
    _assert_same(pmesh.decimate_qem(v, f, cols, 150),
                 jnative.decimate_qem_native(v, f, cols, 150))
    monkeypatch.setenv("PT_DECIMATE", "octree")
    with pytest.raises(ValueError, match="octree"):
        pmesh.decimate(v, f, cols, 150)


@pytest.mark.parametrize("kind", ["bumpy1024", "blob"])
def test_clustered_banks_match_jax(monkeypatch, kind):
    """Under PT_DECIMATE=cluster: the bench models (the bumpy ones are
    decimated to 1024 by clustering), mesh_model_from_arrays with
    target_triangles, ModelBank.from_models and the render-LOD banks at
    256 and 128 equal JAX's, bit for bit."""
    from tests.test_torch_host import _bench_models

    monkeypatch.setenv("PT_DECIMATE", "cluster")
    pmods, jmods = _bench_models(kind, pmesh.mesh_model_from_arrays,
                                 jmesh.mesh_model_from_arrays)
    pb = pmesh.ModelBank.from_models(pmods, t_cap=1024)
    jb = jmesh.ModelBank.from_models(jmods, t_cap=1024)
    for lod in (None, 256, 128):
        pl = pb if lod is None else pb.decimated(lod)
        jl = jb if lod is None else jb.decimated(lod)
        for a in BANK_ARRAYS:
            np.testing.assert_array_equal(getattr(pl, a), getattr(jl, a), a)
    v, f, c, _ = jzoo.zoo_raw_geometry("mug", 2.0)
    pm = pmesh.mesh_model_from_arrays("mug", v, f, colors=c,
                                      target_triangles=300)
    jm = jmesh.mesh_model_from_arrays("mug", v, f, colors=c,
                                      target_triangles=300)
    for fld in dataclasses.fields(pmesh.MeshModel):
        np.testing.assert_array_equal(getattr(pm, fld.name),
                                      getattr(jm, fld.name), fld.name)


def test_bench_problem_bank_under_cluster_matches_jax(monkeypatch):
    """build_bench_problem's bumpy1024 bank and its LOD-256 render bank,
    built by both packages under PT_DECIMATE=cluster, are JAX's exactly,
    and differ from the default QEM bank."""
    monkeypatch.setenv("BENCH_MODELS", "bumpy1024")
    monkeypatch.setenv("PT_DECIMATE", "cluster")
    jenv, _, jargs, _ = jbench.build_bench_problem(n_poses=4)
    bp = pbench.build_bench_problem(n_poses=4, model_kind="bumpy1024",
                                    device="cpu")
    for a in BANK_ARRAYS:
        np.testing.assert_array_equal(getattr(bp.env.bank, a),
                                      getattr(jenv.bank, a), a)
    for i in range(3):
        np.testing.assert_array_equal(bp.args[i].numpy(),
                                      np.asarray(jargs[i]), str(i))
    monkeypatch.delenv("PT_DECIMATE")
    rng = np.random.default_rng(0)
    qem = pmesh.mesh_model_from_arrays(
        "blob0", *pbench.bumpy_blob(rng, radius=0.05), colors=None,
        use_external_pose_list=True)
    assert qem.num_triangles != bp.env.bank.models[0].num_triangles


@pytest.mark.parametrize("mode", ["qem", "cluster"])
def test_cache_key_matches_jax(tmp_path, monkeypatch, mode):
    """The .npz cache key equals JAX's _cache_key for the same file,
    arguments and decimator; the two decimators key apart, and an unset
    PT_DECIMATE keys as "qem"."""
    path = str(tmp_path / "box.ply")
    _write_box_ply(path, 0.12, 0.08, 0.10, (200, 40, 40))
    kw = dict(name="box", use_external_pose_list=True, target_triangles=10)
    unset = pcache._cache_key(path, kw)
    monkeypatch.setenv("PT_DECIMATE", mode)
    key = pcache._cache_key(path, kw)
    assert key == jcache._cache_key(path, kw)
    assert (key == unset) == (mode == "qem")
    other = "cluster" if mode == "qem" else "qem"
    monkeypatch.setenv("PT_DECIMATE", other)
    assert pcache._cache_key(path, kw) != key


def test_model_cache_dir_from_the_environment(tmp_path, monkeypatch):
    """cache_dir=None reads $PT_MODEL_CACHE_DIR: a QEM load writes its
    entry, a clustered load of the same file writes another (equal to
    JAX's clustered load_model), and a later QEM load is served the QEM
    entry, never the clustered one."""
    path = str(tmp_path / "blob.ply")
    _write_binary_ply(path, np.random.default_rng(5))
    cache = tmp_path / "cache"
    monkeypatch.setenv("PT_MODEL_CACHE_DIR", str(cache))
    kw = dict(name="blob", use_external_pose_list=True, target_triangles=60)
    qem = pcache.load_model_cached(path, **kw)
    assert len(list(cache.glob("*.npz"))) == 1
    monkeypatch.setenv("PT_DECIMATE", "cluster")
    clustered = pcache.load_model_cached(path, **kw)
    assert len(list(cache.glob("*.npz"))) == 2
    ref = jmesh.load_model(path, **kw)
    for fld in dataclasses.fields(pmesh.MeshModel):
        np.testing.assert_array_equal(getattr(clustered, fld.name),
                                      getattr(ref, fld.name), fld.name)
    assert clustered.tri_verts.shape != qem.tri_verts.shape or \
        not np.array_equal(clustered.tri_verts, qem.tri_verts)
    monkeypatch.setenv("PT_DECIMATE", "qem")
    again = pcache.load_model_cached(path, **kw)
    assert len(list(cache.glob("*.npz"))) == 2
    for fld in dataclasses.fields(pmesh.MeshModel):
        np.testing.assert_array_equal(getattr(again, fld.name),
                                      getattr(qem, fld.name), fld.name)


@pytest.mark.parametrize("variables", [
    {}, {"PT_ICP_NO_EARLY_EXIT": "1"}, {"PT_ICP_STREAK": "3"},
    {"PT_ICP_NO_EARLY_EXIT": "1", "PT_ICP_STREAK": "3"}])
def test_streak_field_carries_jax_switches(monkeypatch, variables):
    """The port's one early-exit knob is EnvConfig.icp_stagnation_streak:
    the port's library reads neither variable (a harness maps them onto the
    field, as the JAX package's accuracy harness does), and the field set
    to what JAX's _resolve_streak_env gives reaches the port's scorer
    configuration as the switches reach JAX's."""
    for var, value in variables.items():
        monkeypatch.setenv(var, value)
    env = make_env()
    env.set_observation_from_states(gt_states())
    expect = env._scorer_config(do_icp=True).icp_stagnation_streak
    default = env.env.icp_stagnation_streak
    assert expect == jenv_mod._resolve_streak_env(default)
    penv = _port_env(env)
    assert penv._scorer_config(do_icp=True).icp_stagnation_streak == default
    penv.env = dataclasses.replace(penv.env, icp_stagnation_streak=expect)
    assert penv._scorer_config(do_icp=True).icp_stagnation_streak == expect


@pytest.mark.parametrize("variable", ["PT_ICP_NO_EARLY_EXIT",
                                      "PT_ICP_STREAK"])
def test_scored_batch_under_streak_switch_matches_jax(monkeypatch, variable):
    """Eight box-scene candidates scored with the fused ICP by JAX under
    PT_ICP_NO_EARLY_EXIT=1 (streak 10**9) or PT_ICP_STREAK=2
    (interpret-mode kernels), and by the port's twins with the streak field
    set to the value JAX resolved."""
    monkeypatch.setenv(variable, "1" if variable == "PT_ICP_NO_EARLY_EXIT"
                       else "2")
    env = make_env()
    env.env = dataclasses.replace(env.env, icp_mode="fused", roi_size=20,
                                  kernel_backend="pallas_direct_interpret")
    env.set_observation_from_states(gt_states())
    cfg = env._scorer_config(do_icp=True)
    assert cfg.icp_stagnation_streak == (
        10**9 if variable == "PT_ICP_NO_EARLY_EXIT" else 2)
    penv = _port_env(env)
    penv.env = dataclasses.replace(
        penv.env, icp_stagnation_streak=cfg.icp_stagnation_streak)
    pcfg = penv._scorer_config(do_icp=True)
    assert pcfg.icp_stagnation_streak == cfg.icp_stagnation_streak
    cands = _box_candidates(8, seed=20)
    poses = np.stack([env.pose_to_camera(s) for s in cands])
    ids = np.asarray([s.id for s in cands], np.int32)
    labels = np.asarray([s.segmentation_label_id - 1 for s in cands],
                        np.int32)
    totals = np.asarray(env._observed.seg_count, np.float32)[labels]
    ref, out = _score_both(
        env._render_bank,
        (poses, ids, labels, totals, env._proj, env._scene),
        cfg, env._bank_icp_samples, env._bank_icp_normals)
    _assert_slice_close(ref, out)


@pytest.mark.parametrize("seed", [0, 1])
def test_world_to_optical_cam_matches_jax(seed):
    """world_to_optical_cam equals JAX's, and brings the camera's own
    origin to the optical frame's origin."""
    rng = np.random.default_rng(seed)
    cam_to_world = jpose.ContPose.from_euler(
        *rng.normal(0, 0.1, 3), *rng.normal(0, 0.5, 3)).transform()
    out = ppose.world_to_optical_cam(cam_to_world)
    np.testing.assert_array_equal(out, jpose.world_to_optical_cam(
        cam_to_world))
    np.testing.assert_allclose(out @ cam_to_world[:, 3], [0, 0, 0, 1],
                               atol=1e-12)


@pytest.mark.parametrize("decimator", ["qem", "cluster"])
def test_area_report_is_the_setups_cull(monkeypatch, decimator):
    """The twin's setup with areas=True (what chip_smoke.py counts the
    clustered bank's slivers with) reports exactly the pairs its area cull
    removes: a pair is drawn iff it reaches the cull and its screen area
    exceeds AREA_CULL_PX2. On the four bumpy bench models at the LOD-256
    bank, 64 bench-like poses at 640x480."""
    monkeypatch.setenv("PT_DECIMATE", decimator)
    rng = np.random.default_rng(0)
    models = [pmesh.mesh_model_from_arrays(
        f"blob{i}", *pbench.bumpy_blob(rng, radius=0.05 + 0.015 * i))
        for i in range(4)]
    bank = pmesh.ModelBank.from_models(models, t_cap=1024).decimated(256)
    verts, _, valid, cull = convert.bank_tensors(bank)
    verts16 = prd.pack_bank_verts(verts, valid, cull)
    n = 64
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        poses[i, :3, :3] = ppose.euler_xyz_to_matrix(
            *rng.uniform(-np.pi, np.pi, 3))
        poses[i, :3, 3] = [rng.uniform(-0.08, 0.08),
                           rng.uniform(-0.06, 0.06), rng.uniform(0.55, 0.8)]
    cam = CameraIntrinsics(**BENCH_CAM)
    args, kw = prd.prepare_inputs(
        verts16, torch.as_tensor(poses), torch.as_tensor(
            rng.integers(0, 4, n)), None, torch.as_tensor(cam.projection()),
        width=cam.width, height=cam.height, stride=8)
    verts16, pose12, ids, _, proj12 = args
    ok, area = prd._triangle_setup(verts16, pose12, ids, proj12, cam.width,
                                   cam.height, areas=True)
    coefs = prd._triangle_setup(verts16, pose12, ids, proj12, cam.width,
                                cam.height)
    assert ok.shape == area.shape == coefs[:, 8].shape
    assert ok.sum() > 0
    assert torch.equal(torch.isfinite(coefs[:, 8]),
                       ok & (area > prd.AREA_CULL_PX2))
