"""The port's own host modules against the JAX package's originals, the rule
that the port imports nothing of the JAX package, the audit that it has
every public name, class member and parameter of the JAX package (but for
the exclusions by design in NOT_PORTED), and the card as the default
device.

Copies are held to the originals exactly: configuration fields and
defaults, poses, model banks built from the same meshes (the same QEM
decimation, in the port's own copy of the C++ decimator), surface samples
and the bytes of the pose files.
"""

import ast
import dataclasses
import inspect
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import bench_scene as jbench
from perception_tpu.core import config as jconfig
from perception_tpu.core import mesh as jmesh
from perception_tpu.core import pose as jpose
from perception_tpu.core import state as jstate
from perception_tpu.io import model_cache as jcache
from perception_tpu.io import poses_file as jposes
from perception_tpu.utils import stats as jstats
from perception_tpu_torch import convert
from perception_tpu_torch.core import config as pconfig
from perception_tpu_torch.core import mesh as pmesh
from perception_tpu_torch.core import pose as ppose
from perception_tpu_torch.core import state as pstate
from perception_tpu_torch.eval import bench_scene as pbench
from perception_tpu_torch.io import model_cache as pcache
from perception_tpu_torch.io import poses_file as pposes
from perception_tpu_torch.utils import stats as pstats

from tests.jax_native import jax_native_qem  # noqa: F401  (fixture)
from tests.test_search_e2e import _write_box_ply

REPO = Path(__file__).resolve().parent.parent
BANK_ARRAYS = ("tri_verts", "tri_colors", "tri_valid", "backface_cull")


def _fields(cls) -> dict:
    return {f.name: (f.default, f.default_factory)
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", [
    "CameraIntrinsics", "PerchConfig", "EnvConfig"])
def test_config_fields_and_defaults_match_jax(name):
    assert _fields(getattr(pconfig, name)) == _fields(getattr(jconfig, name))


def test_config_behaviour_matches_jax():
    cam = dict(fx=500.0, fy=510.0, cx=320.0, cy=240.0, width=640, height=480)
    np.testing.assert_array_equal(
        pconfig.CameraIntrinsics(**cam).projection(),
        jconfig.CameraIntrinsics(**cam).projection())
    raw = {"perch_params": {"sensor_resolution_radius": 0.02,
                            "visualize_expanded_states": True,
                            "use_color_cost": True, "unknown": 1}}
    assert dataclasses.asdict(pconfig.PerchConfig.from_yaml_dict(raw)) == \
        dataclasses.asdict(jconfig.PerchConfig.from_yaml_dict(raw))
    env = {"roi_size": 32, "render_lod": 128, "unknown": 3}
    pe, je = (pconfig.EnvConfig.from_yaml_dict(env),
              jconfig.EnvConfig.from_yaml_dict(env))
    assert dataclasses.asdict(pe) == dataclasses.asdict(je)


def test_stats_and_state_fields_match_jax():
    assert _fields(pstats.EnvStats) == _fields(jstats.EnvStats)
    assert _fields(pstate.ObjectState) == _fields(jstate.ObjectState)
    assert _fields(pstate.GraphState) == _fields(jstate.GraphState)
    assert _fields(pmesh.MeshModel) == _fields(jmesh.MeshModel)
    assert _fields(pmesh.ModelBank) == _fields(jmesh.ModelBank)
    s = pstats.EnvStats()
    s.update_peak_memory(torch.device("cpu"))
    assert s.peak_device_mem_mb == 0.0
    g = pstate.GraphState().append(pstate.ObjectState(
        id=1, symmetric=False, pose=ppose.ContPose(x=1.0)))
    assert g.num_objects == 1


def test_poses_round_trip_like_jax():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(ppose.CAM_TO_BODY, jpose.CAM_TO_BODY)
    for _ in range(50):
        e = rng.uniform(-3, 3, 3)
        rp, rj = ppose.euler_xyz_to_matrix(*e), jpose.euler_xyz_to_matrix(*e)
        np.testing.assert_array_equal(rp, rj)
        assert ppose.matrix_to_quat(rp) == jpose.matrix_to_quat(rj)
        q = ppose.matrix_to_quat(rp)
        t = rng.normal(size=3)
        pq, jq = ppose.ContPose.from_quat(*t, *q), jpose.ContPose.from_quat(*t, *q)
        np.testing.assert_array_equal(pq.transform(), jq.transform())
        assert pq.quaternion() == jq.quaternion()
        pm = ppose.ContPose.from_matrix(pq.transform())
        assert dataclasses.asdict(pm) == dataclasses.asdict(
            jpose.ContPose.from_matrix(jq.transform()))
        np.testing.assert_allclose(pm.transform(), pq.transform(), atol=1e-12)
        pe, je = ppose.ContPose.from_euler(*t, *e), jpose.ContPose.from_euler(*t, *e)
        np.testing.assert_array_equal(pe.transform(), je.transform())
        assert pe.quaternion() == je.quaternion()


def _bench_models(kind, pm, jm):
    """The bench scene's first two models made by both packages from the
    same seed."""
    rp, rj = np.random.default_rng(0), np.random.default_rng(0)
    pmods, jmods = [], []
    for i in range(2):
        if kind == "bumpy1024":
            vp, fp = pbench.bumpy_blob(rp, radius=0.05 + 0.015 * i)
            vj, fj = jbench.bumpy_blob(rj, radius=0.05 + 0.015 * i)
        else:
            vp, fp = pbench.convex_blob(rp, radius=0.05 + 0.015 * i)
            vj, fj = jbench.convex_blob(rj, radius=0.05 + 0.015 * i)
        np.testing.assert_array_equal(vp, vj)
        np.testing.assert_array_equal(fp, fj)
        cp, cj = rp.uniform(40, 220, (len(vp), 3)), rj.uniform(40, 220,
                                                               (len(vj), 3))
        pmods.append(pm(f"blob{i}", vp, fp, colors=cp,
                        use_external_pose_list=True))
        jmods.append(jm(f"blob{i}", vj, fj, colors=cj,
                        use_external_pose_list=True))
    return pmods, jmods


@pytest.mark.parametrize("kind", ["bumpy1024", "blob"])
def test_bank_and_lod_bank_match_jax(kind, jax_native_qem):
    """ModelBank.from_models at 1024 triangles and the LOD-256 re-decimation
    give the JAX package's arrays, and so do the surface samples."""
    pmods, jmods = _bench_models(kind, pmesh.mesh_model_from_arrays,
                                 jmesh.mesh_model_from_arrays)
    pb = pmesh.ModelBank.from_models(pmods, t_cap=1024)
    jb = jmesh.ModelBank.from_models(jmods, t_cap=1024)
    for a in BANK_ARRAYS:
        np.testing.assert_array_equal(getattr(pb, a), getattr(jb, a), a)
    pl, jl = pb.decimated(256), jb.decimated(256)
    for a in BANK_ARRAYS:
        np.testing.assert_array_equal(getattr(pl, a), getattr(jl, a), a)
    for x, y in zip(pb.surface_samples(256), jb.surface_samples(256)):
        np.testing.assert_array_equal(x, y)
    assert pb.index_of("blob1#2") == jb.index_of("blob1#2") == 1
    cb = convert.bank_from_jax(jb)
    for a in BANK_ARRAYS:
        np.testing.assert_array_equal(getattr(cb, a), getattr(pb, a), a)
    assert [m.name for m in cb.models] == [m.name for m in pb.models]


@pytest.mark.parametrize("target", [64, 300])
def test_decimate_matches_jax(target, jax_native_qem):
    """With PT_DECIMATE unset the port decimates by QEM, and the JAX
    package's QEM gives the same mesh."""
    rng = np.random.default_rng(3)
    v, f = jbench.convex_blob(rng, radius=0.05, n_pts=800)
    cols = rng.uniform(0, 255, (len(v), 3))
    out_p = pmesh.decimate(v, f, cols, target)
    out_j = jmesh.decimate(v, f, cols, target, mode="qem")
    for a, b in zip(out_p, out_j):
        np.testing.assert_array_equal(a, b)
    ok_p, faces_p = pmesh.analyze_winding(v, f)
    ok_j, faces_j = jmesh.analyze_winding(v, f)
    assert ok_p == ok_j
    np.testing.assert_array_equal(faces_p, faces_j)


def _write_binary_ply(path, rng):
    """A binary little-endian PLY blob with vertex colours and an extra
    per-face property."""
    v, f = jbench.convex_blob(rng, radius=0.05, n_pts=200)
    cols = rng.integers(0, 256, (len(v), 3)).astype(np.uint8)
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              f"element face {len(f)}\nproperty list uchar int vertex_indices\n"
              "property float quality\nend_header\n")
    vert = np.zeros(len(v), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                   ("r", "u1"), ("g", "u1"), ("b", "u1")])
    vert["x"], vert["y"], vert["z"] = v.T
    vert["r"], vert["g"], vert["b"] = cols.T
    face = np.zeros(len(f), dtype=[("n", "u1"), ("i", "<i4", 3),
                                   ("q", "<f4")])
    face["n"], face["i"], face["q"] = 3, f, 0.5
    with open(path, "wb") as fh:
        fh.write(header.encode() + vert.tobytes() + face.tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_mesh_files_load_like_jax(tmp_path, fmt, jax_native_qem):
    """PLY reading (the port's C++ loader against both of the JAX
    package's readers), load_model with decimation, and the .npz model
    cache."""
    path = str(tmp_path / "box.ply")
    if fmt == "ascii":
        _write_box_ply(path, 0.12, 0.08, 0.10, (200, 40, 40))
    else:
        _write_binary_ply(path, np.random.default_rng(5))
    for a, b in zip(pmesh.read_mesh(path), jmesh.read_mesh(path)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pmesh.read_mesh(path), jmesh.read_ply(path)):
        np.testing.assert_array_equal(a, b)
    kw = dict(name="box", use_external_pose_list=True, target_triangles=10)
    pm, jm = pmesh.load_model(path, **kw), jmesh.load_model(path, **kw)
    for f in dataclasses.fields(pmesh.MeshModel):
        np.testing.assert_array_equal(getattr(pm, f.name),
                                      getattr(jm, f.name), f.name)
    cache = str(tmp_path / "cache")
    first = pcache.load_model_cached(path, cache_dir=cache, **kw)
    again = pcache.load_model_cached(path, cache_dir=cache, **kw)
    ref = jcache.load_model_cached(path, cache_dir=str(tmp_path / "j"), **kw)
    for m in (first, again):
        for f in dataclasses.fields(pmesh.MeshModel):
            np.testing.assert_array_equal(getattr(m, f.name),
                                          getattr(ref, f.name), f.name)


def test_mesh_library_keeps_a_static_libstdcxx_private(tmp_path):
    """Built by a compiler that links libstdc++ statically, the mesh library
    must keep that copy private: exported, it binds part of its iostream
    calls to the process's own libstdc++ (loaded by torch), and the PLY
    parser misreads every element count (or segfaults). With the port's
    flags such a build reads a file as the shared-libstdc++ build does."""
    from perception_tpu_torch.core import native

    lib = tmp_path / "libmesh_static.so"
    subprocess.run(["g++", *native.CXX_FLAGS, "-static-libstdc++", "-o",
                    str(lib), str(native.SOURCE)], check=True,
                   capture_output=True, timeout=300)
    ply = str(tmp_path / "box.ply")
    _write_box_ply(ply, 0.12, 0.08, 0.10, (200, 40, 40))
    code = ("import ctypes, numpy as np, torch\n"
            "from perception_tpu_torch.core import native\n"
            f"ref = native.load_mesh({ply!r})\n"
            "shared = native.library()\n"
            f"lib = ctypes.CDLL({str(lib)!r})\n"
            "for name in ('pt_load_mesh', 'pt_free', 'pt_last_error'):\n"
            "    getattr(lib, name).argtypes = getattr(shared, name).argtypes\n"
            "    getattr(lib, name).restype = getattr(shared, name).restype\n"
            "native._lib = lib\n"
            f"out = native.load_mesh({ply!r})\n"
            "assert len(out[0]) == 8, out[0].shape\n"
            "for a, b in zip(out, ref):\n"
            "    assert np.array_equal(a, b), (a, b)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_pose_files_have_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    dets_p, dets_j = [], []
    for i in range(3):
        t, q = rng.normal(size=3), jpose.matrix_to_quat(
            jpose.euler_xyz_to_matrix(*rng.uniform(-2, 2, 3)))
        pre = np.eye(4)
        pre[:3, 3] = rng.normal(size=3)
        dets_p.append((f"m{i}", ppose.ContPose.from_quat(*t, *q), pre))
        dets_j.append((f"m{i}", jpose.ContPose.from_quat(*t, *q), pre))
    pposes.write_output_poses(str(tmp_path / "p.txt"), dets_p)
    jposes.write_output_poses(str(tmp_path / "j.txt"), dets_j)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    parsed = pposes.read_output_poses(str(tmp_path / "p.txt"))
    ref = jposes.read_output_poses(str(tmp_path / "j.txt"))
    assert [r["name"] for r in parsed] == [r["name"] for r in ref]
    for a, b in zip(parsed, ref):
        np.testing.assert_array_equal(a["transform_matrix"],
                                      b["transform_matrix"])
    stats = pstats.EnvStats(scenes_rendered=7, time=1.5)
    pposes.write_output_stats(str(tmp_path / "ps.txt"), stats)
    jposes.write_output_stats(str(tmp_path / "js.txt"),
                              jstats.EnvStats(scenes_rendered=7, time=1.5))
    assert (tmp_path / "ps.txt").read_bytes() == \
        (tmp_path / "js.txt").read_bytes()
    rows = rng.normal(size=(5, 7))
    np.savetxt(tmp_path / "poses.txt", rows)
    np.testing.assert_array_equal(
        pposes.read_poses_file(str(tmp_path / "poses.txt")),
        jposes.read_poses_file(str(tmp_path / "poses.txt")))
    # cost_dump.json from the same scored candidates.
    pre = np.eye(4)
    model = types.SimpleNamespace(preprocessing_transform=pre)
    env = types.SimpleNamespace(bank=types.SimpleNamespace(models=[model]))
    scored = [types.SimpleNamespace(
        state=types.SimpleNamespace(id=0, pose=d[1]), target_cost=3,
        source_cost=4, cost=7) for d in dets_p]
    pposes.write_cost_dump(str(tmp_path / "pc.json"), scored, env)
    jposes.write_cost_dump(str(tmp_path / "jc.json"), scored, env)
    assert json.loads((tmp_path / "pc.json").read_text()) == \
        json.loads((tmp_path / "jc.json").read_text())


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_sources_import_nothing_of_the_jax_package():
    """An AST scan of every module of the port and of chip_smoke.py: no
    import of jax, perception_tpu or benchmarks, at any depth of the
    file (function-level imports included)."""
    files = sorted((REPO / "perception_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 25
    scanned = {str(f.relative_to(REPO)) for f in files}
    later = {f"perception_tpu_torch/{m}.py" for m in (
        "parallel/__init__", "parallel/sharding", "parallel/dist",
        "parallel/run", "tools/view_generator", "eval/ycb",
        "eval/workloads", "eval/fat", "eval/shapestacks", "eval/dope",
        "eval/densefusion", "eval/vfh", "eval/demo_frame")}
    assert later <= scanned, later - scanned
    bad = {str(f.relative_to(REPO)): name for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "perception_tpu",
                                     "benchmarks")}
    assert not bad, bad


def _env_attributes(path: Path) -> tuple[set, set]:
    """(read, assigned) attribute names of an env in a module: attributes of
    a name `env` or of any `<x>.env`, at any depth of the file."""
    def is_env(node):
        return ((isinstance(node, ast.Name) and node.id == "env")
                or (isinstance(node, ast.Attribute) and node.attr == "env"))

    read, assigned = set(), set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Attribute) and is_env(node.value):
            (read if isinstance(node.ctx, ast.Load)
             else assigned).add(node.attr)
    return read, assigned


@pytest.mark.parametrize("rel", ["pipeline/search.py", "pipeline/pruning.py",
                                 "parallel/run.py"])
def test_env_neighbours_reach_it_through_its_methods(rel):
    """The tree search, the successor pruning and the multi-process runner
    read none of the env's bank tensors, its projection or its tensor
    helper, and assign no attribute of an env: renders, camera poses and
    composed source images go through the env's methods."""
    read, assigned = _env_attributes(REPO / "perception_tpu_torch" / rel)
    bad = sorted(a for a in read if a.startswith(("_bank", "_render_bank"))
                 or a in ("_proj", "_tensor"))
    assert not bad, bad
    assert not assigned, sorted(assigned)


def test_no_module_beside_the_env_writes_its_private_state():
    """No module of pipeline/ but env.py, and none of parallel/, assigns a
    private attribute of an env."""
    port = REPO / "perception_tpu_torch"
    files = [f for d in ("pipeline", "parallel")
             for f in sorted((port / d).glob("*.py")) if f.name != "env.py"]
    assert len(files) > 8
    bad = {str(f.relative_to(REPO)): sorted(
        a for a in _env_attributes(f)[1] if a.startswith("_"))
        for f in files}
    bad = {k: v for k, v in bad.items() if v}
    assert not bad, bad


# JAX modules whose counterpart lies at another path of the port, or that
# are not ported by design (the XLA compile cache, a TPU tool).
ELSEWHERE = {
    "native/__init__.py": "core/native.py",
    "native/loader.py": "core/native.py",
    "ops/pallas_cost.py": "ops/cost_fused.py",
    "ops/pallas_icp.py": "ops/icp_fused.py",
    "ops/pallas_knn.py": "ops/knn.py",
    "ops/pallas_raster.py": "ops/raster_keys.py",
    "ops/pallas_raster_bin.py": "ops/raster_bin.py",
    "ops/pallas_raster_direct.py": "ops/raster_direct.py",
    "utils/compile_cache.py": None,
}


def test_every_jax_module_has_a_port_counterpart():
    """Each module of perception_tpu/ has one in perception_tpu_torch/ at
    the same path, or where ELSEWHERE says (the Pallas kernels' wrappers,
    the native loader); only the XLA compile cache has none."""
    jax_root, port_root = REPO / "perception_tpu", REPO / "perception_tpu_torch"
    missing = []
    for f in sorted(jax_root.rglob("*.py")):
        rel = str(f.relative_to(jax_root))
        if rel in ELSEWHERE:
            target = ELSEWHERE[rel]
            assert target is None or (port_root / target).exists(), rel
        elif not (port_root / rel).exists():
            missing.append(rel)
    assert not missing, missing



# Why a JAX name has no counterpart in the port. These five are the only
# reasons: the port does everything else the JAX package does.
TPU_TRICK = ("a TPU trick: a Pallas tile, grid or group constant, the "
             "interpreter switch, or a layout for the TPU's vector units")
XLA_BACKEND = 'backend "xla": the composed XLA path is not ported'
ONE_PROCESS_PER_CARD = ("one process per card: a rank drives one device, "
                        "not a mesh of devices")
XLA_CACHE = "the XLA compile cache"
NO_CALLER = ("legacy or test-only: nothing in the repo calls it but the "
             "JAX package's tests or its fallback for a missing C++ "
             "toolchain, which the port refuses")
REASONS = (TPU_TRICK, XLA_BACKEND, ONE_PROCESS_PER_CARD, XLA_CACHE,
           NO_CALLER)

# "module:name" (a top-level name), "module:Class.member", or
# "module:function(parameter)", all of the JAX package -> the reason.
NOT_PORTED = {
    "utils/compile_cache.py": XLA_CACHE,
    "core/mesh.py:read_ply": NO_CALLER,
    "core/mesh.py:read_obj": NO_CALLER,
    "core/mesh.py:read_mesh(prefer_native)": NO_CALLER,
    "native/loader.py:load_mesh_native(target_faces)": NO_CALLER,
    "ops/rasterizer.py:render_oracle_numpy": NO_CALLER,
    # JAX's picks "pallas" on a TPU, else "xla"; the port's "auto" is its
    # kernel on every device.
    "ops/rasterizer.py:default_backend": XLA_BACKEND,
    "pipeline/env.py:PerceptionEnv.set_observation_from_states(noise_std)":
        NO_CALLER,
    "ops/color.py:ciede2000_components(kernel_safe)": TPU_TRICK,
    "ops/cost.py:compute_costs_fused(interpret)": TPU_TRICK,
    "ops/cost.py:compute_costs_fused(bank_lab8)": TPU_TRICK,
    "ops/icp.py:icp_point_to_plane_batch(ref_tile)": TPU_TRICK,
    "ops/icp.py:icp_point_to_plane_batch(backend)": XLA_BACKEND,
    "ops/icp.py:icp_gicp_batch(ref_tile)": TPU_TRICK,
    "ops/icp.py:icp_gicp_batch(backend)": XLA_BACKEND,
    "ops/knn.py:nn1_batch(ref_tile)": TPU_TRICK,
    "ops/knn.py:knn_self(ref_tile)": TPU_TRICK,
    "ops/pallas_cost.py:R_TILE": TPU_TRICK,
    "ops/pallas_cost.py:pack_bank_lab": TPU_TRICK,
    "ops/pallas_cost.py:nn_cost_fused_pallas(interpret)": TPU_TRICK,
    "ops/pallas_cost.py:nn_cost_fused_color_pallas(interpret)": TPU_TRICK,
    "ops/pallas_cost.py:nn_cost_fused_color_tri_pallas(interpret)":
        TPU_TRICK,
    "ops/pallas_cost.py:nn_cost_fused_color_tri_pallas(bank_lab8)":
        TPU_TRICK,
    "ops/pallas_icp.py:gather_rows_onehot": TPU_TRICK,
    "ops/pallas_icp.py:icp_fused_pallas(interpret)": TPU_TRICK,
    "ops/pallas_icp.py:icp_fused_pallas(group)": TPU_TRICK,
    "ops/pallas_knn.py:Q_TILE": TPU_TRICK,
    "ops/pallas_knn.py:R_TILE": TPU_TRICK,
    "ops/pallas_knn.py:nn1_batch_pallas(interpret)": TPU_TRICK,
    "ops/pallas_raster.py:TILE_PIX": TPU_TRICK,
    "ops/pallas_raster.py:TRI_CHUNK": TPU_TRICK,
    "ops/pallas_raster.py:rasterize_keys_pallas(interpret)": TPU_TRICK,
    "ops/pallas_raster_bin.py:TILE_H": TPU_TRICK,
    "ops/pallas_raster_bin.py:TILE_W": TPU_TRICK,
    "ops/pallas_raster_bin.py:SUB_G": TPU_TRICK,
    "ops/pallas_raster_bin.py:TRI_CHUNK": TPU_TRICK,
    "ops/pallas_raster_bin.py:rasterize_bin_pallas(interpret)": TPU_TRICK,
    "ops/pallas_raster_bin.py:rasterize_bin_pallas(sub_g)": TPU_TRICK,
    "ops/pallas_raster_bin.py:rasterize_bin_pallas(tile_h)": TPU_TRICK,
    "ops/pallas_raster_bin.py:rasterize_bin_pallas(tile_w)": TPU_TRICK,
    "ops/pallas_raster_direct.py:TILE_PIX": TPU_TRICK,
    "ops/pallas_raster_direct.py:TRI_CHUNK": TPU_TRICK,
    "ops/pallas_raster_direct.py:SUB_BBOX": TPU_TRICK,
    "ops/pallas_raster_direct.py:SUB_BATCH": TPU_TRICK,
    "ops/pallas_raster_direct.py:rasterize_direct_pallas(interpret)":
        TPU_TRICK,
    "ops/rasterizer.py:render_pose_batch(tile)": TPU_TRICK,
    "parallel/sharding.py:make_pose_mesh(n_devices)": ONE_PROCESS_PER_CARD,
    "parallel/sharding.py:make_pose_mesh(devices)": ONE_PROCESS_PER_CARD,
    "pipeline/scorer.py:ObservedScene.seg_pk_crop": TPU_TRICK,
}

# Counterparts under another name: "module:name" -> the port's
# "module:name" (module paths below each package's root), and
# "module:function(parameter)" -> the port's parameter.
RENAMED = {
    "native/loader.py:load_mesh_native": "core/native.py:load_mesh",
    "native/loader.py:decimate_qem_native": "core/native.py:decimate_qem",
    "native/loader.py:native_available": "core/native.py:library",
    "native/loader.py:qem_available": "core/native.py:library",
    "ops/pallas_cost.py:nn_cost_fused_pallas":
        "ops/cost_fused.py:nn_cost_fused",
    "ops/pallas_cost.py:nn_cost_fused_color_pallas":
        "ops/cost_fused_color.py:nn_cost_fused_color",
    "ops/pallas_cost.py:nn_cost_fused_color_tri_pallas":
        "ops/cost_fused_color.py:nn_cost_fused_color_tri",
    "ops/pallas_icp.py:icp_fused_pallas": "ops/icp_fused.py:icp_fused",
    "ops/pallas_knn.py:nn1_batch_pallas": "ops/knn.py:nn1_batch",
    "ops/pallas_raster.py:rasterize_keys_pallas":
        "ops/raster_keys.py:rasterize_keys",
    "ops/pallas_raster_bin.py:rasterize_bin_pallas":
        "ops/raster_bin.py:rasterize_bin",
    "ops/pallas_raster_direct.py:rasterize_direct_pallas":
        "ops/raster_direct.py:rasterize_direct",
    # The port's table packer takes the |base| column alone.
    "ops/pallas_raster.py:pack_coefficients(aux)": "abs_base",
}

JAX_ROOT = REPO / "perception_tpu"
JAX_MODULES = sorted(str(f.relative_to(JAX_ROOT))
                     for f in JAX_ROOT.rglob("*.py"))


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _jax_surface(rel: str) -> dict:
    """The public names a JAX module defines at its top level: name ->
    ("def", parameters) | ("class", {member: parameters or None}) |
    ("var", None)."""
    tree = ast.parse((JAX_ROOT / rel).read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", _params(node))
        elif isinstance(node, ast.ClassDef):
            members = {}
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if b.name == "__init__" or not b.name.startswith("_"):
                        members[b.name] = _params(b)
                elif isinstance(b, ast.AnnAssign) and isinstance(
                        b.target, ast.Name):
                    members[b.target.id] = None
                elif isinstance(b, ast.Assign):
                    members.update({t.id: None for t in b.targets
                                    if isinstance(t, ast.Name)})
            out[node.name] = ("class", {m: p for m, p in members.items()
                                        if m == "__init__"
                                        or not m.startswith("_")})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update({t.id: ("var", None) for t in targets
                        if isinstance(t, ast.Name)})
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _port_module(rel: str):
    """The port's module for a path below perception_tpu_torch/."""
    import importlib

    name = rel[:-3].replace("/", ".")
    if name.endswith("__init__"):
        name = name[:-len(".__init__")]
    return importlib.import_module(
        "perception_tpu_torch" + ("." + name if name else ""))


def _port_params(obj) -> set[str] | None:
    """Parameter names of a port function, method or class (its
    __init__); None where there are none to read (a property, data)."""
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if isinstance(obj, property) or not callable(obj):
        return None
    try:
        params = inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return None
    return set(params) - {"self", "cls"}


def _port_member(cls, name: str):
    """A class's member as defined (dataclass fields without a default
    included), or a sentinel where it has none."""
    if name in getattr(cls, "__dataclass_fields__", {}):
        return "field"
    if hasattr(cls, name):
        return inspect.getattr_static(cls, name)
    return _MISSING


_MISSING = object()


def _missing_params(key: str, jax_params: list[str], port_obj) -> list:
    port = _port_params(port_obj)
    if port is None:
        return []
    out = []
    for p in jax_params:
        full = f"{key}({p})"
        if full in NOT_PORTED:
            continue
        if RENAMED.get(full, p) not in port:
            out.append(full)
    return out


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_every_public_name_of_the_jax_module(rel):
    """Every public top-level name of the JAX module, every public member
    (method, field, attribute) of its classes, and every parameter of a
    function or method both packages have, exists in the port's
    counterpart (the module ELSEWHERE names, or the one RENAMED names for
    the name), but for NOT_PORTED's entries."""
    if rel in NOT_PORTED:
        assert ELSEWHERE.get(rel, rel) is None, rel
        return
    port = _port_module(ELSEWHERE.get(rel, rel))
    missing = []
    for name, (kind, info) in _jax_surface(rel).items():
        key = f"{rel}:{name}"
        if key in NOT_PORTED:
            continue
        if key in RENAMED:
            mod, pname = RENAMED[key].split(":")
            obj = getattr(_port_module(mod), pname, _MISSING)
        else:
            obj = getattr(port, name, _MISSING)
        if obj is _MISSING:
            missing.append(key)
            continue
        if kind == "def":
            missing += _missing_params(key, info, obj)
        elif kind == "class":
            for member, params in info.items():
                mkey = f"{key}.{member}"
                if mkey in NOT_PORTED:
                    continue
                pm = _port_member(obj, member)
                if pm is _MISSING:
                    missing.append(mkey)
                elif params is not None:
                    missing += _missing_params(mkey, params, pm)
    assert not missing, missing


def test_audit_exclusions_are_by_design_and_current():
    """Every NOT_PORTED entry gives one of the five reasons and names a
    JAX module, name, member or parameter that exists and that the port
    lacks; every RENAMED entry names a JAX name and a port name that
    exist."""
    for key, reason in NOT_PORTED.items():
        assert reason in REASONS, key
        rel, _, rest = key.partition(":")
        assert (JAX_ROOT / rel).exists(), key
        if not rest:
            continue
        surface = _jax_surface(rel)
        name, _, param = rest.partition("(")
        top, _, member = name.partition(".")
        kind, info = surface[top]
        port = _port_module(ELSEWHERE.get(rel, rel))
        if param:
            params = info[member] if member else info
            assert param[:-1] in params, key
        elif member:
            assert member in info, key
            assert _port_member(getattr(port, top), member) is _MISSING, key
        else:
            assert not hasattr(port, top), key
    for key, target in RENAMED.items():
        rel, _, rest = key.partition(":")
        name, _, param = rest.partition("(")
        kind, info = _jax_surface(rel)[name]
        if param:
            assert param[:-1] in info, key
            assert target in _port_params(getattr(
                _port_module(ELSEWHERE.get(rel, rel)), name)), key
        else:
            mod, pname = target.split(":")
            assert hasattr(_port_module(mod), pname), key

def test_port_sources_need_no_cv2_pil_or_yaml():
    """The card machine has no cv2, PIL or yaml: no module of the port nor
    chip_smoke.py imports cv2 or PIL, and only the config reader
    (core/config.py, inside the function that reads a .yaml file) imports
    yaml."""
    files = sorted((REPO / "perception_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    found = {(str(f.relative_to(REPO)), name.split(".")[0]) for f in files
             for name in _imports(f)
             if name.split(".")[0] in ("cv2", "PIL", "yaml")}
    assert found == {("perception_tpu_torch/core/config.py", "yaml")}, found


def test_chip_smoke_imports_without_the_jax_package():
    code = ("import sys\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'perception_tpu', 'benchmarks')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _entry_points():
    from perception_tpu_torch.pipeline.env import PerceptionEnv
    from perception_tpu_torch.pipeline.recognizer import ObjectRecognizer

    return {"PerceptionEnv": PerceptionEnv.__init__,
            "ObjectRecognizer": ObjectRecognizer.__init__,
            "ObjectRecognizer.from_models": ObjectRecognizer.from_models,
            "build_bench_problem": pbench.build_bench_problem}


@pytest.mark.parametrize("name", ["PerceptionEnv", "ObjectRecognizer",
                                  "ObjectRecognizer.from_models",
                                  "build_bench_problem"])
def test_entry_points_default_to_the_card(name):
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_env_without_a_card_raises():
    """Asked for the default device on a machine without a card, the env
    raises instead of running on the CPU."""
    from perception_tpu_torch.pipeline.env import PerceptionEnv

    pmods, _ = _bench_models("blob", pmesh.mesh_model_from_arrays,
                             jmesh.mesh_model_from_arrays)
    bank = pmesh.ModelBank.from_models(pmods)
    cam = pconfig.CameraIntrinsics(fx=100.0, fy=100.0, cx=32.0, cy=24.0,
                                   width=64, height=48)
    if torch.cuda.is_available():
        assert PerceptionEnv(bank, cam).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PerceptionEnv(bank, cam)
        assert PerceptionEnv(bank, cam, device="cpu").device.type == "cpu"
