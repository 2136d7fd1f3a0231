"""The port's coefficient-table ("pallas") and scatter-bin ("pallas_bin")
rasters and the kernel-backend switch, against the JAX package, whose Pallas
kernels run in interpret mode.

Tolerances:
  * coefficient-table keys: JAX's render_pose_batch has no interpreted
    "pallas" branch, so the JAX keys come from its setup (as
    render_pose_batch's setup_pallas computes it) through pack_coefficients
    and rasterize_keys_pallas(interpret=True). Coverage must be equal and
    depth may differ by 1 cm on fewer than 0.5% of pixels: the JAX test's
    own bar (XLA's CPU backend contracts a*b+c into FMAs and computes the
    camera transform with einsum, the port rounds every product in a fixed
    order);
  * the bin raster against rasterize_bin_pallas(interpret=True): depth and
    triangle ids equal except on at most 1% of pixels, each of them a
    silhouette pixel (empty on one side; a triangle edge the FMA moves
    across a sample) or a 1 cm step of the quantised inverse depth;
  * the port's bin keys equal the port's direct keys bit for bit;
  * the slices as `tests/test_torch_scorer.py` states them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perception_tpu.ops import pallas_raster as jpr
from perception_tpu.ops import rasterizer as jras
from perception_tpu.pipeline import scorer as jscorer
from perception_tpu_torch import convert
from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import raster_bin, raster_direct, raster_keys
from perception_tpu_torch.ops import rasterizer as pras
from perception_tpu_torch.pipeline import scorer as pscorer

from tests.test_torch_raster import CAM, INVALID, _scene
from tests.test_torch_scorer import _assert_slice_close, _score_both


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROIS = [None, (24, 24)]


def _jax_keys_inputs(bank, poses, ids, roi):
    """JAX's coefficient-table raster inputs: render_pose_batch's
    setup_pallas (camera transform, backface cull, projection,
    coefficients, screen bboxes), packed, and its ROI anchors."""
    proj = jnp.asarray(CAM.projection())
    cull = jnp.asarray(bank.backface_cull)[ids]

    def setup(tv, ok, pose, cull):
        v_cam = jnp.einsum("ij,tvj->tvi", pose[:3, :3], tv) + pose[:3, 3]
        normal = jnp.cross(v_cam[:, 1] - v_cam[:, 0], v_cam[:, 2] - v_cam[:, 0])
        facing = jnp.sum(normal * v_cam[:, 0], axis=-1) < 0.0
        ok = ok & (facing | ~cull)
        pts2, z = jras.screen_vertices(v_cam * 100.0, proj, CAM.width,
                                       CAM.height)
        coefs, aux, cok = jras.triangle_coefficients(pts2, z, ok)
        bbox = jnp.stack([
            jnp.where(cok, pts2[..., 0].min(axis=-1), jnp.inf),
            jnp.where(cok, pts2[..., 0].max(axis=-1), -jnp.inf),
            jnp.where(cok, pts2[..., 1].min(axis=-1), jnp.inf),
            jnp.where(cok, pts2[..., 1].max(axis=-1), -jnp.inf)], axis=-1)
        return coefs, aux, cok, bbox

    coefs, aux, cok, bboxes = jax.vmap(setup)(
        jnp.asarray(bank.tri_verts[ids]), jnp.asarray(bank.tri_valid[ids]),
        jnp.asarray(poses), cull)
    packed = jpr.pack_coefficients(coefs, aux, cok)
    if roi is None:
        anchors = jnp.zeros((len(poses), 2), jnp.int32)
    else:
        valid = jnp.asarray(bank.tri_valid)
        centers = ((jnp.asarray(bank.tri_verts) * valid[..., None, None])
                   .sum(axis=(1, 2))
                   / (3.0 * jnp.maximum(valid.sum(axis=1), 1)[:, None]))
        anchors = jras.compute_roi_anchors(
            jnp.asarray(poses), proj, CAM.width, CAM.height, 2, roi,
            model_centers=centers[ids])
    return packed, bboxes, anchors


def _jax_keys(packed, bboxes, anchors, roi):
    return np.asarray(jpr.rasterize_keys_pallas(
        packed, width=CAM.width, height=CAM.height, stride=2,
        anchors=anchors, roi_shape=roi, tri_bboxes=bboxes, interpret=True))


def _assert_keys_bar(ref_keys, out_keys):
    """Equal coverage; depth within 1 cm, and off on < 0.5% of pixels."""
    ref, out = np.asarray(ref_keys), np.asarray(out_keys)
    assert (ref != INVALID).any()
    np.testing.assert_array_equal(out != INVALID, ref != INVALID)
    dd = np.abs((out >> 11).astype(np.int64) - (ref >> 11))[ref != INVALID]
    assert dd.max() <= 1 and (dd > 0).mean() < 0.005, (dd.max(),
                                                       (dd > 0).mean())


def _render(bank, poses, ids, roi, backend):
    verts, colors, valid, cull = convert.bank_tensors(bank)
    return pras.render_pose_batch(
        verts, colors, valid, convert.tensor(poses), convert.tensor(ids),
        convert.tensor(CAM.projection()), width=CAM.width, height=CAM.height,
        stride=2, roi_shape=roi, bank_backface=cull, backend=backend)


def _keys_of(out) -> np.ndarray:
    depth, tri = out.depth.numpy(), out.tri_id.numpy()
    return np.where(tri < 0, INVALID, (depth << 11) | tri).reshape(
        len(depth), -1)


@pytest.mark.parametrize("roi", ROIS)
def test_keys_render_matches_jax_keys_kernel(roi):
    """render_pose_batch(backend="pallas") (keys_setup, pack_coefficients,
    the keys twin) against JAX's setup and rasterize_keys_pallas, two
    models, both backface-culled."""
    bank, poses, ids = _scene(seed=5)
    assert bank.backface_cull.all()
    build.reset_counts()
    out = _render(bank, poses, ids, roi, "pallas")
    assert build.TWIN_CALLS == {"raster_keys": 1}
    packed, bboxes, anchors = _jax_keys_inputs(bank, poses, ids, roi)
    np.testing.assert_array_equal(out.anchors.numpy(), np.asarray(anchors))
    _assert_keys_bar(_jax_keys(packed, bboxes, anchors, roi), _keys_of(out))


@pytest.mark.parametrize("roi", ROIS)
def test_keys_twin_matches_jax_on_identical_coefficients(roi):
    """The keys twin fed JAX's own packed coefficients and bboxes."""
    bank, poses, ids = _scene(seed=7)
    packed, bboxes, anchors = _jax_keys_inputs(bank, poses, ids, roi)
    t = convert.tensor
    out = raster_keys.rasterize_keys(
        t(packed), t(bboxes), t(anchors), width=CAM.width, height=CAM.height,
        stride=2, roi_shape=roi)
    assert out.dtype == torch.int32
    _assert_keys_bar(_jax_keys(packed, bboxes, anchors, roi), out.numpy())


def test_keys_setup_and_packing_match_jax():
    """keys_setup + pack_coefficients against JAX's: the same culled set and
    coefficient rows within float32 rounding of the camera transform."""
    bank, poses, ids = _scene(seed=11)
    packed, bboxes, _ = _jax_keys_inputs(bank, poses, ids, None)
    verts, _, valid, cull = convert.bank_tensors(bank)
    coefs, abs_base, ok, bb = pras.keys_setup(
        verts, valid, convert.tensor(poses), convert.tensor(ids).long(),
        convert.tensor(CAM.projection()), CAM.width, CAM.height, cull)
    out = raster_keys.pack_coefficients(coefs, abs_base, ok).numpy()
    ref = np.asarray(packed)
    np.testing.assert_array_equal(np.isinf(out[..., 8]), np.isinf(ref[..., 8]))
    drawn = ~np.isinf(ref[..., 8])
    assert drawn.any() and (~drawn).any()
    np.testing.assert_allclose(out[drawn], ref[drawn], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(bb.numpy(), np.asarray(bboxes), rtol=1e-5,
                               atol=1e-3)


def test_chunk_bboxes_pad_and_widen():
    """prepare_inputs hands the kernel each triangle's own screen box as it
    comes (the kernel widens it by 1 px and culls per triangle; there are no
    per-chunk boxes to pad or widen any more), as contiguous f32 beside the
    f32 coefficients and int32 anchors (zeros for the full frame)."""
    inf = float("inf")
    boxes = torch.tensor([[[10.0, 20.0, 5.0, 9.0], [inf, -inf, inf, -inf],
                           [12.0, 30.0, 1.0, 4.0]]], dtype=torch.float64)
    (c, b, a), kw = raster_keys.prepare_inputs(
        torch.zeros((1, 3, 12), dtype=torch.float64), boxes,
        torch.ones((1, 2), dtype=torch.int64), width=64, height=48, stride=2,
        roi_shape=(8, 8))
    assert (c.dtype, b.dtype, a.dtype) == (torch.float32, torch.float32,
                                           torch.int32)
    np.testing.assert_array_equal(b.numpy(), boxes.numpy())
    np.testing.assert_array_equal(a.numpy(), [[1, 1]])
    assert kw == dict(height=48, stride=2, roi_h=8, roi_w=8)
    strided = torch.zeros((2, 4, 300)).transpose(1, 2)
    (_, b, a), kw = raster_keys.prepare_inputs(
        torch.zeros((2, 300, 12)), strided, None, width=64, height=48,
        stride=2)
    assert b.shape == (2, 300, 4) and b.is_contiguous()
    assert a.dtype == torch.int32 and not a.any() and a.shape == (2, 2)
    assert (kw["roi_h"], kw["roi_w"]) == (24, 32)


@pytest.mark.parametrize("roi", ROIS)
def test_bin_render_matches_jax_bin_kernel(roi):
    """render_pose_batch(backend="pallas_bin") against JAX's with
    "pallas_bin_interpret", two models with backface culling."""
    bank, poses, ids = _scene(seed=7)
    ref = jras.render_pose_batch(
        bank.tri_verts, bank.tri_colors, bank.tri_valid, poses, ids,
        jnp.asarray(CAM.projection()), width=CAM.width, height=CAM.height,
        stride=2, roi_shape=roi, bank_backface=jnp.asarray(bank.backface_cull),
        backend="pallas_bin_interpret")
    build.reset_counts()
    out = _render(bank, poses, ids, roi, "pallas_bin")
    assert build.TWIN_CALLS == {"raster_bin": 1}
    np.testing.assert_array_equal(out.anchors.numpy(), np.asarray(ref.anchors))
    r_d, o_d = np.asarray(ref.depth), out.depth.numpy()
    r_t, o_t = np.asarray(ref.tri_id), out.tri_id.numpy()
    assert (r_d > 0).any()
    same = (r_d == o_d) & (r_t == o_t)
    assert same.mean() >= 0.99, same.mean()
    silhouette = (r_d[~same] == 0) | (o_d[~same] == 0)
    step = (np.abs(r_d[~same] - o_d[~same]) <= 1) & (r_t[~same] == o_t[~same])
    assert (silhouette | step).all()


@pytest.mark.parametrize("roi", ROIS)
def test_bin_keys_equal_direct_keys(roi):
    """The bin twin (binning dropped: it never changes a key) equals the
    direct twin bit for bit, also at a bank padded to a multiple of 16."""
    bank, poses, ids = _scene(n_poses=8, seed=3)
    for t_keep in (16, 12):
        verts, _, valid, cull = convert.bank_tensors(bank)
        v16 = raster_direct.pack_bank_verts(verts[:, :t_keep],
                                            valid[:, :t_keep], cull)
        proj = convert.tensor(CAM.projection())
        rng = np.random.default_rng(2)
        anchors = convert.tensor(rng.integers(0, 30, (len(poses), 2)),
                                 dtype=torch.int32)
        kw = dict(width=CAM.width, height=CAM.height, stride=2,
                  roi_shape=roi)
        args = (v16, convert.tensor(poses), convert.tensor(ids), anchors,
                proj)
        direct = raster_direct.rasterize_direct(*args, **kw)
        binned = raster_bin.rasterize_bin(*args, **kw)
        assert (direct != INVALID).any()
        np.testing.assert_array_equal(binned.numpy(), direct.numpy())


def test_bin_prepare_pads_to_groups_and_sizes_shared_memory():
    """The bin kernel takes the direct raster's arguments as they are (no
    padding: it bins single triangles, not 16-triangle groups). Its shared
    memory, all of it dynamic, is 82 B per triangle, 36 B for the block,
    and 4 B per 8x4-pixel patch of the window it bins at a time: the whole
    ROI, unless that outgrows the block's shared memory, at any T up to
    2048."""
    v16 = torch.zeros((2, 16, 20))
    (same, *_), kw = raster_bin.prepare_inputs(
        v16, torch.eye(4)[None].repeat(3, 1, 1), torch.zeros(3),
        torch.zeros((3, 2)), torch.eye(4), width=640, height=480, stride=8,
        roi_shape=(32, 32))
    assert same.shape == (2, 16, 20) and kw["roi_h"] == 32
    # 4 x 8 patches over 32x32.
    assert raster_bin.window(32, 32, 32) == (4, 8)
    assert raster_bin.shared_bytes(32, 32, 32) == 32 * 82 + 36 + 4 * 32
    # T = 2048 over the 80x60 strided frame: 10 x 15 patches.
    assert raster_bin.shared_bytes(2048, 60, 80) == 2048 * 82 + 36 + 4 * 150
    # T = 2048 at 640x480 stride 1 fits whole; a 4000x4000 ROI in windows
    # of 500 x 32 patches.
    assert raster_bin.window(2048, 480, 640) == (80, 120)
    assert raster_bin.window(2048, 4000, 4000) == (500, 32)
    # T = 16 over 1984x932: 248 x 233 patches, 9 more than the counts that
    # fit beside the triangles and the block's 36 B, so two windows.
    assert raster_bin.window(16, 932, 1984) == (248, 232)
    for t in (16, 256, 2048):
        for roi in ((60, 80), (480, 640), (932, 1984), (4000, 4000),
                    (8, 600000)):
            assert raster_bin.shared_bytes(t, *roi) <= \
                raster_bin.MAX_SHARED_BYTES


@pytest.mark.parametrize("name", ["raster_keys", "raster_bin"])
def test_kernel_launchers_refuse_cpu_tensors(name):
    """A launcher takes CUDA tensors only: no fallback to the twin."""
    bank, poses, ids = _scene(n_poses=2)
    if name == "raster_keys":
        args, kw = raster_keys.prepare_inputs(
            torch.zeros((2, 16, 12)), torch.zeros((2, 16, 4)), None,
            width=CAM.width, height=CAM.height, stride=2)
        launch = raster_keys.launch_kernel
    else:
        verts, _, valid, cull = convert.bank_tensors(bank)
        args, kw = raster_bin.prepare_inputs(
            raster_direct.pack_bank_verts(verts, valid, cull),
            convert.tensor(poses), convert.tensor(ids),
            torch.zeros((2, 2), dtype=torch.int32),
            convert.tensor(CAM.projection()), width=CAM.width,
            height=CAM.height, stride=2)
        launch = raster_bin.launch_kernel
    with pytest.raises(ValueError, match="tensors on cpu"):
        launch(*args, **kw)


@pytest.mark.parametrize("backend,error", [
    ("xla", NotImplementedError), ("pallas_direct_interpret", ValueError),
    ("pallas_bin_interpret", ValueError), ("pallas_interpret", ValueError),
    ("triton", ValueError)])
def test_other_backends_raise(backend, error):
    bank, poses, ids = _scene(n_poses=2)
    with pytest.raises(error):
        _render(bank, poses, ids, None, backend)


@pytest.mark.parametrize("jax_backend,port", [
    ("pallas", "pallas"), ("pallas_bin", "pallas_bin"),
    ("pallas_bin_interpret", "pallas_bin"), ("pallas_direct", "auto"),
    ("pallas_direct_interpret", "auto"), ("auto", "auto"), ("xla", "auto")])
def test_scorer_config_from_jax_keeps_the_raster(jax_backend, port):
    cfg = jscorer.ScorerConfig(backend=jax_backend)
    assert convert.scorer_config_from_jax(cfg).backend == port


def _bench_slice(monkeypatch, n_poses=16):
    from benchmarks.bench_scene import build_bench_problem

    monkeypatch.setenv("BENCH_MODELS", "blob")
    env, _, args, cfg = build_bench_problem(n_poses=n_poses)
    return env, args, dataclasses.replace(cfg, icp_mode="fused")


def test_bin_slice_matches_jax_bin(monkeypatch):
    """The bench problem scored with the bin raster on both sides."""
    env, args, cfg = _bench_slice(monkeypatch)
    build.reset_counts()
    ref, out = _score_both(
        env._render_bank, args[3:],
        dataclasses.replace(cfg, backend="pallas_bin_interpret"),
        env._bank_icp_samples, env._bank_icp_normals)
    assert set(build.TWIN_CALLS) == {"raster_bin", "icp_fused", "cost_fused"}
    _assert_slice_close(ref, out)


def test_keys_slice_matches_jax_direct_and_port_auto(monkeypatch):
    """The bench problem scored through the coefficient-table raster,
    against JAX's direct-kernel slice and the port's own "auto" slice."""
    env, args, cfg = _bench_slice(monkeypatch)
    ref, _ = _score_both(
        env._render_bank, args[3:],
        dataclasses.replace(cfg, backend="pallas_direct_interpret"),
        env._bank_icp_samples, env._bank_icp_normals)
    t = convert.tensor
    pcfg = convert.scorer_config_from_jax(cfg)
    outs = {}
    for backend in ("pallas", "auto"):
        build.reset_counts()
        outs[backend] = pscorer.score_pose_batch(
            *[t(a) for a in env._render_bank[:3]], *[t(a) for a in args[3:8]],
            convert.scene_from_jax(args[8]),
            dataclasses.replace(pcfg, backend=backend),
            bank_backface=t(env._render_bank[3]),
            bank_icp_samples=t(env._bank_icp_samples),
            bank_icp_normals=t(env._bank_icp_normals))
        raster = "raster_keys" if backend == "pallas" else "raster_direct"
        assert set(build.TWIN_CALLS) == {raster, "icp_fused", "cost_fused"}
    _assert_slice_close(ref, outs["pallas"])

    class _Port:   # the port's "auto" slice in the reference's place
        total_cost = outs["auto"].total_cost.numpy()
        adjusted_poses = outs["auto"].adjusted_poses.numpy()

    _assert_slice_close(_Port, outs["pallas"])


@pytest.mark.parametrize("backend,raster", [
    ("pallas", "raster_keys"), ("pallas_bin", "raster_bin"),
    ("pallas_direct", "raster_direct")])
def test_env_kernel_backend_switch(backend, raster):
    """EnvConfig.kernel_backend reaches the scorer's raster; the observation
    render (render_composite of the ground truth, the problem's only raster
    call while it is built) keeps the direct kernel."""
    from perception_tpu_torch.eval.bench_scene import build_bench_problem

    build.reset_counts()
    bp = build_bench_problem(n_poses=6, model_kind="blob", device="cpu",
                             kernel_backend=backend)
    assert build.TWIN_CALLS == {"raster_direct": 1}
    assert bp.cfg.backend == backend
    build.reset_counts()
    scored = bp.env.score_object_states(bp.candidates)
    assert build.TWIN_CALLS[raster] == 1
    assert sum(build.TWIN_CALLS.values()) == 3
    assert any(s.cost >= 0 for s in scored)
