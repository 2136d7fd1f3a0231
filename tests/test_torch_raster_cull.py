"""The direct raster's tile cull (`csrc/raster_direct.cu`), emulated in
plain PyTorch on the bench models, against its twin.

The kernel gives each block a run of 16x16-pixel tiles; per tile it keeps
the triangles whose 1-px-widened screen box meets the tile's own x and y
extents (a warp vote compacts them), and each warp then skips the
survivors whose box misses its 8x4 pixel patch. Neither test may drop a
triangle that covers a pixel: restricting the twin to a tile's survivors,
and to a patch's, must give the full twin's keys exactly (the twin culls
nothing). The emulation computes the boxes and extents in the kernel's
float32 order of operations, including the y-flip of screen rows.
"""

import numpy as np
import pytest
import torch

from perception_tpu_torch import convert
from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.core.mesh import ModelBank, mesh_model_from_arrays
from perception_tpu_torch.core.pose import euler_xyz_to_matrix
from perception_tpu_torch.eval.bench_scene import bumpy_blob
from perception_tpu_torch.ops import raster_direct as prd
from perception_tpu_torch.ops import rasterizer as pras


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


INVALID = 2**31 - 1
TILE = 16                      # csrc/raster_direct.cu kTile
PATCH_W, PATCH_H = 8, 4        # a warp's pixels in a tile
BENCH_CAM = dict(fx=1066.778, fy=1067.487, cx=312.9869, cy=241.3109,
                 width=640, height=480)
# (camera, stride, roi): the scoring ROIs, the ragged 80x60 full frame
# (a 12-row last tile row), and a small frame at stride 1 (72 = 4 x 16 + 8).
FRAMES = {
    "roi32": (BENCH_CAM, 8, (32, 32)),
    "roi24": (BENCH_CAM, 8, (24, 24)),
    "full80x60": (BENCH_CAM, 8, None),
    "stride1_96x72": (dict(fx=160.0, fy=160.0, cx=47.5, cy=35.5, width=96,
                           height=72), 1, None),
}


def _problem(t_cap: int, cam: CameraIntrinsics, n_poses: int = 6,
             seed: int = 0):
    """The four bench models decimated to <= t_cap triangles (the bank
    padded to t_cap) and random bench-like poses, the last one behind the
    camera."""
    rng = np.random.default_rng(seed)
    models = []
    for i in range(4):
        v, f = bumpy_blob(rng, radius=0.05 + 0.015 * i, target=t_cap)
        models.append(mesh_model_from_arrays(f"blob{i}", v, f))
    bank = ModelBank.from_models(models, t_cap=t_cap)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_poses, 1, 1))
    for i in range(n_poses):
        poses[i, :3, :3] = euler_xyz_to_matrix(*rng.uniform(-np.pi, np.pi, 3))
        poses[i, :3, 3] = [rng.uniform(-0.08, 0.08), rng.uniform(-0.06, 0.06),
                           rng.uniform(0.55, 0.8)]
    poses[-1, 2, 3] = -0.6
    ids = rng.integers(0, 4, n_poses).astype(np.int32)
    verts, _, valid, cull = convert.bank_tensors(bank)
    verts16 = prd.pack_bank_verts(verts, valid, cull)
    centers = ((verts.mean(dim=2) * valid[..., None]).sum(dim=1)
               / valid.sum(dim=1, keepdim=True))
    return verts16, torch.as_tensor(poses), torch.as_tensor(ids), centers


def _widened_boxes(verts16, pose12, ids, proj12, width, height):
    """Per pose and triangle the kernel's screen box widened by 1 px,
    [N, 4, T] (min x, max x, min y, max y), +-3e38 where the setup culls the
    triangle."""
    v = verts16[ids.long()]
    p = [pose12[:, i:i + 1] for i in range(12)]
    pr = proj12.tolist()
    hw, hh = 0.5 * width, 0.5 * height
    sx, sy = [], []
    for k in range(3):
        vx, vy, vz = v[:, 3 * k], v[:, 3 * k + 1], v[:, 3 * k + 2]
        cx = p[0] * vx + p[1] * vy + p[2] * vz + p[3]
        cy = p[4] * vx + p[5] * vy + p[6] * vz + p[7]
        cz = p[8] * vx + p[9] * vy + p[10] * vz + p[11]
        zc = cz * 100.0
        xc, yc = cx * 100.0, cy * 100.0
        clip_x = xc * pr[0] + yc * pr[1] + zc * pr[2] + pr[3]
        clip_y = yc * pr[5] + zc * pr[6] + pr[7]
        zdiv = torch.where(zc > 1e-3, zc, 1.0)
        sx.append(clip_x / zdiv * hw + hw)
        sy.append(clip_y / zdiv * hh + hh)
    sx, sy = torch.stack(sx), torch.stack(sy)
    # The setup's own verdict: culled triangles carry abs_base = -inf.
    coefs = prd._triangle_setup(verts16, pose12, ids, proj12, width, height)
    ok = torch.isfinite(coefs[:, 8])
    big = torch.tensor(3e38, dtype=torch.float32)
    return coefs, torch.stack([
        torch.where(ok, sx.amin(0) - 1.0, big),
        torch.where(ok, sx.amax(0) + 1.0, -big),
        torch.where(ok, sy.amin(0) - 1.0, big),
        torch.where(ok, sy.amax(0) + 1.0, -big)], dim=1)


def _meets(boxes, anchors, c0, c1, r0, r1, height, stride):
    """[N, T]: the boxes that meet the strided columns c0..c1 and rows
    r0..r1 of each pose's ROI (the kernel's float extents and test, NaN
    boxes kept)."""
    x0, y0 = anchors[:, 0:1], anchors[:, 1:2]
    x_min = ((x0 + c0) * stride).float()
    x_max = ((x0 + c1) * stride).float()
    y_max = (height - 1 - (y0 + r0) * stride).float()
    y_min = (height - 1 - (y0 + r1) * stride).float()
    return ~((boxes[:, 0] > x_max) | (boxes[:, 1] < x_min)
             | (boxes[:, 2] > y_max) | (boxes[:, 3] < y_min))


def _keys_of(coefs, keep, anchors, c0, c1, r0, r1, height, stride):
    """The twin's keys over ROI columns c0..c1 and rows r0..r1 with only the
    `keep` triangles, [N, rows, cols]."""
    masked = torch.where(keep[:, None, :], coefs, float("nan"))
    shift = torch.tensor([c0, r0], dtype=anchors.dtype)
    rows, cols = r1 - r0 + 1, c1 - c0 + 1
    keys = prd.twin_keys(masked, anchors + shift, height=height,
                         stride=stride, roi_h=rows, roi_w=cols, w_test=True)
    return keys.reshape(-1, rows, cols)


@pytest.mark.parametrize("t_cap", [200, 1024])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_tile_cull_keeps_every_covering_triangle(frame, t_cap):
    cam_kw, stride, roi = FRAMES[frame]
    cam = CameraIntrinsics(**cam_kw)
    verts16, poses, ids, centers = _problem(t_cap, cam)
    proj = torch.as_tensor(cam.projection())
    if roi is None:
        anchors = torch.zeros((len(poses), 2), dtype=torch.int32)
    else:
        anchors = pras.compute_roi_anchors(
            poses, proj, cam.width, cam.height, stride, roi,
            model_centers=centers[ids.long()]).to(torch.int32)
    args, kw = prd.prepare_inputs(verts16, poses, ids, anchors, proj,
                                  width=cam.width, height=cam.height,
                                  stride=stride, roi_shape=roi)
    verts16, pose12, ids32, anchors, proj12 = args
    roi_h, roi_w = kw["roi_h"], kw["roi_w"]
    full = prd.rasterize_direct_twin(*args, **kw).reshape(-1, roi_h, roi_w)
    assert (full[:-1] != INVALID).flatten(1).any(dim=1).all()
    assert (full[-1] == INVALID).all()          # the pose behind the camera
    coefs, boxes = _widened_boxes(verts16, pose12, ids32, proj12, cam.width,
                                  cam.height)
    kept = []
    for r0 in range(0, roi_h, TILE):
        for c0 in range(0, roi_w, TILE):
            c1, r1 = min(c0 + TILE, roi_w) - 1, min(r0 + TILE, roi_h) - 1
            keep = _meets(boxes, anchors, c0, c1, r0, r1, cam.height, stride)
            kept.append(keep.float().mean().item())
            tile_keys = _keys_of(coefs, keep, anchors, c0, c1, r0, r1,
                                 cam.height, stride)
            torch.testing.assert_close(
                tile_keys, full[:, r0:r1 + 1, c0:c1 + 1], rtol=0, atol=0)
            for pr0 in range(r0, r1 + 1, PATCH_H):
                for pc0 in range(c0, c1 + 1, PATCH_W):
                    pc1 = min(pc0 + PATCH_W - 1, c1)
                    pr1 = min(pr0 + PATCH_H - 1, r1)
                    patch = keep & _meets(boxes, anchors, pc0, pc1, pr0, pr1,
                                          cam.height, stride)
                    torch.testing.assert_close(
                        _keys_of(coefs, patch, anchors, pc0, pc1, pr0, pr1,
                                 cam.height, stride),
                        full[:, pr0:pr1 + 1, pc0:pc1 + 1], rtol=0, atol=0)
    # The cull does cull: most (pose, triangle) pairs leave each tile.
    assert np.mean(kept) < 0.5
