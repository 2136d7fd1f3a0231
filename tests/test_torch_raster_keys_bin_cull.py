"""The coefficient-table raster's tile cull (`csrc/raster_keys.cu`) and the
bin raster's patch scatter (`csrc/raster_bin.cu`), emulated in plain
PyTorch on the bench models, against their twins; and the keys path's
setup on the CPU.

The keys kernel keeps, per 16x16-pixel tile, the triangles whose screen box
(from the table's setup, widened by 1 px in the kernel) meets the tile's x
and y extents; each warp then skips the survivors whose box misses its 8x4
pixel patch. The bin kernel turns each drawable triangle's widened box into
a range of 8x4-pixel patches (in its float32 order of operations) and lists
the triangle in every patch of the range, or, when the range spans more than
`raster_bin.MAX_BINS` patches, in one wide list that every patch tests
against the range. Neither may drop a triangle that covers a pixel:
restricting each twin to what a tile, a patch or a patch's lists hand the
kernel must give the full twin's keys exactly (the twins cull nothing).

Run as a script, it prints the share of the dense (pixel, triangle) pairs
that each design tests on 47 bench-like poses and one behind the camera
(seed 1, T = 256), at the 32x32 ROI and the 80x60 full frame.
"""

import functools

import pytest
import torch

from perception_tpu_torch.core.config import CameraIntrinsics
from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import raster_bin as prb
from perception_tpu_torch.ops import raster_direct as prd
from perception_tpu_torch.ops import raster_keys as prk
from perception_tpu_torch.ops import rasterizer as pras

from tests.test_torch_raster_cull import FRAMES, _problem, _widened_boxes

INVALID = 2**31 - 1
TILE = 16                      # csrc/raster_keys.cu kTile
PATCH_W, PATCH_H = prb.PATCH_W, prb.PATCH_H
assert (PATCH_W, PATCH_H) == (8, 4)   # also the keys kernel's warp patch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Run this module's PyTorch CPU work on one thread: beside the other
    test workers, several intra-op threads per process only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _case(frame: str, t_cap: int, n_poses: int = 7, seed: int = 0,
          near: bool = True):
    """The bench problem of `tests/test_torch_raster_cull.py`, with its
    second-last pose moved close to the camera if `near` (its triangles span
    many patches; the last pose lies behind the camera): the direct
    raster's prepared arguments, the keys path's table (CPU setup) and the
    boxes the keys kernel widens."""
    cam_kw, stride, roi = FRAMES[frame]
    cam = CameraIntrinsics(**cam_kw)
    verts16, poses, ids, centers = _problem(t_cap, cam, n_poses, seed)
    if near:
        poses[-2, :3, 3] = torch.tensor([0.0, 0.0, 0.16])
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
    sargs, skw = prk.prepare_setup(verts16, poses, ids, proj,
                                   width=cam.width, height=cam.height)
    table, boxes = prk.setup_twin(*sargs, **skw)
    return cam, args, kw, table, boxes


def _widen(boxes):
    """[N, T, 4] -> [N, 4, T] boxes widened as the keys kernel does."""
    b = boxes.transpose(1, 2)
    return torch.stack([b[:, 0] - 1.0, b[:, 1] + 1.0, b[:, 2] - 1.0,
                        b[:, 3] + 1.0], dim=1)


def _extents(anchors, c0, c1, r0, r1, height, stride):
    """Each pose's float extents (x_min, x_max, y_min, y_max), [N, 1] each,
    of ROI columns c0..c1 and rows r0..r1, as the kernels compute them."""
    x0, y0 = anchors[:, 0:1], anchors[:, 1:2]
    return (((x0 + c0) * stride).float(), ((x0 + c1) * stride).float(),
            (height - 1 - (y0 + r1) * stride).float(),
            (height - 1 - (y0 + r0) * stride).float())


def _meets(boxes, ext):
    """[N, T]: the keys kernel's test of widened boxes [N, 4, T] against
    extents (a NaN box fails)."""
    x_min, x_max, y_min, y_max = ext
    return ((boxes[:, 0] <= x_max) & (boxes[:, 1] >= x_min)
            & (boxes[:, 2] <= y_max) & (boxes[:, 3] >= y_min))


def _keys_of(coefs, keep, anchors, c0, c1, r0, r1, height, stride, w_test):
    """A twin's keys over ROI columns c0..c1 and rows r0..r1 with only the
    `keep` triangles, [N, rows, cols]; coefs [N, 12, T]."""
    masked = torch.where(keep[:, None, :], coefs, float("nan"))
    shift = torch.tensor([c0, r0], dtype=anchors.dtype)
    rows, cols = r1 - r0 + 1, c1 - c0 + 1
    keys = prd.twin_keys(masked, anchors + shift, height=height,
                         stride=stride, roi_h=rows, roi_w=cols, w_test=w_test)
    return keys.reshape(-1, rows, cols)


def _patches(roi_h, roi_w):
    """(column, row) patch indices and ROI extents of every 8x4 patch."""
    for by in range(-(-roi_h // PATCH_H)):
        for bx in range(-(-roi_w // PATCH_W)):
            c0, r0 = bx * PATCH_W, by * PATCH_H
            yield (bx, by, c0, min(c0 + PATCH_W, roi_w) - 1, r0,
                   min(r0 + PATCH_H, roi_h) - 1)


def _bin_ranges(args, kw):
    """The bin kernel's per-triangle patch ranges [N, 4, T] (first and last
    patch column, first and last patch row; empty when first > last) and its
    setup coefficients [N, 12, T], in the kernel's float32 order."""
    verts16, pose12, ids, _, proj12 = args
    _, boxes = _widened_boxes(verts16, pose12, ids, proj12, kw["width"],
                              kw["height"])
    coefs = prd._triangle_setup(verts16, pose12, ids, proj12, kw["width"],
                                kw["height"], finite_guard=True)
    ok = torch.isfinite(coefs[:, 8])
    return _ranges(boxes, ok, args[3], kw, PATCH_W, PATCH_H), coefs


def _ranges(boxes, ok, anchors, kw, size_w, size_h):
    """prb.patch_ranges at the call's geometry."""
    return prb.patch_ranges(boxes, ok, anchors, height=kw["height"],
                            stride=kw["stride"], roi_h=kw["roi_h"],
                            roi_w=kw["roi_w"], size_w=size_w, size_h=size_h)


def _bins(rng):
    """Bins in each range [N, 4, G] -> [N, G]."""
    return ((rng[:, 1] - rng[:, 0] + 1).clamp(min=0)
            * (rng[:, 3] - rng[:, 2] + 1).clamp(min=0))


def _spans(rng, bx, by):
    return ((rng[:, 0] <= bx) & (bx <= rng[:, 1]) & (rng[:, 2] <= by)
            & (by <= rng[:, 3]))


def keys_tested(frame, t_cap, **problem):
    """Check the keys cull on one frame (every tile's and every patch's
    survivors give the full twin's keys); returns (pairs the kernel tests,
    dense pairs)."""
    cam, args, kw, table, boxes = _case(frame, t_cap, **problem)
    anchors = args[3]
    roi_h, roi_w, stride = kw["roi_h"], kw["roi_w"], kw["stride"]
    pargs, pkw = prk.prepare_inputs(table, boxes, anchors, width=cam.width,
                                    height=cam.height, stride=stride,
                                    roi_shape=(roi_h, roi_w))
    full = prk.rasterize_keys_twin(*pargs, **pkw).reshape(-1, roi_h, roi_w)
    assert (full[:-2] != INVALID).flatten(1).any(dim=1).all()
    assert (full[-1] == INVALID).all()          # the pose behind the camera
    coefs = table.transpose(1, 2)
    wide = _widen(boxes)
    tested = 0
    for r0 in range(0, roi_h, TILE):
        for c0 in range(0, roi_w, TILE):
            c1, r1 = min(c0 + TILE, roi_w) - 1, min(r0 + TILE, roi_h) - 1
            keep = _meets(wide, _extents(anchors, c0, c1, r0, r1, cam.height,
                                         stride))
            torch.testing.assert_close(
                _keys_of(coefs, keep, anchors, c0, c1, r0, r1, cam.height,
                         stride, False),
                full[:, r0:r1 + 1, c0:c1 + 1], rtol=0, atol=0)
            for pr0 in range(r0, r1 + 1, PATCH_H):
                for pc0 in range(c0, c1 + 1, PATCH_W):
                    pc1 = min(pc0 + PATCH_W - 1, c1)
                    pr1 = min(pr0 + PATCH_H - 1, r1)
                    patch = keep & _meets(wide, _extents(
                        anchors, pc0, pc1, pr0, pr1, cam.height, stride))
                    tested += int(patch.sum()) * PATCH_W * PATCH_H
                    torch.testing.assert_close(
                        _keys_of(coefs, patch, anchors, pc0, pc1, pr0, pr1,
                                 cam.height, stride, False),
                        full[:, pr0:pr1 + 1, pc0:pc1 + 1], rtol=0, atol=0)
    return tested, full.numel() * table.shape[1]


def bin_tested(frame, t_cap, window=None, **problem):
    """Check the bin scatter on one frame, binned in windows of patches
    (columns, rows; the kernel's `prb.window` unless given): in each window,
    each patch's list plus the window's wide list's triangles whose range
    spans the patch give the full twin's keys, and the window's lists hold
    at most T * MAX_BINS ids. Returns (pairs the kernel tests, dense pairs,
    (pose, triangle) pairs in the wide lists, summed over windows, and those
    wide in one window and listed in another)."""
    cam, args, kw, _, _ = _case(frame, t_cap, **problem)
    anchors = args[3]
    roi_h, roi_w, stride = kw["roi_h"], kw["roi_w"], kw["stride"]
    t = args[0].shape[2]
    ntx, nty = -(-roi_w // PATCH_W), -(-roi_h // PATCH_H)
    win_w, win_h = window or prb.window(t, roi_h, roi_w)
    full = prb.rasterize_bin_twin(*args, **kw).reshape(-1, roi_h, roi_w)
    assert (full[-1] == INVALID).all()          # the pose behind the camera
    rng, coefs = _bin_ranges(args, kw)
    windows = {}
    for wy0 in range(0, nty, win_h):
        for wx0 in range(0, ntx, win_w):
            # Each range clipped to the window, as the kernel clips it.
            clip = torch.stack([
                rng[:, 0].clamp(min=wx0),
                rng[:, 1].clamp(max=min(wx0 + win_w, ntx) - 1),
                rng[:, 2].clamp(min=wy0),
                rng[:, 3].clamp(max=min(wy0 + win_h, nty) - 1)], dim=1)
            bins = _bins(clip)
            is_wide = bins > prb.MAX_BINS
            assert int((bins * ~is_wide).sum(dim=1).max()) <= \
                t * prb.MAX_BINS
            windows[wx0 // win_w, wy0 // win_h] = clip, is_wide, bins
    tested = 0
    for bx, by, c0, c1, r0, r1 in _patches(roi_h, roi_w):
        clip, is_wide, _ = windows[bx // win_w, by // win_h]
        spans = _spans(clip, bx, by)
        # The patch's own list, and the wide list's triangles whose range
        # spans the patch.
        keep = (spans & ~is_wide) | (spans & is_wide)
        tested += int(keep.sum()) * PATCH_W * PATCH_H
        torch.testing.assert_close(
            _keys_of(coefs, keep, anchors, c0, c1, r0, r1, cam.height, stride,
                     False),
            full[:, r0:r1 + 1, c0:c1 + 1], rtol=0, atol=0)
    n_wide = sum(int(w.sum()) for _, w, _ in windows.values())
    wide_somewhere = torch.stack([w for _, w, _ in windows.values()]).any(0)
    listed_somewhere = torch.stack([~w & (b > 0)
                                    for _, w, b in windows.values()]).any(0)
    mixed = int((wide_somewhere & listed_somewhere).sum())
    return tested, full.numel() * t, n_wide, mixed


@pytest.mark.parametrize("t_cap", [200, 1024])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_keys_tile_cull_keeps_every_covering_triangle(frame, t_cap):
    tested, dense = keys_tested(frame, t_cap)
    assert tested < dense


@pytest.mark.parametrize("t_cap", [200, 1024])
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_bin_scatter_keeps_every_covering_triangle(frame, t_cap):
    tested, dense, wide, _ = bin_tested(frame, t_cap)
    assert tested < dense
    # The pose close to the camera puts triangles in the wide list.
    assert wide > 0


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_bin_scatter_in_windows_keeps_every_covering_triangle(frame):
    """The scatter binned in windows of 3 x 3 patches, as the kernel bins an
    ROI whose per-patch counts outgrow its shared memory: ranges clipped to
    each window, so a triangle may be wide in one window and listed in
    another."""
    whole, dense, _, _ = bin_tested(frame, 200)
    tested, _, wide, mixed = bin_tested(frame, 200, window=(3, 3))
    assert tested == whole < dense
    assert wide > 0 and mixed > 0


def test_culls_cull_at_the_roi():
    """At the 32x32 ROI both kernels test under a tenth of the dense
    pairs."""
    keys, dense = keys_tested("roi32", 200)
    bins, _, _, _ = bin_tested("roi32", 200)
    assert keys / dense < 0.1 and bins / dense < 0.1, (keys / dense,
                                                       bins / dense)


def test_setup_twin_is_keys_setup_in_the_kernel_order():
    """setup_twin (keys_setup + pack_coefficients on the bank unpacked from
    the kernel's arguments) equals keys_setup on the bank itself, and on
    drawable triangles the direct raster's setup order (the one
    raster_setup.cuh shares), bit for bit."""
    cam, args, kw, table, boxes = _case("roi32", 200)
    verts16, pose12, ids, _, proj12 = args
    m, _, t = verts16.shape
    bank = verts16[:, :9].transpose(1, 2).reshape(m, t, 3, 3)
    n = len(pose12)
    poses = torch.cat([pose12.reshape(n, 3, 4),
                       torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(n, 1, 4)], 1)
    proj = torch.as_tensor(cam.projection())
    coefs, abs_base, ok, ref_boxes = pras.keys_setup(
        bank, verts16[:, 9] > 0.5, poses, ids.long(), proj, cam.width,
        cam.height, verts16[:, 10, 0] > 0.5)
    ref = prk.pack_coefficients(coefs, abs_base, ok)
    assert torch.equal(table.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(boxes.view(torch.int32), ref_boxes.view(torch.int32))
    direct = prd._triangle_setup(verts16, pose12, ids, proj12, cam.width,
                                 cam.height).transpose(1, 2)
    drawn = torch.isfinite(direct[..., 8])
    assert torch.equal(drawn, ok) and drawn.any() and (~drawn).any()
    assert torch.equal(direct[drawn].view(torch.int32),
                       table[drawn].view(torch.int32))
    assert torch.isneginf(table[~drawn][:, 8]).all()
    assert torch.isinf(boxes[~drawn]).all()


def test_pallas_backend_on_the_cpu_runs_keys_setup(monkeypatch):
    """render_pose_batch(backend="pallas") on CPU tensors runs keys_setup in
    PyTorch and the keys twin, and launches nothing; the setup kernel's
    wrapper refuses CPU tensors."""
    cam, args, kw, _, _ = _case("roi32", 200)
    verts16, pose12, ids, _, _ = args
    calls = []
    setup = pras.keys_setup
    monkeypatch.setattr(pras, "keys_setup",
                        lambda *a, **k: calls.append(1) or setup(*a, **k))
    m, _, t = verts16.shape
    n = len(pose12)
    poses = torch.cat([pose12.reshape(n, 3, 4),
                       torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(n, 1, 4)], 1)
    proj = torch.as_tensor(cam.projection())
    build.reset_counts()
    out = pras.render_pose_batch(
        verts16[:, :9].transpose(1, 2).reshape(m, t, 3, 3),
        torch.zeros((m, t, 3)), verts16[:, 9] > 0.5, poses, ids, proj,
        width=cam.width, height=cam.height, stride=kw["stride"],
        roi_shape=(kw["roi_h"], kw["roi_w"]), backend="pallas")
    assert calls == [1]
    assert build.TWIN_CALLS == {"raster_keys": 1} and not build.LAUNCHES
    assert (out.tri_id >= 0).any()
    with pytest.raises(ValueError, match="tensors on cpu"):
        prk.setup_table(verts16, poses, ids, proj, width=cam.width,
                        height=cam.height)


def main() -> None:
    """The pair shares of PERF.md: 47 bench-like poses and one behind the
    camera, seed 1, T = 256; the parent commit's designs beside these."""
    torch.set_num_threads(1)
    problem = dict(n_poses=48, seed=1, near=False)
    for frame in ("roi32", "full80x60"):
        cam, args, kw, _, boxes = _case(frame, 256, **problem)
        anchors = args[3]
        dense = len(anchors) * kw["roi_h"] * kw["roi_w"] * 256
        wide = _widen(boxes)
        inside = _box_pixels(wide, anchors, kw)
        keys, _ = keys_tested(frame, 256, **problem)
        bins, _, n_wide, _ = bin_tested(frame, 256, **problem)
        old_keys, old_bin = _parent_pairs(args, kw, wide)
        print(f"{frame}: inside widened boxes {inside / dense:.4f}; keys "
              f"{keys / dense:.4f} (parent {old_keys / dense:.4f}); bin "
              f"{bins / dense:.4f} (parent {old_bin / dense:.4f}); "
              f"{n_wide} (pose, triangle) pairs in wide lists")


def _parent_pairs(args, kw, wide):
    """(pixel, triangle) pairs the parent commit's kernels tested: the keys
    kernel one box per 256-triangle chunk against 256-pixel tiles of whole
    ROI rows, the bin kernel the boxes of 16-triangle groups binned into
    8x16-pixel tiles."""
    anchors = args[3]
    roi_h, roi_w = kw["roi_h"], kw["roi_w"]
    n, _, t = wide.shape
    keys = 0
    for k0 in range(0, t, 256):
        cb = wide[:, :, k0:k0 + 256]
        chunk = torch.stack([cb[:, 0].amin(1), cb[:, 1].amax(1),
                             cb[:, 2].amin(1), cb[:, 3].amax(1)], 1)[..., None]
        for p0 in range(0, roi_h * roi_w, 256):
            ext = _extents(anchors, 0, roi_w - 1, p0 // roi_w,
                           (p0 + 255) // roi_w, kw["height"], kw["stride"])
            keys += int(_meets(chunk, ext).sum()) * 256 * cb.shape[2]
    _, boxes = _widened_boxes(*args[:3], args[4], kw["width"], kw["height"])
    groups = boxes.reshape(n, 4, -1, 16)
    big = torch.tensor(3e38)
    group = torch.stack([groups[:, 0].amin(2), groups[:, 1].amax(2),
                         groups[:, 2].amin(2), groups[:, 3].amax(2)], 1)
    drawn = group[:, 0] < big
    bins = _bins(_ranges(group, drawn, anchors, kw, 16, 8))
    return keys, int(bins.sum()) * 128 * 16


def _box_pixels(boxes, anchors, kw) -> int:
    """Strided ROI pixels inside each drawn triangle's box [N, 4, T],
    summed."""
    height, stride = kw["height"], kw["stride"]
    xmin, xmax, ymin, ymax = boxes.unbind(1)
    drawn = torch.isfinite(xmin)
    ax, ay = anchors[:, 0:1].float(), anchors[:, 1:2].float()
    i0 = (torch.ceil(xmin / stride) - ax).clamp(min=0)
    i1 = (torch.floor(xmax / stride) - ax).clamp(max=kw["roi_w"] - 1)
    j0 = (torch.ceil((height - 1 - ymax) / stride) - ay).clamp(min=0)
    j1 = (torch.floor((height - 1 - ymin) / stride) - ay).clamp(
        max=kw["roi_h"] - 1)
    cols = (i1 - i0 + 1).clamp(min=0)
    rows = (j1 - j0 + 1).clamp(min=0)
    return int((cols * rows * drawn).sum())


if __name__ == "__main__":
    main()
