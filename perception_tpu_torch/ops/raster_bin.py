"""Scatter-bin rasteriser: model bank in, packed (depth, triangle) keys out.

Counterpart of `perception_tpu/ops/pallas_raster_bin.py` (kernel_backend
"pallas_bin"). One block per pose (`csrc/raster_bin.cu`) sets up every
triangle as the direct kernel does, plus a per-triangle guard that culls
triangles with non-finite w, beta_c or gamma_c coefficients; scatters each
triangle into the lists of the 8x4-pixel patches of the strided ROI that its
screen box spans (a triangle spanning more than 8 patches into one "wide"
list that every patch tests instead); then rasterises each patch over its
own list and the wide list. Coverage is min(alpha, beta, gamma) >= 0 with no
per-pixel test on w. The keys are those of the direct kernel; the binning is
exact, so the twin neither bins nor culls. The TPU kernel's 16-triangle
groups, its split above 1024 poses (its scalar-memory limit) and its
tile-major output are not ported: the kernel writes row-major keys.
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import raster_direct
from perception_tpu_torch.ops.rasterizer import MAX_TRIS

PATCH_H, PATCH_W = 4, 8    # ROI rows and columns of a warp's patch
MAX_BINS = 8               # patches a binned triangle spans; more: wide list
# Shared memory a block of the H100 can opt in to.
MAX_SHARED_BYTES = 232448
# Shared bytes per triangle: coefficients [3] float4, patch range int4, list
# slots [MAX_BINS] and a wide-list slot of 16-bit ids.
_TRI_BYTES = 48 + 16 + 2 * MAX_BINS + 2
# Shared bytes per block: the scan's 8 warp sums and the wide list's count.
_BLOCK_BYTES = 4 * (8 + 1)


def rasterize_bin(verts16: torch.Tensor, pose_mats: torch.Tensor,
                  model_ids: torch.Tensor, anchors: torch.Tensor,
                  proj: torch.Tensor, *, width: int, height: int, stride: int,
                  roi_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Packed keys [N, roi_h * roi_w] int32 (the full strided frame when
    roi_shape is None). CUDA tensors launch the kernel; CPU tensors run the
    twin."""
    args, kw = prepare_inputs(verts16, pose_mats, model_ids, anchors, proj,
                              width=width, height=height, stride=stride,
                              roi_shape=roi_shape)
    if pose_mats.device.type == "cpu":
        build.TWIN_CALLS["raster_bin"] += 1
        return rasterize_bin_twin(*args, **kw)
    return launch_kernel(*args, **kw)


# The kernel takes the direct raster's arguments.
prepare_inputs = raster_direct.prepare_inputs


def window(t: int, roi_h: int, roi_w: int) -> tuple[int, int]:
    """Patches (columns, rows) of the window the kernel bins at a time: the
    whole ROI unless its per-patch counts outgrow the shared memory left
    beside the triangles."""
    ntx, nty = -(-roi_w // PATCH_W), -(-roi_h // PATCH_H)
    room = (MAX_SHARED_BYTES - _BLOCK_BYTES - t * _TRI_BYTES) // 4
    win_w = max(1, min(ntx, room))
    return win_w, max(1, min(nty, room // win_w))


def shared_bytes(t: int, roi_h: int, roi_w: int) -> int:
    """Shared memory of one block, all of it dynamic: the triangles'
    coefficients, patch ranges, list and wide-list slots, the scan's warp
    sums and the wide list's count, and one count per patch of the
    window."""
    win_w, win_h = window(t, roi_h, roi_w)
    return t * _TRI_BYTES + _BLOCK_BYTES + 4 * win_w * win_h


def patch_ranges(boxes: torch.Tensor, ok: torch.Tensor,
                 anchors: torch.Tensor, *, height: int, stride: int,
                 roi_h: int, roi_w: int, size_w: int = PATCH_W,
                 size_h: int = PATCH_H) -> torch.Tensor:
    """The kernel's bin ranges in plain PyTorch: inclusive ranges [N, 4, T]
    (first and last bin column, first and last bin row) of the size_w x
    size_h-pixel bins of the strided ROI that the 1-px-widened screen boxes
    [N, 4, T] (xmin - 1, xmax + 1, ymin - 1, ymax + 1) span, in the kernel's
    float32 order; (1, 0, 1, 0), empty, for boxes off the ROI or not `ok`.
    The kernel uses none of it: it serves the checks that emulate it."""
    fs = float(stride)
    x0 = anchors[:, 0:1].float()
    y0 = anchors[:, 1:2].float()
    cx0 = boxes[:, 0] / fs - x0
    cx1 = boxes[:, 1] / fs - x0
    ry0 = (float(height - 1) - boxes[:, 3]) / fs - y0
    ry1 = (float(height - 1) - boxes[:, 2]) / fs - y0
    ntx, nty = -(-roi_w // size_w), -(-roi_h // size_h)
    off = (~ok | (boxes[:, 0] > boxes[:, 1]) | (cx1 < 0) | (cx0 > roi_w - 1)
           | (ry1 < 0) | (ry0 > roi_h - 1))

    def index(v, size, last):
        return torch.floor(v / float(size)).clamp(0, last).long()

    rng = torch.stack([index(cx0, size_w, ntx - 1),
                       index(cx1, size_w, ntx - 1),
                       index(ry0, size_h, nty - 1),
                       index(ry1, size_h, nty - 1)], dim=1)
    empty = torch.tensor([1, 0, 1, 0], device=rng.device)[None, :, None]
    return torch.where(off[:, None], empty, rng)


def launch_kernel(verts16, pose12, model_ids, anchors, proj12, *, width,
                  height, stride, roi_h, roi_w) -> torch.Tensor:
    """csrc/raster_bin.cu on CUDA tensors."""
    dev = pose12.device
    if dev.type != "cuda":
        raise ValueError(f"raster_bin kernel: tensors on {dev}")
    n = pose12.shape[0]
    t = verts16.shape[2]
    build.check(verts16, "verts16", torch.float32, (None, 16, None), dev)
    if t > MAX_TRIS:
        raise ValueError(f"raster_bin kernel: {t} triangles > {MAX_TRIS}")
    build.check(pose12, "pose12", torch.float32, (n, 12), dev)
    build.check(model_ids, "model_ids", torch.int32, (n,), dev)
    build.check(anchors, "anchors", torch.int32, (n, 2), dev)
    build.check(proj12, "proj12", torch.float32, (12,), dev)
    keys = torch.empty((n, roi_h * roi_w), dtype=torch.int32, device=dev)
    build.launch("pt_raster_bin", build.ptr(verts16), t, build.ptr(pose12),
                 build.ptr(model_ids), build.ptr(anchors), build.ptr(proj12),
                 n, width, height, stride, roi_h, roi_w,
                 *window(t, roi_h, roi_w), shared_bytes(t, roi_h, roi_w),
                 build.ptr(keys))
    return keys


def rasterize_bin_twin(verts16: torch.Tensor, pose12: torch.Tensor,
                       model_ids: torch.Tensor, anchors: torch.Tensor,
                       proj12: torch.Tensor, *, width: int, height: int,
                       stride: int, roi_h: int, roi_w: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, vectorised over poses, pixels and
    triangles (no binning: it never changes a key)."""
    coefs = raster_direct._triangle_setup(verts16, pose12, model_ids, proj12,
                                          width, height, finite_guard=True)
    return raster_direct.twin_keys(coefs, anchors, height=height,
                                   stride=stride, roi_h=roi_h, roi_w=roi_w,
                                   w_test=False)
