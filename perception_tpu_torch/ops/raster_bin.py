"""Scatter-bin rasteriser: model bank in, packed (depth, triangle) keys out.

Counterpart of `perception_tpu/ops/pallas_raster_bin.py` (kernel_backend
"pallas_bin"). One block per pose (`csrc/raster_bin.cu`) sets up every
triangle as the direct kernel does, plus a per-triangle guard that culls
triangles with non-finite w, beta_c or gamma_c coefficients; bins groups of
16 triangles by their screen bbox into per-tile lists (8x16-pixel tiles of
the strided ROI); then rasterises each tile over its own list only. Coverage
is min(alpha, beta, gamma) >= 0 with no per-pixel test on w. The keys are
those of the direct kernel; the binning is exact, so the twin neither bins
nor culls. The TPU kernel's split above 1024 poses (its scalar-memory limit)
and its tile-major output are not ported: the kernel writes row-major keys.
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import raster_direct
from perception_tpu_torch.ops.rasterizer import MAX_TRIS

SUB_G = 16                 # triangles per binned group
TILE_H, TILE_W = 8, 16     # ROI rows and columns per pixel tile
# Shared memory a block of the H100 can opt in to.
MAX_SHARED_BYTES = 232448


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


def prepare_inputs(verts16, pose_mats, model_ids, anchors, proj, *, width,
                   height, stride, roi_shape=None) -> tuple[tuple, dict]:
    """The direct kernel's arguments, with the bank padded by invalid
    triangles to a multiple of the 16-triangle group."""
    args, kw = raster_direct.prepare_inputs(
        verts16, pose_mats, model_ids, anchors, proj, width=width,
        height=height, stride=stride, roi_shape=roi_shape)
    v16 = args[0]
    pad = -v16.shape[2] % SUB_G
    if pad:
        v16 = torch.nn.functional.pad(v16, (0, pad)).contiguous()
    return (v16, *args[1:]), kw


def shared_bytes(t: int, roi_h: int, roi_w: int) -> int:
    """Dynamic shared memory of one block: coefficients [T][12] f32, tile
    ranges [T/16] int4, per-tile counts and group lists."""
    n_sub = t // SUB_G
    n_tiles = -(-roi_h // TILE_H) * -(-roi_w // TILE_W)
    return t * 48 + n_sub * 16 + n_tiles * 4 + n_tiles * n_sub * 4


def launch_kernel(verts16, pose12, model_ids, anchors, proj12, *, width,
                  height, stride, roi_h, roi_w) -> torch.Tensor:
    """csrc/raster_bin.cu on CUDA tensors."""
    dev = pose12.device
    if dev.type != "cuda":
        raise ValueError(f"raster_bin kernel: tensors on {dev}")
    n = pose12.shape[0]
    t = verts16.shape[2]
    build.check(verts16, "verts16", torch.float32, (None, 16, None), dev)
    if t > MAX_TRIS or t % SUB_G:
        raise ValueError(f"raster_bin kernel: {t} triangles (at most "
                         f"{MAX_TRIS}, a multiple of {SUB_G})")
    smem = shared_bytes(t, roi_h, roi_w)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"raster_bin kernel: a {roi_h}x{roi_w} ROI with {t} "
                         f"triangles needs {smem} B of shared memory > "
                         f"{MAX_SHARED_BYTES}")
    build.check(pose12, "pose12", torch.float32, (n, 12), dev)
    build.check(model_ids, "model_ids", torch.int32, (n,), dev)
    build.check(anchors, "anchors", torch.int32, (n, 2), dev)
    build.check(proj12, "proj12", torch.float32, (12,), dev)
    keys = torch.empty((n, roi_h * roi_w), dtype=torch.int32, device=dev)
    build.launch("pt_raster_bin", build.ptr(verts16), t, build.ptr(pose12),
                 build.ptr(model_ids), build.ptr(anchors), build.ptr(proj12),
                 n, width, height, stride, roi_h, roi_w, smem,
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
