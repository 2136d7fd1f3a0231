"""Coefficient-table rasteriser: per-pose packed triangle coefficients in,
packed (depth, triangle) keys out; and the table's setup.

Counterpart of `perception_tpu/ops/pallas_raster.py` (kernel_backend
"pallas"). The triangle setup runs before the raster: on CUDA tensors as one
kernel launch (`setup_table`, `pt_keys_setup` in `csrc/raster_keys.cu`), on
CPU tensors in PyTorch (`rasterizer.keys_setup`, then `pack_coefficients`).
The table has one [T, 12] row per triangle,
(bx, by, bc, gx, gy, gc, ax, ay, ac, wx, wy, wc), with alpha as its own
affine function and alpha_c = -inf for culled triangles, beside each
triangle's screen box (xmin, xmax, ymin, ymax; +-inf when culled). The raster
kernel (`csrc/raster_keys.cu`) and its PyTorch twin compute, per strided
pixel, the max over covered triangles (min(alpha, beta, gamma) >= 0, no test
on w) of `(bits(w) & ~2047) | (2047 - tri_id)`, then the shared epilogue
`(rint(1 / w) << 11) | tri_id`. The kernel skips every triangle whose box,
widened by 1 px, misses its pixel tile or warp patch; the cull is exact, so
the twin does not cull.
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import rasterizer
from perception_tpu_torch.ops.raster_direct import twin_keys
from perception_tpu_torch.ops.rasterizer import MAX_TRIS


def pack_coefficients(coefs: torch.Tensor, abs_base: torch.Tensor,
                      ok: torch.Tensor) -> torch.Tensor:
    """(coefs [.., T, 3, 3], abs_base [.., T], ok [.., T]) -> packed
    [.., T, 12] rows (bx, by, bc, gx, gy, gc, ax, ay, ac, wx, wy, wc), where
    alpha = |base| - beta - gamma, so coverage is one min-sign test; culled
    triangles get alpha_c = -inf."""
    flat = coefs.reshape(*coefs.shape[:-2], 9)
    abs_base = torch.where(ok, abs_base, float("-inf"))[..., None]
    alpha = torch.cat([
        -flat[..., 0:1] - flat[..., 3:4],
        -flat[..., 1:2] - flat[..., 4:5],
        abs_base - flat[..., 2:3] - flat[..., 5:6],
    ], dim=-1)
    return torch.cat([flat[..., :6], alpha, flat[..., 6:9]], dim=-1)


def rasterize_keys(coefs: torch.Tensor, tri_bboxes: torch.Tensor,
                   anchors: torch.Tensor, *, width: int, height: int,
                   stride: int,
                   roi_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Packed keys [N, roi_h * roi_w] int32 from packed coefficients
    [N, T, 12] and per-triangle screen bboxes [N, T, 4] (the full strided
    frame when roi_shape is None). CUDA tensors launch the kernel; CPU
    tensors run the twin."""
    args, kw = prepare_inputs(coefs, tri_bboxes, anchors, width=width,
                              height=height, stride=stride,
                              roi_shape=roi_shape)
    if coefs.device.type == "cpu":
        build.TWIN_CALLS["raster_keys"] += 1
        return rasterize_keys_twin(*args, **kw)
    return launch_kernel(*args, **kw)


def prepare_inputs(coefs, tri_bboxes, anchors, *, width, height, stride,
                   roi_shape=None) -> tuple[tuple, dict]:
    """The kernel's (and the twin's) arguments: contiguous f32 coefficients
    and per-triangle screen boxes (the kernel widens them by 1 px), int32
    anchors."""
    n = coefs.shape[0]
    if roi_shape is None:
        roi_h, roi_w = height // stride, width // stride
        anchors = torch.zeros((n, 2), dtype=torch.int32, device=coefs.device)
    else:
        roi_h, roi_w = roi_shape
    args = (coefs.to(torch.float32).contiguous(),
            tri_bboxes.to(torch.float32).contiguous(),
            anchors.to(torch.int32).contiguous())
    return args, dict(height=height, stride=stride, roi_h=roi_h, roi_w=roi_w)


def launch_kernel(coefs, tri_bboxes, anchors, *, height, stride, roi_h,
                  roi_w) -> torch.Tensor:
    """csrc/raster_keys.cu on CUDA tensors."""
    dev = coefs.device
    if dev.type != "cuda":
        raise ValueError(f"raster_keys kernel: tensors on {dev}")
    n, t, _ = coefs.shape
    if t > MAX_TRIS:
        raise ValueError(f"raster_keys kernel: {t} triangles > {MAX_TRIS}")
    build.check(coefs, "coefs", torch.float32, (n, t, 12), dev)
    build.check(tri_bboxes, "tri_bboxes", torch.float32, (n, t, 4), dev)
    build.check(anchors, "anchors", torch.int32, (n, 2), dev)
    keys = torch.empty((n, roi_h * roi_w), dtype=torch.int32, device=dev)
    build.launch("pt_raster_keys", build.ptr(coefs), build.ptr(tri_bboxes),
                 build.ptr(anchors), n, t, height, stride, roi_h, roi_w,
                 build.ptr(keys))
    return keys


def rasterize_keys_twin(coefs: torch.Tensor, tri_bboxes: torch.Tensor,
                        anchors: torch.Tensor, *, height: int, stride: int,
                        roi_h: int, roi_w: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, vectorised over poses, pixels and
    triangles; the boxes only cull, so the twin reads none."""
    return twin_keys(coefs.transpose(1, 2), anchors, height=height,
                     stride=stride, roi_h=roi_h, roi_w=roi_w, w_test=False)


def setup_table(verts16: torch.Tensor, pose_mats: torch.Tensor,
                model_ids: torch.Tensor, proj: torch.Tensor, *, width: int,
                height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed table [N, T, 12] and the screen boxes [N, T, 4] of the
    poses' triangles, from the component-major bank pack [M, 16, T]
    (`raster_direct.pack_bank_verts`), in one launch of `pt_keys_setup`.
    CUDA tensors only: CPU callers run `rasterizer.keys_setup` and
    `pack_coefficients` (`setup_twin`)."""
    args, kw = prepare_setup(verts16, pose_mats, model_ids, proj,
                             width=width, height=height)
    return launch_setup(*args, **kw)


def prepare_setup(verts16, pose_mats, model_ids, proj, *, width,
                  height) -> tuple[tuple, dict]:
    """The setup kernel's (and its twin's) arguments: the direct raster's,
    without the anchors."""
    n = pose_mats.shape[0]
    args = (verts16.to(torch.float32).contiguous(),
            pose_mats[:, :3, :].reshape(n, 12).to(torch.float32).contiguous(),
            model_ids.to(torch.int32).contiguous(),
            proj[:3, :].reshape(12).to(torch.float32).contiguous())
    return args, dict(width=width, height=height)


def launch_setup(verts16, pose12, model_ids, proj12, *, width,
                 height) -> tuple[torch.Tensor, torch.Tensor]:
    """pt_keys_setup (csrc/raster_keys.cu) on CUDA tensors."""
    dev = pose12.device
    if dev.type != "cuda":
        raise ValueError(f"keys_setup kernel: tensors on {dev}")
    n = pose12.shape[0]
    t = verts16.shape[2]
    build.check(verts16, "verts16", torch.float32, (None, 16, None), dev)
    if t > MAX_TRIS:
        raise ValueError(f"keys_setup kernel: {t} triangles > {MAX_TRIS}")
    build.check(pose12, "pose12", torch.float32, (n, 12), dev)
    build.check(model_ids, "model_ids", torch.int32, (n,), dev)
    build.check(proj12, "proj12", torch.float32, (12,), dev)
    table = torch.empty((n, t, 12), dtype=torch.float32, device=dev)
    boxes = torch.empty((n, t, 4), dtype=torch.float32, device=dev)
    build.launch("pt_keys_setup", build.ptr(verts16), t, build.ptr(pose12),
                 build.ptr(model_ids), build.ptr(proj12), n, width, height,
                 build.ptr(table), build.ptr(boxes))
    return table, boxes


def setup_twin(verts16: torch.Tensor, pose12: torch.Tensor,
               model_ids: torch.Tensor, proj12: torch.Tensor, *, width: int,
               height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the setup kernel: `rasterizer.keys_setup` and
    `pack_coefficients` on the bank and poses unpacked from the kernel's
    arguments. The kernel equals it bit for bit on drawable rows and on
    every box; on a culled row the kernel's alpha_c is -inf and its other
    entries are not read."""
    m, _, t = verts16.shape
    n = pose12.shape[0]
    tri_verts = verts16[:, :9].transpose(1, 2).reshape(m, t, 3, 3)
    valid = verts16[:, 9] > 0.5
    backface = verts16[:, 10, 0] > 0.5 if t else None
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], device=pose12.device)
    pose_mats = torch.cat([pose12.reshape(n, 3, 4),
                           last.expand(n, 1, 4)], dim=1)
    proj = proj12.reshape(3, 4)
    coefs, abs_base, ok, boxes = rasterizer.keys_setup(
        tri_verts, valid, pose_mats, model_ids.long(), proj, width, height,
        backface)
    return pack_coefficients(coefs, abs_base, ok), boxes
