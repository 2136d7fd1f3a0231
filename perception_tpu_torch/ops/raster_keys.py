"""Coefficient-table rasteriser: per-pose packed triangle coefficients in,
packed (depth, triangle) keys out.

Counterpart of `perception_tpu/ops/pallas_raster.py` (kernel_backend
"pallas"). The triangle setup runs before the kernel, in PyTorch
(`rasterizer.keys_setup`); `pack_coefficients` turns it into one [T, 12]
row per triangle: (bx, by, bc, gx, gy, gc, ax, ay, ac, wx, wy, wc), with
alpha as its own affine function and alpha_c = -inf for culled triangles.
The kernel (`csrc/raster_keys.cu`) and its PyTorch twin compute, per strided
pixel, the max over covered triangles (min(alpha, beta, gamma) >= 0, no test
on w) of `(bits(w) & ~2047) | (2047 - tri_id)`, then the shared epilogue
`(rint(1 / w) << 11) | tri_id`. The kernel skips a 256-triangle chunk whose
screen bbox (1 px margin) misses its pixel tile; the cull is exact, so the
twin does not cull.
"""

from __future__ import annotations

import torch

from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops.raster_direct import twin_keys
from perception_tpu_torch.ops.rasterizer import MAX_TRIS

TRI_CHUNK = 256   # triangles per culled chunk (the kernel's shared-memory pass)


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
    """The kernel's (and the twin's) arguments: contiguous f32 coefficients,
    the per-chunk screen bboxes [N, ceil(T / 256), 4] (each triangle's box
    widened by 1 px; the ragged last chunk padded with empty boxes), int32
    anchors."""
    n, t, _ = coefs.shape
    dev = coefs.device
    if roi_shape is None:
        roi_h, roi_w = height // stride, width // stride
        anchors = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    else:
        roi_h, roi_w = roi_shape
    boxes = tri_bboxes.to(torch.float32)
    pad = -t % TRI_CHUNK
    if pad:
        inf = float("inf")
        empty = torch.tensor([inf, -inf, inf, -inf], device=dev)
        boxes = torch.cat([boxes, empty.expand(n, pad, 4)], dim=1)
    cb = boxes.reshape(n, -1, TRI_CHUNK, 4)
    chunk = torch.stack([cb[..., 0].amin(dim=2) - 1.0,
                         cb[..., 1].amax(dim=2) + 1.0,
                         cb[..., 2].amin(dim=2) - 1.0,
                         cb[..., 3].amax(dim=2) + 1.0], dim=-1)
    args = (coefs.to(torch.float32).contiguous(), chunk.contiguous(),
            anchors.to(torch.int32).contiguous())
    return args, dict(height=height, stride=stride, roi_h=roi_h, roi_w=roi_w)


def launch_kernel(coefs, chunk_bboxes, anchors, *, height, stride, roi_h,
                  roi_w) -> torch.Tensor:
    """csrc/raster_keys.cu on CUDA tensors."""
    dev = coefs.device
    if dev.type != "cuda":
        raise ValueError(f"raster_keys kernel: tensors on {dev}")
    n, t, _ = coefs.shape
    if t > MAX_TRIS:
        raise ValueError(f"raster_keys kernel: {t} triangles > {MAX_TRIS}")
    build.check(coefs, "coefs", torch.float32, (n, t, 12), dev)
    build.check(chunk_bboxes, "chunk_bboxes", torch.float32,
                (n, -(-t // TRI_CHUNK), 4), dev)
    build.check(anchors, "anchors", torch.int32, (n, 2), dev)
    keys = torch.empty((n, roi_h * roi_w), dtype=torch.int32, device=dev)
    build.launch("pt_raster_keys", build.ptr(coefs), build.ptr(chunk_bboxes),
                 build.ptr(anchors), n, t, height, stride, roi_h, roi_w,
                 build.ptr(keys))
    return keys


def rasterize_keys_twin(coefs: torch.Tensor, chunk_bboxes: torch.Tensor,
                        anchors: torch.Tensor, *, height: int, stride: int,
                        roi_h: int, roi_w: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, vectorised over poses, pixels and
    triangles; the chunk bboxes only cull, so the twin reads none."""
    return twin_keys(coefs.transpose(1, 2), anchors, height=height,
                     stride=stride, roi_h=roi_h, roi_w=roi_w, w_test=False)
