"""Debug images.

The port's copy of `colorize_depth`, `save_depth_image` and
`save_batch_grid` from `perception_tpu/utils/debug.py`, writing PNGs with
`io.images.write_png`. The env dumps its final greedy state through them
when `PerchConfig.vis_expanded_states` is set and `PerceptionEnv.debug_dir`
names a directory. `save_batch_grid` labels each cell with a small built-in
pixel font (digits, '-', '.') where the JAX package calls `cv2.putText`:
the pixels of the cells are the same, the label glyphs differ.
"""

from __future__ import annotations

import os

import numpy as np

from perception_tpu_torch.io.images import write_png


def colorize_depth(depth: np.ndarray,
                   max_depth: float | None = None) -> np.ndarray:
    """int / float depth -> uint8 RGB: red rises and blue falls with depth,
    green marks valid pixels, empty pixels are black."""
    d = np.asarray(depth, dtype=np.float64)
    valid = d > 0
    if max_depth is None:
        max_depth = d.max() if valid.any() else 1.0
    norm = np.where(valid, np.clip(d / max(max_depth, 1e-9), 0, 1), 0)
    r = (255 * norm).astype(np.uint8)
    b = (255 * (1 - norm) * valid).astype(np.uint8)
    g = np.where(valid, 80, 0).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def save_depth_image(depth: np.ndarray, path: str,
                     max_depth: float | None = None) -> None:
    """colorize_depth(depth) as a PNG file, its directory made if needed."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, colorize_depth(depth, max_depth))


# 3x5 pixel glyphs of the cost labels, one string of rows per character.
_GLYPHS = {
    "0": ("111", "101", "101", "101", "111"),
    "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"),
    "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"),
    "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"),
    "7": ("111", "001", "010", "010", "010"),
    "8": ("111", "101", "111", "101", "111"),
    "9": ("111", "101", "111", "001", "111"),
    "-": ("000", "000", "111", "000", "000"),
    ".": ("000", "000", "000", "000", "010"),
}
# Top-left pixel (x, y) of a cell's label, and the glyphs' pixel size.
LABEL_ORIGIN = (2, 3)
LABEL_SCALE = 2


def draw_label(img: np.ndarray, text: str) -> None:
    """Draw `text` in white into the RGB uint8 image `img` (in place) at
    LABEL_ORIGIN, one glyph per character with a blank column between
    glyphs; characters without a glyph leave a gap. Pixels outside the
    image are dropped."""
    (x0, y0), scale = LABEL_ORIGIN, LABEL_SCALE
    h, w = img.shape[:2]
    for k, ch in enumerate(text):
        rows = _GLYPHS.get(ch)
        if rows is None:
            continue
        mask = np.repeat(np.repeat(
            np.array([[c == "1" for c in r] for r in rows]), scale, 0),
            scale, 1)
        gx = x0 + k * 4 * scale
        ys, xs = np.nonzero(mask)
        ys, xs = ys + y0, xs + gx
        keep = (ys < h) & (xs < w)
        img[ys[keep], xs[keep]] = 255


def save_batch_grid(
    depth_batch: np.ndarray,    # [N, h, w]
    path: str,
    color_batch: np.ndarray | None = None,
    costs: list | None = None,
    cols: int = 8,
) -> None:
    """Tile a pose batch's renders into one PNG, each cell labelled with its
    cost where `costs` gives one (the reference's PrintGPUImages)."""
    n, h, w = depth_batch.shape
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    if color_batch is not None:
        cell = np.asarray(color_batch, dtype=np.uint8)
    else:
        cell = np.stack([colorize_depth(d) for d in depth_batch])
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        img = cell[i].copy()
        if costs is not None and i < len(costs):
            draw_label(img, str(costs[i]))
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, grid)
