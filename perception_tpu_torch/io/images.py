"""PNG images without OpenCV or PIL: a reader for the CLI's and the camera
loop's depth, mask and colour inputs, and a writer (to a file or to bytes)
for synthetic scenes, the service's pose overlay and tests.

Standard library (`zlib`) and numpy only. The reader takes 8- and 16-bit
greyscale, RGB and RGBA, not interlaced, with any of the five scanline
filters, and returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns
with the channels in RGB order: uint8 or uint16 arrays [H, W], [H, W, 3] or
[H, W, 4]. It raises on anything else (palette, grey + alpha, other bit
depths, interlacing).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (0 grey, 2 RGB, 6 RGBA).
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield tag, body
        pos += 12 + length


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (0 none, 1 sub, 2 up, 3 average,
    4 Paeth) -> [h, stride] uint8."""
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    out = np.zeros((h, stride), np.uint8)
    prev = bytes(stride)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        line = raw[start + 1:start + 1 + stride]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            # Running sum along the row, per byte of the pixel, mod 256.
            cur = np.cumsum(np.frombuffer(line, np.uint8).reshape(-1, bpp),
                            axis=0, dtype=np.uint8).tobytes()
        elif ftype == 2:
            cur = (np.frombuffer(line, np.uint8)
                   + np.frombuffer(prev, np.uint8)).tobytes()
        elif ftype in (3, 4):
            # Both depend on the byte just decoded to the left: one pass in
            # Python integers.
            buf = bytearray(line)
            for x in range(stride):
                a = buf[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                buf[x] = (buf[x] + pred) & 0xFF
            cur = bytes(buf)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = np.frombuffer(cur, np.uint8)
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file -> uint8 / uint16 array [H, W] (grey) or [H, W, C]
    (RGB, RGBA)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_png` of a PNG file's bytes; `path` names it in errors."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not read; use "
                         "grey, RGB or RGBA")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not read")
    if comp or filt:
        raise ValueError(f"{path}: unknown PNG compression / filter method")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = (rows.view(">u2").astype(np.uint16) if depth == 16 else rows)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def write_png(path: str, img: np.ndarray) -> None:
    """Encode a uint8 / uint16 array [H, W] or [H, W, C] (C = 3, 4) as a PNG
    file (filter 0 on every row, zlib level 6)."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray) -> bytes:
    """The bytes of `write_png`'s file for `img`."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png: dtype {img.dtype}, expected uint8 or "
                        "uint16")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(tag + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I",
                                                                       crc)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
