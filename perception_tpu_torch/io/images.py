"""PNG and JPEG images without OpenCV or PIL: a reader for the CLI's, the
camera loop's and the dataset readers' depth, mask and colour inputs, and a
PNG writer (to a file or to bytes) for synthetic scenes, the service's pose
overlay and tests.

Standard library (`zlib`) and numpy only. The PNG reader takes 8- and
16-bit greyscale, RGB and RGBA, not interlaced, with any of the five
scanline filters, and returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)`
returns with the channels in RGB order: uint8 or uint16 arrays [H, W],
[H, W, 3] or [H, W, 4]. It raises on anything else (palette, grey + alpha,
other bit depths, interlacing).

The JPEG decoder (`decode_jpeg`, for the FAT dataset's colour frames) takes
sequential baseline files (Huffman coded, 8-bit, one or three components,
any sampling factors, restart markers) and rounds as libjpeg does by
default, which is what `cv2.imread` runs: its integer inverse DCT
(jidctint.c), its triangular "fancy" chroma upsampling for 2:1 sampling
(jdsample.c) and its fixed-point YCbCr -> RGB (jdcolor.c). It raises on a
progressive, lossless, arithmetic-coded, 12-bit or CMYK file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SOI = b"\xff\xd8"
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


def read_rgb(path: str) -> np.ndarray:
    """A colour image as uint8 RGB [H, W, 3]: what
    `cv2.imread(path)[..., ::-1]` gives for an 8-bit PNG (grey spread to
    three channels, alpha dropped) or a baseline JPEG (`decode_jpeg`)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_JPEG_SOI):
        return decode_jpeg(data, path)
    img = decode_png(data, path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a {img.dtype} PNG is not a colour image")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_grey(path: str) -> np.ndarray:
    """A single-channel PNG (16-bit depth, 8-bit labels) as stored: what
    `cv2.imread(path, cv2.IMREAD_ANYDEPTH)` gives for it."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: {img.shape[2]} channels, expected a "
                         "single-channel image")
    return img


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


# -- Baseline JPEG --------------------------------------------------------

# Natural (row-major) index of the k-th coefficient in zigzag order.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# Start-of-frame markers of the processes this decoder does not take.
_SOF_OTHER = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
              0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
              0xC9: "arithmetic-coded", 0xCA: "arithmetic progressive",
              0xCB: "arithmetic lossless", 0xCD: "arithmetic hierarchical",
              0xCE: "arithmetic hierarchical progressive",
              0xCF: "arithmetic hierarchical lossless"}
# jidctint.c's constants: FIX(x) = round(x * 2^13).
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)


def _huffman_lut(counts: bytes, symbols: bytes) -> tuple[list, list]:
    """Lookup tables on the next 16 bits of the stream: (symbol, code
    length) for every 16-bit prefix (length 0: no code)."""
    sym = np.zeros(1 << 16, np.int64)
    length = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            if hi > 1 << 16:
                raise ValueError("bad Huffman table")
            sym[lo:hi] = symbols[k]
            length[lo:hi] = n
            code += 1
            k += 1
        code <<= 1
    return sym.tolist(), length.tolist()


def _entropy_segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The scan's entropy-coded data from `pos`, cut at its restart markers
    and unstuffed (FF 00 -> FF), and the offset of the marker ending it."""
    segments, out = [], bytearray()
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= len(data):
            raise ValueError("truncated JPEG scan")
        nxt = data[j + 1]
        if nxt == 0x00:                 # a stuffed data byte
            out += data[pos:j + 1]
            pos = j + 2
        elif nxt == 0xFF:               # a fill byte ahead of a marker
            out += data[pos:j]
            pos = j + 1
        else:
            out += data[pos:j]
            segments.append(bytes(out))
            out = bytearray()
            if 0xD0 <= nxt <= 0xD7:     # RSTn
                pos = j + 2
            else:
                return segments, j


def _decode_scan(segment: bytes, units: list, coefs: dict, mcus: list,
                 dc_lut: dict, ac_lut: dict) -> None:
    """Huffman-decode the MCUs `mcus` (lists of (component, block row,
    block column) per data unit) of one restart interval into `coefs`
    (component -> [rows, cols, 64] int64, natural order). `units` gives
    each component's (DC table, AC table)."""
    buf = segment + b"\x00" * 6
    pos = 0
    pred = {c: 0 for c in coefs}
    zig = _ZIGZAG.tolist()

    def peek16(p):
        b = p >> 3
        return ((buf[b] << 16 | buf[b + 1] << 8 | buf[b + 2])
                >> (8 - (p & 7))) & 0xFFFF

    def receive(p, s):
        v = peek16(p) >> (16 - s)
        return v - (1 << s) + 1 if v < 1 << (s - 1) else v

    for mcu in mcus:
        for comp, row, col in mcu:
            dc_sym, dc_len = dc_lut[units[comp][0]]
            ac_sym, ac_len = ac_lut[units[comp][1]]
            block = coefs[comp][row, col]
            bits = peek16(pos)
            n = dc_len[bits]
            if not n:
                raise ValueError("bad JPEG Huffman code")
            s = dc_sym[bits]
            pos += n
            if s:
                pred[comp] += receive(pos, s)
                pos += s
            block[0] = pred[comp]
            k = 1
            while k < 64:
                bits = peek16(pos)
                n = ac_len[bits]
                if not n:
                    raise ValueError("bad JPEG Huffman code")
                rs = ac_sym[bits]
                pos += n
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError("bad JPEG run length")
                    block[zig[k]] = receive(pos, s)
                    pos += s
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
    if pos > 8 * len(segment) + 8:
        raise ValueError("truncated JPEG scan data")


def _idct_1d(x: list, shift: int) -> list:
    """jpeg_idct_islow's 1-D pass (libjpeg's LL&M integer IDCT) on eight
    int64 arrays, descaled by `shift` bits."""
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_plane(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Dequantised coefficient blocks [R, C, 64] -> samples [8R, 8C] uint8
    (the column pass, then the row pass, then +128 and the clamp)."""
    rows, cols = coefs.shape[:2]
    blk = (coefs * quant).reshape(rows, cols, 8, 8)     # [.., v, u]
    ws = _idct_1d([blk[:, :, v, :] for v in range(8)],
                  _CONST_BITS - _PASS1_BITS)            # [y] of [.., u]
    ws = np.stack(ws, axis=2)                           # [.., y, u]
    out = _idct_1d([ws[..., u] for u in range(8)],
                   _CONST_BITS + _PASS1_BITS + 3)       # [x] of [.., y]
    out = np.stack(out, axis=-1)                        # [.., y, x]
    out = np.clip(out + 128, 0, 255)
    return out.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _upsample_h2(plane: np.ndarray, width: int) -> np.ndarray:
    """h2v1_fancy_upsample: each row doubled by 3/4 nearer + 1/4 further
    sample, the end samples copied (box doubling at <= 2 samples)."""
    c = plane[:, :width].astype(np.int64)
    if width <= 2:
        return np.repeat(c, 2, axis=1)
    out = np.empty((c.shape[0], 2 * width), np.int64)
    out[:, 0] = c[:, 0]
    out[:, 2::2] = (3 * c[:, 1:] + c[:, :-1] + 1) >> 2
    out[:, 1:-1:2] = (3 * c[:, :-1] + c[:, 1:] + 2) >> 2
    out[:, -1] = c[:, -1]
    return out


def _upsample_h2v2(plane: np.ndarray, width: int, height: int) -> np.ndarray:
    """h2v2_fancy_upsample: column sums 3 * nearer + further row (the
    edge rows repeated), then the triangle across columns, /16 (box
    doubling at <= 2 samples)."""
    c = plane[:height, :width].astype(np.int64)
    if width <= 2:
        return np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)
    above = np.concatenate([c[:1], c[:-1]])
    below = np.concatenate([c[1:], c[-1:]])
    sums = np.empty((2 * height, width), np.int64)
    sums[0::2] = 3 * c + above
    sums[1::2] = 3 * c + below
    out = np.empty((2 * height, 2 * width), np.int64)
    out[:, 0] = (4 * sums[:, 0] + 8) >> 4
    out[:, 2::2] = (3 * sums[:, 1:] + sums[:, :-1] + 8) >> 4
    out[:, 1:-1:2] = (3 * sums[:, :-1] + sums[:, 1:] + 7) >> 4
    out[:, -1] = (4 * sums[:, -1] + 7) >> 4
    return out


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed-point tables."""
    def fix(x):
        return int(x * 65536 + 0.5)

    half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode a sequential baseline JPEG -> uint8 RGB [H, W, 3] (a grey
    file spread to three channels), rounded as libjpeg rounds by default."""
    if not data.startswith(_JPEG_SOI):
        raise ValueError(f"{path}: not a JPEG file")
    quant: dict[int, np.ndarray] = {}
    dc_lut: dict[int, tuple] = {}
    ac_lut: dict[int, tuple] = {}
    frame = None
    coefs: dict[int, np.ndarray] = {}
    restart = 0
    adobe_transform = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and \
                pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: truncated or corrupt JPEG")
        marker = data[pos + 1]
        if marker == 0xD9:                                   # EOI
            break
        if pos + 4 > len(data):
            raise ValueError(f"{path}: truncated JPEG")
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in _SOF_OTHER:
            raise ValueError(f"{path}: {_SOF_OTHER[marker]} JPEG is not "
                             "read; only sequential baseline files are")
        if marker == 0xDB:                                   # DQT
            i = 0
            while i < len(body):
                prec, tid = body[i] >> 4, body[i] & 15
                n = 128 if prec else 64
                raw = np.frombuffer(body[i + 1:i + 1 + n],
                                    ">u2" if prec else np.uint8)
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = raw
                quant[tid] = table
                i += 1 + n
        elif marker == 0xC4:                                 # DHT
            i = 0
            while i < len(body):
                cls, tid = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                lut = _huffman_lut(counts, body[i + 17:i + 17 + n])
                (ac_lut if cls else dc_lut)[tid] = lut
                i += 17 + n
        elif marker in (0xC0, 0xC1):                         # SOF0 / SOF1
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG is not read")
            if nc not in (1, 3):
                raise ValueError(f"{path}: {nc}-component JPEG is not read")
            comps = [(body[6 + 3 * k], body[7 + 3 * k] >> 4,
                      body[7 + 3 * k] & 15, body[8 + 3 * k])
                     for k in range(nc)]
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            frame = (h, w, comps, hmax, vmax, mcux, mcuy)
            for cid, hs, vs, _ in comps:
                coefs[cid] = np.zeros((mcuy * vs, mcux * hs, 64), np.int64)
        elif marker == 0xDD:                                 # DRI
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xEE and body[:5] == b"Adobe":        # APP14
            adobe_transform = body[11] if len(body) > 11 else None
        elif marker == 0xDA:                                 # SOS
            if frame is None:
                raise ValueError(f"{path}: scan before the frame header")
            h, w, comps, hmax, vmax, mcux, mcuy = frame
            ns = body[0]
            units = {body[1 + 2 * k]: (body[2 + 2 * k] >> 4,
                                       body[2 + 2 * k] & 15)
                     for k in range(ns)}
            sampling = {c[0]: c[1:3] for c in comps}
            if ns == 1:
                # A non-interleaved scan: one block per MCU, over the
                # component's own blocks.
                (cid,) = units
                hs, vs = sampling[cid]
                bw = -(-(-(-w * hs // hmax)) // 8)
                bh = -(-(-(-h * vs // vmax)) // 8)
                mcus = [[(cid, r, c)] for r in range(bh) for c in range(bw)]
            else:
                mcus = [[(cid, my * sampling[cid][1] + v,
                          mx * sampling[cid][0] + u)
                         for cid in units
                         for v in range(sampling[cid][1])
                         for u in range(sampling[cid][0])]
                        for my in range(mcuy) for mx in range(mcux)]
            segments, pos = _entropy_segments(data, pos)
            step = restart or len(mcus)
            if -(-len(mcus) // step) > len(segments):
                raise ValueError(f"{path}: truncated JPEG scan")
            for k in range(0, len(mcus), step):
                _decode_scan(segments[k // step], units,
                             {c: coefs[c] for c in units},
                             mcus[k:k + step], dc_lut, ac_lut)
    if frame is None:
        raise ValueError(f"{path}: no frame header")
    h, w, comps, hmax, vmax, _, _ = frame
    planes = []
    for cid, hs, vs, tq in comps:
        plane = _idct_plane(coefs[cid], quant[tq])
        cw, ch = -(-w * hs // hmax), -(-h * vs // vmax)
        if (hmax // hs, vmax // vs) == (1, 1):
            full = plane[:ch, :cw].astype(np.int64)
        elif (hmax // hs, vmax // vs) == (2, 1) and hmax == 2 * hs:
            full = _upsample_h2(plane[:ch], cw)
        elif (hmax // hs, vmax // vs) == (2, 2) and hmax == 2 * hs \
                and vmax == 2 * vs:
            full = _upsample_h2v2(plane, cw, ch)
        else:
            raise ValueError(f"{path}: JPEG sampling {hs}x{vs} of "
                             f"{hmax}x{vmax} is not read")
        planes.append(full[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    ids = tuple(c[0] for c in comps)
    if adobe_transform == 0 or ids == (82, 71, 66):   # stored as RGB
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)
