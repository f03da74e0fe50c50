"""PNG reading and writing in numpy and zlib; JPEG through an optional
decoder.

The streams of the JAX package read images with OpenCV; this module takes
its place so the port reads image sequences where neither OpenCV nor PIL
is installed.  Channels come out in RGB order, as the JAX streams hand
them on after their BGR-to-RGB conversion.

    read_png(path)      the file's own samples: (H, W) gray, (H, W, 2)
                        gray + alpha, (H, W, 3) RGB or (H, W, 4) RGBA,
                        uint8 or uint16 (palette files expand to RGB/RGBA)
    imread_rgb(path)    (H, W, 3) uint8 RGB, as `cv2.imread` + BGR2RGB
                        gives it: gray replicated, alpha dropped, 16-bit
                        samples cut to their high byte; PNG here, JPEG
                        through cv2 or PIL when one can be imported
    imread_depth(path)  a gray PNG's samples unchanged (16-bit depth maps),
                        as `cv2.imread(path, cv2.IMREAD_ANYDEPTH)`
    write_png(path, a)  uint8 gray / RGB / RGBA, uint16 gray / RGB

PNG rows are filtered with one of five predictors.  Sub, Average and Paeth
depend on the decoded pixel to the left, so a row cannot be decoded with
whole-row array operations.  Pixel (r, c) depends only on (r, c-1),
(r-1, c) and (r-1, c-1), so the decoder visits anti-diagonals: every pixel
with r + c = d is decoded at once, from diagonals d-1 and d-2, in H + W - 1
array steps.  Files whose rows use only None, Sub and Up decode a run of
rows at a time (Sub and Up are cumulative sums modulo 256).
"""

import functools
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_BIT_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _chunks(data, path):
    """(type, payload) of every chunk, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


@functools.cache
def _paeth_table():
    """Paeth's choice as a table: with p = b - c and q = a - c, the
    predictor is c + T[p·511 + q] (T holds q, p or 0); a negative index
    wraps to the end of the table, which is laid out for it."""
    k = np.arange(511 * 511)
    k = np.where(k <= 511 * 511 // 2, k, k - 511 * 511)
    p = (k + 255) // 511
    q = k - 511 * p
    pa, pb, pc = np.abs(p), np.abs(q), np.abs(p + q)
    return np.where((pa <= pb) & (pa <= pc), q,
                    np.where(pb <= pc, p, 0)).astype(np.int32)


def _paeth(a, b, c):
    """The Paeth predictor on int32 arrays of bytes."""
    idx = (b - c) * 511
    idx += a - c
    return c + np.take(_paeth_table(), idx)


def _predict(f, a, b, c):
    """Prediction of filter f from the left (a), upper (b) and upper-left
    (c) bytes."""
    if f == 1:
        return a
    if f == 2:
        return b
    if f == 3:
        return (a + b) >> 1
    if f == 4:
        return _paeth(a, b, c)
    return 0


def _runs(ftype):
    """(start, end) of the runs of consecutive rows that share a filter."""
    starts = np.flatnonzero(np.diff(ftype)) + 1
    return list(zip([0, *starts.tolist()], [*starts.tolist(), len(ftype)]))


def _unfilter_rows(ftype, x):
    """Decode rows that use only None (0), Sub (1) and Up (2), a run of
    rows with one filter at a time: Sub is a cumulative sum along the row,
    Up one down the rows (modulo 256, in uint8).

    x: (H, W, bpp) uint8 filtered bytes; returns the raw bytes."""
    out = np.empty_like(x)
    prev = np.zeros_like(x[0])
    for lo, hi in _runs(ftype):
        f, blk = ftype[lo], out[lo:hi]
        if f == 0:
            blk[:] = x[lo:hi]
        elif f == 1:
            np.cumsum(x[lo:hi], axis=1, dtype=np.uint8, out=blk)
        else:
            np.cumsum(x[lo:hi], axis=0, dtype=np.uint8, out=blk)
            blk += prev
        prev = out[hi - 1]
    return out


def _unfilter_diagonal(rows, bpp):
    """Decode rows with any of the five filters along anti-diagonals.

    rows: (H, 1 + W·bpp) scanlines, each led by its filter byte.  In the
    diagonal-major layout D[d, 1 + r] holds pixel (r, d - r) and row 0 of
    every diagonal is zero, so a pixel's left neighbour is D[d-1, 1+r], its
    upper one D[d-1, r] and its upper-left one D[d-2, r]; only the cells of
    the image are written, so the ones beside it read as zero.  Both
    layouts are strided views of each other, so no element is scattered
    or gathered."""
    H = rows.shape[0]
    W = (rows.shape[1] - 1) // bpp
    nd = H + W - 1
    # X[d, r] = pixel (r, d - r) of the scanlines: a strided view of a
    # padded copy (cells off the image read other bytes and are never used)
    flat = np.zeros(rows.size + 2 * rows.shape[1] + nd * bpp, np.uint8)
    flat[:rows.size] = rows.reshape(-1)
    X = np.lib.stride_tricks.as_strided(
        flat[1:], (nd, H, bpp), (bpp, rows.shape[1] - bpp, 1),
        writeable=False)
    D = np.zeros((nd + 1, H + 1, bpp), np.int32)       # D[0] = diagonal -1
    ftype = rows[:, 0]
    # rows [r, run_end[r]) share row r's filter
    run_end = np.empty(H, np.int64)
    for lo, hi in _runs(ftype):
        run_end[lo:hi] = hi
    for d in range(nd):
        lo, hi = max(0, d - W + 1), min(H, d + 1)      # rows on diagonal d
        a = D[d, 1 + lo:1 + hi]                        # left
        b = D[d, lo:hi]                                # up
        c = D[max(d - 1, 0), lo:hi]                    # upper left
        if run_end[lo] >= hi:                          # one filter
            pred = _predict(ftype[lo], a, b, c)
        else:
            pred = np.zeros_like(a)
            for f in np.unique(ftype[lo:hi]):
                sel = (ftype[lo:hi] == f)[:, None]
                pred = np.where(sel, _predict(f, a, b, c), pred)
        D[d + 1, 1 + lo:1 + hi] = (X[d, lo:hi] + pred) & 255
    # pixel (r, c) = D[r + c + 1, 1 + r]
    e = D.itemsize * bpp
    out = np.lib.stride_tricks.as_strided(
        D[1:, 1:], (H, W, bpp), ((H + 2) * e, (H + 1) * e, D.itemsize),
        writeable=False)
    return out.astype(np.uint8)


def _unfilter(raw, H, row_bytes, bpp, path):
    """Filtered scanlines -> (H, row_bytes) raw bytes."""
    if len(raw) != H * (row_bytes + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"expected {H * (row_bytes + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(H, row_bytes + 1)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {ftype.max()}")
    # whole pixels along the row: a sub-byte row is bpp = 1 byte groups
    x = rows[:, 1:].reshape(H, row_bytes // bpp, bpp)
    if ftype.max(initial=0) <= 2:
        out = _unfilter_rows(ftype, x)
    else:
        out = _unfilter_diagonal(rows, bpp)
    return out.reshape(H, row_bytes)


def read_png(path):
    """Decode a PNG file into its own samples, RGB(A) channel order.

    8-bit and 16-bit gray, gray + alpha, RGB and RGBA; gray at 1, 2 or 4
    bits is scaled to 8 bits; palette images expand to RGB, or RGBA when
    the file has a tRNS chunk.  Interlaced files are refused."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _BIT_DEPTHS[ctype]:
        raise ValueError(f"{path}: unsupported PNG colour type {ctype} at "
                         f"{depth} bits")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    row_bytes = (W * bits + 7) // 8
    bpp = max(1, bits // 8)
    raw = _unfilter(zlib.decompress(b"".join(idat)), H, row_bytes, bpp,
                    path)

    if depth == 16:
        img = raw.view(">u2").astype(np.uint16).reshape(H, W, ch)
    elif depth == 8:
        img = raw.reshape(H, W, ch)
    else:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        img = ((raw[:, :, None] >> shifts) & ((1 << depth) - 1))
        img = img.reshape(H, row_bytes * per)[:, :W, None]
        if ctype == 0:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = img[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        rgb = palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:len(palette)]
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    return img[..., 0] if ch == 1 else img


def _jpeg_rgb(path):
    """A JPEG through OpenCV or PIL, whichever can be imported."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{path}: OpenCV cannot decode this file")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: reading JPEG needs OpenCV (cv2) or PIL, and neither "
            f"can be imported; convert the sequence to PNG") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imread_rgb(path):
    """(H, W, 3) uint8 RGB with the semantics of `cv2.imread(path)`
    followed by BGR-to-RGB: gray samples replicated to three channels,
    alpha dropped, 16-bit samples reduced to their high byte."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        return _jpeg_rgb(path)
    if ext != ".png":
        raise ValueError(f"{path}: only PNG and JPEG images are read")
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:                         # gray + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def imread_depth(path):
    """A gray PNG's samples as stored (uint16 for 16-bit depth maps), as
    `cv2.imread(path, cv2.IMREAD_ANYDEPTH)` gives them."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: a depth map must be a gray PNG, got "
                         f"{img.shape[-1]} channels")
    return img


def write_png(path, img, level=6):
    """Encode a uint8 (H, W), (H, W, 3) or (H, W, 4) image, or a uint16
    (H, W) or (H, W, 3) one, channels in RGB(A) order.  Every row uses the
    Up filter."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[-1]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None or img.ndim not in (2, 3):
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4), "
                         f"got {img.shape}")
    H, W = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = raw.view(np.uint8).reshape(H, -1)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]                  # uint8 wraps modulo 256
    body = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(body.tobytes(), level))
                 + chunk(b"IEND", b""))
    return path
