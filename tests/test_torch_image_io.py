"""The port's PNG codec (data/image_io.py) against OpenCV.

Decoding is exact: every sample equals `cv2.imread(..., IMREAD_UNCHANGED)`
(channels in RGB order), on the repository's fixtures and on files OpenCV
writes with each of the five row filters forced, in 8-bit gray, RGB and
RGBA and 16-bit gray.  OpenCV reads the port's encoder's files back
exactly.  A subprocess with cv2 and PIL blocked runs the port's streams on
both fixture sequences, the path of a machine that has neither.
"""

import glob
import json
import os
import os.path as osp
import subprocess
import sys

import cv2
import numpy as np
import pytest

from droid_slam_tpu_torch.data import image_io

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE_PNGS = sorted(glob.glob(osp.join(ROOT, "tests", "fixtures", "**",
                                         "*.png"), recursive=True))
FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "all": cv2.IMWRITE_PNG_ALL_FILTERS}


def cv2_unchanged_rgb(path):
    """cv2.imread(IMREAD_UNCHANGED) with channels in RGB(A) order."""
    a = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if a.ndim == 3:
        a = a[..., [2, 1, 0, 3][:a.shape[2]]]
    return a


def to_bgr(img):
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


def contents(kind, H=37, W=53, seed=0):
    """Rows alternating noise and smooth ramps, so an encoder that picks
    filters per row uses several of them."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    if kind == "gray16":
        ramp = (x * 977 + y * 31) % 65536
        return np.where(y % 2, rng.integers(0, 65536, (H, W)),
                        ramp).astype(np.uint16)
    ch = {"gray8": 1, "rgb8": 3, "rgba8": 4}[kind]
    ramp = (x[..., None] * 3 + y[..., None] * 2 + 40 * np.arange(ch)) % 256
    img = np.where((y % 3 == 0)[..., None],
                   rng.integers(0, 256, (H, W, ch)), ramp).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def row_filters(path):
    """The filter byte of every row of a non-interlaced 8/16-bit PNG."""
    import struct
    import zlib

    with open(path, "rb") as f:
        chunks = list(image_io._chunks(f.read(), path))
    H = struct.unpack(">I", chunks[0][1][4:8])[0]
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    return np.frombuffer(raw, np.uint8).reshape(H, -1)[:, 0]


@pytest.mark.parametrize("path", FIXTURE_PNGS,
                         ids=[osp.relpath(p, ROOT) for p in FIXTURE_PNGS])
def test_fixture_decode_equals_cv2(path):
    got = image_io.read_png(path)
    want = cv2_unchanged_rgb(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flt", list(FILTERS))
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_decode_each_filter_equals_cv2(tmp_path, kind, flt):
    img = contents(kind)
    path = str(tmp_path / f"{kind}_{flt}.png")
    assert cv2.imwrite(path, to_bgr(img), [cv2.IMWRITE_PNG_FILTER,
                                           FILTERS[flt]])
    used = set(row_filters(path).tolist())
    if flt != "all":
        assert used == {list(FILTERS).index(flt)}
    got = image_io.read_png(path)
    np.testing.assert_array_equal(got, cv2_unchanged_rgb(path))
    np.testing.assert_array_equal(got, img)


def test_mixed_filters_are_all_exercised(tmp_path):
    """OpenCV's adaptive choice on 16-bit contents mixes all five filters
    in one file; the decoder takes them along anti-diagonals."""
    path = str(tmp_path / "mixed.png")
    cv2.imwrite(path, contents("gray16", 64, 80, seed=0),
                [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    assert set(row_filters(path).tolist()) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(image_io.read_png(path),
                                  cv2_unchanged_rgb(path))


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_encoder_read_back_by_cv2(tmp_path, kind):
    img = contents(kind, seed=1)
    path = str(tmp_path / f"{kind}.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(cv2_unchanged_rgb(path), img)
    np.testing.assert_array_equal(image_io.read_png(path), img)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_imread_rgb_is_cv2_default_read(tmp_path, kind):
    """imread_rgb = cv2.imread (IMREAD_COLOR) + BGR2RGB: gray replicated,
    alpha dropped, 16-bit samples to their high byte."""
    img = contents(kind, seed=2)
    path = str(tmp_path / f"{kind}.png")
    cv2.imwrite(path, to_bgr(img))
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    got = image_io.imread_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_imread_depth_is_cv2_anydepth(tmp_path):
    depth = contents("gray16", seed=4)
    path = str(tmp_path / "depth.png")
    cv2.imwrite(path, depth)
    want = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    got = image_io.imread_depth(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    rgb = str(tmp_path / "rgb.png")
    cv2.imwrite(rgb, contents("rgb8"))
    with pytest.raises(ValueError, match="gray"):
        image_io.imread_depth(rgb)


def filtered_png(path, rows, bpp, depth, ctype, W):
    """A PNG of raw scanlines (H, row_bytes) whose row r is filtered with
    filter r % 5, each filter computed pixel by pixel as the PNG
    specification states it."""
    import struct
    import zlib

    def paeth(a, b, c):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if pa <= pb and pa <= pc else (b if pb <= pc else c)

    out = []
    prev = np.zeros(rows.shape[1], int)
    for r, row in enumerate(rows.astype(int)):
        f = r % 5
        enc = [f]
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            pred = (0, a, b, (a + b) // 2, paeth(a, b, c))[f]
            enc.append((x - pred) % 256)
        out.extend(enc)
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    H = rows.shape[0]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                             ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_low_depth_gray_all_filters_equal_cv2(tmp_path, bits):
    """1-, 2- and 4-bit gray (scaled to 8 bits on reading) with rows under
    all five filters, written by the test's own encoder."""
    rng = np.random.default_rng(bits)
    H, W = 15, 29
    vals = rng.integers(0, 1 << bits, (H, W))
    per = 8 // bits
    padded = np.zeros((H, -(-W // per) * per), int)
    padded[:, :W] = vals
    shifts = np.arange(8 - bits, -1, -bits)
    rows = (padded.reshape(H, -1, per) << shifts).sum(-1)
    path = str(tmp_path / f"gray{bits}.png")
    filtered_png(path, rows, 1, bits, 0, W)
    got = image_io.read_png(path)
    np.testing.assert_array_equal(got, cv2_unchanged_rgb(path))
    np.testing.assert_array_equal(got, vals * (255 // ((1 << bits) - 1)))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_equals_cv2(tmp_path, bits):
    """Palette images with and without transparency, written by PIL."""
    from PIL import Image

    rng = np.random.default_rng(bits)
    idx = rng.integers(0, 1 << bits, (23, 31)).astype(np.uint8)
    pal = Image.fromarray(idx, mode="P")
    pal.putpalette(rng.integers(0, 256, (1 << bits) * 3).astype(
        np.uint8).tolist())
    for name, kw in (("pal.png", {}), ("pal_t.png", {"transparency": 0})):
        path = str(tmp_path / name)
        pal.save(path, bits=bits, **kw)
        got = image_io.read_png(path)
        assert got.shape[-1] == (4 if kw else 3)
        np.testing.assert_array_equal(got, cv2_unchanged_rgb(path))


def test_corrupt_and_unsupported_files_raise(tmp_path):
    path = str(tmp_path / "x.png")
    image_io.write_png(path, contents("rgb8"))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF                                 # inside IDAT
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        image_io.read_png(bad)
    txt = str(tmp_path / "x.bmp")
    open(txt, "wb").write(b"BM")
    with pytest.raises(ValueError, match="PNG and JPEG"):
        image_io.imread_rgb(txt)


def test_jpeg_through_cv2_or_error_naming_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "frame.jpg")
    img = contents("rgb8")
    cv2.imwrite(path, to_bgr(img))
    np.testing.assert_array_equal(
        image_io.imread_rgb(path),
        cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="frame.jpg.*cv2.*PIL"):
        image_io.imread_rgb(path)


BLOCKED = r"""
import json, sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import numpy as np
from droid_slam_tpu_torch.data import streams
out = {}
for name, frames in (
        ("tiny_seq", streams.directory_stream(
            sys.argv[1], sys.argv[1] + "/calib.txt", target_area=96 * 128)),
        ("tum_tiny", streams.tum_stream(sys.argv[2], stride=1))):
    frames = list(frames)
    out[name] = dict(n=len(frames), shape=list(frames[0][1].shape),
                     sums=[int(f[1].astype(np.int64).sum()) for f in frames],
                     intr=frames[0][2].tolist())
print(json.dumps(out))
"""


def test_streams_run_with_cv2_and_pil_blocked():
    """The port's streams in a process where cv2 and PIL cannot be
    imported give the frames they give here."""
    from droid_slam_tpu_torch.data import streams

    fix = osp.join(ROOT, "tests", "fixtures")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED, osp.join(fix, "tiny_seq"),
         osp.join(fix, "tum_tiny")], capture_output=True, text=True,
        env=env, timeout=300, check=True)
    got = json.loads(res.stdout.strip().splitlines()[-1])
    tiny = list(streams.directory_stream(
        osp.join(fix, "tiny_seq"), osp.join(fix, "tiny_seq", "calib.txt"),
        target_area=96 * 128))
    tum = list(streams.tum_stream(osp.join(fix, "tum_tiny"), stride=1))
    for name, frames in (("tiny_seq", tiny), ("tum_tiny", tum)):
        assert got[name]["n"] == len(frames) > 0
        assert got[name]["shape"] == list(frames[0][1].shape)
        assert got[name]["sums"] == [int(f[1].astype(np.int64).sum())
                                     for f in frames]
        assert got[name]["intr"] == frames[0][2].tolist()
