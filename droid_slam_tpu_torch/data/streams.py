"""Evaluation image streams: TUM-RGBD, EuRoC (mono/stereo), ETH3D,
TartanAir, KITTI and calibrated image directories.

The streams of the JAX package's `data/streams.py`, with the same
signatures and yields, reading PNG through `image_io` and resizing,
undistorting and rectifying through `warp` instead of OpenCV.  All yield
RGB HWC uint8 images (stereo: (2, H, W, 3), or left and right apart where
the JAX stream yields them apart) and fx/fy/cx/cy at the yielded
resolution; RGB-D streams add a metric depth map.
"""

import glob
import os.path as osp

import numpy as np

from ..geom.align import associate
from .image_io import imread_depth, imread_rgb
from .warp import remap_linear, resize_linear, undistort, \
    undistort_rectify_map

# EuRoC rectification constants (the reference's test_euroc.py:29-49)
_EUROC_K_L = np.array(
    [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0, 0, 1]
).reshape(3, 3)
_EUROC_D_L = np.array(
    [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
)
_EUROC_R_L = np.array([
    0.999966347530033, -0.001422739138722922, 0.008079580483432283,
    0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
    -0.008089410156878961, -0.007044357138835809, 0.9999424675829176,
]).reshape(3, 3)
_EUROC_P_L = np.array([
    435.2046959714599, 0, 367.4517211914062, 0,
    0, 435.2046959714599, 252.2008514404297, 0,
    0, 0, 1, 0,
]).reshape(3, 4)
_EUROC_K_R = np.array(
    [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0, 0, 1]
).reshape(3, 3)
_EUROC_D_R = np.array(
    [-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
)
_EUROC_R_R = np.array([
    0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
    0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
    -0.007729688520722713, 0.007064130529506649, 0.999945173484644,
]).reshape(3, 3)
_EUROC_P_R = np.array([
    435.2046959714599, 0, 367.4517211914062, -47.90639384423901,
    0, 435.2046959714599, 252.2008514404297, 0,
    0, 0, 1, 0,
]).reshape(3, 4)

# TUM fr1 calibration (the reference's test_tum.py:23-28)
_TUM_INTR = (517.3, 516.5, 318.6, 255.3)
_TUM_DIST = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])


def _crop8(img):
    """Crop the bottom/right edge to a multiple of 8."""
    h, w = img.shape[:2]
    return img[: h - h % 8, : w - w % 8]


def _images(*parts):
    """Sorted PNG and JPEG paths of a directory."""
    return sorted(glob.glob(osp.join(*parts, "*.png"))
                  + glob.glob(osp.join(*parts, "*.jpg")))


def _read_calib(calib):
    """fx fy cx cy [distortion...] of a calibration file, and K."""
    calib = np.loadtxt(calib, delimiter=" ")
    fx, fy, cx, cy = calib[:4]
    K = np.eye(3)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2] = fx, cx, fy, cy
    return calib, K


def _load_resized(path, calib, K, target_area):
    """A calibrated directory's image: undistorted when the calibration
    has distortion terms, resized to about `target_area` pixels, cropped
    to a multiple of 8.  Returns (image, (h0, w0, h1, w1))."""
    image = imread_rgb(path)
    if len(calib) > 4:
        image = undistort(image, K, calib[4:])
    h0, w0 = image.shape[:2]
    s = np.sqrt(target_area / (h0 * w0))
    h1, w1 = int(h0 * s), int(w0 * s)
    image = _crop8(resize_linear(image, h1, w1))
    return image, (h0, w0, h1, w1)


def _scaled_intr(calib, shape):
    fx, fy, cx, cy = calib[:4]
    h0, w0, h1, w1 = shape
    return np.array([fx * w1 / w0, fy * h1 / h0, cx * w1 / w0,
                     cy * h1 / h0], np.float32)


def tum_stream(datapath, stride=2):
    """TUM-RGBD mono stream: undistort with the fr1 intrinsics, resize to
    352x256, crop the distortion boundary to 240x320."""
    fx, fy, cx, cy = _TUM_INTR
    K = np.array([fx, 0, cx, 0, fy, cy, 0, 0, 1]).reshape(3, 3)
    images_list = sorted(
        glob.glob(osp.join(datapath, "rgb", "*.png")))[::stride]
    intr = np.array([
        fx * 352 / 640.0, fy * 256 / 480.0,
        cx * 352 / 640.0 - 16, cy * 256 / 480.0 - 8,
    ], np.float32)
    for t, imfile in enumerate(images_list):
        image = undistort(imread_rgb(imfile), K, _TUM_DIST)
        image = resize_linear(image, 256, 352)
        yield t, image[8:-8, 16:-16], intr


def euroc_stream(datapath, stereo=False, stride=1, image_size=(320, 512)):
    """EuRoC MAV stream: stereo rectification maps, resize to image_size.
    Yields (stride·t, image, intrinsics, timestamp in ns)."""
    ht0, wd0 = 480, 752
    map_l = undistort_rectify_map(_EUROC_K_L, _EUROC_D_L, _EUROC_R_L,
                                  _EUROC_P_L, (ht0, wd0))
    map_r = undistort_rectify_map(_EUROC_K_R, _EUROC_D_R, _EUROC_R_R,
                                  _EUROC_P_R, (ht0, wd0))
    intr0 = np.array([
        435.2046959714599, 435.2046959714599,
        367.4517211914062, 252.2008514404297,
    ])

    images_left = sorted(
        glob.glob(osp.join(datapath, "mav0/cam0/data/*.png")))[::stride]
    images_right = [x.replace("cam0", "cam1") for x in images_left]

    H, W = image_size
    intr = (intr0 * np.array([W / wd0, H / ht0, W / wd0, H / ht0])
            ).astype(np.float32)
    for t, (imgL, imgR) in enumerate(zip(images_left, images_right)):
        if stereo and not osp.isfile(imgR):
            continue
        tstamp = float(osp.basename(imgL)[:-4])
        ims = [remap_linear(imread_rgb(imgL), *map_l)]
        if stereo:
            ims.append(remap_linear(imread_rgb(imgR), *map_r))
        ims = [resize_linear(im, H, W) for im in ims]
        image = np.stack(ims, 0) if stereo else ims[0]
        yield stride * t, image, intr, tstamp


def eth3d_stream(datapath, stride=1, depth_scale=5000.0):
    """ETH3D-SLAM RGB-D stream: associated rgb/depth pairs, depth divided
    by depth_scale, cropped to a multiple of 8.  Yields (t, image, depth,
    intrinsics, timestamp)."""
    rgb_list = np.loadtxt(
        osp.join(datapath, "rgb.txt"), dtype=str, skiprows=0
    ).reshape(-1, 2)
    depth_list = np.loadtxt(
        osp.join(datapath, "depth.txt"), dtype=str, skiprows=0
    ).reshape(-1, 2)
    calib = np.loadtxt(osp.join(datapath, "calibration.txt"))

    matches = associate(
        rgb_list[:, 0].astype(np.float64),
        depth_list[:, 0].astype(np.float64),
    )[::stride]

    for t, (i, j) in enumerate(matches):
        tstamp = float(rgb_list[i, 0])
        image = imread_rgb(osp.join(datapath, rgb_list[i, 1]))
        depth = imread_depth(osp.join(datapath, depth_list[j, 1])).astype(
            np.float32) / depth_scale
        yield (t, _crop8(image), _crop8(depth),
               calib[:4].astype(np.float32), tstamp)


def tartan_stream(datapath, stride=1):
    """TartanAir scene stream: `image_left/*.png` at the fixed TartanAir
    pinhole calibration.  Yields (t, (H, W, 3) RGB uint8, fx/fy/cx/cy)."""
    intr = np.array([320.0, 320.0, 320.0, 240.0], np.float32)
    paths = sorted(
        glob.glob(osp.join(datapath, "image_left", "*.png")))[::stride]
    for t, path in enumerate(paths):
        yield t, _crop8(imread_rgb(path)), intr


def kitti_stream(datapath, stride=1, stereo=False):
    """KITTI odometry sequence stream: `image_2/` (+ `image_3/` right, or
    `image_0/` / `image_1/`) with the sequence `calib.txt` P2 (or P0)
    projection row.  Yields (t, image, intr) or, with stereo,
    (t, left, right, intr); images cropped to a multiple of 8."""
    P = {}
    with open(osp.join(datapath, "calib.txt")) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                P[k.strip()] = np.array(v.split(), np.float64).reshape(3, 4)
    P2 = P["P2"] if "P2" in P else P["P0"]
    intr = np.array(
        [P2[0, 0], P2[1, 1], P2[0, 2], P2[1, 2]], np.float32
    )

    ldir = "image_2" if osp.isdir(osp.join(datapath, "image_2")) else \
        "image_0"
    rdir = "image_3" if osp.isdir(osp.join(datapath, "image_3")) else \
        "image_1"
    lefts = sorted(glob.glob(osp.join(datapath, ldir, "*.png")))[::stride]
    rights = sorted(glob.glob(osp.join(datapath, rdir, "*.png")))[::stride]

    for t, lp in enumerate(lefts):
        if stereo:
            yield (t, _crop8(imread_rgb(lp)), _crop8(imread_rgb(rights[t])),
                   intr)
        else:
            yield t, _crop8(imread_rgb(lp)), intr


def directory_stream(imagedir, calib, stride=1, target_area=384 * 512,
                     t0=0):
    """Calibrated image-directory stream (`calib`: fx fy cx cy [k1 k2 p1
    p2 [k3]]): undistorted, resized to about target_area pixels, cropped
    to a multiple of 8; frames t0, t0 + stride, ...  Yields (t, image,
    intrinsics)."""
    calib, K = _read_calib(calib)
    for t, path in enumerate(_images(imagedir)[t0::stride]):
        image, shape = _load_resized(path, calib, K, target_area)
        yield t, image, _scaled_intr(calib, shape)


def stereo_directory_stream(datapath, calib, stride=1,
                            target_area=384 * 512):
    """Calibrated stereo stream: `image_left/` + `image_right/` with
    matching sorted filenames.  Yields (t, (H, W, 3) left RGB, (H, W, 3)
    right RGB, intrinsics)."""
    calib, K = _read_calib(calib)
    lefts = _images(datapath, "image_left")[::stride]
    rights = _images(datapath, "image_right")[::stride]
    for t, (lp, rp) in enumerate(zip(lefts, rights)):
        left, shape = _load_resized(lp, calib, K, target_area)
        right, _ = _load_resized(rp, calib, K, target_area)
        yield t, left, right, _scaled_intr(calib, shape)


def rgbd_directory_stream(datapath, calib, stride=1, depth_scale=1000.0):
    """Calibrated RGB-D stream: `rgb/` + `depth/` with matching sorted
    filenames; depth PNGs divided by depth_scale.  Yields (t, (H, W, 3)
    RGB, (H, W) metric depth, intrinsics)."""
    calib = np.loadtxt(calib, delimiter=" ")
    intr = calib[:4].astype(np.float32)
    rgbs = _images(datapath, "rgb")[::stride]
    depths = sorted(glob.glob(osp.join(datapath, "depth", "*.png")))[::stride]
    for t, (ip, dp) in enumerate(zip(rgbs, depths)):
        depth = imread_depth(dp).astype(np.float32) / depth_scale
        yield t, _crop8(imread_rgb(ip)), _crop8(depth), intr
