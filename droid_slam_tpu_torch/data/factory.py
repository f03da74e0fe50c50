"""Evaluation streams by dataset layout.

`create_stream` of the JAX package's `data/factory.py`: the dataset is
recognised by its marker files.  The training-dataset registry waits for
the TartanAir reader, which is not ported yet.
"""

import os.path as osp

from . import streams


def create_stream(datapath, **kwargs):
    """The evaluation stream of the dataset at `datapath`.  Marker-file
    priority: calibration.txt -> ETH3D, image_left/ -> TartanAir,
    rgb.txt or rgb/ -> TUM, mav0/ -> EuRoC, calib.txt -> KITTI."""
    if osp.isfile(osp.join(datapath, "calibration.txt")):
        return streams.eth3d_stream(datapath, **kwargs)
    if osp.isdir(osp.join(datapath, "image_left")):
        return streams.tartan_stream(datapath, **kwargs)
    if osp.isfile(osp.join(datapath, "rgb.txt")) or \
       osp.isdir(osp.join(datapath, "rgb")):
        return streams.tum_stream(datapath, **kwargs)
    if osp.isdir(osp.join(datapath, "mav0")):
        return streams.euroc_stream(datapath, **kwargs)
    if osp.isfile(osp.join(datapath, "calib.txt")):
        return streams.kitti_stream(datapath, **kwargs)
    raise ValueError(f"unrecognized dataset layout at {datapath}")
