"""Training datasets by name and evaluation streams by dataset layout.

The JAX package's `data/factory.py`: `dataset_factory` concatenates the
named training datasets; `create_stream` recognises an evaluation dataset
by its marker files.
"""

import os.path as osp

import numpy as np

from . import streams
from .base import sample_batches


def dataset_factory(dataset_list, **kwargs):
    """The training datasets named in `dataset_list` ("tartan"), each
    built with `kwargs`; one dataset alone, else their concatenation."""
    from .tartan import TartanAir

    registry = {"tartan": TartanAir}
    datasets = [registry[name](**kwargs) for name in dataset_list]
    if len(datasets) == 1:
        return datasets[0]
    return ConcatDataset(datasets)


class ConcatDataset:
    """Datasets indexed one after another."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.lengths = np.asarray([len(d) for d in datasets])
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)])

    def __len__(self):
        return int(self.lengths.sum())

    def __getitem__(self, index, rng=None):
        index = index % len(self)
        d = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return self.datasets[d].__getitem__(index - int(self.offsets[d]),
                                            rng)

    def sample_batches(self, batch_size, rng, shuffle=True):
        """Endless stacked batches drawn with `rng`."""
        return sample_batches(self, batch_size, rng, shuffle)


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
