"""TartanAir dataset reader.

The JAX package's `data/tartan.py`: scenes are <root>/*/*/*/* with
image_left/*.png, depth_left/*.npy and pose_left.txt; poses arrive in NED
order and are permuted [1, 2, 0, 4, 5, 3, 6]; depths and pose translations
are divided by DEPTH_SCALE = 5 to balance rotation and translation
magnitudes; the 32-scene test split is left out of training.
"""

import glob
import os.path as osp

import numpy as np

from .base import RGBDDataset

# the reference's held-out validation scenes (tartan_test.txt)
TEST_SPLIT = [
    "abandonedfactory/abandonedfactory/Easy/P011",
    "abandonedfactory/abandonedfactory/Hard/P011",
    "abandonedfactory_night/abandonedfactory_night/Easy/P013",
    "abandonedfactory_night/abandonedfactory_night/Hard/P014",
    "amusement/amusement/Easy/P008", "amusement/amusement/Hard/P007",
    "carwelding/carwelding/Easy/P007",
    "endofworld/endofworld/Easy/P009",
    "gascola/gascola/Easy/P008", "gascola/gascola/Hard/P009",
    "hospital/hospital/Easy/P036", "hospital/hospital/Hard/P049",
    "japanesealley/japanesealley/Easy/P007",
    "japanesealley/japanesealley/Hard/P005",
    "neighborhood/neighborhood/Easy/P021",
    "neighborhood/neighborhood/Hard/P017",
    "ocean/ocean/Easy/P013", "ocean/ocean/Hard/P009",
    "office2/office2/Easy/P011", "office2/office2/Hard/P010",
    "office/office/Hard/P007",
    "oldtown/oldtown/Easy/P007", "oldtown/oldtown/Hard/P008",
    "seasidetown/seasidetown/Easy/P009",
    "seasonsforest/seasonsforest/Easy/P011",
    "seasonsforest/seasonsforest/Hard/P006",
    "seasonsforest_winter/seasonsforest_winter/Easy/P009",
    "seasonsforest_winter/seasonsforest_winter/Hard/P018",
    "soulcity/soulcity/Easy/P012", "soulcity/soulcity/Hard/P009",
    "westerndesert/westerndesert/Easy/P013",
    "westerndesert/westerndesert/Hard/P007",
]

# pose_left.txt's NED [t, q] to the camera frame trajectories are
# estimated in
NED_PERMUTATION = [1, 2, 0, 4, 5, 3, 6]


class TartanAir(RGBDDataset):
    DEPTH_SCALE = 5.0

    def __init__(self, datapath, **kwargs):
        super().__init__(name="TartanAir", datapath=datapath, **kwargs)

    @staticmethod
    def is_test_scene(scene):
        return any(x in scene.replace("\\", "/") for x in TEST_SPLIT)

    @staticmethod
    def calib_read():
        return np.array([320.0, 320.0, 320.0, 240.0])

    @staticmethod
    def depth_read(depth_file):
        depth = np.load(depth_file) / TartanAir.DEPTH_SCALE
        depth[~np.isfinite(depth)] = 1.0
        return depth

    def _build_dataset(self):
        scene_info = {}
        scenes = sorted(glob.glob(osp.join(self.root, "*/*/*/*")))
        for scene in scenes:
            images = sorted(glob.glob(osp.join(scene, "image_left/*.png")))
            depths = sorted(glob.glob(osp.join(scene, "depth_left/*.npy")))
            if not images or len(images) != len(depths):
                continue

            poses = np.loadtxt(osp.join(scene, "pose_left.txt"),
                               delimiter=" ")
            poses = poses[:, NED_PERMUTATION]
            poses[:, :3] /= TartanAir.DEPTH_SCALE
            intrinsics = [TartanAir.calib_read()] * len(images)

            graph = self.build_frame_graph(poses, depths, intrinsics)
            scene_info[scene] = {
                "images": images, "depths": depths, "poses": poses,
                "intrinsics": intrinsics, "graph": graph,
            }
        return scene_info
