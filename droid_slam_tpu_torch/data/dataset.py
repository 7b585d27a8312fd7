"""Training datasets: clips sampled along the covisibility graphs of RGB-D
scenes (numpy on the host).

The port's counterpart of the JAX package's ``data/dataset.py`` (reference
data_readers/base.py ``RGBDDataset``, tartan.py ``TartanAir`` and
factory.py). ``clips()`` yields the batches that ``apps/train.py`` consumes.
Each scene's covisibility graph (the flow-distance matrix over its
ground-truth poses and depths, :mod:`.rgbd_utils`) is computed once and
cached as a pickle (base.py:33-47), one per dataset name and root
directory, by default in this package's ``data/cache/``. Images are decoded by the native library
(:mod:`.native_loader`), else by ``cv2``; a subclass may override the
``image_read`` staticmethod."""

from __future__ import annotations

import glob
import hashlib
import os
import os.path as osp
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .augmentation import RGBDAugmentor
from .rgbd_utils import compute_distance_matrix_flow
from .streams import _imread_rgb

DEFAULT_CACHE_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "cache")


class RGBDDataset:
    """Base class: scenes → covisibility graphs → clip sampling."""

    def __init__(
        self,
        name: str,
        datapath: str,
        n_frames: int = 4,
        crop_size: Tuple[int, int] = (384, 512),
        fmin: float = 8.0,
        fmax: float = 75.0,
        do_aug: bool = True,
        cache_dir: Optional[str] = None,
        seed: int = 0,
    ):
        self.root = datapath
        self.name = name
        self.n_frames = n_frames
        self.fmin = fmin  # exclude very easy examples (base.py:26)
        self.fmax = fmax  # exclude very hard examples
        self.rng = np.random.default_rng(seed)
        self.aug = RGBDAugmentor(crop_size=crop_size, seed=seed) if do_aug else None

        # one pickle per dataset and root: a cache keyed by the name alone
        # would hand one root's graphs (and file paths) to another
        cache_dir = cache_dir or DEFAULT_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        root_key = hashlib.sha256(osp.abspath(datapath).encode()).hexdigest()[:16]
        cache_path = osp.join(cache_dir, f"{self.name}-{root_key}.pickle")

        if osp.isfile(cache_path):
            with open(cache_path, "rb") as f:
                scene_info = pickle.load(f)[0]
        else:
            scene_info = self._build_dataset()
            with open(cache_path, "wb") as f:
                pickle.dump((scene_info,), f)

        self.scene_info = scene_info
        self._build_dataset_index()

    # ------------------------------------------------------------ subclass API

    @staticmethod
    def is_test_scene(scene: str) -> bool:
        return False

    @staticmethod
    def image_read(image_file: str) -> np.ndarray:
        """u8 RGB [H, W, 3]: the native decoder, else cv2."""
        return _imread_rgb(image_file)

    @staticmethod
    def depth_read(depth_file: str) -> np.ndarray:
        return np.load(depth_file)

    def _build_dataset(self) -> Dict:
        raise NotImplementedError

    # ------------------------------------------------------------- graph build

    def build_frame_graph(self, poses, depths, intrinsics, f: int = 16, max_flow: float = 256):
        """Flow-distance covisibility graph at 1/f resolution (base.py:67-90)."""

        def read_disp(fn):
            depth = self.__class__.depth_read(fn)[f // 2 :: f, f // 2 :: f]
            depth[depth < 0.01] = np.mean(depth)
            return 1.0 / depth

        poses = np.array(poses, np.float32)
        intrinsics = np.array(intrinsics, np.float32) / f
        disps = np.stack([read_disp(d) for d in depths], 0)
        d = f * compute_distance_matrix_flow(poses, disps, intrinsics)

        graph = {}
        for i in range(d.shape[0]):
            (j,) = np.where(d[i] < max_flow)
            graph[i] = (j, d[i, j])
        return graph

    def _build_dataset_index(self):
        self.dataset_index: List[Tuple[str, int]] = []
        for scene in self.scene_info:
            if not self.__class__.is_test_scene(scene):
                graph = self.scene_info[scene]["graph"]
                for i in graph:
                    if len(graph[i][0]) > self.n_frames:
                        self.dataset_index.append((scene, i))

    # --------------------------------------------------------------- sampling

    def __len__(self) -> int:
        return len(self.dataset_index)

    def __getitem__(self, index: int):
        """Sample one training clip (base.py:92-150): walk the covisibility
        graph preferring forward frames with fmin < flow < fmax; returns
        (images [N,H,W,3] RGB f32, poses w2c? — as stored, disps [N,H,W],
        intrinsics [N,4]) with the scene rescaled to unit mean disparity."""
        scene_id, ix = self.dataset_index[index % len(self.dataset_index)]
        info = self.scene_info[scene_id]
        frame_graph = info["graph"]

        inds = [ix]
        while len(inds) < self.n_frames:
            k = (frame_graph[ix][1] > self.fmin) & (frame_graph[ix][1] < self.fmax)
            frames = frame_graph[ix][0][k]
            if np.count_nonzero(frames[frames > ix]):
                ix = int(self.rng.choice(frames[frames > ix]))
            elif np.count_nonzero(frames):
                ix = int(self.rng.choice(frames))
            inds.append(ix)

        images = np.stack(
            [self.__class__.image_read(info["images"][i]) for i in inds]
        ).astype(np.float32)
        depths = np.stack(
            [self.__class__.depth_read(info["depths"][i]) for i in inds]
        ).astype(np.float32)
        poses = np.stack([info["poses"][i] for i in inds]).astype(np.float32)
        intrinsics = np.stack([info["intrinsics"][i] for i in inds]).astype(np.float32)

        disps = 1.0 / depths
        if self.aug is not None:
            images, poses, disps, intrinsics = self.aug(images, poses, disps, intrinsics)

        # scene scale normalisation (base.py:144-148)
        valid = disps[disps > 0.01]
        if valid.size > 0:
            s = valid.mean()
            disps = disps / s
            poses = poses.copy()
            poses[..., :3] *= s

        return images, poses, disps, intrinsics

    def clips(self, batch: int, shuffle: bool = True) -> Iterator[Dict]:
        """Yield batched training dicts compatible with train.trainer."""
        order = np.arange(len(self))
        if len(order) < batch:
            raise ValueError(
                f"dataset has {len(order)} clips but batch={batch}: the "
                "clip loop would spin forever yielding nothing (fewer "
                "scenes than the batch size, or the covisibility graph "
                "filtered almost everything)"
            )
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for s in range(0, len(order) - batch + 1, batch):
                samples = [self[int(i)] for i in order[s : s + batch]]
                images, poses, disps, intrinsics = (np.stack(x) for x in zip(*samples))
                yield {
                    "images": images,
                    "poses": poses,
                    "disps": disps,
                    "intrinsics": intrinsics,
                }


TARTAN_TEST_SCENES = [
    "abandonedfactory/abandonedfactory/Easy/P011",
    "abandonedfactory/abandonedfactory/Hard/P011",
    "abandonedfactory_night/abandonedfactory_night/Easy/P013",
    "abandonedfactory_night/abandonedfactory_night/Hard/P014",
    "amusement/amusement/Easy/P008",
    "amusement/amusement/Hard/P007",
    "carwelding/carwelding/Easy/P007",
    "endofworld/endofworld/Easy/P009",
    "gascola/gascola/Easy/P008",
    "gascola/gascola/Hard/P009",
    "hospital/hospital/Easy/P036",
    "hospital/hospital/Hard/P049",
    "japanesealley/japanesealley/Easy/P007",
    "japanesealley/japanesealley/Hard/P005",
    "neighborhood/neighborhood/Easy/P021",
    "neighborhood/neighborhood/Hard/P017",
    "ocean/ocean/Easy/P013",
    "ocean/ocean/Hard/P009",
    "office2/office2/Easy/P011",
    "office2/office2/Hard/P010",
    "office/office/Hard/P007",
    "oldtown/oldtown/Easy/P007",
    "oldtown/oldtown/Hard/P008",
    "seasidetown/seasidetown/Easy/P009",
    "seasonsforest/seasonsforest/Easy/P011",
    "seasonsforest/seasonsforest/Hard/P006",
    "seasonsforest_winter/seasonsforest_winter/Easy/P009",
    "seasonsforest_winter/seasonsforest_winter/Hard/P018",
    "soulcity/soulcity/Easy/P012",
    "soulcity/soulcity/Hard/P009",
    "westerndesert/westerndesert/Easy/P013",
    "westerndesert/westerndesert/Hard/P007",
]


class TartanAir(RGBDDataset):
    """TartanAir training reader (tartan.py:18-66). Poses are converted from
    NED to the (x-right, y-down, z-forward) camera convention via the column
    permutation [1,2,0,4,5,3,6]; depths are divided by DEPTH_SCALE=5 to
    balance rotation/translation magnitudes."""

    DEPTH_SCALE = 5.0

    def __init__(self, datapath: str, **kwargs):
        super().__init__(name="TartanAir", datapath=datapath, **kwargs)

    @staticmethod
    def is_test_scene(scene: str) -> bool:
        return any(x in scene for x in TARTAN_TEST_SCENES)

    def _build_dataset(self) -> Dict:
        scene_info = {}
        scenes = sorted(glob.glob(osp.join(self.root, "*/*/*/*")))
        for scene in scenes:
            images = sorted(glob.glob(osp.join(scene, "image_left/*.png")))
            depths = sorted(glob.glob(osp.join(scene, "depth_left/*.npy")))
            if not images or len(images) != len(depths):
                continue

            poses = np.loadtxt(osp.join(scene, "pose_left.txt"), delimiter=" ")
            poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]
            poses[:, :3] /= TartanAir.DEPTH_SCALE
            intrinsics = [TartanAir.calib_read()] * len(images)

            graph = self.build_frame_graph(poses, depths, intrinsics)
            scene_info[scene] = {
                "images": images,
                "depths": depths,
                "poses": poses,
                "intrinsics": intrinsics,
                "graph": graph,
            }
        return scene_info

    @staticmethod
    def calib_read() -> np.ndarray:
        return np.array([320.0, 320.0, 320.0, 240.0])

    @staticmethod
    def depth_read(depth_file: str) -> np.ndarray:
        depth = np.load(depth_file) / TartanAir.DEPTH_SCALE
        depth[~np.isfinite(depth)] = 1.0
        return depth


def dataset_factory(dataset_list: List[str], **kwargs) -> RGBDDataset:
    """Mirror of data_readers/factory.py:17 (TartanAir is the only training
    set the reference trainer uses, train.py:63)."""
    datasets = []
    for name in dataset_list:
        if name == "tartan":
            datasets.append(TartanAir(**kwargs))
        else:
            raise ValueError(f"unknown dataset: {name}")
    if len(datasets) == 1:
        return datasets[0]
    raise NotImplementedError("multi-dataset concatenation: pass one dataset")
