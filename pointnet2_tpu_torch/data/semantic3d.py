"""Semantic3D dataset: per-scene z-box sampling and multi-scene batching.

An own copy of ``pointnet2_tpu/data/semantic3d.py`` (the port imports nothing
of the JAX package): with the same seed it draws the same batches, bit for bit.

Behavioral parity with dataset/semantic_dataset.py:
- scenes stored x-sorted for fast z-column crops (:84-88),
- random z-box crop around a random center point (:123-165),
- fixed-size down/up-sampling masks (:90-107),
- box centering: x/y centered, z floored at 0 (:109-121),
- scene choice weighted by point counts (:265-269, :317-320),
- 1/log(1.2 + freq) label weights on train splits (:271-285),
- identical split -> file-prefix lists (:7-54).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pointnet2_tpu_torch.data import augment as aug
from pointnet2_tpu_torch.data.io import load_labels, read_pcd
from pointnet2_tpu_torch.data.rng import ThreadLocalRNG, resolve_rng

train_file_prefixes = [
    "bildstein_station1_xyz_intensity_rgb",
    "bildstein_station3_xyz_intensity_rgb",
    "bildstein_station5_xyz_intensity_rgb",
    "domfountain_station1_xyz_intensity_rgb",
    "domfountain_station2_xyz_intensity_rgb",
    "domfountain_station3_xyz_intensity_rgb",
    "neugasse_station1_xyz_intensity_rgb",
    "sg27_station1_intensity_rgb",
    "sg27_station2_intensity_rgb",
]

validation_file_prefixes = [
    "sg27_station4_intensity_rgb",
    "sg27_station5_intensity_rgb",
    "sg27_station9_intensity_rgb",
    "sg28_station4_intensity_rgb",
    "untermaederbrunnen_station1_xyz_intensity_rgb",
    "untermaederbrunnen_station3_xyz_intensity_rgb",
]

test_file_prefixes = [
    "birdfountain_station1_xyz_intensity_rgb",
    "castleblatten_station1_intensity_rgb",
    "castleblatten_station5_xyz_intensity_rgb",
    "marketplacefeldkirch_station1_intensity_rgb",
    "marketplacefeldkirch_station4_intensity_rgb",
    "marketplacefeldkirch_station7_intensity_rgb",
    "sg27_station10_intensity_rgb",
    "sg27_station3_intensity_rgb",
    "sg27_station6_intensity_rgb",
    "sg27_station8_intensity_rgb",
    "sg28_station2_intensity_rgb",
    "sg28_station5_xyz_intensity_rgb",
    "stgallencathedral_station1_intensity_rgb",
    "stgallencathedral_station3_intensity_rgb",
    "stgallencathedral_station6_intensity_rgb",
]

all_file_prefixes = train_file_prefixes + validation_file_prefixes + test_file_prefixes

map_name_to_file_prefixes = {
    "train": train_file_prefixes,
    "train_full": train_file_prefixes + validation_file_prefixes,
    "validation": validation_file_prefixes,
    "test": test_file_prefixes,
    "all": all_file_prefixes,
}

LABEL_NAMES = [
    "unlabeled",
    "man-made terrain",
    "natural terrain",
    "high vegetation",
    "low vegetation",
    "buildings",
    "hard scape",
    "scanning artifact",
    "cars",
]

NUM_CLASSES = 9


class SemanticFileData:
    """One scene: points/labels/colors, x-sorted, with z-box sampling."""

    def __init__(
        self,
        file_path_without_ext: str,
        has_label: bool,
        use_color: bool,
        box_size_x: float,
        box_size_y: float,
        rng: "Optional[np.random.RandomState] | ThreadLocalRNG" = None,
    ):
        self.file_path_without_ext = file_path_without_ext
        self.box_size_x = box_size_x
        self.box_size_y = box_size_y
        self._rng = rng if rng is not None else np.random.RandomState()

        cloud = read_pcd(file_path_without_ext + ".pcd")
        self.points = np.asarray(cloud.points)

        if has_label:
            self.labels = load_labels(file_path_without_ext + ".labels")
        else:
            self.labels = np.zeros(len(self.points), dtype=np.int32)

        if use_color and cloud.colors is not None:
            self.colors = np.asarray(cloud.colors)
        else:
            self.colors = np.zeros_like(self.points)

        # x-sort to enable searchsorted z-box cropping (semantic_dataset.py:84-88)
        sort_idx = np.argsort(self.points[:, 0])
        self.points = self.points[sort_idx]
        self.labels = self.labels[sort_idx]
        self.colors = self.colors[sort_idx]

    @property
    def rng(self) -> np.random.RandomState:
        """The calling thread's RandomState (see data/rng.py for the contract)."""
        return resolve_rng(self._rng)

    @rng.setter
    def rng(self, value) -> None:
        self._rng = value

    # -- sampling helpers -------------------------------------------------

    def _get_fix_sized_sample_mask(self, points: np.ndarray, num: int):
        """Random keep-mask (downsample) or cyclic repetition (upsample)."""
        if len(points) - num > 0:
            mask = np.zeros(len(points), dtype=bool)
            mask[:num] = True
            self.rng.shuffle(mask)
            return mask
        idx = np.arange(len(points))
        reps = -(-num // max(len(idx), 1))
        return np.tile(idx, reps)[:num]

    def _center_box(self, points: np.ndarray) -> np.ndarray:
        """x/y centered on box, z floored at 0 (semantic_dataset.py:109-121)."""
        box_min = np.min(points, axis=0)
        shift = np.array(
            [
                box_min[0] + self.box_size_x / 2,
                box_min[1] + self.box_size_y / 2,
                box_min[2],
            ]
        )
        return points - shift

    def _extract_z_box(self, center_point: np.ndarray) -> np.ndarray:
        """Full-height box around (x, y) of center (semantic_dataset.py:123-165)."""
        scene_z_size = self.points[:, 2].max() - self.points[:, 2].min()
        half = np.array(
            [self.box_size_x / 2, self.box_size_y / 2, scene_z_size]
        )
        box_min = center_point - half
        box_max = center_point + half

        i_min = np.searchsorted(self.points[:, 0], box_min[0])
        i_max = np.searchsorted(self.points[:, 0], box_max[0])
        sub = self.points[i_min:i_max]
        mask = np.all((sub >= box_min) & (sub <= box_max), axis=1)
        full = np.zeros(len(self.points), dtype=bool)
        full[i_min:i_max] = mask
        assert full.any()
        return full

    def sample(self, num_points_per_sample: int):
        """One fixed-size sample: (points_centered, points_raw, labels, colors)."""
        center = self.points[self.rng.randint(0, len(self.points))]
        crop = self._extract_z_box(center)
        points = self.points[crop]
        labels = self.labels[crop]
        colors = self.colors[crop]

        mask = self._get_fix_sized_sample_mask(points, num_points_per_sample)
        points = points[mask]
        labels = labels[mask]
        colors = colors[mask]

        return self._center_box(points), points, labels, colors

    def sample_batch(self, batch_size: int, num_points_per_sample: int):
        centered, raw, labels, colors = [], [], [], []
        for _ in range(batch_size):
            c, r, l, col = self.sample(num_points_per_sample)
            centered.append(c)
            raw.append(r)
            labels.append(l)
            colors.append(col)
        return (
            np.array(centered),
            np.array(raw),
            np.array(labels),
            np.array(colors),
        )


class SemanticDataset:
    """Multi-scene dataset with point-count-weighted scene sampling."""

    def __init__(
        self,
        num_points_per_sample: int,
        split: str,
        use_color: bool,
        box_size_x: float,
        box_size_y: float,
        path: str,
        seed: Optional[int] = None,
    ):
        self.num_points_per_sample = num_points_per_sample
        self.split = split
        self.use_color = use_color
        self.box_size_x = box_size_x
        self.box_size_y = box_size_y
        self.num_classes = NUM_CLASSES
        self.path = path
        self.labels_names = list(LABEL_NAMES)
        # One RandomState PER SAMPLING THREAD, spawned from one SeedSequence:
        # the BatchProducer's worker threads each draw from their own stream
        # (RandomState is not thread-safe; the reference re-seeded per worker
        # process instead, train.py:123). With a fixed seed and one sampling
        # thread, the batch stream is bit-reproducible (data/rng.py).
        self._rng = ThreadLocalRNG(seed)

        file_prefixes = map_name_to_file_prefixes[split]
        self.list_file_data = [
            SemanticFileData(
                file_path_without_ext=os.path.join(path, p),
                has_label=split != "test",
                use_color=use_color,
                box_size_x=box_size_x,
                box_size_y=box_size_y,
                rng=self._rng,
            )
            for p in file_prefixes
        ]

        totals = np.array([len(fd.points) for fd in self.list_file_data], np.float64)
        self.scene_probas = totals / totals.sum()

        if split in ("train", "train_full"):
            hist = np.zeros(NUM_CLASSES)
            for fd in self.list_file_data:
                tmp, _ = np.histogram(fd.labels, range(NUM_CLASSES + 1))
                hist += tmp
            freq = hist.astype(np.float32) / hist.sum()
            self.label_weights = (1.0 / np.log(1.2 + freq)).astype(np.float32)
        else:
            # Reference quirk, preserved deliberately
            # (dataset/semantic_dataset.py:284-285): non-train splits get
            # all-zero label weights, so any loss computed on validation
            # batches is identically 0 (SUM_BY_NONZERO_WEIGHTS over zero
            # weights). Eval quality is judged from the confusion matrix
            # (accuracy/mIoU) instead — train.py logs only those for eval,
            # and Trainer._eval_step documents the always-zero loss.
            self.label_weights = np.zeros(NUM_CLASSES, np.float32)

    @property
    def rng(self) -> np.random.RandomState:
        """The calling thread's RandomState (see data/rng.py for the contract)."""
        return resolve_rng(self._rng)

    @rng.setter
    def rng(self, value) -> None:
        self._rng = value

    def sample_in_all_files(self, is_training: bool):
        scene_index = self.rng.choice(len(self.list_file_data), p=self.scene_probas)
        centered, raw, labels, colors = self.list_file_data[scene_index].sample(
            self.num_points_per_sample
        )
        if is_training:
            weights = self.label_weights[labels]
            return centered, labels, colors, weights
        return scene_index, centered, raw, labels, colors

    def sample_batch_in_all_files(self, batch_size: int, augment: bool = True):
        data, label, weights = [], [], []
        for _ in range(batch_size):
            pts, labels, colors, w = self.sample_in_all_files(is_training=True)
            data.append(np.hstack((pts, colors)) if self.use_color else pts)
            label.append(labels)
            weights.append(w)

        batch_data = np.array(data, np.float32)
        batch_label = np.array(label, np.int32)
        batch_weights = np.array(weights, np.float32)

        if augment:
            if self.use_color:
                batch_data = aug.rotate_feature_point_cloud(batch_data, 3, rng=self.rng)
            else:
                batch_data = aug.rotate_point_cloud(batch_data, rng=self.rng)
        return batch_data, batch_label, batch_weights

    def get_total_num_points(self) -> int:
        return int(sum(len(fd.points) for fd in self.list_file_data))

    def get_num_batches(self, batch_size: int) -> int:
        return int(
            self.get_total_num_points() / (batch_size * self.num_points_per_sample)
        )

    def get_file_paths_without_ext(self):
        return [fd.file_path_without_ext for fd in self.list_file_data]
