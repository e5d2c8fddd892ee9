"""Hyperparameter config, JSON-compatible with the reference's semantic.json.

An own copy of ``pointnet2_tpu/config.py``'s ``Config`` and ``SALayerSpec``:
the port imports nothing of the JAX package. The schema is the same, so
``semantic.json`` and ``semantic_no_color.json`` load verbatim.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class SALayerSpec:
    """One set-abstraction level: FPS target count, ball radius, group size."""

    npoint: int
    radius: float
    nsample: int


@dataclasses.dataclass(frozen=True)
class Config:
    # runtime / paths
    gpu: str = "0"
    logdir: str = "log/semantic"
    data_path: str = "dataset/semantic_downsampled/"

    # training
    max_epoch: int = 500
    num_point: int = 8192
    batch_size: int = 16
    use_color: int = 1

    optimizer: str = "adam"
    momentum: float = 0.9
    learning_rate: float = 0.001
    decay_step: int = 200000
    learning_rate_decay_rate: float = 0.7

    # sampling box
    box_size_x: float = 10.0
    box_size_y: float = 10.0

    # batch-norm momentum schedule
    bn_init_decay: float = 0.5
    bn_decay_decay_rate: float = 0.5
    bn_decay_clip: float = 0.99

    # SA levels (semantic.json:23-37)
    l1_radius: float = 0.5
    l1_nsample: int = 32
    l1_npoint: int = 1024
    l2_radius: float = 1.0
    l2_nsample: int = 32
    l2_npoint: int = 256
    l3_radius: float = 2.0
    l3_nsample: int = 32
    l3_npoint: int = 64
    l4_radius: float = 4.0
    l4_nsample: int = 32
    l4_npoint: int = 16

    @property
    def sa_layers(self) -> tuple[SALayerSpec, ...]:
        return (
            SALayerSpec(self.l1_npoint, self.l1_radius, self.l1_nsample),
            SALayerSpec(self.l2_npoint, self.l2_radius, self.l2_nsample),
            SALayerSpec(self.l3_npoint, self.l3_radius, self.l3_nsample),
            SALayerSpec(self.l4_npoint, self.l4_radius, self.l4_nsample),
        )

    @property
    def feature_size(self) -> int:
        return 3 * int(self.use_color)

    @property
    def point_dim(self) -> int:
        return 3 + self.feature_size

    @classmethod
    def from_json(cls, path: str | pathlib.Path) -> "Config":
        raw: dict[str, Any] = json.loads(pathlib.Path(path).read_text())
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        return cls(**raw)

    def to_json(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=4) + "\n")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
