"""Host time of a predict request through the ``pn2`` operators and through the raw kernel wrappers.

    python /path/to/pointnet2_tpu_torch/tools/dispatch_probe.py [TAG] [REQUESTS]
        (from a tree's root, that tree on PYTHONPATH)

On one card at ``semantic.json`` width: a ``Predictor`` of seeded weights
answers 16-cloud requests (chunks of 8), each timed on the host clock to a
synchronize and by CUDA events. Where the tree has ``ops.library``, each of
REQUESTS rounds (default 30) runs one request in each of two modes on the
same clouds, the first mode alternating: ``pn2`` as the package runs, and
``raw`` with every ``torch.ops.pn2`` operator replaced by its CUDA
implementation (``ops.library.CUDA``, the ``ops.cuda`` wrapper), so that the
two differ only in the dispatcher's layer and meet the same state of the
host. A tree without it runs its one mode, ``as_is``. After each request,
100 queued calls of ``ops.fps_centroids`` at SA4's shape (B=8 of 64 points,
16 centroids) are timed on the host clock. One JSON line: each mode's
medians and samples, and the medians of the paired differences. It calls
only the API every tree of the port has, so one copy reads an older tree
too: run it from that tree's root with that tree on ``PYTHONPATH``, in turns
with the newer one on the same card. Needs a card.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

from pointnet2_tpu_torch import convert, ops
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor, full_float32
from pointnet2_tpu_torch.utils.bench import card_line

BATCH, CHUNK, SEED = 16, 8, 0
WARMUP, FPS_CALLS = 3, 100


def clouds(cfg: Config, seed: int) -> np.ndarray:
    """``BATCH`` clouds of ``cfg.num_point`` points in a 10 x 10 x 4 m box, colours in [0, 1)."""
    rng = np.random.RandomState(seed)
    xyz = rng.rand(BATCH, cfg.num_point, 3) * np.array([10.0, 10.0, 4.0])
    return np.concatenate([xyz, rng.rand(BATCH, cfg.num_point, 3)], -1).astype(np.float32)


@contextlib.contextmanager
def mode(name: str):
    """``raw``: every ``pn2`` operator replaced by its CUDA implementation."""
    if name != "raw":
        yield
        return
    library = importlib.import_module("pointnet2_tpu_torch.ops.library")
    saved = {op: getattr(torch.ops.pn2, op) for op in library.CUDA}
    for op, fn in library.CUDA.items():
        setattr(torch.ops.pn2, op, fn)
    try:
        yield
    finally:
        for op, fn in saved.items():
            setattr(torch.ops.pn2, op, fn)


def request(predictor: Predictor, x: np.ndarray, xyz4: torch.Tensor, npoint: int) -> tuple[float, float, float]:
    """Host and event ms of one request; host µs an FPS call after it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    predictor.predict_step(x)
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(FPS_CALLS):
        ops.fps_centroids(xyz4, npoint)
    fps_us = (time.perf_counter() - t0) * 1e6 / FPS_CALLS
    torch.cuda.synchronize()
    return host, start.elapsed_time(end), fps_us


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tag = argv[0] if argv else "tree"
    requests = int(argv[1]) if len(argv) > 1 else 30
    if not torch.cuda.is_available():
        raise RuntimeError("dispatch_probe times requests on a card, and there is none")
    full_float32()
    cfg = Config.from_json(pathlib.Path.cwd() / "semantic.json")
    state = convert.from_flax_variables(convert.init_variables(cfg, num_classes=9, seed=SEED, bn_stats="random"))
    predictor = Predictor(cfg, state, num_classes=9, infer_chunk=CHUNK, device="cuda")
    inputs = [clouds(cfg, SEED + 1 + i) for i in range(requests)]
    xyz4 = torch.from_numpy(np.ascontiguousarray(inputs[0][:CHUNK, : cfg.l3_npoint, :3])).cuda()
    try:
        importlib.import_module("pointnet2_tpu_torch.ops.library")
        modes = ("pn2", "raw")
    except ImportError:
        modes = ("as_is",)
    for name in modes:
        with mode(name):
            for x in inputs[:WARMUP]:
                request(predictor, x, xyz4, cfg.l4_npoint)
    samples = {name: {"host_ms": [], "event_ms": [], "fps_centroids_host_us": []} for name in modes}
    for i, x in enumerate(inputs):
        for name in modes if i % 2 == 0 else modes[::-1]:
            with mode(name):
                for key, value in zip(samples[name], request(predictor, x, xyz4, cfg.l4_npoint)):
                    samples[name][key].append(value)
    out = {"tag": tag, "requests": requests, "card": card_line(), "modes": {
        name: {**{f"{key}_median": statistics.median(v) for key, v in got.items()}, **got}
        for name, got in samples.items()
    }}
    if len(modes) == 2:
        pn2, raw = samples["pn2"], samples["raw"]
        for key in pn2:
            out[f"pn2_minus_raw_{key}_median"] = statistics.median(a - b for a, b in zip(pn2[key], raw[key]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
