"""The port's host pipeline against the JAX package's, on the CPU.

``BatchProducer`` with one worker yields the batches of the direct calls, in
order, as the JAX producer does; a worker's exception reaches the consumer;
``stop()`` joins the workers. ``device_prefetch`` on the CPU yields the
values of the host batches (as the JAX ``device_prefetch`` does), in their
dtypes, read ``depth`` batches ahead, and pins nothing. ``Trainer._to_device``
hands a tensor that is already in place back as the same object.

Tolerance: none; every value is compared bit for bit. The CUDA side of
``device_prefetch`` (pinned buffers, the copy stream) is held against the
host batches on the card in ``tests/test_torch_cuda.py``.
"""

import itertools
import sys
import threading

import numpy as np
import pytest
import torch

from pointnet2_tpu.data import pipeline as jax_pipeline
from pointnet2_tpu.data import semantic3d as jax_s3d
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data import pipeline, semantic3d
from pointnet2_tpu_torch.data.io import write_labels, write_pcd
from pointnet2_tpu_torch.train import Trainer

JOIN_S = 30

# As tests/test_torch_model.py does for every worker of a whole run: the CLIs'
# plain operators are many small parallel regions, and PyTorch's default of a
# thread a core in each of several workers made one train CLI run 60 times
# slower (5 s alone, 320 s in 4 workers).
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("pipeline")
    rng = np.random.RandomState(0)
    for prefix in semantic3d.train_file_prefixes:
        pts = rng.rand(2000, 3) * [20.0, 20.0, 4.0]
        write_pcd(data_dir / f"{prefix}.pcd", pts, rng.rand(2000, 3))
        write_labels(data_dir / f"{prefix}.labels", np.where(pts[:, 2] < 2.0, 1, 5))
    return str(data_dir)


def _dataset(module, path, seed=5):
    return module.SemanticDataset(num_points_per_sample=256, split="train", use_color=True,
                                  box_size_x=10.0, box_size_y=10.0, path=path, seed=seed)


def _take(producer, n):
    try:
        return [producer.get() for _ in range(n)]
    finally:
        producer.stop()


def _joined(producer) -> bool:
    return not any(t.is_alive() for t in producer._threads)


def test_one_worker_yields_the_direct_calls_in_order(scenes):
    """The worker thread is the first to draw, so it gets the seed's first
    stream, as the caller's thread does on a fresh dataset."""
    port_ds, jax_ds = _dataset(semantic3d, scenes), _dataset(jax_s3d, scenes)
    port = pipeline.BatchProducer(lambda: port_ds.sample_batch_in_all_files(2, True), max_queue=2, num_workers=1)
    ref = jax_pipeline.BatchProducer(lambda: jax_ds.sample_batch_in_all_files(2, True), max_queue=2, num_workers=1)
    got, want = _take(port, 5), _take(ref, 5)
    direct_ds = _dataset(semantic3d, scenes)
    direct = [direct_ds.sample_batch_in_all_files(2, True) for _ in range(5)]
    for g, w, d in zip(got, want, direct, strict=True):
        assert all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(g, w, d, strict=True))
    assert _joined(port)


def test_a_worker_exception_is_raised_in_the_consumer():
    calls = itertools.count()

    def sample():
        i = next(calls)
        if i == 2:
            raise ValueError("boom in the sampler")
        return i

    producer = pipeline.BatchProducer(sample, max_queue=4, num_workers=1)
    try:
        assert [producer.get(), producer.get()] == [0, 1]
        with pytest.raises(RuntimeError, match="batch producer failed") as err:
            producer.get()
        assert "boom in the sampler" in str(err.value)
    finally:
        producer.stop()
    assert _joined(producer)


def test_stop_joins_workers_blocked_on_a_full_queue():
    producer = pipeline.BatchProducer(lambda: np.zeros(4), max_queue=1, num_workers=3)
    done = threading.Event()
    stopper = threading.Thread(target=lambda: (producer.stop(), done.set()))
    stopper.start()
    stopper.join(timeout=JOIN_S)
    assert done.is_set() and _joined(producer)


def test_many_workers_lose_and_repeat_no_batch():
    """Stress: more workers than cores and a short switch interval. Each
    worker numbers its own batches; the consumer must see every worker's
    numbers in order, with no gap and no repeat."""
    local = threading.local()

    def sample():
        local.n = getattr(local, "n", -1) + 1
        return threading.get_ident(), local.n

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        producer = pipeline.BatchProducer(sample, max_queue=4, num_workers=32)
        items = _take(producer, 3000)
    finally:
        sys.setswitchinterval(old)
    assert _joined(producer)
    seen: dict = {}
    for ident, n in items:
        assert n == seen.get(ident, -1) + 1
        seen[ident] = n


def _host_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield {
            "points": rng.rand(2, 64, 6).astype(np.float32),
            "labels": rng.randint(0, 9, (2, 64)).astype(np.int32),
            "weights": rng.rand(2, 64).astype(np.float32),
        }


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_on_the_cpu_yields_the_host_values(depth):
    host = list(_host_batches(5))
    got = list(pipeline.device_prefetch(iter(host), "cpu", depth=depth))
    want = list(jax_pipeline.device_prefetch(iter(host), depth=depth))
    assert len(got) == len(want) == 5
    for g, w, h in zip(got, want, host, strict=True):
        assert set(g) == set(h)
        for k in h:
            assert g[k].device.type == "cpu" and g[k].dtype == torch.from_numpy(h[k]).dtype
            assert np.array_equal(g[k].numpy(), h[k]) and np.array_equal(g[k].numpy(), np.asarray(w[k]))
    host[0]["points"][:] = -1.0  # a copy, not a view of the host batch
    assert (got[0]["points"] >= 0).all()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_reads_depth_batches_ahead(depth):
    """When a batch is handed over, the next ``depth`` are already copied, as in the JAX version."""
    pulled = {"port": [], "jax": []}

    def source(side):
        for i, batch in enumerate(_host_batches(6)):
            pulled[side].append(i)
            yield batch

    port = pipeline.device_prefetch(source("port"), "cpu", depth=depth)
    ref = jax_pipeline.device_prefetch(source("jax"), depth=depth)
    next(port), next(ref)
    assert len(pulled["port"]) == len(pulled["jax"]) == 1 + depth
    assert len(list(port)) == 5


def test_device_prefetch_on_the_cpu_pins_nothing_and_takes_no_stream(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path touched CUDA")

    empty = torch.empty

    def unpinned_empty(*args, **kwargs):
        if kwargs.get("pin_memory"):
            refuse()
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Stream", refuse)
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    monkeypatch.setattr(torch, "empty", unpinned_empty)
    assert len(list(pipeline.device_prefetch(_host_batches(3), torch.device("cpu")))) == 3
    with pytest.raises(ValueError, match="depth"):
        pipeline.device_prefetch(_host_batches(1), "cpu", depth=0)


def test_trainer_to_device_returns_tensors_in_place_as_they_are():
    cfg = Config(num_point=64, batch_size=2, l1_npoint=16, l2_npoint=8, l3_npoint=4, l4_npoint=2,
                 l1_nsample=4, l2_nsample=4, l3_nsample=4, l4_nsample=4)
    trainer = Trainer(cfg, device="cpu")
    batch = next(pipeline.device_prefetch(_host_batches(1), "cpu"))
    batch["labels"] = batch["labels"].long()
    points, labels, weights = trainer._to_device(batch)
    assert points is batch["points"] and labels is batch["labels"] and weights is batch["weights"]
    host = next(_host_batches(1))
    points, labels, weights = trainer._to_device(host)  # NumPy and int32 labels are converted
    assert labels.dtype == torch.int64 and np.array_equal(labels.numpy(), host["labels"])
    assert points.dtype == torch.float32 and np.array_equal(points.numpy(), host["points"])
