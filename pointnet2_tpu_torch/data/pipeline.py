"""Host batch producer, and the copy of each batch to the card ahead of its step.

Counterpart of ``pointnet2_tpu/data/pipeline.py``, rewritten for PyTorch (that
module imports JAX):

- ``BatchProducer``: worker threads run ``sample_fn()`` into a bounded queue;
  a worker's exception is raised again in the consumer; ``stop()`` ends and
  joins the workers. The samplers are NumPy work on many small arrays, and
  what of it holds the GIL is taken from the thread that dispatches the
  step's kernels one by one (PERF.md §5);
- ``device_prefetch``: keeps ``depth`` batches copied to the device ahead of
  the one the caller is using. On CUDA each batch goes through a ring of
  pinned host buffers and a ``non_blocking`` copy on a side stream; the
  consumer's stream waits for the copies before it is handed a batch, and
  each yielded tensor is recorded on that stream, so the caching allocator
  does not hand its memory to another copy while the consumer's work on it
  is queued. A pinned buffer is filled again only after the event of its
  last copy has completed. On the CPU the batches are plain copies, and
  nothing is pinned (pinning needs CUDA).
"""

from __future__ import annotations

import itertools
import queue
import threading
import traceback
from typing import Callable, Iterable, Iterator, Mapping

import torch


class _ProducerError:
    """Sentinel carrying a worker's traceback to the consumer."""

    def __init__(self, tb: str):
        self.tb = tb


class BatchProducer:
    """Background producer running ``sample_fn()`` into a bounded queue.

    With one worker the batches arrive in the order of the calls, so a seeded
    sampler gives the same stream as calling it directly (``data/rng.py``).
    """

    def __init__(self, sample_fn: Callable[[], object], max_queue: int = 8, num_workers: int = 4):
        self._sample_fn = sample_fn
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._fill, daemon=True) for _ in range(num_workers)]
        for t in self._threads:
            t.start()

    def _put(self, item) -> None:
        """Queue ``item``; give up once stopped (a full queue is not read any more)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.25)
                return
            except queue.Full:
                continue

    def _fill(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._sample_fn()
            except Exception:  # the consumer raises it again in get()
                self._put(_ProducerError(traceback.format_exc()))
                return
            self._put(batch)

    def get(self):
        item = self._queue.get()
        if isinstance(item, _ProducerError):
            raise RuntimeError(f"batch producer failed:\n{item.tb}")
        return item

    def __iter__(self) -> Iterator:
        """Endless iterator view (for ``device_prefetch``)."""
        while True:
            yield self.get()

    def stop(self) -> None:
        """End the workers and join them; what they had queued is dropped."""
        self._stop.set()
        for t in self._threads:
            t.join()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


def device_prefetch(
    batches: Iterable[Mapping], device: str | torch.device, depth: int = 2
) -> Iterator[dict[str, torch.Tensor]]:
    """Dicts of tensors on ``device``, each copied ``depth`` batches ahead of its use.

    ``batches`` yields mappings of NumPy arrays (or CPU tensors); the keys and
    dtypes are kept. The iterator ends when ``batches`` does.
    """
    device = torch.device(device)
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if device.type == "cuda":
        return _cuda_prefetch(iter(batches), device, depth)
    return _ahead(
        iter(batches), depth, lambda batch: {k: torch.as_tensor(v).to(device, copy=True) for k, v in batch.items()}
    )


def _ahead(it: Iterator, depth: int, put: Callable, before_yield: Callable = lambda out: None) -> Iterator:
    """``put`` each item of ``it``, ``depth`` items ahead of the one yielded."""
    pending = []
    for batch in it:
        pending.append(put(batch))
        if len(pending) == depth:
            break
    while pending:
        out = pending.pop(0)
        before_yield(out)
        batch = next(it, None)
        if batch is not None:
            pending.append(put(batch))
        yield out


def _cuda_prefetch(it: Iterator, device: torch.device, depth: int) -> Iterator[dict[str, torch.Tensor]]:
    copy_stream = torch.cuda.Stream(device)
    # depth + 1 pinned buffers: the yielded batch's, the depth - 1 copies in
    # flight behind it, and the one being filled.
    slots: list = [None] * (depth + 1)  # name -> pinned tensor
    copied: list = [None] * (depth + 1)  # the event of each buffer's last copy
    turns = itertools.cycle(range(depth + 1))

    def put(batch: Mapping) -> dict[str, torch.Tensor]:
        s = next(turns)
        if copied[s] is not None:
            copied[s].synchronize()  # the last copy out of this buffer has read it
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        pinned = slots[s]
        if pinned is None or any(
            k not in pinned or pinned[k].shape != t.shape or pinned[k].dtype != t.dtype for k, t in host.items()
        ):
            pinned = slots[s] = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for k, t in host.items()}
        out = {}
        with torch.cuda.stream(copy_stream):
            for k, t in host.items():
                pinned[k].copy_(t)
                out[k] = pinned[k].to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        copied[s] = event
        return out

    def before_yield(out: dict[str, torch.Tensor]) -> None:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_stream(copy_stream)  # every copy queued so far, this batch's among them
        for t in out.values():
            t.record_stream(consumer)

    return _ahead(it, depth, put, before_yield)
