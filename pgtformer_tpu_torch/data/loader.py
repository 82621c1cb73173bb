"""Concurrent prefetching batch loader for training (the port's copy of the
JAX package's ``data/loader.py``).

The reference trains with 4 DataLoader worker processes + prefetch
(``num_worker_per_gpu: 4``, ``prefetch_mode``); the on-the-fly blind
degradation (``data/degradations.py:blind_degrade_clip``: per-frame cv2 blur
and JPEG round-trips) is far too slow to feed a training step from a
synchronous loop.  This loader overlaps sample loading with device compute:

  * `num_workers` concurrent workers each assemble complete batches
    (worker w handles batch ordinals w, w+W, ... — batch composition is
    identical to the synchronous `clip_batches`, so runs are reproducible);
  * a bounded reorder buffer yields batches strictly in order with up to
    `prefetch` batches resident;
  * thread backend by default (cv2/numpy release the GIL); `backend=
    "process"` (spawn) for hosts where Python-side work dominates.

Two differences from the JAX package's loader:

  * `reseed_dataset` redraws each epoch's degradations under the sample
    seed ``seed0 + 100003 * epoch`` (the value the JAX loader writes into
    ``dataset.seed``), passed to ``dataset.get(index, seed)``: the shared
    dataset is never written, and a fresh run's batches equal the JAX
    package's bit for bit;
  * a loader can start inside an epoch (:meth:`PrefetchLoader.seek`): a
    resumed run sees the batches an uninterrupted run would have seen;
  * under data parallelism (`shard`) each rank's loader assembles only its
    rows of each global batch, in the one shuffled order every rank draws
    (the JAX package assembles the whole batch on its one host, then
    shards it).

:func:`device_prefetch` uploads batches ahead of the step on a transfer
thread; on the card :func:`upload_fn` pins each batch and copies it on a
stream of its own, and the consumer's stream waits for that copy.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _batch_orders(n: int, batch_size: int, shuffle: bool, seed: int,
                  drop_last: bool) -> List[np.ndarray]:
    """Per-batch index lists, identical to data/vfhq.clip_batches."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    batches = [order[i:i + batch_size]
               for i in range(0, n, batch_size)]
    if batches and len(batches[-1]) < batch_size and drop_last:
        batches.pop()
    return batches


def _collate(samples: Sequence[Dict[str, np.ndarray]],
             keys=("gt", "lq", "llq")) -> Dict[str, np.ndarray]:
    out = {k: np.stack([s[k] for s in samples])
           for k in keys if k in samples[0]}
    if "path" in samples[0]:
        out["path"] = [s["path"] for s in samples]
    return out


def _sample(dataset, index: int, seed: Optional[int]):
    return dataset[index] if seed is None else dataset.get(index, seed)


class PrefetchLoader:
    """Iterable over collated batches with worker concurrency + prefetch.

    Each `iter()` pass is one epoch; `epoch` advances the shuffle seed per
    pass (`seed + epoch`), as a torch DistributedSampler's set_epoch.
    Exceptions raised in workers propagate to the consumer.  `load_seconds`
    keeps the assembly time (decode, degradation, collate) of the last 1000
    batches, each on the worker that made it.

    `shard` = (rank, world): `batch_size` is the global batch, and this
    loader yields rank's rows [rank * b, (rank + 1) * b) of each, b =
    batch_size / world; the batch count, the epochs and the positions
    (:meth:`position_at`) are the global batches'.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True, backend: str = "thread",
                 keys=("gt", "lq", "llq"), reseed_dataset: bool = False,
                 shard: Optional[Tuple[int, int]] = None):
        assert backend in ("thread", "process", "sync")
        if shard is not None and (batch_size % shard[1] or not 0 <= shard[0] < shard[1]):
            raise ValueError(f"shard {shard} of a batch of {batch_size}")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.backend = backend
        self.keys = tuple(keys)
        self.epoch = 0
        self.skip = 0        # batches of `epoch` already consumed (a resume)
        self.load_seconds: deque = deque(maxlen=1000)
        # reseed_dataset: fresh per-index randomness (degradation draws,
        # hflip) every pass, as the reference's datasets draw from global
        # numpy state; a deterministic (seed, index) draw would freeze them
        # and make small sets memorizable for the discriminator
        self.reseed_dataset = reseed_dataset and hasattr(dataset, "seed")
        if self.reseed_dataset and not hasattr(dataset, "get"):
            raise TypeError("reseed_dataset needs a dataset with get(index, seed)")
        self._dataset_seed0 = getattr(dataset, "seed", 0)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def position_at(self, step: int) -> Dict[str, int]:
        """Where a run that consumed `step` batches stands: the epoch, the
        batches of it consumed, and the cut of the epochs (batches an epoch,
        batch size) that places `step` there."""
        epoch, consumed = divmod(int(step), len(self))
        return {"epoch": epoch, "consumed": consumed, "batches_per_epoch": len(self),
                "batch_size": self.batch_size}

    def seek(self, position: Dict[str, int]) -> None:
        """Start the next pass at a saved `position` (:meth:`position_at`):
        inside its epoch, past the batches already consumed.  A position cut
        otherwise (another batch size or dataset) is refused: it would
        replay or skip batches."""
        step = int(position["epoch"]) * len(self) + int(position["consumed"])
        if dict(position) != self.position_at(step):
            raise ValueError(
                f"loader position {dict(position)} was saved by a loader cut otherwise "
                f"than this one ({len(self)} batches of {self.batch_size} an epoch): "
                "resume with the saved run's dataset and batch size")
        self.epoch, self.skip = int(position["epoch"]), int(position["consumed"])

    def sample_seed(self, epoch: int) -> Optional[int]:
        """The sample seed of `epoch`'s draws (None: the dataset's own)."""
        return self._dataset_seed0 + 100003 * epoch if self.reseed_dataset else None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = _batch_orders(len(self.dataset), self.batch_size,
                                self.shuffle, self.seed + self.epoch,
                                self.drop_last)[self.skip:]
        if self.shard is not None:
            rank, world = self.shard
            per = self.batch_size // world
            batches = [b[rank * per:(rank + 1) * per] for b in batches]
        seed = self.sample_seed(self.epoch)
        self.epoch += 1
        self.skip = 0
        if not batches:
            return iter(())
        if self.backend == "sync":
            return self._iter_sync(batches, seed)
        if self.backend == "process":
            return self._iter_process(batches, seed)
        return self._iter_thread(batches, seed)

    def _load(self, idxs: np.ndarray, seed: Optional[int]) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        out = _collate([_sample(self.dataset, int(i), seed) for i in idxs], self.keys)
        self.load_seconds.append(time.perf_counter() - t0)
        return out

    def _iter_sync(self, batches, seed):
        for idxs in batches:
            yield self._load(idxs, seed)

    def _iter_thread(self, batches, seed):
        W = min(self.num_workers, len(batches))
        done: Dict[int, object] = {}
        cv = threading.Condition()
        # cap resident completed batches: worker w blocks until the
        # consumer is within `prefetch` of its next ordinal
        yielded = [0]
        stop = threading.Event()

        def worker(w: int):
            try:
                for ordinal in range(w, len(batches), W):
                    with cv:
                        while (ordinal - yielded[0] >= self.prefetch + W
                               and not stop.is_set()):
                            cv.wait(timeout=0.5)
                    if stop.is_set():
                        return
                    batch = self._load(batches[ordinal], seed)
                    with cv:
                        done[ordinal] = batch
                        cv.notify_all()
            except BaseException as e:  # surfaced to the consumer
                with cv:
                    done[-1 - w] = e
                    cv.notify_all()

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(W)]
        for t in threads:
            t.start()
        try:
            for ordinal in range(len(batches)):
                with cv:
                    while ordinal not in done:
                        errs = [k for k in done if k < 0]
                        if errs:
                            raise done[errs[0]]
                        cv.wait(timeout=0.5)
                    batch = done.pop(ordinal)
                    yielded[0] = ordinal + 1
                    cv.notify_all()
                yield batch
        finally:
            stop.set()
            with cv:
                cv.notify_all()
            for t in threads:
                t.join(timeout=5.0)

    def _iter_process(self, batches, seed):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        with ctx.Pool(min(self.num_workers, len(batches)),
                      initializer=_proc_init,
                      initargs=(self.dataset, self.keys)) as pool:
            for batch, dt in pool.imap(_proc_load, [(b.tolist(), seed) for b in batches],
                                       chunksize=1):
                self.load_seconds.append(dt)
                yield batch


_PROC_STATE: dict = {}


def _proc_init(dataset, keys):
    _PROC_STATE["dataset"] = dataset
    _PROC_STATE["keys"] = keys


def _proc_load(job):
    idxs, seed = job
    t0 = time.perf_counter()
    ds = _PROC_STATE["dataset"]
    out = _collate([_sample(ds, int(i), seed) for i in idxs], _PROC_STATE["keys"])
    return out, time.perf_counter() - t0


def _tree_map(fn: Callable, batch):
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


class _InFlight:
    """A batch whose copy to the card was issued on the transfer stream;
    :meth:`ready` makes the consumer's stream wait for it."""

    def __init__(self, value, tensors: List[torch.Tensor], event):
        self.value, self.tensors, self.event = value, tensors, event

    def ready(self):
        stream = torch.cuda.current_stream(self.tensors[0].device)
        stream.wait_event(self.event)
        for t in self.tensors:
            # the caching allocator must not hand this memory to the
            # transfer stream again before the consumer's work on it is done
            t.record_stream(stream)
        return self.value


def upload_fn(device, stream: bool = True) -> Callable[[Any], Any]:
    """`put` for :func:`device_prefetch`: a host batch (an array or a dict of
    arrays) -> torch tensors on `device`.  On the card (with `stream`) it
    runs on the transfer thread: each array is copied into pinned memory,
    then to the card with ``non_blocking=True`` on a CUDA stream of its own,
    and an event marks the copy's end; the consumer's stream waits on that
    event before the step reads the batch.  Without `stream` it copies on
    the caller's stream."""
    device = torch.device(device)
    if device.type != "cuda" or not stream:
        return lambda b: _tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                                   .to(device), b)
    stream = torch.cuda.Stream(device=device)

    def put(batch):
        tensors: List[torch.Tensor] = []

        def up(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            t = t.to(device, non_blocking=True)
            tensors.append(t)
            return t

        with torch.cuda.stream(stream):
            value = _tree_map(up, batch)
            event = torch.cuda.Event()
            event.record(stream)
        return _InFlight(value, tensors, event)

    return put


def device_prefetch(iterator, put, depth: int = 2):
    """Run `put(batch)` one-or-more batches AHEAD of the consumer, on a
    dedicated thread, so the upload of batch k+1 overlaps the step on
    batch k.  `depth` uploaded batches are kept in flight.  Exceptions
    (from the loader or the transfer) propagate to the consumer.  A batch
    that `put` returns in flight on another CUDA stream (:func:`upload_fn`)
    is handed on only after the consumer's current stream waits for it.
    Closing the generator stops the thread and closes `iterator`."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        it = iter(iterator)
        try:
            for b in it:
                if not offer(put(b)):
                    break
        except BaseException as e:
            err.append(e)
        finally:
            if hasattr(it, "close"):
                it.close()
            offer(sentinel)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item.ready() if isinstance(item, _InFlight) else item
    finally:
        stop.set()
        t.join(timeout=10.0)
