"""Batches: per-host index sharding, multi-dataset mixing, and the device
stage that turns clip plans into pixels (counterpart of
``empirical_mvm_tpu/data/loader.py``; ref: dataset.py:220-250, 480-547,
swinbert/data_sampler.py).

* :class:`ShardedBatchLoader`: deterministic per-host, per-epoch shuffling
  and fixed-size batches (drop-last at train); items built on a thread
  pool (reading, base64 and the transform plan, all on the host) and a
  bounded queue ahead of the consumer.
* :class:`MetaLoader`: the weighted multi-dataset schedule, the JAX
  package's: every host derives the same dataset choice from (seed, step).
* :func:`materialize`: decodes a host batch's frames (nvJPEG on a CUDA
  device, the caller's decode function on the CPU), runs the clip plans
  there (``data/transforms.py`` ``run_plans``) and moves the other arrays
  to the device. A clip any of whose frames fails is zeroed and its item
  marked ``corrupt`` (with a pretrain item's ``on_corrupt`` text and vq),
  never raised.
* :class:`DevicePrefetcher`: :func:`materialize` in a producer thread on a
  side CUDA stream; the consumer's stream waits on an event, and the
  tensors it gets are recorded on its stream. At most ``depth`` batches are
  on the device at once.
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction
from typing import Any, Callable, Iterator

import numpy as np
import torch

from empirical_mvm_torch.data.composite import shard_affinity_indices
from empirical_mvm_torch.data.jpeg import frame_decoder
from empirical_mvm_torch.data.transforms import ClipPlan, run_plans


def _collate(items: list[dict[str, Any]]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) \
                or isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals  # clip plans, on_corrupt rows
    return out


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put unless the consumer has stopped; False if it has."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _consume(q: queue.Queue, stop: threading.Event, done, err: list) -> Iterator:
    """Yield the queue's items until ``done`` or ``stop``; re-raise a
    producer's error; on exit (also when the consumer stops early) tell the
    producer."""
    try:
        while True:
            try:
                item = q.get(timeout=0.1)
            except queue.Empty:
                if stop.is_set():
                    return
                continue
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class ShardedBatchLoader:
    """Deterministic sharded loader (ref: get_dl at dataset.py:220-228 +
    DistributedSampler semantics). Batches are host dicts: numpy arrays,
    and lists of clip plans under ``img``."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 seed: int = 88, num_hosts: int = 1, host_index: int = 0,
                 drop_last: bool | None = None, num_threads: int = 8,
                 prefetch: int = 2, limit_samples: int = -1,
                 source_idx: list[int] | None = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_index = host_index
        self.drop_last = shuffle if drop_last is None else drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        # per-host sample cap (ref: swinbert/data_sampler.py:13-95)
        self.limit_samples = limit_samples
        # per-item source-shard ids: whole shards get host affinity
        # (ref: swinbert/data_sampler.py:98-193 NodeSplitSampler)
        self.source_idx = source_idx
        self.epoch = 0
        self._producers: list[tuple[threading.Event, threading.Thread]] = []

    def close(self) -> None:
        """Stop every iteration's producer and wait for it to end (at most
        the batch it is building); those iterations end. No thread of this
        loader then outlives the call, so a process may exit right after."""
        producers, self._producers = self._producers, []
        for stop, _ in producers:
            stop.set()
        for _, thread in producers:
            thread.join()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if self.source_idx is not None:
            mine = shard_affinity_indices(self.source_idx, self.num_hosts, self.host_index,
                                          seed=self.seed + self.epoch, shuffle=self.shuffle)
            if self.limit_samples > 0:
                mine = mine[:self.limit_samples]
            return np.asarray(mine)
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            rs.shuffle(idx)
        # per-host contiguous shard, padded like DistributedSampler
        per_host = int(np.ceil(n / self.num_hosts))
        pad = per_host * self.num_hosts - n
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        mine = idx[self.host_index::self.num_hosts]
        if self.limit_samples > 0:
            mine = mine[:self.limit_samples]
        return mine

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def __iter__(self) -> Iterator[dict[str, Any]]:
        idx = self._indices()
        nb = len(self)
        done = object()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        err: list[BaseException] = []

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in range(nb):
                        chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
                        items = list(pool.map(self.ds.__getitem__, chunk))
                        if not _put(q, _collate(items), stop):
                            return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                err.append(e)
            finally:
                _put(q, done, stop)         # never leave the consumer blocked

        thread = threading.Thread(target=produce, daemon=True)
        self._producers.append((stop, thread))
        thread.start()
        yield from _consume(q, stop, done, err)


class MetaLoader:
    """Weighted multi-dataset mixing with a deterministic schedule
    (ref: dataset.py:511-547; weights = iters ratio per
    main_pretrain_yaml.py:256-259). Every host derives the same choice from
    (seed, step), so no collective picks it."""

    def __init__(self, loaders: dict[str, tuple[ShardedBatchLoader, float]],
                 seed: int = 88, accum_steps: int = 1):
        self.loaders = {n: ld for n, (ld, _) in loaders.items()}
        # rational ratios are scaled so every dataset gets a non-zero
        # integer slot count
        ratios = {n: float(r) for n, (_, r) in loaders.items()}
        bad = [n for n, r in ratios.items() if r <= 0]
        if bad:
            raise ValueError(f"MetaLoader ratios must be > 0: {bad}")
        fr = {n: Fraction(r).limit_denominator(1000) for n, r in ratios.items()}
        lcm = math.lcm(*(f.denominator for f in fr.values()))
        counts = {n: max(1, int(f * lcm)) for n, f in fr.items()}
        g = math.gcd(*counts.values())
        self.pool: list[str] = []
        for name, c in counts.items():
            self.pool.extend([name] * (c // g))
        self.seed = seed
        self.accum_steps = accum_steps
        self.step = 0
        self.closed = False
        self._iters = {n: iter(ld) for n, ld in self.loaders.items()}

    def _choice(self, step: int) -> str:
        rs = np.random.RandomState((self.seed * 1_000_003 + step) % (2 ** 31))
        return self.pool[rs.randint(len(self.pool))]

    def __iter__(self):
        task = self.pool[0]
        while not self.closed:
            if self.step % self.accum_steps == 0:
                task = self._choice(self.step // self.accum_steps)
            self.step += 1
            try:
                batch = next(self._iters[task])
            except StopIteration:
                if self.closed:
                    return
                self.loaders[task].set_epoch(self.loaders[task].epoch + 1)
                self._iters[task] = iter(self.loaders[task])
                batch = next(self._iters[task])
            yield task, batch

    def close(self) -> None:
        """Stop every loader's producer; the schedule ends."""
        self.closed = True
        for ld in self.loaders.values():
            ld.close()


def _to_device(v, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(v))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def materialize(batch: dict[str, Any], decoder, device) -> dict[str, Any]:
    """A host batch -> tensors on ``device``: the clip plans under ``img``
    decoded by ``decoder`` (``data/jpeg.py``) and run (uint8 (B, T, H, W, 3)
    clips, float32 where the plans normalize; (B, n, T, H, W, 3) for
    multi-clip items), every numeric array as a tensor, ``corrupt`` (B,)
    set where a clip failed, and a failed pretrain item's ``on_corrupt``
    text and vq put in place."""
    device = torch.device(device)
    plans = batch["img"]
    multi = isinstance(plans[0], tuple)
    clips: list[ClipPlan] = [c for p in plans for c in p] if multi else list(plans)
    owner = [i for i, p in enumerate(plans) for _ in (p if multi else (p,))]
    frames = [f for c in clips for f in c.frames]
    sizes = [op.src for c in clips for op in c.ops]
    decoded = decoder.decode(frames, sizes)
    failed = np.zeros(len(plans), bool)
    per_clip, k = [], 0
    for c, i in zip(clips, owner):
        fr = decoded[k:k + len(c.ops)]
        k += len(c.ops)
        failed[i] |= any(f is None for f in fr)
        per_clip.append(fr)
    if failed.any():
        per_clip = [[] if failed[i] else fr for fr, i in zip(per_clip, owner)]
        clips = [c.failed() if failed[i] else c for c, i in zip(clips, owner)]
    img = run_plans(clips, [[f.to(device) for f in fr] for fr in per_clip], device)
    if multi:
        img = img.reshape(len(plans), -1, *img.shape[1:])
    out: dict[str, Any] = {"img": img}
    corrupt = np.asarray(batch.get("corrupt", np.zeros(len(plans), bool))) | failed
    fills = batch.get("on_corrupt")
    for k2, v in batch.items():
        if k2 in ("img", "on_corrupt", "corrupt"):
            continue
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            if fills is not None and k2 in fills[0] and failed.any():
                v = v.copy()
                for i in np.flatnonzero(failed):
                    v[i] = fills[i][k2]
            out[k2] = _to_device(v, device)
        else:
            out[k2] = v
    out["corrupt"] = _to_device(corrupt, device)
    return out


class DevicePrefetcher:
    """Batches from ``source`` (items ``(tag, host_batch)`` or host batches)
    materialized on ``device`` ahead of the consumer: on a CUDA device in a
    producer thread on a side stream (frames through nvJPEG), on the CPU
    with the caller's ``decode`` function (required there). Yields
    ``(tag, batch)``; at most ``depth`` batches are on the device at once
    (the one being built, those queued, the one the consumer holds).
    Closing the iterator waits for the producer thread to end."""

    def __init__(self, source, device="cuda", decode: Callable | None = None,
                 depth: int = 2):
        self.source = source
        self.device = torch.device(device)
        self.decoder = frame_decoder(self.device, decode)
        if depth < 1:
            raise ValueError("depth must be at least 1")
        self.depth = depth

    def __iter__(self):
        done = object()
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        slots = threading.Semaphore(self.depth)
        err: list[BaseException] = []
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def produce():
            try:
                for item in self.source:
                    tag, batch = item if isinstance(item, tuple) else (None, item)
                    while not slots.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                    if cuda:
                        with torch.cuda.device(self.device), torch.cuda.stream(side):
                            out = materialize(batch, self.decoder, self.device)
                            ready = torch.cuda.Event()
                            ready.record(side)
                    else:
                        out, ready = materialize(batch, self.decoder, self.device), None
                    if not _put(q, (tag, out, ready), stop):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                err.append(e)
            finally:
                _put(q, done, stop)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            for tag, out, ready in _consume(q, stop, done, err):
                if ready is not None:
                    main = torch.cuda.current_stream(self.device)
                    main.wait_event(ready)
                    for v in out.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(main)
                yield tag, out
                del out
                slots.release()         # the consumer has let go of its last batch
        finally:
            stop.set()
            producer.join()
