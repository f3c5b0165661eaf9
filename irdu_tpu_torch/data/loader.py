"""Batched loading and device prefetch (counterpart:
``irdu_tpu/data/loader.py``).

``batched_loader`` assembles (noisy, clean) numpy batches one batch ahead
of the consumer, with one of two backends:

  * "native": the C++ batch assembler (``data/native``): crop, pad,
    augment, normalize and noise in C++ threads, bitwise the python
    backend's batches (numpy's RNG reproduced); it raises when the library
    cannot be built or loaded or the dataset is not ``native_compatible``;
  * "python": a thread pool over ``dataset[i]`` (numpy releases the GIL for
    the heavy parts).

"auto" takes JAX's choice: native when the dataset's ``native_compatible()``
holds, else the thread pool. Unlike JAX's "auto", a native batch that fails
raises instead of being assembled again in Python.

Under data parallelism (``shard``) each rank assembles only its contiguous
slice of every global batch: an item is a pure function of (dataset seed,
index), so the slices of all ranks stacked are the one-device batch, on
either backend.

``device_prefetch`` turns the numpy batches into tensors on the device,
``size`` batches in flight: on a CUDA device each batch goes through pinned
host memory and is copied with ``non_blocking=True``, so the copy overlaps
the step; on the CPU the tensors share the numpy arrays' memory.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch


def batched_loader(
    dataset,
    batch_size: int,
    *,
    num_workers: int = 4,
    drop_last: bool = True,
    indices: Iterable[int] | None = None,
    backend: str = "auto",
    skip_batches: int = 0,
    shard: tuple[int, int] | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (noisy, clean) batches stacked on axis 0, in index order.

    skip_batches: fast-forward the index stream by that many (global)
    batches without making them (a mid-stage resume). An item is a pure
    function of (dataset seed, index), so the stream after the skip is the
    one a replay gives. shard (index, count): yield only slice ``index`` of
    ``count`` equal contiguous slices of each ``batch_size`` batch, which
    must divide by ``count``.
    """
    index, count = shard or (0, 1)
    if batch_size % count:
        raise ValueError(f"global batch {batch_size} does not divide by {count} ranks")
    per_rank = batch_size // count
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown loader backend: {backend}")
    compatible = getattr(dataset, "native_compatible", lambda: False)
    use_native = backend == "native" or (backend == "auto" and compatible())
    if backend == "native" and not compatible():
        from irdu_tpu_torch.data import native

        why = "" if native.available() else f" (the native library: {native.load_error()})"
        raise RuntimeError(f"backend='native': {type(dataset).__name__} is not "
                           f"native_compatible(){why}")
    idx_iter = iter(indices) if indices is not None else iter(range(len(dataset)))
    if skip_batches:
        next(itertools.islice(idx_iter, skip_batches * batch_size,
                              skip_batches * batch_size), None)

    item_pool = None if use_native else ThreadPoolExecutor(max_workers=num_workers)

    def fetch(batch_idx):
        if use_native:
            return dataset.get_batch(batch_idx, num_threads=num_workers)
        items = list(item_pool.map(dataset.__getitem__, batch_idx))
        return np.stack([it[0] for it in items]), np.stack([it[1] for it in items])

    def batches():
        while True:
            batch_idx = list(itertools.islice(idx_iter, batch_size))
            if not batch_idx or (drop_last and len(batch_idx) < batch_size):
                return
            yield batch_idx[index * per_rank:(index + 1) * per_rank]

    try:
        with ThreadPoolExecutor(max_workers=1) as prefetcher:
            pending = collections.deque()
            for batch_idx in batches():
                pending.append(prefetcher.submit(fetch, batch_idx))
                if len(pending) >= 2:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
    finally:
        if item_pool is not None:
            item_pool.shutdown(wait=False)


def device_prefetch(iterator: Iterator, device: str | torch.device = "cuda", *,
                    size: int = 2) -> Iterator:
    """Each batch (a tuple of numpy arrays) as tensors on ``device``, with
    ``size`` batches in flight. CUDA: pinned host copies, copied to the card
    with ``non_blocking=True`` on the current stream (the step that reads
    them runs after the copy on the same stream). CPU: ``torch.from_numpy``,
    no copy."""
    device = torch.device(device)
    queue = collections.deque()

    def put(batch):
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        if device.type == "cpu":
            return tensors
        return tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
