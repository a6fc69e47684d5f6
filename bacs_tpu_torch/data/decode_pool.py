"""Multi-process host decode pool (``training.num_workers``).

Port of ``bacs_tpu/data/decode_pool.py``: N worker processes decode index
batches ahead of the consumer, the counterpart of the reference's
DataLoader ``num_workers`` (reference: dataloaders/base_datamodule.py:45-54,
341-377).  The DataModule's one prefetch thread reads the pool's stream and
pins each batch for the copy to the card (``data/datamodule.py``); the
pool adds processes, not a second thread (the JAX package measured a
second decode thread slower, ``bacs_tpu/data/datamodule.py:309-313``).

- **spawn, not fork**: the parent holds a CUDA context and threads by the
  time streaming starts, and neither survives a fork.  Workers are spawned
  once per DataModule and reused across epochs and tasks.
- **no CUDA in the children**: a child unpickles its source, which imports
  ``bacs_tpu_torch.data.datasets`` and with it torch (a few seconds a
  child), and decodes with the native decoder (each call on every
  hardware thread, as JAX's workers do), or numpy and PIL.
  ``CUDA_VISIBLE_DEVICES`` is emptied in the child before anything could
  touch the card.
- **order-preserving window**: batches are submitted ``workers + 2`` ahead
  and yielded strictly in submission order, so the stream is bit-identical
  to serial decoding at any worker count; a worker's exception re-raises
  at the consumer.

Sources must be picklable (``FolderSource``, ``SyntheticSource``,
``DomainShiftedSource`` over one of those).  The caches are served
in-process: a child filling its own copy of a cache would help nobody, and
``DeviceCache`` holds tensors on the card.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Iterable, Iterator, Sequence, Tuple

import numpy as np

# set by _worker_init in each worker process
_SRC = None


def gather_host(source, indices) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one index batch: (images [n, s, s, 3], labels [n, s, s])
    uint8, through the source's ``load_batch`` where it has one that
    answers (a folder source's native decode, a cache's), else one ``load``
    per sample (``bacs_tpu/data/decode_pool.py:41-51``)."""
    batch = getattr(source, "load_batch", None)
    if batch is not None:
        out = batch([int(i) for i in indices])
        if out is not None:
            return out
    imgs, lbls = [], []
    for i in indices:
        img, lbl = source.load(int(i))
        imgs.append(img)
        lbls.append(lbl)
    return np.stack(imgs), np.stack(lbls)


def _worker_init(source) -> None:
    global _SRC
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _SRC = source


def _worker_gather(indices: Sequence[int]):
    return gather_host(_SRC, indices)


class DecodePool:
    """N spawn-context decode workers with an in-order lookahead window."""

    def __init__(self, source, workers: int):
        assert workers >= 1
        import multiprocessing as mp

        self.workers = workers
        if hasattr(source, "load_batch"):
            # build the native decoder here, once, before the workers load it
            from bacs_tpu_torch.data import native_decode

            native_decode.available()
        ctx = mp.get_context("spawn")
        self._pool = ctx.Pool(workers, initializer=_worker_init, initargs=(source,))

    def stream(
        self, index_batches: Iterable[Sequence[int]]
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        window: deque = deque()
        depth = self.workers + 2
        try:
            for idx in index_batches:
                window.append(
                    self._pool.apply_async(_worker_gather, ([int(i) for i in idx],)))
                if len(window) >= depth:
                    yield window.popleft().get()
            while window:
                yield window.popleft().get()
        except GeneratorExit:
            # consumer abandoned the epoch; drop pending results
            window.clear()
            raise

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


def pool_eligible(source) -> bool:
    """Whether ``source`` may ship to the workers: not a cache, nor a
    wrapper (``DomainShiftedSource``'s ``base``) around one."""
    from bacs_tpu_torch.data.datasets import DecodedCache, DeviceCache

    while source is not None:
        if isinstance(source, (DecodedCache, DeviceCache)):
            return False
        source = getattr(source, "base", None)
    return True
