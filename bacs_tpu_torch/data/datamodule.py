"""DataModule: continual-learning train and eval batch streams on the card.

Port of ``bacs_tpu/data/datamodule.py`` (``DataModule``,
``create_datamodule``, ``:84-560``): the task state, the debug (6 samples)
and sweep (10 %) subsets, per-task train streams, and eval streams over one
task's validation images with the labels of tasks 0..t visible, padded to
whole batches with the padding's labels ignored and ``n_real`` given.

- The index order is the JAX package's: the per-epoch permutation of a
  ``RandomState((seed, t, epoch).__hash__() % 2**31)``, the tiling of a
  task smaller than a batch, the subsets' ``RandomState(seed + t)`` and
  ``RandomState(seed + 77 + t)`` draws (``:197-305``).
- The augmentation draws are JAX's (``ops/rng.py``): the epoch's key is
  ``PRNGKey`` of the same numpy draw (``:305``), split once per batch
  (``:319``) and per image by ``transforms.train_transform``; the card,
  the CPU and JAX crop alike from one seed.
- Host decode runs in a prefetch thread (``_prefetch``, two batches ahead)
  into pinned host memory; the consumer thread copies each batch to the
  card without blocking and transforms it there.  With
  ``training.num_workers`` (or ``input_workers``) of 2 or more, the thread
  reads the batches from a pool of decode processes
  (``data/decode_pool.py``; the same stream at any count).  A
  ``DeviceCache`` source skips both: its batches are gathered on the card.
- The domain-incremental mode (Cityscapes cities, or the synthetic
  source's ``n_domains``): tasks are domains, and each task validates on
  its own 20 % of the train source (``:352-357``).

- Data parallelism: the global batch is ``batch_size x n_devices``
  (``:216-294``), and a rank decodes only its contiguous rows of it
  (``rank``), as JAX's process slice; its augmentation draws are the
  global batch's, those rows taken.
- Host decode: a folder source's batches decode through the native
  decoder where it builds (``data/native_decode.py``), else PIL, as JAX's;
  ``decoder`` names the one the train source takes, which the Trainer logs.
  ``dataset.cache_decoded`` keeps the decoded set in RAM, on disk under
  ``<root>/cache`` (``disk``) or on the card (``device``), and
  ``dataset.download`` fetches a missing tree first (``data/download.py``).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from bacs_tpu_torch import parallel
from bacs_tpu_torch.data import download, native_decode, transforms
from bacs_tpu_torch.data.continual import (
    ContinualScenario,
    DomainScenario,
    compute_class_sets,
    shuffle_class_order,
)
from bacs_tpu_torch.data.datasets import (
    DecodedCache,
    DeviceCache,
    DomainShiftedSource,
    SyntheticSource,
    make_ade_source,
    make_cityscapes_source,
    make_voc_source,
)
from bacs_tpu_torch.data.decode_pool import DecodePool, gather_host, pool_eligible
from bacs_tpu_torch.ops import rng


def _prefetch(iterator, depth: int = 2):
    """Run `iterator` in a daemon thread, keeping `depth` items ready.

    Worker exceptions re-raise at the consumer (a failed decode must not
    silently truncate the epoch).  Abandoning the generator early (break /
    exception in the consumer) sets `stop`, so the worker exits instead of
    blocking forever on a full queue holding decoded batches."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _identity_table(num_classes: int) -> np.ndarray:
    return np.concatenate(
        [np.arange(256)[:num_classes], np.full(256 - num_classes, 255)]
    ).astype(np.int32)


class DataModule:
    def __init__(
        self,
        train_source,
        val_source,
        num_classes: int,
        crop_size: int = 512,
        batch_size: int = 8,
        initial_increment: int = 0,
        increment: int = 0,
        mode: str = "overlap",
        shuffle_classes: bool = False,
        seed: int = 42,
        debug: bool = False,
        sweep: bool = False,
        cache_dir: Optional[str] = None,
        domain_ids=None,
        n_domains_per_task: int = 1,
        input_workers: int = 0,
        device: torch.device | str = "cuda",
    ):
        self.train_source = train_source
        self.val_source = val_source
        self.num_classes = num_classes
        self.crop_size = crop_size
        self.batch_size = batch_size
        self.debug = debug
        self.sweep = sweep
        self.seed = seed
        self.task_id = 0
        self.device = torch.device(device)
        # decode processes (reference num_workers, base_datamodule.py:45-54);
        # they engage at 2 or more on a pool-eligible source
        self.input_workers = int(input_workers or 0)
        self._pools: Dict[int, DecodePool] = {}
        # domain-incremental mode (reference: cityscape_datamodule.py:270-295)
        self.domain_shift = domain_ids is not None
        # continual detection (reference: base_datamodule.py:37-40)
        self.continual = (0 < initial_increment < num_classes - 1) or self.domain_shift
        class_order = (
            shuffle_class_order(num_classes, seed) if shuffle_classes else None
        )
        if self.domain_shift:
            scenario = DomainScenario(domain_ids, num_classes, n_domains_per_task, seed=seed)
            self.train_scenario = scenario
            self.val_scenario = scenario
            self.n_tasks = scenario.n_tasks
        elif self.continual:

            def _sets(source, tag):
                cache = (
                    os.path.join(cache_dir, f"class_sets_{tag}.npz")
                    if cache_dir
                    else None
                )
                return compute_class_sets(
                    (lambda i=i: source.load_label(i) for i in range(len(source))),
                    cache,
                )

            self.train_scenario = ContinualScenario(
                _sets(train_source, "train"), initial_increment, increment,
                num_classes, mode=mode, class_order=class_order,
            )
            # eval scenario always uses overlap membership
            # (reference: base_datamodule.py:278-306 "with_prev_tasks")
            self.val_scenario = ContinualScenario(
                _sets(val_source, "val"), initial_increment, increment,
                num_classes, mode="overlap", class_order=class_order,
            )
            self.n_tasks = self.train_scenario.n_tasks
        else:
            self.train_scenario = None
            self.val_scenario = None
            self.n_tasks = 1

    # ------------------------------------------------------------------

    def set_task_id(self, task_id: int):
        self.task_id = task_id

    @property
    def decoder(self) -> str:
        """The train source's host decode: ``native``, ``PIL`` (a folder
        source where the native decoder did not build) or ``generated``."""
        source = self.train_source
        while source is not None and not hasattr(source, "label_paths"):
            source = getattr(source, "source", getattr(source, "base", None))
        if source is None:
            return "generated"
        return "native" if native_decode.available() else "PIL"

    @property
    def class_names(self):
        return getattr(self.train_source, "class_names", None)

    def _subset(self, indices: np.ndarray, rng: np.random.RandomState):
        """debug → 6 random samples; sweep → 10%
        (reference: base_datamodule.py:331-339)."""
        if self.debug:
            take = min(6, len(indices))
            return rng.choice(indices, size=take, replace=False)
        if self.sweep:
            take = max(1, int(0.1 * len(indices)))
            return rng.choice(indices, size=take, replace=False)
        return indices

    def train_indices(self, task_id: Optional[int] = None) -> np.ndarray:
        t = self.task_id if task_id is None else task_id
        if self.continual:
            idx = self.train_scenario.task_indices(t)
        else:
            idx = np.arange(len(self.train_source))
        return self._subset(idx, np.random.RandomState(self.seed + t))

    def steps_per_epoch(self, n_devices: int = 1) -> int:
        """Steps of one epoch at the global batch ``batch_size x n_devices``."""
        global_batch = self.batch_size * n_devices
        return max(1, len(self.train_indices()) // max(global_batch, 1))

    # ------------------------------------------------------------------

    def train_index_batches(self, epoch: int, n_devices: int = 1):
        """(index batches of one epoch at the global batch ``batch_size x
        n_devices``, the augmentation seed, the label table) of the current
        task."""
        t = self.task_id
        indices = self.train_indices(t)
        rng = np.random.RandomState((self.seed, t, epoch).__hash__() % (2**31))
        perm = rng.permutation(indices)
        global_batch = self.batch_size * n_devices
        n_steps = max(1, len(perm) // global_batch) if len(perm) >= global_batch else 1
        if len(perm) < global_batch:  # tile tiny debug sets to a full batch
            perm = np.resize(perm, global_batch)
        table = (self.train_scenario.label_table(t, train=True) if self.continual
                 else _identity_table(self.num_classes))
        seed = int(rng.randint(2**31))
        batches = [perm[s * global_batch:(s + 1) * global_batch] for s in range(n_steps)]
        return batches, seed, table

    def eval_index_batches(self, task_id: int, n_devices: int = 1):
        """(index batches padded to whole global batches of ``batch_size x
        n_devices``, real counts, label table) of task ``task_id``'s
        validation images (in the domain mode, indices of the train
        source)."""
        if self.domain_shift:
            # domain tasks validate on their own held-out 20% of the SAME
            # (merged) source (reference: cityscape_datamodule.py:270-295)
            idx = self.val_scenario.val_indices(task_id)
            table = self.val_scenario.label_table(self.task_id, train=False)
        elif self.continual:
            idx = self.val_scenario.task_indices(task_id)
            table = self.val_scenario.label_table(self.task_id, train=False)
        else:
            idx = np.arange(len(self.val_source))
            table = _identity_table(self.num_classes)
        idx = self._subset(idx, np.random.RandomState(self.seed + 77 + task_id))
        global_batch = self.batch_size * n_devices
        n_steps = math.ceil(len(idx) / global_batch)
        batches, n_reals = [], []
        for s in range(n_steps):
            batch_idx = idx[s * global_batch:(s + 1) * global_batch]
            n_reals.append(len(batch_idx))
            if len(batch_idx) < global_batch:  # pad to a whole batch
                batch_idx = np.resize(batch_idx, global_batch)
            batches.append(batch_idx)
        return batches, n_reals, table

    def _rows(self, n_devices: int, rank: Optional[int]):
        """(lo, hi) of a rank's rows of the global batch; every row for
        ``rank`` None."""
        if rank is None:
            return 0, self.batch_size * n_devices
        return parallel.rank_rows(self.batch_size * n_devices, n_devices, rank)

    def _host_stream(self, source, index_batches):
        """Decoded (images, labels) numpy batches: from the decode pool when
        it is configured and the source may ship to it, else decoded here,
        one sample after another (the same stream either way)."""
        if self.input_workers >= 2 and pool_eligible(source):
            pool = self._pools.get(id(source))
            if pool is None:
                pool = self._pools[id(source)] = DecodePool(source, self.input_workers)
            return pool.stream(index_batches)
        return (gather_host(source, idx) for idx in index_batches)

    def _pinned(self, source, index_batches):
        """The host stream as tensors, pinned when bound for the card."""
        for batch in self._host_stream(source, index_batches):
            out = [torch.from_numpy(x) for x in batch]
            if self.device.type == "cuda":
                out = [x.pin_memory() for x in out]
            yield out

    def close(self):
        """Terminate the decode workers (idempotent)."""
        for pool in self._pools.values():
            pool.close()
        self._pools.clear()

    def _device_stream(self, source, index_batches) -> Iterator:
        """(images, labels) uint8 tensors on the card per index batch."""
        if isinstance(source, DeviceCache):
            for idx in index_batches:
                yield source.load_batch(idx)
            return
        host = _prefetch(self._pinned(source, index_batches))
        for imgs, lbls in host:
            yield (imgs.to(self.device, non_blocking=True),
                   lbls.to(self.device, non_blocking=True))

    def train_batches(self, epoch: int, augment: bool = True, n_devices: int = 1,
                      rank: Optional[int] = None) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of batches for the current task, on the card.  The
        global batch is ``batch_size x n_devices`` (``bacs_tpu/data/
        datamodule.py:216-294``); with ``rank`` only that rank's contiguous
        ``batch_size`` rows are decoded and augmented, the augmentation
        drawn for the whole global batch, so the ranks' rows together are
        the global batch."""
        batches, seed, table = self.train_index_batches(epoch, n_devices)
        lo, hi = self._rows(n_devices, rank)
        table = torch.from_numpy(table).to(self.device)
        # the epoch's key (bacs_tpu/data/datamodule.py:305), split once per batch
        key = rng.key(seed)
        for imgs, lbls in self._device_stream(self.train_source, [b[lo:hi] for b in batches]):
            key, sub = rng.split(key)
            if augment:
                shard = {} if rank is None else {"rows": (lo, len(batches[0]))}
                yield transforms.train_transform(sub, imgs, lbls, table, crop=self.crop_size,
                                                 **shard)
            else:
                yield transforms.eval_transform(imgs, lbls, table, crop=self.crop_size)

    def train_loader(self, epoch: int, augment: bool = True) -> "_Loader":
        """``train_batches`` as a loader: each iteration streams the epoch
        anew, as the reference's DataLoader does, so a consumer that passes
        over it twice (``end_task``'s prototype sweep, then its buffer
        fill) gets the batches both times."""
        return _Loader(lambda: self.train_batches(epoch, augment=augment))

    def eval_batches(self, task_id: int, n_devices: int = 1,
                     rank: Optional[int] = None) -> Iterator[Dict[str, torch.Tensor]]:
        """Eval batches for ONE task's val subset with labels of tasks 0..t
        visible (reference: base_datamodule.py:407-431 get_val_test_all);
        each carries ``n_real``, its global batch's count of real
        (unpadded) images.  The global batch is ``batch_size x n_devices``,
        the last one padded to it whatever the world; with ``rank`` the
        rank's rows only, as JAX's process slice
        (``bacs_tpu/data/datamodule.py:377-396``)."""
        batches, n_reals, table = self.eval_index_batches(task_id, n_devices)
        lo, hi = self._rows(n_devices, rank)
        table = torch.from_numpy(table).to(self.device)
        source = self.train_source if self.domain_shift else self.val_source
        for n_real, (imgs, lbls) in zip(n_reals,
                                        self._device_stream(source, [b[lo:hi] for b in batches])):
            if n_real < hi:  # padded duplicates count for nothing
                lbls = lbls.clone()
                lbls[max(0, n_real - lo):] = 255
            out = transforms.eval_transform(imgs, lbls, table, crop=self.crop_size)
            out["n_real"] = n_real
            yield out

    def eval_task_range(self, up_to_task: int) -> List[int]:
        """Tasks evaluated after training task t: 0..t
        (reference: trainer.py:371-383)."""
        if not self.continual:
            return [0]
        return list(range(up_to_task + 1))


class _Loader:
    def __init__(self, make):
        self._make = make

    def __iter__(self):
        return iter(self._make())


def _host_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _resolve_workers(value) -> int:
    """Reference num_workers grammar (base_datamodule.py:45-54): "auto" is
    the host's cores; a count is clamped to them (decode workers are
    CPU-bound, so more processes only add spawn and IPC cost)."""
    if str(value).lower() == "auto":
        return _host_cores()
    return min(int(value or 0), _host_cores())


def create_datamodule(config, device: torch.device | str = "cuda") -> DataModule:
    """Build a DataModule on ``device`` from a reference-style config tree
    (reference `_target_` strings: dataloaders.VocDataModule etc.)."""
    dcfg = config["dataset"]
    tcfg = config["training"]
    target = str(dcfg.get("_target_", "synthetic")).lower().rsplit(".", 1)[-1]
    inner = dcfg.get("dataset", {})
    root = inner.get("root", "~/data")
    num_classes = int(inner.get("num_classes", 21))
    crop = int(inner.get("crop_size", 512))
    common = dict(
        num_classes=num_classes,
        crop_size=crop,
        batch_size=int(tcfg.get("batch_size", 8)),
        # `input_workers` wins if both are set
        input_workers=_resolve_workers(tcfg.get("input_workers", tcfg.get("num_workers", 0))),
        initial_increment=int(tcfg.get("initial_increment", 0) or 0),
        increment=int(tcfg.get("increment", 0) or 0),
        mode=str(tcfg.get("mode", "overlap")),
        shuffle_classes=bool(tcfg.get("shuffle_classes", False)),
        seed=int(tcfg.get("seed", 42)),
        debug=bool(tcfg.get("debug", False)),
        sweep=bool(tcfg.get("sweep", False)),
        device=device,
    )
    # downloads into the layouts the sources read (reference: prepare_data
    # hooks); offline they raise DownloadError with the layout to place by hand
    want_download = bool(inner.get("download", False))
    cache_decoded = inner.get("cache_decoded", False)

    def _maybe_cache(src):
        if not cache_decoded:
            return src
        if str(cache_decoded).lower() == "device":
            return DeviceCache(src, device)
        if str(cache_decoded).lower() == "disk":
            return DecodedCache(src, os.path.expanduser(os.path.join(root, "cache")))
        return DecodedCache(src)

    if "voc" in target:
        if want_download:
            download.download_voc(root)
        train = _maybe_cache(make_voc_source(root, "train", crop))
        val = _maybe_cache(make_voc_source(root, "val", crop))
        common["cache_dir"] = os.path.expanduser(os.path.join(root, "cache"))
    elif "ade" in target:
        if want_download:
            download.download_ade20k(root)
        train = _maybe_cache(make_ade_source(root, "train", crop))
        val = _maybe_cache(make_ade_source(root, "val", crop))
    elif "cityscape" in target:
        if want_download:
            download.download_cityscapes(root, str(inner.get("username", "")),
                                         str(inner.get("password", "")))
        train = make_cityscapes_source(root, "train", crop)
        val = make_cityscapes_source(root, "val", crop)
        n_cities = inner.get("n_cities", None)
        if n_cities:
            # domain-shift variant: cities become domains
            common["domain_ids"] = train.domain_ids
            common["n_domains_per_task"] = max(
                1, len(set(train.domain_ids)) // int(n_cities))
        else:
            train, val = _maybe_cache(train), _maybe_cache(val)
    else:  # synthetic
        n_train = int(inner.get("n_train", 64))
        n_val = int(inner.get("n_val", 16))
        style = str(inner.get("style", "flat"))
        # controlled background-shift regime (see SyntheticSource.__init__)
        era_kw = {}
        cooccur = float(inner.get("cooccur", -1.0))
        if cooccur >= 0 or bool(inner.get("bg_drift", False)):
            era_kw = dict(
                cooccur=max(cooccur, 0.0),
                bg_drift=bool(inner.get("bg_drift", False)),
                cooccur_initial=int(tcfg.get("initial_increment", 0) or 0),
                cooccur_increment=int(tcfg.get("increment", 0) or 1),
            )
        train = SyntheticSource(n_train, crop, num_classes, seed=1, style=style, **era_kw)
        val = SyntheticSource(n_val, crop, num_classes, seed=2, style=style, **era_kw)
        if str(cache_decoded).lower() == "device":
            train, val = DeviceCache(train, device), DeviceCache(val, device)
        n_domains = inner.get("n_domains", None)
        if n_domains:
            domain_ids = [i % int(n_domains) for i in range(n_train)]
            # a real appearance shift per domain, so domain forgetting is
            # measurable (val is the 80/20 split of the train source inside
            # DomainScenario)
            train = DomainShiftedSource(train, domain_ids)
            common["domain_ids"] = domain_ids
    return DataModule(train, val, **common)
