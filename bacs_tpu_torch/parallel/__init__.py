"""Data parallelism across processes: the port of ``bacs_tpu/parallel/mesh.py``.

JAX runs one program over a 1-D ``data`` mesh and XLA emits the
collectives that ``shard_map`` names (``lax.pmean``/``psum`` over the
``data`` axis).  Here every device is a process, a rank of a
``torch.distributed`` process group, and the port names its collectives
itself: each rank trains on its contiguous ``1/n`` of the global batch and
the steps all-reduce what JAX pmeans or psums (``train/step.py``,
``ops/abn_core.py``, ``ops/stem_pool.py``, ``models/norm.py``,
``methods/base.py``).  A group is NCCL for CUDA tensors and gloo for CPU
ones (the counterpart of JAX's virtual CPU devices); gloo also carries
CUDA tensors, so two gloo ranks can share one card where NCCL refuses two
ranks per device.

- :func:`spawn` runs a function in ``n`` fresh ranks (spawn start method, a
  free loopback port) and returns their results by rank; a rank's error
  is raised in the caller.  :func:`join_env` joins a group that ``torchrun``
  described in the environment.
- :func:`world_size` and :func:`rank` read a group (``None`` is one
  device: world 1, rank 0); :func:`rank_rows` is a rank's slice of a
  global batch, for the steps' callers and the DataModule alike.
- :func:`all_reduce_` sums or averages tensors in place in one flat
  collective; :func:`pmean` is the differentiable mean across ranks whose
  backward is itself, as the transpose of JAX's ``pmean``;
  :func:`all_gather` joins the ranks' slices of a batch.
- :func:`synchronized` names the group the synchronized norms read
  (:func:`sync_group`) while a train step runs; the task-boundary passes
  run outside it, as JAX's boundary passes run a model without an axis.

Not ported, being TPU-only: GSPMD spatial partitioning (``make_spatial_mesh``
and K11), and the multihost ``multihost_init``, ``replicate_to_global`` and
``localize_to_host``.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import queue
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


# all_reduce_ calls and the bytes they carried, for the step's accounting
counters = {"calls": 0, "bytes": 0}


def world_size(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    return 0 if group is None else dist.get_rank(group)


def rank_rows(global_batch: int, world: int, rank_: int) -> tuple[int, int]:
    """(lo, hi) of rank ``rank_``'s contiguous slice of a global batch
    split across ``world`` ranks."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} ranks")
    local = global_batch // world
    return rank_ * local, (rank_ + 1) * local


def backend_for(device: str | torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_group(rank_: int, world: int, port: int, device: str | torch.device = "cpu",
               backend: Optional[str] = None):
    """Join the ``world``-rank group at ``tcp://127.0.0.1:port`` as
    ``rank_``; returns the group.  ``backend`` defaults to NCCL for a CUDA
    ``device`` (made the current device first) and gloo otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or backend_for(device),
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank_, world_size=world)
    return dist.group.WORLD


def join_env(device: str | torch.device = "cpu", backend: Optional[str] = None):
    """The running group: the one already initialised in this process, else
    the one ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), else None."""
    if dist.is_initialized():
        return dist.group.WORLD
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group(backend or backend_for(device), init_method="env://")
    return dist.group.WORLD


def rank_device(device: str | torch.device, rank_: int) -> torch.device:
    """A rank's device: ``cuda`` without an index is the rank's own card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank_)
    return device


def _rank_main(rank_, world, port, device, backend, threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, rank_)
        group = init_group(rank_, world, port, dev, backend)
        try:
            out = fn(group, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank_, True, out))
    except Exception:  # the rank's boundary: report it to the caller, which raises
        results.put((rank_, False, traceback.format_exc()))


# seconds :func:`spawn` waits for its ranks' results before it stops them
SPAWN_TIMEOUT = 3600.0


def spawn(fn: Callable[..., Any], n: int, args: Sequence[Any] = (),
          device: str | torch.device = "cpu", backend: Optional[str] = None,
          threads: Optional[int] = None) -> List[Any]:
    """``[fn(group, device, *args) for each of n ranks]``, each rank a fresh
    process.

    ``fn`` and ``args`` are pickled (a module-level function).  ``device``
    ``cuda`` gives rank r the card ``cuda:r``; an indexed device is every
    rank's.  ``threads`` sets each rank's intra-op threads.  A rank that
    raises stops the others, and its traceback is raised here."""
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    port = free_port()
    procs = [mp.Process(target=_rank_main, daemon=True,
                        args=(r, n, port, str(device), backend, threads, fn, tuple(args),
                              results)) for r in range(n)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * n
    got = 0
    try:
        waited = 0.0
        while got < n:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or waited > SPAWN_TIMEOUT:
                    raise RuntimeError(
                        f"rank(s) {[procs.index(p) for p in dead]} died without a result"
                        if dead else f"ranks gave no result in {SPAWN_TIMEOUT} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {n} failed:\n{value}")
            out[r] = value
            got += 1
    finally:
        for p in procs:
            # after a failure the others may wait in a collective: stop them
            p.join(timeout=30 if got == n else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return out


# ------------------------------------------------------------------ collectives


def all_reduce_(tensors: Sequence[torch.Tensor], group, mean: bool = True):
    """Sum (or, with ``mean``, average) each tensor across ``group`` in
    place, in one collective per dtype over their flat concatenation.
    Returns ``tensors``."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if mean:
            flat /= world_size(group)
        counters["calls"] += 1
        counters["bytes"] += flat.numel() * flat.element_size()
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (of one shape on all ranks) joined along the first
    axis in rank order, on every rank: the global batch of contiguous
    slices."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_([x.clone()], group)[0]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_([g.contiguous().clone()], ctx.group)[0], None


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` across ranks, differentiable: the cotangent is
    averaged across ranks too, as JAX transposes ``pmean`` under
    ``shard_map``, so each rank's input gradient is that of the sum of
    every rank's loss."""
    return x if group is None else _PMean.apply(x, group)


# ------------------------------------------------------------------ sync scope

_sync_group = None


@contextlib.contextmanager
def synchronized(group):
    """Within the block, the synchronized norms reduce their statistics
    over ``group`` (None: no group).  A global, not a thread-local: the
    autograd engine runs a CUDA backward, and a remat recompute, in its own
    thread."""
    global _sync_group
    before, _sync_group = _sync_group, group
    try:
        yield
    finally:
        _sync_group = before


def sync_group():
    """The group a synchronized norm reduces over now, or None."""
    return _sync_group
