"""Per-client state stores (the port of ``repro.core.client_store``,
DESIGN.md §11-§12).

Every algorithm with persistent per-client state (Scaffold's and FedDyn's
control variates, FedComLoc's ``h`` and EF memory, LoCoDL's iterates and
variates) keeps it behind one cohort-row contract:

* ``init_slot(name, template, n_clients, init)`` at ``init`` time; the
  returned value is what the algorithm keeps in its state;
* ``cohort_index(clients, device)`` — once a round, the host cohort in
  the form the store indexes with (on the device for the stacked store,
  host int64 for a host store), so a round moves its cohort once;
* ``gather(name, slot, idx)`` — the cohort's rows, on the template's
  device, at round start;
* ``scatter(name, slot, idx, rows, ctx)`` — write the cohort's updated
  rows back at round end; returns the slot's next value.  Under a sharded
  client-axis ``ctx`` (DESIGN.md §6) ``idx`` and ``rows`` are the
  shard's, and the in-memory store writes every shard's rows through
  ``ctx.scatter_rows``.

Two backends:

* :class:`InMemoryStore` (the default): the slot is the stacked
  ``(n, ...)`` tensor on the device, and ``gather``/``scatter`` are the
  ``t[idx]`` and ``index_copy`` the round bodies used to inline, so
  trajectories and checkpoints are unchanged.
* :class:`HostStore`: rows live on the host in numpy buffers (or
  ``np.memmap`` files under ``mmap_dir``), and the slot is an int32
  version token that ``scatter`` bumps.  Buffers are filled lazily: a
  slot holds one fill row and a ``touched`` bitmap, and a gather reads
  only rows scattered before, so a million-client slot that has seen
  64-client cohorts costs 64 rows a round of host memory.  The device
  holds cohort rows only.

The port's round is eager Python, so the reference's ordered host
callbacks are plain calls here: ``gather`` copies the rows into pinned
host memory and on to the device, ``scatter`` copies the device rows to
the host before it returns.

``HostStore(prefetch=True)`` adds the reference's pipeline (§12).  A
worker thread, which touches numpy only, owns the buffers between rounds:

* write-behind scatter: ``scatter`` copies the cohort's rows and queues
  them; the worker applies them (and writes the memmap files) while the
  device computes;
* cohort prefetch: ``submit_cohort_plan`` hands the store the coming
  rounds' cohorts (the engine replays the key chain to get them); after
  applying round t's scatter of a slot the worker stages round t+1's
  rows, so ``gather`` usually takes a staged buffer;
* hazard rules: a gather that misses the staging buffer drains the queue
  (a flush stall) and reads synchronously; a scatter overlapping a staged
  entry discards it (a RAW hazard); a stage that raced an apply to the
  same slot is dropped.  Every row served is the row the plain store
  would read, so the pipelined store is bit-identical to the plain one.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.clients import NULL_CTX

PyTree = Any

INIT_MODES = ("zeros", "broadcast")


def _host_idx(idx) -> np.ndarray:
    """A cohort's client indices as a host int64 array."""
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    return np.asarray(idx, np.int64)


class ClientStore:
    """The cohort-row contract round implementations write against."""

    #: True if rows live on the host (:class:`HostStore`).
    host_side: bool = False

    def cohort_index(self, clients: torch.Tensor, device) -> Any:
        """The round's host cohort as this store's ``idx``."""
        return clients.to(device)

    def init_slot(self, name: str, template: PyTree, n_clients: int,
                  init: str = "zeros") -> PyTree:
        raise NotImplementedError

    def gather(self, name: str, slot: PyTree, idx) -> PyTree:
        raise NotImplementedError

    def scatter(self, name: str, slot: PyTree, idx, rows: PyTree,
                ctx=NULL_CTX) -> PyTree:
        raise NotImplementedError


class InMemoryStore(ClientStore):
    """The stacked-tensor backend: the slot is the ``(n, ...)`` tree on
    the template's device, and every method is the operation the round
    bodies inlined before stores existed."""

    def init_slot(self, name: str, template: PyTree, n_clients: int,
                  init: str = "zeros") -> PyTree:
        if init not in INIT_MODES:
            raise ValueError(f"init must be one of {INIT_MODES}")
        if init == "broadcast":
            return tree_util.map(
                lambda p: p.unsqueeze(0).expand(
                    (n_clients,) + tuple(p.shape)).clone(), template)
        return tree_util.map(
            lambda p: torch.zeros((n_clients,) + tuple(p.shape),
                                  dtype=p.dtype, device=p.device), template)

    @staticmethod
    def _on_slot_device(idx, slot: PyTree):
        """``idx`` where the slot lives: a no-op for the round's
        ``cohort_index``, one copy a call for any other index."""
        leaves = tree_util.leaves(slot)
        return idx.to(leaves[0].device) if leaves else idx

    def gather(self, name: str, slot: PyTree, idx) -> PyTree:
        idx = self._on_slot_device(idx, slot)
        return tree_util.map(lambda t: t[idx], slot)

    def scatter(self, name: str, slot: PyTree, idx, rows: PyTree,
                ctx=NULL_CTX) -> PyTree:
        return ctx.scatter_rows(slot, self._on_slot_device(idx, slot), rows)


@dataclasses.dataclass
class _HostSlot:
    """One named slot's host storage."""

    leaves: List[np.ndarray]          # (n, ...) buffers (numpy or memmap)
    fill: List[np.ndarray]            # one (...) fill row per leaf
    touched: np.ndarray               # (n,) bool — rows ever scattered
    like: PyTree                      # the template (structure, dtypes)
    devices: List[torch.device]       # where each leaf's rows are served
    # write fds of memmap leaves (None for a RAM leaf): scatters pwrite
    # one row a syscall into the file the mapping reads, instead of
    # faulting fresh pages in through the mapping
    fds: List[Optional[int]] = dataclasses.field(default_factory=list)


class HostStore(ClientStore):
    """Host-memory (optionally memory-mapped) backend.

    ``mmap_dir`` spools each leaf to a ``np.memmap`` file there, created
    sparse, so untouched rows cost no disk and the population may exceed
    host memory too.  ``prefetch=True`` adds write-behind scatters and
    plan-driven cohort prefetch on a worker thread, bit-identical to the
    plain store (see the module docstring for the hazard rules); the
    engine feeds the plan through :meth:`submit_cohort_plan`.
    """

    host_side = True

    def __init__(self, mmap_dir: Optional[str | Path] = None, *,
                 prefetch: bool = False):
        self._mmap_dir = Path(mmap_dir) if mmap_dir is not None else None
        self._slots: Dict[str, _HostSlot] = {}
        self.prefetch = bool(prefetch)
        # telemetry: rows/bytes moved, pipeline health, and wall seconds a
        # phase (gather/scatter on the round's thread; apply/prefetch on
        # the worker)
        self.bytes_gathered = 0
        self.bytes_scattered = 0
        self.rows_gathered = 0
        self.rows_scattered = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.flush_stalls = 0
        self.raw_hazards = 0
        self.phase_seconds = {"gather": 0.0, "scatter": 0.0,
                              "apply": 0.0, "prefetch": 0.0}
        # pipeline state (prefetch mode), all mutated under _cond
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._pending = 0
        self._staged: Dict[str, tuple] = {}      # name -> (idx, leaves)
        self._plan: Optional[List[np.ndarray]] = None
        self._next_stage: Dict[str, int] = {}
        self._apply_seq: Dict[str, int] = {}
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None

    def cohort_index(self, clients: torch.Tensor, device) -> np.ndarray:
        return _host_idx(clients)

    def telemetry(self) -> dict:
        """Every counter in one flat dict."""
        out = {k: getattr(self, k) for k in (
            "rows_gathered", "rows_scattered", "bytes_gathered",
            "bytes_scattered", "prefetch_hits", "prefetch_misses",
            "flush_stalls", "raw_hazards")}
        out.update({f"{k}_seconds": round(v, 6)
                    for k, v in self.phase_seconds.items()})
        return out

    # -- allocation ------------------------------------------------------ #

    def _alloc(self, name: str, i: int, shape, dtype):
        if self._mmap_dir is None:
            # calloc'd pages: untouched rows stay zero-page backed, and the
            # touched bitmap keeps gathers from faulting them in
            return np.zeros(shape, dtype), None
        self._mmap_dir.mkdir(parents=True, exist_ok=True)
        path = self._mmap_dir / f"{name}.leaf_{i}.mm"
        buf = np.memmap(path, dtype=dtype, mode="w+", shape=shape)
        return buf, os.open(path, os.O_WRONLY)

    def init_slot(self, name: str, template: PyTree, n_clients: int,
                  init: str = "zeros") -> torch.Tensor:
        if init not in INIT_MODES:
            raise ValueError(f"init must be one of {INIT_MODES}")
        bufs, fds, fills, devices = [], [], [], []
        for i, leaf in enumerate(tree_util.leaves(template)):
            if leaf.dtype == torch.bfloat16:
                raise TypeError("HostStore rows must have a numpy dtype; "
                                "bfloat16 slots need the in-memory store")
            row = leaf.detach().cpu().numpy()
            buf, fd = self._alloc(name, i, (n_clients,) + row.shape,
                                  row.dtype)
            bufs.append(buf)
            fds.append(fd)
            # the fill row serves every never-scattered gather, so a
            # "broadcast" init never writes n_clients copies of the model
            fills.append(row.copy() if init == "broadcast"
                         else np.zeros(row.shape, row.dtype))
            devices.append(leaf.device)
        self._slots[name] = _HostSlot(
            leaves=bufs, fill=fills, touched=np.zeros((n_clients,), bool),
            like=template, devices=devices, fds=fds)
        # the slot value is a version token: a real (checkpointable) leaf
        # of the state that every scatter bumps
        return torch.zeros((), dtype=torch.int32)

    # -- host-side row movement ------------------------------------------ #

    def _gather_host(self, name: str, idx: np.ndarray) -> List[np.ndarray]:
        slot = self._slots[name]
        t = slot.touched[idx]
        out = []
        for buf, fill in zip(slot.leaves, slot.fill):
            rows = np.empty((idx.shape[0],) + fill.shape, fill.dtype)
            # read only rows scattered before; the rest come from the fill
            # row without faulting buffer pages in
            rows[:] = fill
            if t.any():
                rows[t] = buf[idx[t]]
            out.append(rows)
            self.bytes_gathered += rows.nbytes
        return out

    def _scatter_host(self, name: str, idx: np.ndarray,
                      leaves: List[np.ndarray]) -> None:
        slot = self._slots[name]
        for buf, fd, rows in zip(slot.leaves, slot.fds, leaves):
            if fd is None:
                buf[idx] = rows
            else:
                # memmap leaf: pwrite lands in the page cache the mapping
                # reads from, so later gathers see it
                row_bytes = buf.dtype.itemsize * int(
                    np.prod(buf.shape[1:], dtype=np.int64))
                flat = np.ascontiguousarray(
                    rows, dtype=buf.dtype).reshape(idx.shape[0], -1)
                for k in range(idx.shape[0]):
                    os.pwrite(fd, flat[k], int(idx[k]) * row_bytes)
            self.bytes_scattered += rows.nbytes
        slot.touched[idx] = True

    def _to_device(self, name: str, leaves: List[np.ndarray]) -> PyTree:
        """The gathered rows as tensors where the slot's template lives;
        rows bound for the card go through pinned host memory."""
        slot = self._slots[name]
        out = []
        for rows, dev in zip(leaves, slot.devices):
            if dev.type == "cuda":
                pinned = torch.empty(rows.shape,
                                     dtype=torch.from_numpy(rows[:0]).dtype,
                                     pin_memory=True)
                pinned.numpy()[...] = rows
                out.append(pinned.to(dev, non_blocking=True))
            else:
                out.append(torch.from_numpy(rows).to(dev))
        return tree_util.unflatten(slot.like, out)

    # -- pipeline worker (prefetch mode) --------------------------------- #

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name="hoststore-pipeline",
                daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                op = self._queue.popleft()
            try:
                if self._worker_error is None:
                    if op[0] == "apply":
                        t0 = time.perf_counter()
                        _, name, idx, leaves = op
                        self._scatter_host(name, idx, leaves)
                        self.phase_seconds["apply"] += (
                            time.perf_counter() - t0)
                        self._do_stage(name)
                    else:                      # ("stage", name)
                        self._do_stage(op[1])
            except BaseException as e:         # surfaced by the next call
                with self._cond:
                    self._worker_error = e
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def _do_stage(self, name: str) -> None:
        """Read the slot's next planned cohort into the staging buffer.

        The read runs without the lock (the worker is the only buffer
        writer, and synchronous reads happen only once the queue has
        drained); the result is published under the lock, or dropped if an
        apply to the same slot raced past it."""
        with self._cond:
            if self._plan is None:
                return
            j = self._next_stage.get(name, len(self._plan))
            if j >= len(self._plan):
                return
            idx = self._plan[j]
            self._next_stage[name] = j + 1
            seq0 = self._apply_seq.get(name, 0)
        t0 = time.perf_counter()
        leaves = self._gather_host(name, idx)
        with self._cond:
            if self._apply_seq.get(name, 0) == seq0:
                self._staged[name] = (idx, leaves)
            self.phase_seconds["prefetch"] += time.perf_counter() - t0

    def _raise_worker_error(self) -> None:
        if self._worker_error is not None:
            raise RuntimeError(
                "HostStore pipeline worker failed") from self._worker_error

    def flush(self) -> None:
        """Barrier: wait until every queued scatter is applied and every
        queued stage has landed; re-raises a worker error.  A no-op on a
        plain store."""
        with self._cond:
            while self._pending and self._worker_error is None:
                self._cond.wait()
        self._raise_worker_error()

    def submit_cohort_plan(self, cohorts: Sequence[np.ndarray]) -> None:
        """Hand the store the coming rounds' cohorts (``cohorts[t]`` the
        ``(s,)`` indices round t will gather and scatter).  The plan is a
        hint: a wrong entry costs a prefetch miss, never a wrong row.  It
        replaces any earlier plan, after a flush, so stale staged rows
        cannot survive it."""
        if not self.prefetch:
            return
        self.flush()
        self._ensure_worker()
        with self._cond:
            self._staged.clear()
            self._plan = [_host_idx(c) for c in cohorts]
            self._next_stage = {name: 0 for name in self._slots}
            for name in self._slots:
                self._queue.append(("stage", name))
                self._pending += 1
            self._cond.notify_all()

    # -- the round's contract -------------------------------------------- #

    def _gather_rows(self, name: str, idx: np.ndarray) -> List[np.ndarray]:
        if not self.prefetch:
            return self._gather_host(name, idx)
        self._raise_worker_error()
        with self._cond:
            entry = self._staged.get(name)
            if entry is not None and np.array_equal(entry[0], idx):
                del self._staged[name]
                self.prefetch_hits += 1
                return entry[1]
            if self._pending:
                # a planned stage (or a scatter this gather must observe)
                # is in flight: drain, then retry the staging buffer
                self.flush_stalls += 1
                while self._pending and self._worker_error is None:
                    self._cond.wait()
                entry = self._staged.get(name)
                if entry is not None and np.array_equal(entry[0], idx):
                    del self._staged[name]
                    self.prefetch_hits += 1
                    return entry[1]
        self._raise_worker_error()
        self.prefetch_misses += 1
        return self._gather_host(name, idx)

    def gather(self, name: str, slot, idx) -> PyTree:
        t0 = time.perf_counter()
        idx_np = _host_idx(idx)
        try:
            return self._to_device(name, self._gather_rows(name, idx_np))
        finally:
            self.rows_gathered += int(idx_np.shape[0])
            self.phase_seconds["gather"] += time.perf_counter() - t0

    def scatter(self, name: str, slot, idx, rows: PyTree,
                ctx=NULL_CTX) -> torch.Tensor:
        hs = self._slots[name]
        leaves = tree_util.leaves(rows)
        if len(leaves) != len(hs.leaves):
            raise ValueError(
                f"scatter to slot {name!r} with mismatched tree structure")
        t0 = time.perf_counter()
        idx_np = _host_idx(idx)
        try:
            # copies on the host, complete before this returns: the worker
            # never reads a device tensor or memory the caller may reuse
            copies = [np.array(l.detach().cpu().numpy(), copy=True)
                      for l in leaves]
            if not self.prefetch:
                self._scatter_host(name, idx_np, copies)
            else:
                self._raise_worker_error()
                self._ensure_worker()
                with self._cond:
                    entry = self._staged.get(name)
                    if (entry is not None
                            and np.intersect1d(entry[0], idx_np).size):
                        # RAW hazard: the staged rows predate this write
                        del self._staged[name]
                        self.raw_hazards += 1
                    self._apply_seq[name] = self._apply_seq.get(name, 0) + 1
                    self._queue.append(("apply", name, idx_np, copies))
                    self._pending += 1
                    self._cond.notify_all()
            return slot + 1
        finally:
            self.rows_scattered += int(idx_np.shape[0])
            self.phase_seconds["scatter"] += time.perf_counter() - t0

    def __del__(self):
        for slot in getattr(self, "_slots", {}).values():
            for fd in slot.fds:
                if fd is not None:
                    try:
                        os.close(fd)
                    except OSError:
                        pass

    # -- persistence (checkpoint-resume) --------------------------------- #

    def state_dict(self) -> dict:
        """The store's host state as one nested dict of numpy arrays, for
        ``repro_torch.checkpoint.save`` (the reference's layout, so either
        package reads it).  Buffers are written dense: checkpoints are for
        resumable experiments, not for spooling a million-client
        population.  Flushes first, so every committed scatter is in."""
        self.flush()
        out = {}
        for name, slot in self._slots.items():
            out[name] = {
                "touched": slot.touched.copy(),
                "fill": {f"leaf_{i}": f.copy()
                         for i, f in enumerate(slot.fill)},
                "data": {f"leaf_{i}": np.asarray(buf).copy()
                         for i, buf in enumerate(slot.leaves)},
            }
        return out

    def load_state_dict(self, d: dict) -> None:
        """Restore :meth:`state_dict`'s buffers into the slots ``init_slot``
        registered (call the algorithm's ``init`` first).  Drops staged
        rows and the cohort plan: they described the earlier timeline."""
        self.flush()
        with self._cond:
            self._staged.clear()
            self._plan = None
            self._next_stage = {}
        for name, payload in d.items():
            if name not in self._slots:
                raise KeyError(
                    f"state_dict slot {name!r} was never registered; call "
                    "the algorithm's init() before load_state_dict()")
            slot = self._slots[name]
            slot.touched[:] = np.asarray(payload["touched"])
            for i in range(len(slot.leaves)):
                slot.fill[i][...] = np.asarray(payload["fill"][f"leaf_{i}"])
                slot.leaves[i][...] = np.asarray(payload["data"][f"leaf_{i}"])


def resolve_store(store: Optional[ClientStore]) -> ClientStore:
    """Default and type-check the ``store=`` argument every algorithm
    takes."""
    if store is None:
        return InMemoryStore()
    if not isinstance(store, ClientStore):
        raise TypeError(
            f"store must be a ClientStore, got {type(store).__name__}")
    return store
