"""SPMD view over the out-of-core block store: one rank per mesh worker
(this package's counterpart of the JAX package's ``repro.store.spmd``).

The JAX package runs one process with W devices: its group holds W
per-worker stores and reassembles each scheduled block's whole [b, E_cap]
slice from their [b/W, E_cap] rows, and GSPMD turns the executors' leading-
axis operations into collectives.  Here every rank is its own process
(``torch.distributed``, as the resident SPMD path runs): a rank builds only
its own :class:`~repro_torch.store.residency.DiskBlockStore` over
``Manifest.worker_shard_view(rank, W)`` -- its contiguous range of b_w =
b / W stripe files, its own residency budget, its own prefetch thread --
and its [b_w, E_cap] rows never leave it.  The disk executors run the same
per-block bodies on those rows and cross the ranks only in their tails,
through ``core/collectives.py`` (the compact or packed exchange, the
horizontal and dense-region gathers), so the result is bitwise the
single-process disk result: the same slices, the same per-block sums, the
same fold order.

The group quacks like a DiskBlockStore (``block_nnz`` / ``stats`` /
``begin_iteration`` / ``make_pipeline`` / ``device`` /
``peak_resident_bytes``).  Every schedule is the same on every rank: it
comes from the whole-store block arrays, which each shard view carries.
Its ``stats`` are the fleet's, as ``_GroupStats`` of the JAX package gives
them: bytes, fetch and wait seconds summed over the W workers,
``blocks_fetched`` their max (every worker fetches its rows of the same
logical block), the overlap from the sums; ``compute_s`` stays the rank's
own.  :meth:`SpmdDiskGroup.worker_io_stats` gathers the W workers' figures
with one small ``all_gather`` (collective: every rank calls it, once per
iteration, in the executor's leg order) and returns the ``store_worker_*``
lists, so every rank's iteration record carries the same lists and
aggregates.

Faults: each rank holds its own injector built from the same plan, and its
store's ``fault_scope`` is its worker index, so an event that names a
worker fires on that worker's rank alone.  An event that names none is kept
only in the injector of the rank at worker index 0 and dropped from every
other rank's (``FaultInjector.drop_unscoped``), so it fires once, as in the
JAX package, whose W stores share one injector; there such an event goes to
whichever store fetches first, here always to worker index 0, so the choice
is deterministic, and the fleet's ``fault.injected*`` sums equal the JAX
package's single-host disk run of the same plan.  Kills name no worker and
stay on every rank (each rank's engine stops at the same boundary).  Tracing: a rank's store records into the
``w{rank}`` child of the engine's recorder (its prefetch thread a track of
that lane); :meth:`SpmdDiskGroup.fleet_recorder` gathers the W lanes into
one recorder that ``repro_torch.obs.fleet.merge_traces`` lays out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.gimv import GimvSpec
from repro_torch.faults import DEFAULT_RETRY, RetryPolicy, as_injector
from repro_torch.obs.recorder import as_recorder
from repro_torch.store.manifest import open_store
from repro_torch.store.residency import DiskBlockStore

__all__ = ["SpmdDiskGroup", "SpmdPrefetchPipeline"]

# the columns of a rank's row in the gathered fleet figures
_FLEET = ("bytes_read", "io_s", "wait_s", "blocks_fetched", "prefetch_degraded", "read_s",
          "verify_s", "weights_s", "h2d_s", "peak_resident_bytes")
_COL = {name: i for i, name in enumerate(_FLEET)}


class _GroupStats:
    """ResidencyStats facade over the W workers, every field the executors
    sum (``residency._summed``).  The I/O fields read the fleet figures of
    the group's last gather (zero from ``begin_iteration`` until the
    iteration's gather); ``compute_s`` and ``blocks_skipped`` are set by the
    executor and stay the rank's own (compute is each rank's program, the
    skipped blocks the shared schedule's)."""

    def __init__(self, group: "SpmdDiskGroup"):
        self._group = group
        self.compute_s = 0.0
        self.blocks_skipped = 0
        # the copies' events stay on their rank: their seconds arrive summed
        self.h2d: list = []

    def _sum(self, name: str) -> float:
        return float(self._group._fleet[:, _COL[name]].sum())

    @property
    def bytes_read(self) -> int:
        return int(self._sum("bytes_read"))

    @property
    def blocks_fetched(self) -> int:
        # logical blocks: every worker fetches its rows of the same block
        return int(self._group._fleet[:, _COL["blocks_fetched"]].max())

    @property
    def io_s(self) -> float:
        return self._sum("io_s")

    @property
    def wait_s(self) -> float:
        return self._sum("wait_s")

    @property
    def read_s(self) -> float:
        return self._sum("read_s")

    @property
    def verify_s(self) -> float:
        return self._sum("verify_s")

    @property
    def weights_s(self) -> float:
        return self._sum("weights_s")

    @property
    def h2d_timed_s(self) -> float:
        return self._sum("h2d_s")


class SpmdDiskGroup:
    """This rank's worker store of an SPMD disk solve, presented as the W
    workers' one DiskBlockStore-shaped group (module doc).  ``local`` is the
    rank's own store; ``axis`` the mesh's worker axis."""

    def __init__(self, local: DiskBlockStore, axis: collectives.WorkerAxis, *, obs=None):
        self.local = local
        self.axis = axis
        self.striping = local.striping
        self.device = local.device
        # the group-level recorder is the parent of the rank store's w{rank} lane
        self.obs = local.obs if obs is None else as_recorder(obs)
        self.block_nnz = local.block_nnz
        self.budget_bytes = local.budget_bytes      # PER-WORKER budget
        self._fleet = np.zeros((axis.size, len(_FLEET)))
        self._peak = 0
        self.stats = _GroupStats(self)

    @classmethod
    def build(cls, store, striping: str, spec: GimvSpec, mesh, axis_name, *,
              budget_bytes: int | None = None, obs=None, faults=None,
              verify: bool | None = None, dense_gather_idx=None,
              device=None) -> "SpmdDiskGroup":
        """The calling rank's worker store over its shard view of ``store``
        (no bytes move).  ``budget_bytes`` is PER WORKER: each rank budgets
        its own double buffer.  ``device`` is where the rank's slices go (its
        card, or the CPU).  Raises ValueError when the mesh size does not
        divide b."""
        manifest = open_store(store)
        axis = collectives.worker_axis(mesh, axis_name)
        count = axis.size
        if manifest.b % count != 0:
            raise ValueError(
                f"mesh size {count} must divide b={manifest.b} so each "
                "worker owns a whole stripe range")
        recorder = as_recorder(obs)
        rank = axis.index
        injector = as_injector(faults, recorder)
        if injector is not None and rank != 0:
            injector.drop_unscoped()      # an unnamed fetch event fires once (module doc)
        # the rank's store records into its own w{rank} lane (its prefetch
        # thread a track of it); the child shares the parent's metrics, so
        # store.prefetch_degraded and retry.* count on the rank's registry
        local = DiskBlockStore(manifest.worker_shard_view(rank, count), striping, spec,
                               budget_bytes=budget_bytes, device=device,
                               dense_gather_idx=dense_gather_idx,
                               obs=recorder.child(f"w{rank}"),
                               faults=injector, verify=verify,
                               fault_scope=rank)
        return cls(local, axis, obs=recorder)

    @property
    def peak_resident_bytes(self) -> int:
        """The largest worker's peak (as of the last gather, and this
        rank's own now)."""
        return max(self._peak, self.local.peak_resident_bytes)

    def begin_iteration(self) -> None:
        self.local.begin_iteration()
        self._fleet[:] = 0.0
        self.stats.compute_s = 0.0
        self.stats.blocks_skipped = 0

    def make_pipeline(self, schedule, retry: RetryPolicy = DEFAULT_RETRY):
        return SpmdPrefetchPipeline(self, schedule, retry)

    def _gather(self) -> np.ndarray:
        """Every worker's row of the fleet figures: one all_gather of a
        float64 [1, 10] tensor (on the rank's device, which every backend
        takes).  Collective."""
        st, local = self.local.stats, self.local
        row = [float(st.bytes_read), st.io_s, st.wait_s, float(st.blocks_fetched),
               float(bool(local.prefetch_degraded)), st.read_s, st.verify_s, st.weights_s,
               st.h2d_s, float(local.peak_resident_bytes)]
        mine = torch.tensor([row], dtype=torch.float64, device=self.device)
        fleet = collectives.all_gather(mine, self.axis).cpu().numpy()
        self._fleet = fleet
        self._peak = max(self._peak, int(fleet[:, _COL["peak_resident_bytes"]].max()))
        return fleet

    def worker_io_stats(self) -> dict:
        """The W workers' ``store_worker_*`` lists of the current iteration,
        gathered now (collective); afterwards ``stats`` holds the fleet's
        aggregates of the same figures."""
        f = self._gather()
        io, wait = f[:, _COL["io_s"]], f[:, _COL["wait_s"]]
        return {
            "store_worker_bytes_read": f[:, _COL["bytes_read"]].tolist(),
            "store_worker_io_s": io.tolist(),
            "store_worker_wait_s": wait.tolist(),
            "store_worker_overlap": [1.0 if i <= 0.0 else max(0.0, 1.0 - w / i)
                                     for i, w in zip(io.tolist(), wait.tolist())],
            # per-worker physical fetches and the sticky degraded flag: the
            # max-fold of stats.blocks_fetched hides which worker fell behind
            "store_worker_blocks_fetched": f[:, _COL["blocks_fetched"]].tolist(),
            "store_worker_prefetch_degraded": f[:, _COL["prefetch_degraded"]].tolist(),
        }

    def fleet_recorder(self):
        """One recorder holding the run's whole fleet trace, on every rank
        (collective): rank 0's main lane and each rank's worker lanes as
        children, for ``repro_torch.obs.fleet.merge_traces``.

        Epochs: each rank's spans are stored relative to its own recorder's
        epoch, a ``time.perf_counter()`` reading.  On Linux that clock is
        CLOCK_MONOTONIC, one clock for every process of a host, so the
        merged timeline starts at the earliest rank's epoch and rank r's spans
        move onto it by adding epoch_r - that epoch (never negative, so no
        merged span can start before 0, whichever rank started first).
        Ranks on different hosts share no such clock; their lanes would be
        aligned only as well as the hosts' clocks are."""
        from repro_torch.obs.recorder import Recorder

        rec = self.obs
        mine = (rec.epoch, list(rec.events) if self.axis.index == 0 else None,
                {label: list(ch.events) for label, ch in rec.children.items()})
        got = collectives.all_gather_object(mine, self.axis)
        start = min(epoch for epoch, _main, _lanes in got)
        fleet = Recorder(_epoch=start)
        fleet.events = [dict(ev, ts=ev["ts"] + got[0][0] - start) for ev in got[0][1]]
        for epoch, _main, lanes in got:
            shift = epoch - start
            for label, events in lanes.items():
                fleet.child(label).events.extend(
                    dict(ev, ts=ev["ts"] + shift) for ev in events)
        return fleet


class SpmdPrefetchPipeline:
    """The rank's one PrefetchPipeline over the shared schedule: iteration
    *t*'s exchange / assign tail overlaps the rank's disk leg of *t+1*, as
    single-process.  There is nothing to assemble: the rank's [b_w, E_cap]
    rows are what its executor computes on.  A rank whose prefetch thread
    breaks degrades alone (its own synchronous fetches, its own
    ``store.prefetch_degraded``)."""

    def __init__(self, group: SpmdDiskGroup, schedule,
                 retry: RetryPolicy = DEFAULT_RETRY):
        self.group = group
        self.schedule = list(schedule)
        self.retry = retry
        self._pipe = group.local.make_pipeline(self.schedule, retry)

    def iteration(self):
        """Yield (block, this rank's slice) for ONE pass over the schedule."""
        return self._pipe.iteration()

    def close(self) -> None:
        self._pipe.close()
