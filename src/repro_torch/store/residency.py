"""Residency manager + schedule-driven prefetch for the block store (this
package's counterpart of the JAX package's ``repro.store.residency``).

``PMVEngine(..., store=..., residency=...)`` picks where the pre-partitioned
matrix lives:

  'device'  load the store and put every stripe on the engine's device
            (bitwise the in-memory engine).
  'host'    the same load; on a GPU the stripes stay in pinned host memory
            and each step copies them to the card (on the CPU this
            coincides with 'device').
  'disk'    the stripes never materialize: the executors below walk the
            plan's block schedule, fetch each scheduled block's shard slice
            from the memmap-backed store, run the per-block bodies the
            resident path is made of (placement.single_block_compact /
            single_block_partial / single_block_contrib), and fetch the next
            scheduled block behind the current block's compute.

On the card a fetched slice is read into one of two pinned host buffers and
copied to the device on a side CUDA stream; the compute stream waits on the
copy's event, and a pinned buffer is written again only after its last copy
has completed.  On the CPU the slice's host arrays are used in place.

The vertical executor is bitwise the resident vertical step on the CPU: the
same per-block sums in the same order, the same compact exchange and the
same scatter / assign tail.  With ``exchange='packed'`` it gathers each
block's partial at the prepare-time static send order (repro_torch.exchange)
and runs the payload-only scatter tail.  The horizontal executor streams the
gather per SOURCE block and folds the per-block contributions with the same
pairwise tree ``gathered_gimv`` uses, so every semiring, float plus_times
included, is bitwise the resident reduction whatever order the schedule
walked the blocks in.  The θ-split hybrid executor runs both: the dense
region's ``dense_horizontal`` stripes per source block against the compact
dense slice, the sparse region's ``sparse_vertical`` stripes per
destination block through the compact exchange, each leg off its own
prefetch pipeline, combined sparse-first before the assign, so it is
bitwise the resident hybrid step.  On the card the segment sums use
atomics, so plus_times agrees to rounding there, and the selection
semirings exactly.

SPMD (``mesh=``): each rank runs these executors on its own workers' rows
(``axis=``), its store the ``repro_torch.store.SpmdDiskGroup`` over its
shard view of the store; the tails cross the ranks (module doc of
``repro_torch.store.spmd``).

Robustness: every fetched slice is verified against the manifest's
ingest-time per-row checksums (a mismatch raises a typed
:class:`~repro_torch.store.manifest.ShardCorruptError` naming the file,
worker and block row), every fetch runs under a bounded
:class:`~repro_torch.faults.RetryPolicy`, and a prefetch THREAD failure
degrades the double buffer to synchronous fetches instead of failing the
solve.

Fault injection (``faults=``, a ``repro_torch.faults`` plan or injector
shared with the engine): each fetch attempt first asks the injector for a
transient I/O error or a straggler's sleep, a freshly read slice may get
one seeded byte flipped before its checksums are verified, and a pipeline
that is built while a ``BreakPrefetch`` is scheduled fetches synchronously.

Tracing (``obs=``, shared with the engine): a ``store.fetch`` span per
slice read (on the thread that reads it, so the prefetch thread has its own
trace lane) with the modeled read time, a ``store.wait`` span per slice
handed to the compute, a fenced ``launch.disk_block`` span per block body
with the plan's predicted cost, and the ``store.*`` counters.  The executor
and the pipeline read their recorder when they record, so one swapped in
later (``PMVEngine.explain(live=True)``) takes effect at once.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import BrokenExecutor, CancelledError, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import collectives, cost_model, placement, sparse_exchange
from repro_torch.core.gimv import GimvSpec, combine_elementwise, tree_combine
from repro_torch.core.partition import Partition
from repro_torch.core.planner import ExecutionPlan
from repro_torch.exchange import runtime as packed_rt
from repro_torch.faults import DEFAULT_RETRY, RetryPolicy, as_injector
from repro_torch.kernels import plain_versions
from repro_torch.obs.recorder import as_recorder
from repro_torch.store import format as fmt
from repro_torch.store.manifest import (
    Manifest,
    ShardCorruptError,
    open_store,
    row_weights,
    row_weights_dense,
)

__all__ = ["RESIDENCY_MODES", "DiskBlockStore", "DiskExecutor", "DiskLeg",
           "HybridDiskExecutor", "PrefetchPipeline", "ResidencyStats", "make_disk_step"]

RESIDENCY_MODES = cost_model.RESIDENCY_MODES


@dataclasses.dataclass
class ResidencyStats:
    """Per-iteration I/O accounting of the disk executor."""

    bytes_read: int = 0
    blocks_fetched: int = 0
    blocks_skipped: int = 0
    io_s: float = 0.0          # wall time spent inside fetches
    wait_s: float = 0.0        # wall time the compute loop blocked on a fetch
    compute_s: float = 0.0
    # the fetches' host legs (parts of io_s): the copy of the rows out of the
    # memmaps, their checksums, the recomputed weights
    read_s: float = 0.0
    verify_s: float = 0.0
    weights_s: float = 0.0
    # CUDA (start, end) event pairs of the slices' host-to-device copies
    h2d: list = dataclasses.field(default_factory=list)
    # copy seconds already read off their events (an SPMD group's: the
    # events stay on their ranks)
    h2d_timed_s: float = 0.0

    @property
    def overlap(self) -> float:
        """Fraction of fetch time hidden behind compute by the double
        buffer (1.0 = fully overlapped)."""
        if self.io_s <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.wait_s / self.io_s)

    @property
    def h2d_s(self) -> float:
        """Device time of the slices' host-to-device copies (waits for any
        copy still in flight)."""
        total = self.h2d_timed_s
        for start, end in self.h2d:
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
        return total


class DiskBlockStore:
    """Memmap-backed shard access at block-slice granularity, with a
    residency budget.

    The fetch unit is one scheduled block's slice across all b workers:
    vertical -- destination block i's rows ([b, E_cap] seg / gat + counts,
    plus the per-spec weights recomputed from the stored out-degrees);
    horizontal -- source block jj's rows; the hybrid pair the same over the
    θ-split regions (a ``dense_horizontal`` store needs the dense region's
    ``dense_gather_idx`` to recompute its weights).  Only the double buffer
    (the slice being computed and the one prefetched) is resident, so peak host bytes
    stay O(b * E_cap) however large the block set is; ``budget_bytes`` makes
    that bound an enforced contract.  ``device`` is where fetched slices are
    handed to the compute: on a CUDA device through two pinned host buffers
    (the budgeted double buffer itself) and a side stream.  ``obs`` (a
    recorder, or None) receives the fetch spans and the store counters.
    ``faults`` (a FaultPlan or a shared FaultInjector) injects into every
    fetch; ``fault_scope`` is the worker id a scoped fault event must name
    to fire here (None: a single store, where unscoped events fire).
    ``verify`` None checks every fetch against the manifest's digests when
    it has them; True requires them, False skips the checks.  A per-host
    shard view (``Manifest.worker_shard_view``) opens only the stripe files
    of the workers it owns, and its slices hold their rows alone.
    """

    def __init__(self, store, striping: str, spec: GimvSpec, *,
                 budget_bytes: int | None = None, device=None, dense_gather_idx=None,
                 obs=None, faults=None, fault_scope: int | None = None,
                 verify: bool | None = None):
        if striping not in fmt.STRIPINGS:
            raise ValueError(f"unknown striping {striping!r}")
        if striping == "dense_horizontal" and dense_gather_idx is None:
            raise ValueError(
                "dense_horizontal stripes need the dense-region gather index "
                "to recompute weights (pass dense_gather_idx)")
        self.dense_gather_idx = dense_gather_idx
        self.obs = as_recorder(obs)
        self.faults = as_injector(faults, self.obs)
        self.fault_scope = fault_scope
        self.manifest: Manifest = open_store(store)
        self.striping = striping
        self.spec = spec
        self.part: Partition = self.manifest.part
        self.device = torch.device("cpu") if device is None else torch.device(device)
        b = self.manifest.b
        self.workers = list(self.manifest.owned_workers(default=range(b)))
        # verify=None: fetches are verified whenever the manifest carries
        # digests (pre-checksum stores keep working, unverified)
        if verify is None:
            verify = self.manifest.checksums is not None
        if verify and self.manifest.checksums is None:
            raise ValueError(
                "verify=True but the store has no checksums — re-ingest it "
                "(repro_torch.store.ingest_edges digests every shard)")
        self.verify = verify
        self._sums = ([self.manifest.stripe_checksums(striping, w) for w in self.workers]
                      if self.verify else None)
        self._algo = self.manifest.checksum_algorithm
        self._mm = [self.manifest.stripe_arrays(striping, w, mmap=True) for w in self.workers]
        # counts are [b] int32 per worker: tiny, kept resident (and on the
        # device) so the schedule skips empty blocks without touching the
        # edge shards.  They and the degree array are read once, so they are
        # verified here rather than per fetch.
        self._cnt = np.stack([np.asarray(mm[2]) for mm in self._mm])  # [b_w, b]
        if self.verify:
            for wi, w in enumerate(self.workers):
                expected = self._sums[wi]["cnt"]
                actual = fmt.checksum_array(self._cnt[wi], self._algo)
                if actual != expected:
                    raise ShardCorruptError(
                        fmt.stripe_path(self.manifest.root, striping, w, "cnt"),
                        array="cnt", worker=w, expected=expected, actual=actual)
            self.manifest.verify_array("out_deg")
            self.manifest.verify_array(fmt.nnz_array_of(striping))
        self._cnt_t = torch.from_numpy(self._cnt).to(self.device)
        self.out_deg = np.asarray(self.manifest.array("out_deg"))
        self.block_nnz = np.asarray(self.manifest.array(fmt.nnz_array_of(striping)))
        self.e_cap = self.manifest.e_cap_of(striping)
        frac = len(self.workers) / b
        self.total_bytes = int(self.manifest.total_shard_bytes(striping) * frac)
        # RESIDENT bytes per fetched slice: seg + gat read from disk plus the
        # recomputed weight array when the spec needs one (in RAM, not read).
        self.slice_bytes = cost_model.stripe_slice_bytes(
            len(self.workers), self.e_cap, has_w=spec.needs_weights)
        self.budget_bytes = budget_bytes
        if budget_bytes is not None and 2 * self.slice_bytes > budget_bytes:
            raise ValueError(
                f"residency budget {budget_bytes} B cannot hold the double "
                f"buffer (2 x {self.slice_bytes} B block slices) — raise the "
                "budget or increase b so block slices shrink")
        self.peak_resident_bytes = 0
        # bytes of the slices staged on a CUDA device (two in flight at
        # most: the one being computed and the one prefetched); 0 on the CPU,
        # where the host arrays are used in place.
        self.device_buffer_bytes = 0
        # sticky: set when the prefetch thread failed and fetches went
        # synchronous.
        self.prefetch_degraded = False
        self.stats = ResidencyStats()
        self._staging = _PinnedStaging(self) if self.device.type == "cuda" else None

    def begin_iteration(self) -> None:
        self.stats = ResidencyStats()

    def make_pipeline(self, schedule, retry: RetryPolicy = DEFAULT_RETRY) -> "PrefetchPipeline":
        """The prefetch pipeline serving this store; executors always build
        theirs through it."""
        return PrefetchPipeline(self, schedule, retry)

    def _verify_rows(self, k: int, seg: np.ndarray, gat: np.ndarray) -> None:
        """Check the fetched rows against the manifest's per-row digests;
        raises ShardCorruptError naming the shard file, worker and block row
        of the first mismatch."""
        for wi, w in enumerate(self.workers):
            sums = self._sums[wi]
            for name, arr in (("seg", seg[wi]), ("gat", gat[wi])):
                expected = sums[name][k]
                actual = fmt.checksum_array(arr, self._algo)
                if actual != expected:
                    self.obs.counter("store.verify_failures").add(1)
                    raise ShardCorruptError(
                        fmt.stripe_path(self.manifest.root, self.striping, w, name),
                        array=name, worker=w, block=k, expected=expected, actual=actual)

    def fetch(self, k: int) -> dict:
        """Block k's shard slice across workers, as tensors on the store's
        device: seg / gat [b_w, E_cap] int32, cnt [b_w] int32, w [b_w, E_cap]
        float32 | None; on a CUDA device also the copy's ``event``, which
        the consumer waits on (:func:`_ready`).

        Raises :class:`ShardCorruptError` when the read bytes do not match
        the ingest-time digests, and ``OSError`` on I/O failure: both
        retryable (the caller's RetryPolicy re-fetches)."""
        obs = self.obs
        if self.faults is not None:
            # may raise InjectedIOError or sleep; outside the fetch span, as
            # in the JAX package
            self.faults.on_fetch(k, scope=self.fault_scope)
        with obs.span("store.fetch") as sp:
            if self._staging is not None:
                sl = self._staging.fetch(k)
            else:
                b_w, e_cap = len(self.workers), self.e_cap
                seg = np.empty((b_w, e_cap), np.int32)
                gat = np.empty((b_w, e_cap), np.int32)
                w = np.empty((b_w, e_cap), np.float32) if self.spec.needs_weights else None
                read, times = self._read(k, seg, gat, w)
                sl = {"seg": torch.from_numpy(seg), "gat": torch.from_numpy(gat),
                      "w": None if w is None else torch.from_numpy(w),
                      "cnt": self._cnt_t[:, k], "nbytes": read, "times": times}
            read = sl["nbytes"]
            sp.set("block", k)
            sp.set("bytes", read)
            sp.set("predicted_s", cost_model.disk_io_seconds(read))
        obs.counter("store.bytes_read").add(read)
        obs.counter("store.blocks_fetched").add(1)
        return sl

    def _read(self, k: int, seg: np.ndarray, gat: np.ndarray, w: np.ndarray | None):
        """Read block k's rows into the host arrays seg / gat, verify them,
        recompute the weights into w.  Returns (bytes read, the seconds of
        each leg as ResidencyStats field names)."""
        t0 = time.perf_counter()
        np.stack([mm[0][k] for mm in self._mm], out=seg)
        np.stack([mm[1][k] for mm in self._mm], out=gat)
        cnt = self._cnt[:, k]
        if self.faults is not None:
            # a scheduled byte flip, BEFORE verification: a checksummed store
            # must catch it
            self.faults.corrupt_slice(k, {"seg": seg, "gat": gat}, scope=self.fault_scope)
        t1 = time.perf_counter()
        if self.verify:
            self._verify_rows(k, seg, gat)
        t2 = time.perf_counter()
        if w is not None:
            self._row_weights(k, gat, cnt, out=w)
        t3 = time.perf_counter()
        read = seg.nbytes + gat.nbytes + cnt.nbytes
        resident = read + (0 if w is None else w.nbytes)
        self.peak_resident_bytes = max(self.peak_resident_bytes, 2 * resident)
        return read, {"read_s": t1 - t0, "verify_s": t2 - t1, "weights_s": t3 - t2}

    def _row_weights(self, k: int, gat: np.ndarray, cnt: np.ndarray, out: np.ndarray) -> None:
        """Per-spec matrix values of the fetched rows, recomputed host-side
        exactly as partition time computes them (never stored).  Vertical
        stripings read source block = the stripe's worker id; horizontal
        reads source block = the fetched block k; dense_horizontal's gather
        column holds compact dense SLOTS, resolved to local ids through the
        dense-region gather index first."""
        if self.striping == "dense_horizontal":
            rows = [row_weights_dense(self.spec, self.part, k, gat[wi], cnt[wi], self.out_deg,
                                      self.dense_gather_idx)
                    for wi in range(len(self.workers))]
        else:
            vertical = self.striping in ("vertical", "sparse_vertical")
            rows = [row_weights(self.spec, self.part, w if vertical else k, gat[wi], cnt[wi],
                                self.out_deg)
                    for wi, w in enumerate(self.workers)]
        np.stack(rows, out=out)


class _PinnedStaging:
    """The CUDA side of :meth:`DiskBlockStore.fetch`: two pinned host slots
    (the budgeted double buffer) filled in turn, each copied to the device
    on a side stream.  A slot is written again only after its last copy
    has completed (its event is synchronized first), and the lock keeps two
    fetches (the prefetch thread's and an inline one) from sharing a slot."""

    def __init__(self, store: DiskBlockStore):
        self.store = store
        b_w, e_cap = len(store.workers), store.e_cap
        has_w = store.spec.needs_weights

        def pinned(dtype):
            return torch.empty((b_w, e_cap), dtype=dtype, pin_memory=True)

        self.slots = [{"seg": pinned(torch.int32), "gat": pinned(torch.int32),
                       "w": pinned(torch.float32) if has_w else None} for _ in range(2)]
        self.events: list = [None, None]
        self.next = 0
        self.stream = torch.cuda.Stream(device=store.device)
        self.lock = threading.Lock()
        store.device_buffer_bytes = 2 * sum(
            t.numel() * t.element_size() for t in self.slots[0].values() if t is not None)

    def fetch(self, k: int) -> dict:
        store = self.store
        with self.lock:
            s = self.next
            self.next = 1 - s
            if self.events[s] is not None:
                self.events[s].synchronize()
            slot = self.slots[s]
            w = slot["w"]
            read, times = store._read(k, slot["seg"].numpy(), slot["gat"].numpy(),
                                      None if w is None else w.numpy())
            with torch.cuda.stream(self.stream):
                start = torch.cuda.Event(enable_timing=True)
                start.record(self.stream)
                out = {name: None if t is None else t.to(store.device, non_blocking=True)
                       for name, t in slot.items()}
                event = torch.cuda.Event(enable_timing=True)
                event.record(self.stream)
            self.events[s] = event
        out.update(cnt=store._cnt_t[:, k], nbytes=read, times=times, event=event,
                   h2d=(start, event))
        return out


def _ready(sl: dict) -> tuple:
    """(seg, gat, w, cnt) of a fetched slice, usable on the current stream:
    on a CUDA device the current stream waits for the slice's copy, and the
    copied tensors are recorded as used there, so the caching allocator
    does not hand their memory to the side stream while the compute still
    reads them."""
    event = sl.get("event")
    if event is not None:
        stream = torch.cuda.current_stream(sl["seg"].device)
        stream.wait_event(event)
        for name in ("seg", "gat", "w"):
            if sl[name] is not None:
                sl[name].record_stream(stream)
    return sl["seg"], sl["gat"], sl["w"], sl["cnt"]


class PrefetchPipeline:
    """Double-buffered prefetch over an ENDLESSLY REPEATING launch schedule.

    One pipeline lives as long as its executor: a cursor walks the schedule
    modulo its length, keeping one fetch in flight behind the block being
    computed.  After the last block of iteration *t* is handed out, the next
    submit is iteration *t+1*'s FIRST block, so the exchange / assign tail
    and the convergence check of iteration *t* overlap the disk leg of *t+1*.

    Every fetch runs under ``retry`` whether it happens on the prefetch
    thread or inline.  If the prefetch THREAD fails (the pool refuses a
    submit, or a future dies of executor breakage) the pipeline degrades to
    synchronous fetches instead of deadlocking or failing the solve
    (``store.prefetch_degraded``); so does a pipeline built while the
    store's injector holds a ``BreakPrefetch``.  Fetch errors that survive the retry
    budget propagate typed (ShardCorruptError / OSError /
    FetchDeadlineError).

    I/O accounting happens at CONSUMPTION time into the store's *current*
    ``ResidencyStats``: a slice prefetched during iteration *t* but consumed
    by iteration *t+1* bills its bytes / io / wait to *t+1*.
    """

    def __init__(self, store: DiskBlockStore, schedule: list[int],
                 retry: RetryPolicy = DEFAULT_RETRY):
        self.store = store
        self.schedule = list(schedule)
        self.retry = retry
        self._ex = ThreadPoolExecutor(max_workers=1) if self.schedule else None
        self._fut = None                 # (block, future) in flight
        self._cursor = 0                 # next schedule position, mod len
        self._sync = False
        inj = store.faults
        if inj is not None and inj.break_prefetch(store.fault_scope):
            self._degrade()

    @property
    def obs(self):
        """The store's recorder, read at each use (the pipeline outlives a
        recorder swapped onto the store)."""
        return self.store.obs

    def _degrade(self) -> None:
        if not self._sync:
            self._sync = True
            self.store.prefetch_degraded = True
            self.obs.counter("store.prefetch_degraded").add(1)

    def _timed_fetch(self, k: int):
        t0 = time.perf_counter()
        sl = self.retry.call(lambda: self.store.fetch(k), obs=self.obs, label="fetch")
        return sl, time.perf_counter() - t0

    def _next_block(self) -> int:
        k = self.schedule[self._cursor % len(self.schedule)]
        self._cursor += 1
        return k

    def _submit(self) -> None:
        if self._sync or self._fut is not None or self._ex is None:
            return
        k = self.schedule[self._cursor % len(self.schedule)]
        try:
            fut = self._ex.submit(self._timed_fetch, k)
        except RuntimeError:     # pool shut down / cannot take work
            self._degrade()
            return
        self._cursor += 1
        self._fut = (k, fut)

    def iteration(self):
        """Yield (block, slice) for ONE pass over the schedule."""
        obs = self.obs
        for _ in range(len(self.schedule)):
            self._submit()
            t0 = time.perf_counter()
            with obs.span("store.wait"):
                if self._fut is None:
                    k = self._next_block()
                    sl, io_s = self._timed_fetch(k)
                else:
                    k, fut = self._fut
                    self._fut = None
                    try:
                        sl, io_s = fut.result()
                    except (BrokenExecutor, CancelledError):
                        self._degrade()
                        sl, io_s = self._timed_fetch(k)
            wait = time.perf_counter() - t0
            stats = self.store.stats     # the CURRENT iteration's record
            stats.wait_s += wait
            stats.io_s += io_s
            stats.bytes_read += sl["nbytes"]
            stats.blocks_fetched += 1
            for leg, t in sl["times"].items():
                setattr(stats, leg, getattr(stats, leg) + t)
            if "h2d" in sl:
                stats.h2d.append(sl["h2d"])
            obs.counter("store.io_s").add(io_s)
            obs.counter("store.wait_s").add(wait)
            self._submit()               # may cross into the next iteration
            yield k, sl

    def close(self) -> None:
        """Stop prefetching.  A fetch in flight runs to its end first, so
        nothing records into the store's recorder once this returns."""
        self._fut = None
        if self._ex is not None:
            self._ex.shutdown(wait=True)
        self._ex = None
        self._sync = True


def _summed(records) -> ResidencyStats:
    """ResidencyStats summed field by field."""
    first, *rest = records
    return ResidencyStats(**{f.name: sum((getattr(r, f.name) for r in rest),
                                         getattr(first, f.name))
                             for f in dataclasses.fields(ResidencyStats)})


@dataclasses.dataclass
class DiskLeg:
    """One striping a disk executor streams: its store, the blocks it walks
    each iteration in launch order (blocks with no edge are skipped: they
    contribute the identity without any I/O), and its prefetch pipeline,
    made lazily by the store and kept across iterations so the tail of
    iteration t overlaps the first fetch of t+1."""

    store: DiskBlockStore
    schedule: list
    pipeline: PrefetchPipeline | None = None
    # the leg's finished iterations' I/O, summed without the copies' events
    # (see run_stats)
    finished: ResidencyStats = dataclasses.field(default_factory=ResidencyStats)

    @classmethod
    def walking(cls, store: DiskBlockStore, by: str) -> "DiskLeg":
        """The leg over ``store`` walking its non-empty destination blocks
        (``by='destination'``, vertical) or source blocks (``'source'``)."""
        nnz = store.block_nnz
        rows = nnz if by == "destination" else nnz.T
        return cls(store, [k for k in range(nnz.shape[0]) if rows[k].any()])

    @property
    def skipped(self) -> int:
        return self.store.block_nnz.shape[0] - len(self.schedule)

    def begin_iteration(self) -> None:
        self.finished = dataclasses.replace(_summed([self.finished, self.store.stats]), h2d=[])
        self.store.begin_iteration()
        self.store.stats.blocks_skipped = self.skipped

    def run_stats(self) -> ResidencyStats:
        """The leg's I/O summed over every iteration so far, the current one
        included (``h2d`` holds only the current iteration's copies)."""
        return _summed([self.finished, self.store.stats])

    def prefetched(self, retry: RetryPolicy):
        """One schedule pass off the leg's persistent prefetch pipeline."""
        if self.pipeline is None:
            self.pipeline = self.store.make_pipeline(self.schedule, retry)
        return self.pipeline.iteration()

    def close(self) -> None:
        if self.pipeline is not None:
            self.pipeline.close()
            self.pipeline = None


class DiskExecutor:
    """Runs one prepared solve's per-iteration compute against a
    DiskBlockStore, one scheduled block at a time: vertical walks the
    non-empty destination blocks, horizontal the non-empty source blocks.
    ``legs`` holds the striping it streams (the hybrid executor adds a
    second).  ``obs`` receives one fenced ``launch.disk_block`` span per
    block body.

    ``axis`` (a ``collectives.WorkerAxis``) runs the executor as one rank of
    an SPMD solve: ``store`` is then the rank's ``SpmdDiskGroup``, v and the
    slices hold the rank's b_w workers' rows, and the tails cross the ranks
    (the compact or packed exchange all-to-all, the horizontal v and the
    dense region's v_d gathered, the counts summed); None, the emulated
    solve of all b workers, where each of those is the leading-axis
    operation it always was.  ``interpret`` folds the tails with the scatter
    kernels' plain versions (the engine's ``pallas_interpret=True``)."""

    def __init__(self, spec: GimvSpec, part: Partition, plan: ExecutionPlan | None,
                 store: DiskBlockStore, *, capacity: int | None = None,
                 scatter: str = "segment", retry: RetryPolicy | None = None,
                 exchange: str = "sparse", xchg: dict | None = None, xplan=None, obs=None,
                 axis=None, interpret: bool = False):
        self.spec = spec
        self.interpret = interpret
        self.axis = axis
        self.obs = as_recorder(obs)
        self.part = part
        self.plan = plan
        self.store = store
        self.capacity = capacity
        self.scatter = scatter
        self.retry = retry if retry is not None else DEFAULT_RETRY
        self.exchange = exchange
        self.xchg = xchg
        self.xplan = xplan
        if exchange == "packed":
            assert plan.strategy == "vertical", "packed exchange is vertical-only"
            assert xchg is not None and xplan is not None, \
                "packed exchange needs the prepare-built index arrays and plan"
        # no plan: the hybrid's sparse leg, which walks as vertical does
        if plan is None or plan.strategy == "vertical":
            assert capacity is not None
            self.cap_eff = min(capacity, part.n_local)
            self.legs = [DiskLeg.walking(store, "destination")]
        else:
            self.legs = [DiskLeg.walking(store, "source")]
        # static per-launch span attributes (the plan's predicted costs),
        # built once so the hot loop never allocates them, and built with
        # obs off too, so a recorder swapped in later still gets them; the
        # hybrid (no plan) records its launches without attributes
        self._launch_attrs: dict = {}
        if plan is not None:
            axis = "dest" if plan.strategy == "vertical" else "src"
            self._launch_attrs = {k: plan.launch_attrs(k, axis=axis)
                                  for k in self.legs[0].schedule}

    def _begin_iteration(self) -> None:
        for leg in self.legs:
            leg.begin_iteration()

    def close(self) -> None:
        for leg in self.legs:
            leg.close()

    def _blocks(self, body, leg: DiskLeg | None = None):
        """Run ``body(block, seg, gat, w, cnt)`` on every block of one pass
        over ``leg`` (default: the first) as it comes off the leg's
        pipeline, charging its time to the leg's compute_s.  On a CUDA
        device the compute stream is synchronized after each block, so
        compute_s and wait_s split the iteration's wall time honestly, and a
        block's temporaries are freed before the next block's arrive."""
        leg = self.legs[0] if leg is None else leg
        store = leg.store
        cuda = store.device.type == "cuda"
        obs = self.obs
        out = {}
        for k, sl in leg.prefetched(self.retry):
            t0 = time.perf_counter()
            with obs.span("launch.disk_block", self._launch_attrs.get(k)):
                out[k] = obs.fence(body(k, *_ready(sl)))
            del sl
            if cuda:
                torch.cuda.current_stream(store.device).synchronize()
            store.stats.compute_s += time.perf_counter() - t0
        return out

    def _full(self, shape, v) -> torch.Tensor:
        return torch.full(shape, self.spec.identity, dtype=v.dtype, device=v.device)

    def _compact_blocks(self, v):
        """The compact exchange's send side, from disk: per scheduled
        destination block its compact slice; a skipped block's slice is pure
        padding, exactly what compacting its zero-edge partial yields.
        Stacked by destination block, which is the exchange's receive order
        in emulation: (idx [b, b_w, cap], val [b, b_w, cap(, Q)], overflow,
        logical), the counts summed over the worker axis."""
        spec, n_local, cap = self.spec, self.part.n_local, self.capacity
        b, b_w = self.part.b, v.shape[0]

        def body(_i, seg, gat, w, cnt):
            return placement.single_block_compact(spec, seg, gat, w, cnt, v, n_local, cap)

        got = self._blocks(body)
        idx_pad = torch.full((b_w, self.cap_eff), n_local, dtype=torch.int32, device=v.device)
        val_pad = self._full((b_w, self.cap_eff) + tuple(v.shape[2:]), v)
        idx = torch.stack([got[i][0] if i in got else idx_pad for i in range(b)])
        val = torch.stack([got[i][1] if i in got else val_pad for i in range(b)])
        zero = torch.zeros((), device=v.device)
        over = sum((g[2] for g in got.values()), zero)
        logical = sum((g[3] for g in got.values()), zero)
        return idx, val, collectives.psum(over, self.axis), collectives.psum(logical, self.axis)

    def _to_owners(self, x):
        """A compact exchange buffer stacked by destination ([b, b_w, ...],
        ``_compact_blocks``) -> the rank's destinations' rows from every
        sender [b_w, b, ...], the scatter's input.  Emulation: ``x``, which
        is already in receive order."""
        if self.axis is None:
            return x
        return collectives.all_to_all(x.transpose(0, 1), self.axis)

    def _packed_blocks(self, v):
        """The packed exchange's send side, from disk, and the exchange: per
        scheduled destination block its partial gathered at the static send
        order (no (idx, val) compaction; a skipped block's payload is the
        identity), stacked [b_w, b, p(, Q)] and sent all-to-all.  Returns
        (the rank's received payload [b_w, b, p(, Q)], logical), the count
        summed over the worker axis."""
        spec, n_local = self.spec, self.part.n_local
        send_rows = self.xchg["send_rows"]
        b, b_w = self.part.b, v.shape[0]

        def body(i, seg, gat, w, cnt):
            partial = placement.single_block_partial(spec, seg, gat, w, cnt, v, n_local)
            pay = packed_rt.gather_payload(spec, partial[:, None], send_rows[:, i:i + 1])
            return pay[:, 0], sparse_exchange.count_non_identity(spec, pay)

        got = self._blocks(body)
        pad = self._full((b_w, self.xplan.p_dev) + tuple(v.shape[2:]), v)
        val = torch.stack([got[i][0] if i in got else pad for i in range(b)], dim=1)
        logical = sum((lg for _, lg in got.values()), torch.zeros((), device=v.device))
        return collectives.all_to_all(val, self.axis), collectives.psum(logical, self.axis)

    def _vertical_iteration_packed(self, v, ctx, mask):
        """One vertical iteration through the packed exchange: the payloads
        from disk (``_packed_blocks``), then the payload-only scatter tail."""
        self._begin_iteration()
        val, logical = self._packed_blocks(v)
        with plain_versions(self.interpret):
            r = packed_rt.scatter_payload(
                self.spec, val, self.part.n_local,
                recv_rows=self.xchg.get("recv_rows"), recv_words=self.xchg.get("recv_words"),
                p_dev=self.xplan.p_dev, width=self.xplan.width_dev, method=self.scatter)
        v_new = placement.apply_assign(self.spec, v, r, ctx, mask)
        # payload slots are structurally sized: overflow is impossible
        return v_new, r, torch.zeros((), device=v.device), logical

    def vertical_iteration(self, v, ctx, mask):
        """One vertical iteration: per-block compact compute from disk, then
        the shared exchange / scatter / assign tail.  Returns (v_new, r,
        overflow, logical)."""
        if self.exchange == "packed":
            return self._vertical_iteration_packed(v, ctx, mask)
        self._begin_iteration()
        idx, val, over, logical = self._compact_blocks(v)
        with plain_versions(self.interpret):
            r = sparse_exchange.scatter_partials(self.spec, self._to_owners(idx),
                                                 self._to_owners(val), self.part.n_local,
                                                 method=self.scatter)
        v_new = placement.apply_assign(self.spec, v, r, ctx, mask)
        return v_new, r, over, logical

    def horizontal_iteration(self, v, ctx, mask):
        """One horizontal iteration streaming the gather per source block.

        Contributions are collected per source block as they come off disk
        and folded ONCE, in block-index order, with the same pairwise tree
        ``gathered_gimv`` uses (skipped blocks contribute the identity the
        resident path computes for them), so the result is the resident
        horizontal step's whatever order the schedule walked the blocks in.
        Returns (v_new, r)."""
        spec, n_local = self.spec, self.part.n_local
        self._begin_iteration()
        v_all = collectives.all_gather(v, self.axis)        # [b, n_local(, Q)]

        def body(jj, seg, gat, w, cnt):
            return placement.single_block_contrib(spec, seg, gat, w, cnt, v_all[jj], n_local)

        got = self._blocks(body)
        pad = self._full(v.shape, v)
        r = tree_combine(spec, [got.get(jj, pad) for jj in range(self.part.b)])
        return placement.apply_assign(spec, v, r, ctx, mask), r

    def _io_record(self) -> ResidencyStats:
        """The current iteration's I/O record, summed over the legs."""
        return _summed([leg.store.stats for leg in self.legs])

    def io_stats(self) -> dict:
        # under an axis, first each leg's fleet figures (one gather a leg):
        # the record below then reads the W workers' aggregates
        worker = ([leg.store.worker_io_stats() for leg in self.legs]
                  if self.axis is not None else [])
        s = self._io_record()
        out = {
            "store_bytes_read": float(s.bytes_read),
            "store_blocks_fetched": float(s.blocks_fetched),
            "store_blocks_skipped": float(s.blocks_skipped),
            "store_io_s": s.io_s,
            "store_wait_s": s.wait_s,
            "store_compute_s": s.compute_s,
            "store_overlap": s.overlap,
            # the port's split of store_io_s (and, on a GPU, the copies'
            # device time), which the JAX package does not report
            "store_read_s": s.read_s,
            "store_verify_s": s.verify_s,
            "store_weights_s": s.weights_s,
            "store_h2d_s": s.h2d_s,
        }
        if worker:
            out.update(_worker_io_sum(worker))
        return out

    def _sparse_stats(self, nq: int | None, vb: int, over, logical) -> dict:
        """The compact exchange's per-iteration stats, as the resident
        step's ``_compact_exchange`` counts them."""
        b = self.part.b
        id_b, pay_b = sparse_exchange.exchange_wire_split(b, self.capacity, nq, vb)
        return {
            "gathered_elems": 0.0,
            # the unclamped capacity, as the resident step counts it
            # (compact_partials clamps the buffers)
            "exchanged_elems": float(b * (b - 1) * self.capacity * (1 + (nq or 1))),
            "gathered_bytes": 0.0,
            "exchanged_bytes": sparse_exchange.exchange_wire_bytes(b, self.capacity, nq, vb),
            # the padded stream re-ships its int32 ids EVERY iteration
            "exchange_id_bytes": id_b,
            "exchange_payload_bytes": pay_b,
            "logical_elems": logical,
            "overflow": over,
        }

    def iteration(self, v, ctx, mask):
        """One full out-of-core iteration (single vector or trailing-Q
        batched): (v_new, r, stats) with the resident placements' stats keys
        plus the store_* I/O accounting."""
        b, n_local = self.part.b, self.part.n_local
        nq = v.shape[-1] if v.ndim == 3 else None
        vb = np.dtype(self.spec.dtype).itemsize
        if self.plan.strategy == "vertical":
            v_new, r, over, logical = self.vertical_iteration(v, ctx, mask)
            if self.exchange == "packed":
                xp = self.xplan
                pay_b = xp.payload_bytes_per_iter(nq, vb)
                stats = {  # values only on the wire; ids shipped once
                    "gathered_elems": 0.0,
                    "exchanged_elems": float(b * (b - 1) * xp.p_dev * (nq or 1)),
                    "gathered_bytes": 0.0,
                    "exchanged_bytes": pay_b,
                    "exchange_id_bytes": float(xp.id_bytes),
                    "exchange_payload_bytes": pay_b,
                    "logical_elems": logical,
                    "overflow": over,
                }
            else:
                stats = self._sparse_stats(nq, vb, over, logical)
        else:
            v_new, r = self.horizontal_iteration(v, ctx, mask)
            stats = {
                "gathered_elems": float(b * (b - 1) * n_local * (nq or 1)),
                "exchanged_elems": 0.0,
                "gathered_bytes": float(b * (b - 1) * n_local * (nq or 1) * vb),
                "exchanged_bytes": 0.0,
            }
        stats.update(self.io_stats())
        return v_new, r, stats


class HybridDiskExecutor(DiskExecutor):
    """θ-split hybrid solve from disk (``strategy='hybrid'`` under
    ``residency='disk'``), over the two stripings the hybrid ingest wrote.

    The dense region's ``dense_horizontal`` stripes stream per SOURCE block
    against the compact dense slice ``v_d`` (``v`` gathered at the region's
    ``gather_idx``), their contributions keyed by block and folded in block
    order with the pairwise tree; the sparse region's ``sparse_vertical``
    stripes run the vertical compact path per destination block; one tail
    scatters the sparse partials and combines them elementwise with the
    dense leg, sparse first, before the assign -- the two legs the resident
    ``hybrid_step`` fuses, so the result is bitwise that step's on the CPU.
    ``legs`` is (sparse, dense), each with its own store (budget, pinned
    slots, side stream) and prefetch pipeline; the dense leg runs first, so
    its next-iteration prefetch overlaps the whole sparse leg.  The summed
    ``store_io_s`` adds both legs' fetch time, which their two threads spend
    at once, so the summed ``store_overlap`` is not the share of I/O hidden
    behind compute; ``DiskLeg.run_stats`` gives each leg's own.  The
    schedule is structural (no planner plan): both legs fold independently
    of the launch order.
    """

    def __init__(self, spec: GimvSpec, part: Partition, sparse_store: DiskBlockStore,
                 dense_store: DiskBlockStore, region, *, capacity: int,
                 scatter: str = "segment", retry: RetryPolicy | None = None, obs=None,
                 axis=None, interpret: bool = False):
        super().__init__(spec, part, None, sparse_store, capacity=capacity, scatter=scatter,
                         retry=retry, obs=obs, axis=axis, interpret=interpret)
        self.legs.append(DiskLeg.walking(dense_store, "source"))
        self.region = region
        # [b_w, d_cap]: the rank's workers' rows
        gather_idx = np.asarray(region.gather_idx, dtype=np.int64)[
            collectives.own_slice(axis, part.b)]
        self._gather_idx = torch.from_numpy(gather_idx).to(sparse_store.device)

    def iteration(self, v, ctx, mask):
        """One hybrid out-of-core iteration: (v_new, r, stats) with the
        resident hybrid step's stats keys plus the store_* I/O accounting
        over both legs."""
        spec, n_local, b = self.spec, self.part.n_local, self.part.b
        nq = v.shape[-1] if v.ndim == 3 else None
        vb = np.dtype(spec.dtype).itemsize
        self._begin_iteration()
        gidx = self._gather_idx if nq is None else self._gather_idx[:, :, None].expand(-1, -1, nq)
        v_d = collectives.all_gather(torch.gather(v, 1, gidx), self.axis)   # [b, d_cap(, Q)]

        def dense_body(jj, seg, gat, w, cnt):
            return placement.single_block_contrib(spec, seg, gat, w, cnt, v_d[jj], n_local)

        got = self._blocks(dense_body, self.legs[1])
        pad = self._full(v.shape, v)
        r_dense = tree_combine(spec, [got.get(jj, pad) for jj in range(b)])
        del got, pad, v_d
        idx, val, over, logical = self._compact_blocks(v)
        with plain_versions(self.interpret):
            r_sparse = sparse_exchange.scatter_partials(spec, self._to_owners(idx),
                                                        self._to_owners(val), n_local,
                                                        method=self.scatter)
        r = combine_elementwise(spec, r_sparse, r_dense)
        v_new = placement.apply_assign(spec, v, r, ctx, mask)
        d_cap = self.region.d_cap
        stats = self._sparse_stats(nq, vb, over, logical)
        stats["gathered_elems"] = float(b * (b - 1) * d_cap * (nq or 1))
        stats["gathered_bytes"] = float(b * (b - 1) * d_cap * (nq or 1) * vb)
        stats.update(self.io_stats())
        return v_new, r, stats


def _worker_io_sum(legs: list[dict]) -> dict:
    """The ``store_worker_*`` lists of an executor's legs, summed worker by
    worker (the degraded flag: any leg's), each overlap from the summed
    fetch and wait seconds, as the JAX package's hybrid executor sums its
    two legs'."""
    def total(key):
        return [float(sum(xs)) for xs in zip(*(leg[key] for leg in legs))]

    io, wait = total("store_worker_io_s"), total("store_worker_wait_s")
    return {
        "store_worker_bytes_read": total("store_worker_bytes_read"),
        "store_worker_io_s": io,
        "store_worker_wait_s": wait,
        "store_worker_overlap": [1.0 if i <= 0.0 else max(0.0, 1.0 - w / i)
                                 for w, i in zip(wait, io)],
        "store_worker_blocks_fetched": total("store_worker_blocks_fetched"),
        "store_worker_prefetch_degraded": [
            float(max(xs)) for xs in zip(*(leg["store_worker_prefetch_degraded"]
                                            for leg in legs))],
    }


def make_disk_step(spec: GimvSpec, executor: DiskExecutor):
    """Engine-compatible step(matrix, v, ctx, mask) -> (v_new, r, stats) for
    residency='disk' (``matrix`` is unused: the executor owns the shard
    access)."""
    del spec  # carried by the executor

    def step(matrix, v, ctx, mask):
        del matrix
        return executor.iteration(v, ctx, mask)

    return step
