"""The solves of ``chip_smoke.py`` at a small scale on the CPU: the same
knobs (b=8, backend='auto', PageRank/selective, SSSP/vertical with the
scatter kernel, CC/hybrid on the symmetrized edges, PageRank/vertical over
the packed exchange with delta_eps=0) through the port's
``PMVEngine(device='cpu')``, held against the smoke's own scipy references
with its tolerances (PageRank rtol 1e-4; SSSP and CC exact)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse import csgraph

from repro_torch.core import PMVEngine, connected_components, pagerank, sssp
from repro_torch.graph import rmat, symmetrize_edges

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

SCALE = 10
N = 1 << SCALE
STREAM_SCALE = 12
EDGES = rmat(SCALE, 16 << SCALE, seed=0)


def test_pagerank_selective():
    eng = PMVEngine(EDGES, N, b=8, strategy="selective", backend="auto", device="cpu")
    res = eng.run(pagerank(N), max_iters=100, tol=1e-6)
    assert eng.prepare(pagerank(N))[-1]["backend"] == "planned"
    assert res.converged
    want = smoke.pagerank_ref(np, sp, EDGES, N, res.iterations)
    np.testing.assert_allclose(res.v, want, rtol=1e-4, atol=1e-12)


def test_sssp_vertical_scatter_kernel():
    eng = PMVEngine(EDGES, N, b=8, strategy="vertical", backend="auto", scatter="kernel",
                    stream="off", device="cpu")
    res = eng.run(sssp(0), max_iters=100, tol=0.5)
    meta = eng.prepare(sssp(0))[-1]
    assert meta["backend"] == "planned" and meta["plan"].scatter == "kernel"
    assert res.converged
    want = smoke.sssp_ref(np, sp, csgraph, EDGES, N, 0)
    np.testing.assert_array_equal(res.v.astype(np.float64), want)


@pytest.mark.parametrize("theta", [60.0, 100.0])
def test_cc_hybrid(theta):
    sym = symmetrize_edges(EDGES)
    eng = PMVEngine(sym, N, b=8, strategy="hybrid", theta=theta, backend="auto",
                    stream="off", device="cpu")
    res = eng.run(connected_components(), max_iters=100, tol=0.5)
    meta = eng.prepare(connected_components())[-1]
    assert meta["backend"] == "planned" and meta["n_dense"] > 0
    assert res.converged
    np.testing.assert_array_equal(res.v, smoke.cc_ref(np, sp, csgraph, sym, N))


def test_pagerank_vertical_packed_delta():
    eng = PMVEngine(EDGES, N, b=8, strategy="vertical", backend="auto", scatter="kernel",
                    exchange="packed", delta_eps=0.0, device="cpu")
    res = eng.run(pagerank(N), max_iters=100, tol=1e-6)
    meta = eng.prepare(pagerank(N))[-1]
    assert meta["exchange"] == "packed" and meta["delta_reason"] == "active"
    assert meta["plan"].scatter == "kernel" and "recv_words" in eng.prepare(pagerank(N))[0]["xchg"]
    assert res.converged
    want = smoke.pagerank_ref(np, sp, EDGES, N, res.iterations)
    np.testing.assert_allclose(res.v, want, rtol=1e-4, atol=1e-12)


def test_sparse_scatter_phase_on_cpu(monkeypatch):
    """The smoke's kernel-3 phase on the SSSP run's compacted buffers, on the
    CPU (the wrapper takes its plain version there), with the card's timers
    stubbed: every comparison it makes holds, and its row gets the valid-slot
    bound and every time."""
    import torch

    from repro_torch.core import placement, sparse_exchange

    monkeypatch.setattr(smoke, "time_ms", lambda torch, fn, reps, warmup=2: (fn(), 0.5)[1])
    monkeypatch.setattr(smoke, "profiled_calls", lambda torch, fn, cls: (fn(), 1.0, 0.25, {})[1:])
    eng = PMVEngine(EDGES, N, b=8, strategy="vertical", backend="auto", scatter="kernel",
                    stream="off", device="cpu")
    spec = sssp(0)
    res = eng.run(spec, max_iters=3, tol=-1.0)
    matrix, _, _, _, meta = eng.prepare(spec)
    part = meta["part"]
    nl = part.n_local
    v = torch.from_numpy(part.to_blocked(res.v.astype(np.float32)).copy())
    partials = placement._planned_vertical_partials(spec, matrix["planned"], v, nl)
    idx, val, _, _ = sparse_exchange.compact_partials(spec, partials, meta["capacity"])
    idx_x, val_x = idx.transpose(0, 1).contiguous(), val.transpose(0, 1).contiguous()
    rows = {"scatter_combine": {"launches": 6}}
    gen = torch.Generator().manual_seed(0)
    smoke.sparse_scatter_phase(torch, torch.device("cpu"), gen, N, idx_x, val_x, nl, rows)
    row = rows["scatter_combine"]
    n_valid = int((idx_x < nl).sum())
    assert 0 < n_valid < idx_x.numel() and row["valid_slots"] == n_valid
    want_ms, by = smoke.bound(n_valid * 8 + idx_x.shape[0] * nl * 4, n_valid)
    assert row["bound_ms"] == want_ms and row["bound_by"] == by == "bytes"
    assert row["device_launches_per_call"] == 1.0 and row["launches"] == 6
    for key in ("ms", "plain_ms", "library_ms", "device_ms", "scatter_reduce_all_slots_ms",
                "plus_times_ms", "plus_times_device_ms", "plus_times_library_ms"):
        assert row[key] > 0, key


@pytest.mark.parametrize("caught, others, nodes, want", [
    ([20], {}, {"kernel": 1}, 1),
    ([19] * 8, {}, {"kernel": 1}, 1),
    ([17, 19, 18] + [16] * 5, {}, {"kernel": 1}, 1),
    ([20], {}, {"kernel": 2}, 2),
    ([20], {}, {"kernel": 1, "memset": 1}, 2),
    ([20], {"other": 20}, {"kernel": 1}, "error"),
    ([21] * 8, {}, {"kernel": 1}, "error"),
    ([0] * 8, {}, {"kernel": 1}, "error"),
])
def test_profiled_calls_counts_launches_in_a_captured_graph(monkeypatch, caught, others, nodes,
                                                            want):
    """profiled_calls reads a class's launches per call from one call
    captured in a CUDA graph (every node counts), so a trace that drops
    events in every window does not fail the check; it reads the device ms
    from the window that caught the most, and refuses a trace that shows
    another class, more than one launch a call, or none at all."""
    windows = iter(caught)

    def breakdown(torch, run, iters):
        n = next(windows)
        launches = dict({"scatter_combine": n} if n else {}, **others)
        return {"device_launches": launches, "by_kernel_ms": {"scatter_combine": n / 1000},
                "device_ms_per_iter": n / 1000}

    monkeypatch.setattr(smoke, "device_breakdown", breakdown)
    monkeypatch.setattr(smoke, "graph_nodes", lambda torch, fn: dict(nodes))
    if want == "error":
        with pytest.raises(smoke.SmokeError):
            smoke.profiled_calls(None, lambda: None, "scatter_combine")
        return
    per_call, dev_ms, seen = smoke.profiled_calls(None, lambda: None, "scatter_combine")
    assert per_call == want and dev_ms == max(caught) / 1000
    assert seen["windows_caught"] == caught and seen["graph_nodes_per_call"] == nodes


def test_disk_phase_on_cpu(monkeypatch, tmp_path, capsys):
    """The smoke's disk phase at scale 10 on the CPU, with the card's memory
    calls stubbed and the launch counters faked (nothing launches here):
    the store ingests (with θ-split shards at a θ that leaves dense
    vertices at this scale) and audits clean, the five disk solves (three
    basic, SSSP and PageRank hybrid) pass their checks against scipy and
    the resident SSSP, the chaos disk SSSP (killed and resumed under the
    seeded plan of every fault kind) and the overflow retry are bitwise
    the clean disk SSSP, the disk serve's answers equal the resident
    serve's and scipy's, the chaos disk serve's equal the resident serve's
    with both faults recovered, every leg's budget holds, the kernel rows
    gain their disk launches (the chaos and overflow solves' kernel 3, the
    chaos serve's kernel 6) and a plain-version check on each kernel-3/6
    tail's own (idx, val), the fleet reports of the two traced SSSP solves
    (one worker, no straggler) and the CLI's store verify, obs report and
    obs merge (over two resident traces) pass; the store directory is
    returned for the spmd phase (which removes it) and the checkpoints'
    are gone."""
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.obs import Recorder
    from repro_torch.serving import PMVServer, Query

    theta = 60.0
    assert 0 < int((np.bincount(EDGES[:, 0], minlength=N) >= theta).sum()) < N
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 1 << 30)
    fake = dict(kernels.launch_counts(), scatter_combine=3, packed_scatter_combine=10,
                scatter_combine_multi=7)
    monkeypatch.setattr(kernels, "launch_counts", lambda: dict(fake))
    root = tmp_path / "store"
    made = []

    def mkdtemp(prefix=""):
        # the store's directory first, then the checkpoints'
        d = root if not made else tmp_path / f"{prefix}{len(made)}"
        d.mkdir()
        made.append(d)
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    sssp_v = PMVEngine(EDGES, N, b=8, strategy="vertical", device="cpu").run(
        sssp(0), max_iters=100, tol=0.5).v
    sources = np.flatnonzero(np.bincount(EDGES[:, 0], minlength=N))[:16]
    resident = PMVServer(EDGES, N, b=8, strategy="hybrid", theta=theta, backend="auto",
                         scatter="kernel", stream="off", device="cpu").serve(
        [Query("sssp", source=int(s), tol=0.5) for s in sources])
    served = ([(r.query.source, r.vector, r.iterations) for r in resident], sources[:8])
    rows = {"scatter_combine": {"launches": 6}, "packed_scatter_combine": {"launches": 50},
            "scatter_combine_multi": {"launches": 20}}
    failures = []
    peaks = {"sssp/vertical": 1.0, "pagerank/selective": 1.0, "pagerank/vertical packed": 1.0,
             "serve": 1.0}
    traces = {}
    for label in ("pagerank/selective", "sssp/vertical"):
        traces[label] = Recorder()
        PMVEngine(EDGES, N, b=8, strategy="vertical", device="cpu", obs=traces[label]).run(
            sssp(0), max_iters=2, tol=0.5)
    disk = smoke.disk_phase(torch, np, sp, csgraph, torch.device("cpu"), EDGES, N, 8, theta,
                            sssp_v, served, peaks, rows, failures, traces=traces)
    assert failures == []
    # the store stays for the spmd phase, with what it holds its runs to
    assert disk["root"] == str(root) and root.exists()
    assert sorted(disk["solves"]) == sorted(
        ["sssp/vertical disk", "pagerank/horizontal disk", "pagerank/vertical packed disk",
         "sssp/hybrid disk", "pagerank/hybrid disk"])
    assert len(disk["rwr"]) == 8 and disk["rwr_sources"] == [int(s) for s in sources[:8]]
    shutil.rmtree(root)
    out = capsys.readouterr().out
    for label in ("sssp/vertical disk", "sssp/hybrid disk"):
        assert f"fleet {label}: workers=1 iterations=" in out
        assert f"fleet trace {label}: merge_traces" in out
    assert "fleet: 1 workers" in out                     # obs report's digest
    assert "merged 2 trace(s)" in out and "cli: store verify, obs report" in out
    checks = {name: rows[name].pop("disk_checks") for name in
              ("scatter_combine", "scatter_combine_multi")}
    assert rows["scatter_combine"] == {"launches": 21, "disk_launches": 15}
    assert rows["packed_scatter_combine"] == {"launches": 60, "disk_launches": 10}
    assert rows["scatter_combine_multi"] == {"launches": 34, "disk_launches": 14}
    assert [(c["path"], c["semiring"]) for c in checks["scatter_combine"]] == [
        ("sssp/vertical disk", "min_plus"), ("sssp/hybrid disk", "min_plus"),
        ("pagerank/hybrid disk", "plus_times")]
    assert [(c["path"], c["semiring"], c["shape"][0], c["shape"][-1])
            for c in checks["scatter_combine_multi"]] == [
        ("disk serve sssp", "min_plus", 8, 16), ("disk serve rwr", "plus_times", 8, 8)]
    # the plain version on the CPU: the same function, so no error at all
    assert all(c["max_abs_err"] == 0.0 for cs in checks.values() for c in cs)
    assert not root.exists()
    assert [d.name for d in made[1:]] == ["pmv_ckpt_1"] and not any(d.exists() for d in made)


def test_bf16_phase_on_cpu(monkeypatch, capsys):
    """The smoke's bfloat16-wire phase at scale 10 on the CPU, with the
    card's calls stubbed and the launch counters faked: the checkpointed and
    resumed PageRank is bitwise the uninterrupted one, within the phase's
    bound of scipy, its payload bytes half the float32 wire's; kernels 1
    and 3 gain the phase's launches, and the checkpoint save's legs are
    printed against the median iteration."""
    import torch

    from repro_torch import kernels

    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    fake = dict(kernels.launch_counts(), ell_gimv=40, scatter_combine=5)
    monkeypatch.setattr(kernels, "launch_counts", lambda: dict(fake))
    rows = {"ell_gimv": {"launches": 1}, "scatter_combine": {"launches": 2}}
    failures = []
    smoke.bf16_phase(torch, np, sp, torch.device("cpu"), EDGES, N, 8, rows, failures)
    assert failures == []
    assert rows == {"ell_gimv": {"launches": 41, "bf16_launches": 40},
                    "scatter_combine": {"launches": 7, "bf16_launches": 5}}
    out = capsys.readouterr().out
    assert "check pagerank/vertical bf16: " in out and out.count("-> ok") == 1
    assert "checkpoint save (" in out and "x the median iteration" in out


def test_bf16_phase_fails_over_its_bound(monkeypatch):
    """The phase's error bound is live: at a bound below the bf16 wire's
    error the phase records a failure."""
    import torch

    from repro_torch import kernels

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch_counts", lambda: {"ell_gimv": 1, "scatter_combine": 1})
    rows = {"ell_gimv": {"launches": 0}, "scatter_combine": {"launches": 0}}
    failures = []
    smoke.bf16_phase(torch, np, sp, torch.device("cpu"), EDGES, N, 8, rows, failures,
                     iters=4, every=2, bound=1e-6)
    assert len(failures) == 1 and "bf16" in failures[0]


def _count_launches_on_cpu(monkeypatch):
    """Each kernel wrapper counts one launch per call, as it does on the card
    (on the CPU the wrappers take their plain versions and count nothing):
    the wrappers are swapped, where the main path looks them up, for
    counting ones that call the original."""
    import repro_torch.kernels.block_gimv as block_gimv
    import repro_torch.kernels.ell_spmv as ell_spmv
    import repro_torch.kernels.scatter_combine as scatter_combine
    from repro_torch import kernels
    from repro_torch.core import placement

    for fn in kernels.WRAPPERS.values():
        def counted(*args, _fn=fn, **kw):
            _fn.launches += 1
            return _fn(*args, **kw)

        for mod in (placement, block_gimv, ell_spmv, scatter_combine):
            if hasattr(mod, fn.__name__):
                monkeypatch.setattr(mod, fn.__name__, counted)


def test_stream_phase_on_cpu(monkeypatch):
    """The smoke's stream phase (SSSP streamed under the default
    stream='auto', the same solve fused, a Q = 64 RWR serve streamed, and
    the kernel holds on their per-block buffers) at scale 12 and the smoke's
    b = 64 on the CPU (the smallest scale at which the default 'auto'
    streams: capacity 27 of n_local 64, savings 2.29x), with the card's
    memory calls and profiler stubbed and the wrappers counting their
    calls: the plans stream, the ELL launches equal the launch schedule's
    count, the answers pass the smoke's checks, and the kernel rows gain
    their launches and holds."""
    import itertools

    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    # the streamed run reads its peak first: rising peaks stand for the
    # fused run's larger one
    peaks_read = itertools.count(1 << 20, 1 << 20)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: next(peaks_read))
    monkeypatch.setattr(smoke, "device_breakdown", lambda torch, run, iters: {})
    _count_launches_on_cpu(monkeypatch)
    rows, failures, peaks = {}, [], {}
    gen = torch.Generator().manual_seed(0)
    smoke.stream_phase(torch, np, sp, csgraph, torch.device("cpu"), gen, STREAM_SCALE, 0, rows,
                       failures, peaks)
    assert failures == []
    for name in ("ell_gimv", "scatter_combine", "ell_gimv_multi", "scatter_combine_multi"):
        assert rows[name]["stream_launches"] > 0, name
        assert rows[name]["launches"] == rows[name]["stream_launches"], name
        assert [c["max_abs_err"] for c in rows[name]["stream_checks"]] == [0.0], name
    for name in ("dense_gimv", "packed_scatter_combine", "packed_scatter_combine_multi"):
        assert name not in rows or "stream_launches" not in rows[name], name
    assert set(peaks) == {"sssp/vertical streamed", "stream serve"}


def test_expected_stream_launches_counts_the_launch_schedule():
    """The smoke's count of a streamed step's ELL launches, from the plan
    alone, equals what the engine's streamed layout launches a step."""
    from repro_torch.core import PMVEngine, sssp
    from repro_torch.graph import erdos_renyi

    for b in (8, 32):
        eng = PMVEngine(erdos_renyi(N, 16 * N, seed=0), N, b=b, strategy="vertical",
                        backend="auto", stream="on", device="cpu")
        matrix, *_, meta = eng.prepare(sssp(0))
        fs = matrix["streamed"]
        assert smoke.expected_stream_launches(meta["plan"]) == fs.launches_per_step() > b


def test_obs_phase_on_cpu(monkeypatch, capsys):
    """The smoke's traced SSSP run at scale 10 on the CPU: the prepare
    phases line (the spans fit in prepare_s), the recorder's overhead runs
    (bitwise the traced run, the recorder restored), the trace round trip,
    explain(live=True); a failing check raises."""
    import torch

    from repro_torch.obs import Recorder

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rec = Recorder()
    eng = PMVEngine(EDGES, N, b=8, strategy="vertical", backend="auto", scatter="kernel",
                    stream="off", device="cpu", obs=rec)
    spec = sssp(0)
    res = eng.run(spec, max_iters=100, tol=0.5)
    meta = eng.prepare(spec)[-1]
    phases = smoke.prepare_phases("sssp/vertical", rec, meta)
    assert set(phases) == {"partition", "stripes", "plan", "pack", "device_put"}
    smoke.obs_overhead(torch, np, "sssp/vertical", eng, spec, res, max_iters=100, tol=0.5)
    assert eng.obs is rec
    assert len(rec.spans("pmv.iteration")) == 4 * res.iterations
    assert smoke.check_trace("sssp/vertical", rec) == len(rec.events)
    text = eng.explain(spec, live=True)
    assert "live (measured):" in text and eng.obs is rec
    out = capsys.readouterr().out
    assert "prepare phases sssp/vertical: partition=" in out
    assert "obs overhead sssp/vertical: median iteration on" in out
    wrong = dict(meta, prepare_s=1e-9)
    with pytest.raises(smoke.SmokeError, match="do not fit"):
        smoke.prepare_phases("sssp/vertical", rec, wrong)
    bad = type(res)(**{**res.__dict__, "v": res.v + 1})
    with pytest.raises(smoke.SmokeError, match="bitwise"):
        smoke.obs_overhead(torch, np, "sssp/vertical", eng, spec, bad, max_iters=100, tol=0.5)
    assert eng.obs is rec


class _FakeEvent:
    """torch.cuda.Event on the CPU: records a host clock reading."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time

        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_profiler_phase_on_cpu(monkeypatch, capsys):
    """The smoke's profiler phase on a scale-10 SSSP run on the CPU (the
    card's synchronize and events stubbed): the spans count the plan's
    non-skip blocks three times, every bucket's first launch equals its
    plain version, the calibration and profiler lines print; a plain
    version that disagrees fails the phase."""
    import torch

    from repro_torch.kernels import ell_spmv

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    eng = PMVEngine(EDGES, N, b=8, strategy="vertical", backend="auto", scatter="kernel",
                    stream="off", device="cpu")
    spec = sssp(0)
    plan = eng.prepare(spec)[-1]["plan"]
    out = smoke.profiler_phase(torch, np, "sssp/vertical", eng, spec)
    tactics = plan.tactic_counts()
    assert out["spans"] == {"launch.ell": 3 * tactics["ell"],
                            "launch.dense": 3 * tactics["dense"]}
    assert len(out["ratios"]) == tactics["ell"] + tactics["dense"]
    text = capsys.readouterr().out
    assert "profile calibration sssp/vertical ell: launches=" in text
    assert "profiler sssp/vertical: all non-skip blocks:" in text
    assert "profiler launches sssp/vertical (outside the main path's counts)" in text
    monkeypatch.setattr(ell_spmv, "ell_gimv_ref",
                        lambda cols, w, v, semiring: torch.zeros(cols.shape[0], dtype=v.dtype))
    with pytest.raises(smoke.SmokeError, match="disagrees with its plain version"):
        smoke.profiler_phase(torch, np, "sssp/vertical", eng, spec, repeats=1)


def test_telemetry_checks_on_cpu(capsys):
    """The smoke's telemetry checks on a small CPU serve with the exporter
    on: the retired count, the SLO events, the scrape and ``obs top`` pass;
    a wrong query count fails; close() stops the exporter's thread."""
    from repro_torch.obs import TelemetryConfig
    from repro_torch.serving import PMVServer, Query

    srv = PMVServer(EDGES, N, b=8, strategy="vertical", buckets=(8,), device="cpu",
                    telemetry=TelemetryConfig(latency_target_s=30.0, host="127.0.0.1", port=0))
    try:
        srv.serve([Query("rwr", source=s, tol=1e-6) for s in range(6)])
        smoke.telemetry_checks("serve", srv, 6)
        with pytest.raises(smoke.SmokeError, match="does not count the 7 queries"):
            smoke.telemetry_checks("serve", srv, 7)
    finally:
        smoke.telemetry_close_check("serve", srv)
    out = capsys.readouterr().out
    assert "telemetry serve: http://127.0.0.1:" in out and "-> ok" in out
    assert "pmv serve" in out                              # obs top's frame
    assert "close() stopped the exporter's thread" in out


def test_spmd_gloo_phase_on_cpu(capsys, tmp_path):
    """The smoke's spmd phase, part (b), rehearsed on the CPU at scale 10:
    8 gloo ranks (subprocesses of chip_smoke.py --spmd-rank) run, on the
    smaller graph, the flat SSSP (bitwise an emulated engine and its
    exchanged elements, and scipy), the horizontal PageRank, the two-hop
    SSSP on (2, 4) and the RWR serve, against the smoke's scipy references;
    backend='pallas' on the pallas phase's graph (the SSSP on two replicas
    of 4 workers and with axis_name against rank order, the horizontal
    PageRank), against the emulated pallas runs; then the out-of-core runs
    over a store as the disk phase leaves it (each
    rank on its own shard view under a per-worker budget): the SSSP, the
    hybrid and packed PageRanks and the hybrid RWR serve bitwise the
    single-process disk runs, the chaos SSSP with worker 1's prefetch
    degraded and worker 2 the straggler, and each tail's kernel held
    against its plain version on every rank (nothing launches on the CPU,
    so the launch checks are off)."""
    import torch

    from repro_torch.core import cost_model
    from repro_torch.serving import PMVServer, Query
    from repro_torch.store import ingest_edges

    root = str(tmp_path / "store")
    man = ingest_edges(EDGES, N, 8, root, theta=40.0)
    budget = 2 * cost_model.stripe_slice_bytes(8, man.e_cap, has_w=True)
    kw = dict(store=root, residency="disk", backend="auto", store_budget_bytes=budget,
              device="cpu")

    def solve(spec, iters, tol, **k):
        disk_eng = PMVEngine(None, **kw, **k)
        try:
            return disk_eng.run(spec, max_iters=iters, tol=tol)
        finally:
            disk_eng.prepare(spec)[-1]["executor"].close()

    solves = {
        "sssp/vertical disk": solve(sssp(0), 100, 0.5, strategy="vertical", scatter="kernel"),
        "pagerank/hybrid disk": solve(pagerank(N), 10, 0.0, strategy="hybrid", theta=40.0,
                                      scatter="kernel"),
        "pagerank/vertical packed disk": solve(pagerank(N), 10, 0.0, strategy="vertical",
                                               exchange="packed", scatter="kernel")}
    sources = [3, 17, 100, 200, 300, 400, 500, 600]
    srv = PMVServer(store=root, residency="disk", strategy="hybrid", theta=40.0,
                    backend="auto", scatter="kernel", store_budget_bytes=budget, device="cpu")
    try:
        got = srv.serve([Query("rwr", source=s, c=0.85, max_iters=10) for s in sources])
    finally:
        srv.close()
    disk = {"root": root, "e_cap": man.e_cap, "budget": budget, "solves": solves,
            "rwr": [(r.vector, r.iterations) for r in got], "rwr_sources": sources}
    rows = {name: {"launches": 0} for name in smoke.KERNEL_SOURCES}
    failures = []
    small = (rmat(SCALE - 1, 16 << (SCALE - 1), seed=0), N // 2)
    pal_edges = rmat(SCALE - 1, 16 << (SCALE - 1), seed=1)
    pal = PMVEngine(pal_edges, N // 2, b=8, strategy="horizontal", backend="pallas",
                    device="cpu").run(pagerank(N // 2), max_iters=100, tol=1e-6)
    pallas = {"edges": pal_edges, "n": N // 2, "pagerank": (pal.v, pal.iterations)}
    for key, b in (("sssp", 8), ("sssp_b4", 4)):
        pallas[key] = PMVEngine(pal_edges, N // 2, b=b, strategy="vertical", backend="pallas",
                                scatter="kernel", device="cpu").run(sssp(0), tol=0.5).v
    smoke.spmd_gloo(torch, np, sp, csgraph, torch.device("cpu"), EDGES, N, 8, 40.0,
                    sources, rows, failures, small=small, hints={"pagerank": 52},
                    expect_launches=False, disk=disk, pallas=pallas)
    out = capsys.readouterr().out
    assert failures == [], (failures, out)
    for label in ("sssp_flat", "pagerank_horizontal", "sssp_hier", "serve_rwr"):
        assert f"spmd run {label} W=8" in out and "-> ok" in out
    for label in smoke.SPMD_PALLAS_RUNS:
        line = next(x for x in out.splitlines() if x.startswith(f"spmd run {label} W=8"))
        assert line.endswith("-> ok"), line
    for label in smoke.SPMD_DISK_RUNS:
        line = next(x for x in out.splitlines() if x.startswith(f"spmd disk {label} W=8"))
        assert line.endswith("-> ok"), line
    assert "bitwise the disk phase's single-process run: True" in out
    assert [(c["path"], c["semiring"]) for c in rows["scatter_combine"]["disk_checks"]] == [
        ("spmd sssp_disk", "min_plus"), ("spmd pagerank_hybrid_disk", "plus_times"),
        ("spmd sssp_disk_chaos", "min_plus")]
    assert [c["path"] for c in rows["packed_scatter_combine"]["disk_checks"]] == [
        "spmd pagerank_packed_disk"]
    assert [c["path"] for c in rows["scatter_combine_multi"]["disk_checks"]] == [
        "spmd serve_rwr_disk"]
    assert "spmd gloo phase:" in out


def test_pallas_phase_on_cpu(monkeypatch, capsys):
    """The smoke's pallas phase (backend='pallas': PageRank horizontal, SSSP
    vertical and its pallas_interpret=True twin, CC hybrid, PageRank vertical
    packed, the sparse and the packed serve at Q = 8, and kernels 1 and 5 at
    the merged table's flat shape) at scale 10 on the CPU, with the card's
    timers stubbed and the wrappers counting their calls: every check
    holds, every kernel of the path launches, and the kernel rows gain the
    flat-width lines."""
    import torch

    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(smoke, "time_ms", lambda torch, fn, reps, warmup=2: (fn(), 0.5)[1])
    _count_launches_on_cpu(monkeypatch)
    rows = {name: {"launches": 0} for name in smoke.KERNEL_SOURCES}
    failures = []
    out = smoke.pallas_phase(torch, np, sp, csgraph, torch.device("cpu"), 0, rows, failures,
                             scale=SCALE, theta=40.0)
    text = capsys.readouterr().out
    assert failures == [], (failures, text)
    assert text.count("check pallas") == 6 and "-> FAIL" not in text
    for name in smoke.KERNEL_SOURCES:
        assert rows[name]["launches"] > 0, name
    for name in ("ell_gimv", "ell_gimv_multi"):
        flat = rows[name]["flat_width"]
        assert flat["ms"] == 0.5 and flat["bound_ms"] > 0 and flat["shape"][0] == N
    assert set(out) == {"edges", "n", "pagerank", "sssp", "sssp_b4"}
    np.testing.assert_array_equal(out["sssp"], out["sssp_b4"])


def test_lm_phase_on_cpu(monkeypatch, capsys):
    """The smoke's lm phase on the CPU, qwen3-1.7b cut to its smoke config
    (``config_for`` stubbed) and the card's memory calls stubbed: every
    check holds (float32 decode against the forward, the CLI's bfloat16
    run, the nine smoke archs' card-against-host comparisons, here host
    against host), and no PMV kernel launches."""
    import torch

    from repro_torch import configs

    monkeypatch.setattr(configs, "config_for", configs.smoke_config)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 1 << 30)
    failures = []
    smoke.lm_phase(torch, np, torch.device("cpu"), "a card, 700 W", failures)
    out = capsys.readouterr().out
    assert failures == [], failures
    assert "FAIL" not in out
    assert out.count("lm ") >= 12 and "[serve] qwen3-1.7b-smoke: generated (4, 32) tokens" in out
    assert "PMV kernel launches 0" in out
    for arch in configs.ARCHS[1:]:
        assert f"lm {arch} smoke: forward12=" in out

