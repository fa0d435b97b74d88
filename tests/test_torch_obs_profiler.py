"""The port's per-block launch profiler (``repro_torch.obs.profiler``)
against the JAX package's (``repro.obs.profiler``, run as its own tests run
it: ``backend='auto'`` on the CPU, the Pallas kernels in interpret mode).

Seconds differ between the packages by design (wall clocks, and the port's
``SLOT_TIME_S`` is the H100's data-sheet anchor where the JAX package's is
1e-8), so the comparisons are of structure, counts and slots: the launch
spans' (name, i, j, tactic, nnz, rows, predicted_cost) multiset and
``calibration_summary``'s launches and predicted slots per kind, exactly."""
from collections import Counter

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from _torch_graphs import tactic_mix_edges
from repro.graph import erdos_renyi, rmat
from repro.obs import calibration_summary as j_calibration
from repro.obs.profiler import profile_block_launches as j_profile
from repro_torch.kernels import block_gimv, ell_spmv
from repro_torch.obs import (
    Recorder,
    calibration_summary,
    check_span_nesting,
    profile_block_launches,
    validate_chrome_trace,
)

# name -> (edges, n, engine knobs); b = 4 everywhere
GRAPHS = {
    "mix_vertical": (tactic_mix_edges(64, 4), 64, dict(strategy="vertical")),
    "mix_hybrid": (tactic_mix_edges(64, 4), 64, dict(strategy="hybrid", theta=40.0)),
    "rmat8_vertical": (rmat(8, 1500, seed=3), 256, dict(strategy="vertical")),
}
ALGOS = {"pagerank": lambda m, n: m.pagerank(n), "sssp": lambda m, n: m.sssp(0)}
SPAN_KEYS = ("i", "j", "tactic", "nnz", "rows", "predicted_cost")


def _engines(graph):
    edges, n, kw = GRAPHS[graph]
    return (J.PMVEngine(edges, n, b=4, backend="auto", **kw),
            T.PMVEngine(edges, n, b=4, backend="auto", device="cpu", **kw), n)


def _launch_spans(rec) -> Counter:
    return Counter((e["name"],) + tuple(e["attrs"][k] for k in SPAN_KEYS)
                   for e in rec.events if e["name"].startswith("launch."))


def _structure(cal: dict) -> dict:
    return {kind: (c["launches"], c.get("predicted_slots")) for kind, c in cal.items()}


@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_profiler_spans_match_reference(graph, algo):
    """The same blocks are launched under the same span names with the same
    plan attributes, and the calibration summary counts the same launches
    and predicted slots per kind, as the JAX package's profiler."""
    j_eng, t_eng, n = _engines(graph)
    j_rec = j_profile(j_eng, ALGOS[algo](J, n))
    t_rec = profile_block_launches(t_eng, ALGOS[algo](T, n))
    spans = _launch_spans(t_rec)
    assert spans == _launch_spans(j_rec)
    assert {name for name, *_ in spans} <= {"launch.ell", "launch.dense"}
    plan = t_eng.prepare(ALGOS[algo](T, n))[-1]["plan"]
    counts = plan.tactic_counts()
    assert sum(spans.values()) == counts["ell"] + counts["dense"]
    assert _structure(calibration_summary(t_rec)) == _structure(j_calibration(j_rec))
    # the port's predicted seconds are its slots at its own slot time
    for e in t_rec.spans("launch."):
        a = e["attrs"]
        assert a["predicted_s"] == T.cost_model.slot_seconds(a["predicted_cost"])
    doc = t_rec.to_chrome_trace()
    validate_chrome_trace(doc)
    check_span_nesting(doc)


@pytest.mark.parametrize("graph", ["mix_hybrid", "rmat8_vertical"])
def test_profiler_repeats_give_even_counts(graph):
    """repeats=2 records every block twice: each kind's launch count doubles
    (so it is even), and the same blocks appear as at repeats=1."""
    _, t_eng, n = _engines(graph)
    once = profile_block_launches(t_eng, T.sssp(0))
    twice = profile_block_launches(t_eng, T.sssp(0), repeats=2)
    c1, c2 = calibration_summary(once), calibration_summary(twice)
    assert set(c1) == set(c2)
    for kind in c2:
        assert c2[kind]["launches"] == 2 * c1[kind]["launches"]
        assert c2[kind]["launches"] % 2 == 0
    assert _launch_spans(twice) == Counter({k: 2 * v for k, v in _launch_spans(once).items()})
    assert len(twice.spans("profile.pack")) == len(once.spans("profile.pack"))


def _mulmin_spec(mod, xp):
    return mod.GimvSpec(name="mulmin", combine2="mul", combine_all="min",
                        dtype=np.float32, assign=lambda v, r, c: xp.minimum(v, r),
                        init=lambda ids, c: (ids % 7).astype(np.float32))


@pytest.mark.parametrize("case", ["no_semiring", "disk"])
def test_profiler_refusals_match_reference(case, tmp_path):
    """A spec with no kernel semiring and a residency='disk' engine raise
    ValueError in both packages, with the same leading words."""
    import jax.numpy as jnp

    edges = rmat(7, 600, seed=2)
    if case == "no_semiring":
        j_eng = J.PMVEngine(edges, 128, b=4, strategy="vertical", backend="auto")
        t_eng = T.PMVEngine(edges, 128, b=4, strategy="vertical", backend="auto",
                            device="cpu")
        j_spec, t_spec, match = _mulmin_spec(J, jnp), _mulmin_spec(T, torch), "no kernel semiring"
    else:
        from repro_torch.store import ingest_edges

        root = str(tmp_path / "s")
        ingest_edges(edges, 128, 4, root)
        j_eng = J.PMVEngine(None, store=root, residency="disk", strategy="vertical")
        t_eng = T.PMVEngine(None, store=root, residency="disk", strategy="vertical",
                            device="cpu")
        j_spec, t_spec, match = J.sssp(0), T.sssp(0), "residency='disk' never materializes"
    with pytest.raises(ValueError, match=match):
        j_profile(j_eng, j_spec)
    with pytest.raises(ValueError, match=match):
        profile_block_launches(t_eng, t_spec)


def test_profiler_calibration_summary():
    """The mirror of the JAX package's
    ``tests/test_obs.py::test_profiler_calibration_summary`` on the same
    graph (``erdos_renyi(96, 420, seed=3)``)."""
    n = 96
    edges = erdos_renyi(n, 420, seed=3)
    eng = T.PMVEngine(edges, n, b=4, strategy="vertical", backend="auto", device="cpu")
    rec = profile_block_launches(eng, T.pagerank(n), repeats=2)
    cal = calibration_summary(rec)
    assert "ell" in cal
    s = cal["ell"]
    assert s["launches"] > 0 and s["launches"] % 2 == 0  # repeats=2
    assert s["measured_s"] > 0.0 and s["predicted_s"] > 0.0
    assert s["ratio"] > 0.0 and s["predicted_slots"] > 0.0
    doc = rec.to_chrome_trace()
    validate_chrome_trace(doc)
    check_span_nesting(doc)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_profiler_inspect_hook(algo):
    """``inspect`` sees each profiled block once, after its first launch and
    in the order of the spans: the outputs equal the plain versions on the
    same tables (the wrappers run them on the CPU), one ELL output per
    non-empty bucket of the block's plan, and its ``launch`` runs again;
    ``obs`` records into the given recorder."""
    j_eng, t_eng, n = _engines("mix_hybrid")
    spec = ALGOS[algo](T, n)
    semiring = block_gimv.semiring_of(spec.combine2, spec.combine_all)
    plan = t_eng.prepare(spec)[-1]["plan"]
    seen = []

    def inspect(rec):
        seen.append(rec)
        a = rec["attrs"]
        if rec["name"] == "launch.dense":
            want = block_gimv.dense_gimv_ref(rec["operands"], rec["v"], semiring=semiring)
            assert torch.equal(rec["out"], want)
        else:
            assert len(rec["out"]) == sum(1 for r in plan.block(a["i"], a["j"]).bucket_rows if r)
            for (cols, w), out in zip(rec["operands"], rec["out"]):
                want = ell_spmv.ell_gimv_ref(cols, w if spec.needs_weights else None, rec["v"],
                                             semiring=semiring)
                assert torch.equal(out, want)
        assert isinstance(rec["launch"](), (list, torch.Tensor))

    rec = Recorder()
    assert profile_block_launches(t_eng, spec, obs=rec, inspect=inspect) is rec
    spans = rec.spans("launch.")
    assert [(r["attrs"]["i"], r["attrs"]["j"]) for r in seen] == \
        [(e["attrs"]["i"], e["attrs"]["j"]) for e in spans]
    assert {r["name"] for r in seen} == {"launch.ell", "launch.dense"}
