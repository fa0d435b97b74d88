"""Pre-partitioning, planned packing and the planner's tactic table of the
PyTorch port against the JAX package: equal arrays, equal plans, over the
fuzz topologies and RMAT graphs of 2^8-2^10 vertices with b in {2, 4}.  A
partition converted with ``from_reference`` feeds both packages' steps."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fuzz_parity import TOPOLOGIES, _fuzz_edges

from repro.core import algorithms as jalg
from repro.core import blocks as jblocks
from repro.core import cost_model as jcost
from repro.core import partition as jpart
from repro.core import placement as jplace
from repro.core import planner as jplanner
from repro.core.engine import _stack_stripes
from repro.graph import rmat as jrmat
from repro.graph import stats as jstats
from repro_torch.core import algorithms as talg
from repro_torch.core import blocks as tblocks
from repro_torch.core import cost_model as tcost
from repro_torch.core import partition as tpart
from repro_torch.core import placement as tplace
from repro_torch.core import planner as tplanner
from repro_torch.core.convert import from_reference
from repro_torch.graph import generators as tgen
from repro_torch.graph import rmat as trmat
from repro_torch.graph import stats as tstats

SPECS = {"pagerank": (lambda n: jalg.pagerank(n), lambda n: talg.pagerank(n), False, "plus_times"),
         "sssp": (lambda n: jalg.sssp(0), lambda n: talg.sssp(0), False, "min_plus"),
         "cc": (lambda n: jalg.connected_components(), lambda n: talg.connected_components(),
                True, "min_src")}


def _graphs():
    cases = []
    for i, topo in enumerate(TOPOLOGIES):
        b = (2, 4)[i % 2]
        n = b * (5 + i)
        cases.append((f"{topo}-b{b}", _fuzz_edges(topo, n, b, np.random.default_rng(i)), n, b))
    for scale, b in ((8, 2), (9, 4), (10, 4)):
        cases.append((f"rmat{scale}-b{b}", jrmat(scale, 6 << scale, seed=scale), 1 << scale, b))
    return cases


GRAPHS = _graphs()
GRAPH_IDS = [g[0] for g in GRAPHS]


def _assert_same(a, b, path="root"):
    """Recursive equality of the two packages' containers (by field name)."""
    if a is None or b is None:
        assert a is None and b is None, path
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(b):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (int, float, str, np.generic)):
        assert a == b, (path, a, b)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=path)


def _theta(edges, n):
    out = np.bincount(edges[:, 0], minlength=n)
    return float(max(np.sort(out)[-3], 1))   # a few dense vertices


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("graph", GRAPHS, ids=GRAPH_IDS)
def test_partition_and_plans_equal_jax(graph, spec_name):
    _, edges, n, b = graph
    jmk, tmk, sym, semiring = SPECS[spec_name]
    if sym:
        edges = tgen.symmetrize_edges(edges)
    theta = _theta(edges, n)
    jpm, jhm = jpart.partition_graph(edges, n, b, jmk(n), theta=theta)
    tpm, thm = tpart.partition_graph(edges, n, b, tmk(n), theta=theta)
    _assert_same(tpm, jpm)
    _assert_same(thm, jhm)
    assert tcost.select_strategy(b, n, len(edges)) == jcost.select_strategy(b, n, len(edges))

    for strategy in ("horizontal", "vertical", "hybrid"):
        cap = None if strategy == "horizontal" else (
            jhm.sparse_partial_cap if strategy == "hybrid" else jpm.partial_cap)
        jplan = jplanner.plan_execution(jpm, jhm, strategy=strategy, mode="planned",
                                        theta=theta, capacity=cap, scatter="auto",
                                        interpret=True)
        tplan = tplanner.plan_execution(tpm, thm, strategy=strategy, mode="planned",
                                        theta=theta, capacity=cap, scatter="auto",
                                        interpret=True)
        assert tplan.boundaries == jplan.boundaries
        assert tplan.scatter == jplan.scatter
        assert tplan.tactic_counts() == jplan.tactic_counts()
        for tb, jb in zip(tplan.blocks, jplan.blocks):
            assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
        # the block table of the report is the reference's, row for row
        t_rows = tplanner.format_plan(tplan).splitlines()[-b * b:]
        assert t_rows == jplanner.format_plan(jplan).splitlines()[-b * b:]
        # packing against the plan, per worker and stacked
        layout = "merged" if strategy == "horizontal" else "vertical"
        stripes = {"horizontal": (jpm.horizontal, tpm.horizontal),
                   "vertical": (jpm.vertical, tpm.vertical),
                   "hybrid": (jhm.sparse_vertical, thm.sparse_vertical)}[strategy]
        packs = []
        for mod, plan, sts in ((jblocks, jplan, stripes[0]), (tblocks, tplan, stripes[1])):
            per = [mod.pack_planned_stripe(s, plan.tactics_for_worker(w, layout), jpm.part.n_local,
                                           layout=layout, boundaries=plan.boundaries,
                                           semiring=semiring)
                   for w, s in enumerate(sts)]
            packs.append((per, mod.stack_planned(per, semiring)))
        _assert_same(packs[1], packs[0])
    if thm is not None:
        for s_t, s_j in zip(thm.dense_horizontal, jhm.dense_horizontal):
            np.testing.assert_array_equal(
                tblocks.materialize_dense_matrix(s_t, tpm.part.n_local, thm.dense.d_cap, semiring),
                jblocks.materialize_dense_matrix(s_j, jpm.part.n_local, jhm.dense.d_cap, semiring))


def test_theta_star_and_capacity_match_jax():
    for scale, b in ((8, 2), (10, 4)):
        edges = jrmat(scale, 8 << scale, seed=1)
        n = 1 << scale
        js, ts = jstats.compute_stats(edges, n), tstats.compute_stats(edges, n)
        assert tcost.theta_star(b, n, ts) == jcost.theta_star(b, n, js)
        for theta in (None, 5.0):
            assert tcost.capacity_from_cost_model(b, n, len(edges), stats=ts, theta=theta) == \
                jcost.capacity_from_cost_model(b, n, len(edges), stats=js, theta=theta)
        for nl, cap in ((100, 10), (100, 90), (7, 7)):
            assert tcost.prefer_streamed(b, nl, cap) == jcost.prefer_streamed(b, nl, cap)
            for interp in (False, True):
                assert tcost.prefer_kernel_scatter(b * cap, nl + 1, interpret=interp) == \
                    jcost.prefer_kernel_scatter(b * cap, nl + 1, interpret=interp)
        m = len(edges)
        for name in ("vertical_cost", "expected_partial_nnz", "prefer_horizontal"):
            assert getattr(tcost, name)(b, n, m) == getattr(jcost, name)(b, n, m)
        assert tcost.horizontal_cost(b, n) == jcost.horizontal_cost(b, n)
        assert tcost.hybrid_cost(b, n, ts, 4.0) == jcost.hybrid_cost(b, n, js, 4.0)
        assert tplanner.bucket_boundaries(69017) == jplanner.bucket_boundaries(69017)


def test_generators_match_jax():
    from repro.graph import generators as jgen

    np.testing.assert_array_equal(trmat(9, 3000, seed=4), jrmat(9, 3000, seed=4))
    e = jrmat(8, 900, seed=2)
    np.testing.assert_array_equal(tgen.symmetrize_edges(e), jgen.symmetrize_edges(e))
    for name in ("chain_graph", "star_graph", "complete_graph"):
        np.testing.assert_array_equal(getattr(tgen, name)(9), getattr(jgen, name)(9))


@pytest.mark.parametrize("strategy", ["horizontal", "vertical", "hybrid"])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_converted_partition_feeds_both_steps(strategy, spec_name):
    """One reference partition, converted with from_reference, through the
    port's torch step and the JAX package's xla step: the same v_new."""
    jmk, tmk, sym, _ = SPECS[spec_name]
    n, b = 256, 4
    edges = jrmat(8, 2000, seed=5)
    if sym:
        edges = tgen.symmetrize_edges(edges)
    theta = _theta(edges, n)
    jspec, tspec = jmk(n), tmk(n)
    jpm, jhm = jpart.partition_graph(edges, n, b, jspec, theta=theta)
    tpm, thm = from_reference(jpm), from_reference(jhm)
    assert isinstance(tpm, tpart.PartitionedMatrix) and isinstance(thm, tpart.HybridMatrix)
    nl = tpm.part.n_local
    rng = np.random.default_rng(0)
    v = (rng.integers(0, n, (b, nl)).astype(np.int32) if spec_name == "cc"
         else rng.random((b, nl)).astype(np.float32))
    mask = tpm.part.global_ids_grid() < n

    def put(stripes):
        s = tblocks.stack_stripes(stripes)
        return tblocks.BlockEdges(*(None if x is None else torch.from_numpy(x).long()
                                    if x.dtype == np.int32 else torch.from_numpy(x)
                                    for x in (s.seg_local, s.gat_local, s.w, s.count)))

    tv, tm = torch.from_numpy(v), torch.from_numpy(mask)
    jv, jm = jnp.asarray(v), jnp.asarray(mask)
    if strategy == "horizontal":
        want = jplace.horizontal_step(jspec, _stack_stripes(jpm.horizontal), jv, {}, jm,
                                      n_local=nl, axis_name=None)[0]
        got = tplace.horizontal_step(tspec, put(tpm.horizontal), tv, {}, tm, n_local=nl)[0]
    elif strategy == "vertical":
        want = jplace.vertical_step(jspec, _stack_stripes(jpm.vertical), jv, {}, jm, n_local=nl,
                                    axis_name=None, capacity=jpm.partial_cap)[0]
        got = tplace.vertical_step(tspec, put(tpm.vertical), tv, {}, tm, n_local=nl,
                                   capacity=tpm.partial_cap)[0]
    else:
        region = thm.dense
        jregion = jhm.dense
        want = jplace.hybrid_step(jspec, _stack_stripes(jhm.sparse_vertical),
                                  _stack_stripes(jhm.dense_horizontal), jregion, jv, {}, jm,
                                  n_local=nl, axis_name=None, capacity=jhm.sparse_partial_cap)[0]
        tregion = tblocks.DenseRegion(torch.from_numpy(region.gather_idx).long(),
                                      torch.from_numpy(region.d_count), region.d_cap, region.theta)
        got = tplace.hybrid_step(tspec, put(thm.sparse_vertical), put(thm.dense_horizontal),
                                 tregion, tv, {}, tm, n_local=nl,
                                 capacity=thm.sparse_partial_cap)[0]
    if spec_name == "pagerank":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
