"""The port's two-hop exchange (``exchange='hier'``) and tuple worker axes
under ``torch.distributed`` (gloo ranks on the CPU, ``tests/_torch_spmd.py``)
against the JAX package.

- hier on a (2, 2, 2) ('pod', 'data', 'model') mesh, single-vector solves
  and one batched step (``make_batched_step``, Q = 4), against the JAX
  package's own hier run on the same mesh (``shard_map`` over 8 emulated
  host devices, in a subprocess as tests/test_hierarchical.py runs it): the
  same v (SSSP element for element, PageRank within rtol 1e-6, atol 1e-9)
  and the same ``inter_pod_elems`` / ``intra_pod_elems``;
- the tuple axis ('data', 'model') on (2, 4), mirroring the JAX package's
  test_pmv_multipod_axis_tuple, against its emulated engine.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_spmd as S
import repro.core as J
from repro.graph import erdos_renyi

ROOT = Path(__file__).resolve().parents[1]
N, B, Q = 160, 8, 4
MESH3 = ((2, 2, 2), ("pod", "data", "model"))
AXIS3 = ("pod", "data", "model")
ALGOS = ("pagerank", "sssp")
RUN = dict(max_iters=8, tol=0.0)
HIER_CASES = [(algo, backend, stream) for algo in ALGOS
              for backend in ("torch", "auto") for stream in ("off", "on")]

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import PMVEngine, pagerank, sssp
from repro.serving.server import make_batched_step
from repro.graph import erdos_renyi

out_path = sys.argv[1]
n, b, q = 160, 8, 4
edges = erdos_renyi(n, 900, seed=4)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
axis = ("pod", "data", "model")
out = {}
for name, spec in (("pagerank", pagerank(n)), ("sssp", sssp(0))):
    r = PMVEngine(edges, n, b=b, strategy="vertical", exchange="hier", mesh=mesh,
                  axis_name=axis).run(spec, max_iters=8, tol=0.0)
    out[name + "_v"] = r.v
    for k in ("inter_pod_elems", "intra_pod_elems", "exchanged_elems", "logical_elems",
              "exchanged_bytes"):
        out[name + "_" + k] = np.array([rec[k] for rec in r.per_iter])
spec = pagerank(n)
shard = NamedSharding(mesh, P(axis))
v_np = np.random.default_rng(0).random((b, n // b, q)).astype(np.float32)
for name, exchange in (("hier", "hier"), ("flat", "sparse")):
    eng = PMVEngine(edges, n, b=b, strategy="vertical", exchange=exchange, mesh=mesh,
                    axis_name=axis)
    _, matrix, _v0, _ctx, mask, meta = eng.prepare(spec)
    step = make_batched_step(spec, meta["cfg"], mesh, axis, delta_kind="abs")
    v_new, d, st = step(matrix, jax.device_put(jnp.asarray(v_np), shard), {}, mask,
                        jnp.ones(q, bool))
    out["batched_" + name + "_v"] = np.asarray(v_new)
    out["batched_" + name + "_deltas"] = np.asarray(d)
    for k in ("inter_pod_elems", "intra_pod_elems", "exchanged_elems"):
        if k in st:
            out["batched_" + name + "_" + k] = np.asarray(float(st[k]))
out["batched_v0"] = v_np
np.savez(out_path, **out)
print("JAX-HIER-OK")
"""


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    """The port's hier runs on 8 ranks and the JAX package's in one
    8-device subprocess, side by side."""
    edges = erdos_renyi(N, 900, seed=4)
    v0 = np.random.default_rng(0).random((B, N // B, Q)).astype(np.float32)
    cases = [dict(algo=a, run=RUN, strategy="vertical", exchange="hier", backend=bk, stream=st)
             for a, bk, st in HIER_CASES]
    cases += [dict(algo=a, run=RUN, strategy="vertical", exchange="sparse") for a in ALGOS]
    engine = S.spawn("engine_cases", B, dict(mesh=MESH3, axis_name=AXIS3, edges=edges, n=N,
                                             b=B, cases=cases), timeout=240)
    out_path = str(tmp_path_factory.mktemp("jax_hier") / "hier.npz")
    jax_run = subprocess.run([sys.executable, "-c", JAX_SCRIPT, out_path], capture_output=True,
                             text=True, timeout=560, cwd=str(ROOT),
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "JAX-HIER-OK" in jax_run.stdout, jax_run.stderr[-3000:]
    ranks = engine.results()
    batched = S.run("batched_hier", B, dict(mesh=MESH3, axis_name=AXIS3, edges=edges, n=N,
                                            b=B, q=Q, v=v0, backends=("torch", "auto")))
    for got in batched[1:]:
        for key, r in got.items():
            np.testing.assert_array_equal(r["v"], batched[0][key]["v"])
    with np.load(out_path) as z:
        ref = {k: z[k] for k in z.files}
    np.testing.assert_array_equal(ref["batched_v0"], v0)
    return ranks, batched[0], ref


@pytest.mark.parametrize("case", HIER_CASES, ids=["-".join(c) for c in HIER_CASES])
def test_hier_matches_jax_hier(hier, case):
    """A solve through the two-hop exchange: the JAX package's v and its
    per-iteration inter- and intra-pod element counts, on every rank; the
    inter-pod volume under the flat exchange's."""
    ranks, _, ref = hier
    algo = case[0]
    i = HIER_CASES.index(case)
    got = ranks[0][i]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[i]["v"], got["v"])
    if algo == "sssp":
        np.testing.assert_array_equal(got["v"], ref["sssp_v"])
    else:
        np.testing.assert_allclose(got["v"], ref["pagerank_v"], rtol=1e-6, atol=1e-9)
    for k in ("inter_pod_elems", "intra_pod_elems", "exchanged_elems", "exchanged_bytes"):
        np.testing.assert_array_equal([r[k] for r in got["per_iter"]], ref[f"{algo}_{k}"])
    if algo == "sssp":
        np.testing.assert_array_equal([r["logical_elems"] for r in got["per_iter"]],
                                      ref["sssp_logical_elems"])
    flat = ranks[0][len(HIER_CASES) + ALGOS.index(algo)]
    np.testing.assert_array_equal(flat["v"], got["v"]) if algo == "sssp" else \
        np.testing.assert_allclose(flat["v"], got["v"], rtol=1e-6, atol=1e-9)
    assert got["per_iter"][-1]["inter_pod_elems"] < flat["per_iter"][-1]["exchanged_elems"]
    assert got["meta"]["exchange"] == "hier"


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_hier_batched_matches_jax_hier(hier, backend):
    """One batched step (Q = 4, one shared index set per partial row)
    through both hops: the JAX package's hier step's v_new and deltas, its
    inter- and intra-pod counts; the flat sparse step of the same batch
    within rtol 1e-5 (the JAX package's own hier-vs-flat tolerance)."""
    _, batched, ref = hier
    got = {name: batched[backend, name] for name in ("hier", "flat")}
    np.testing.assert_allclose(got["hier"]["v"], ref["batched_hier_v"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got["hier"]["deltas"], ref["batched_hier_deltas"], rtol=1e-6)
    np.testing.assert_allclose(got["flat"]["v"], ref["batched_flat_v"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got["hier"]["v"], got["flat"]["v"], rtol=1e-5, atol=1e-7)
    for k in ("inter_pod_elems", "intra_pod_elems", "exchanged_elems"):
        assert got["hier"]["stats"][k] == float(ref["batched_hier_" + k]), k
    assert got["hier"]["stats"]["inter_pod_elems"] < got["flat"]["stats"]["exchanged_elems"]


TUPLE_CASES = [(algo, strategy, backend) for algo in ("pagerank", "sssp")
               for strategy in ("horizontal", "vertical", "hybrid")
               for backend in ("torch", "auto")]


@pytest.fixture(scope="module")
def tuple_axis():
    n = 128
    edges = erdos_renyi(n, 600, seed=2)
    cases = [dict(algo=a, run=RUN, strategy=st, backend=bk, theta=4.0)
             for a, st, bk in TUPLE_CASES]
    spawned = S.spawn("engine_cases", B, dict(mesh=((2, 4), ("data", "model")),
                                              axis_name=("data", "model"), edges=edges, n=n,
                                              b=B, cases=cases))
    refs = {}
    for a, st, bk in TUPLE_CASES:
        spec = J.pagerank(n) if a == "pagerank" else J.sssp(0)
        refs[a, st, bk] = J.PMVEngine(edges, n, b=B, strategy=st, theta=4.0,
                                      backend={"torch": "xla", "auto": "auto"}[bk]).run(
            spec, **RUN)
    return spawned.results(), refs


@pytest.mark.parametrize("case", TUPLE_CASES, ids=["-".join(c) for c in TUPLE_CASES])
def test_tuple_axis_matches_emulation(tuple_axis, case):
    """A ('data', 'model') worker axis on a (2, 4) mesh: worker g = 4 * data
    + model, the JAX package's emulated answer on every rank."""
    ranks, refs = tuple_axis
    i = TUPLE_CASES.index(case)
    want = refs[case]
    for r in ranks:
        if case[0] == "sssp":
            np.testing.assert_array_equal(r[i]["v"], want.v)
        else:
            np.testing.assert_allclose(r[i]["v"], want.v, rtol=1e-6, atol=1e-9)
