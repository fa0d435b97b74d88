"""Package rules of the PyTorch port: it never imports JAX or the JAX
package, its engine and server run on the GPU unless told otherwise, every
knob outside the ported slice raises NotImplementedError naming the knob,
the SPMD knobs name what they need when it is missing, and the store knobs
the slice takes behave as the JAX package's do."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro.serving as JS
import repro_torch.core as T
import repro_torch.serving as TS
from repro.graph import erdos_renyi, rmat

ROOT = Path(__file__).resolve().parents[1]


def test_port_modules_never_import_jax_or_reference():
    """Import every repro_torch module (and chip_smoke.py) in a fresh
    interpreter: neither jax nor repro may end up in sys.modules."""
    code = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = []
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert {"repro_torch.core.engine", "repro_torch.core.placement",
            "repro_torch.core.sparse_exchange", "repro_torch.exchange.codec",
            "repro_torch.exchange.plan", "repro_torch.exchange.runtime",
            "repro_torch.kernels.build", "repro_torch.kernels.ell_spmv.ops",
            "repro_torch.kernels.block_gimv.ops",
            "repro_torch.kernels.scatter_combine.ops",
            "repro_torch.serving.batcher", "repro_torch.serving.server",
            "repro_torch.store.format", "repro_torch.store.manifest",
            "repro_torch.store.ingest", "repro_torch.store.verify",
            "repro_torch.store.residency", "repro_torch.faults.retry", "repro_torch.faults.plan",
            "repro_torch.graph.io", "repro_torch.obs.profiler", "repro_torch.obs.fleet",
            "repro_torch.obs.live", "repro_torch.cli"} <= set(report["modules"])


def test_engine_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = rmat(6, 200, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.PMVEngine(edges, 64, b=2)
    with pytest.raises(RuntimeError):
        T.PMVEngine(edges, 64, b=2, device="cuda")
    assert T.PMVEngine(edges, 64, b=2, device="cpu").device.type == "cpu"


# The engine and the server take the out-of-core store's knobs (store,
# residency, store_budget_bytes, io_retry; the engine also strategy='hybrid'
# with residency='disk'), obs, and the fault-tolerance layer's knobs
# (capacity='model' and any other non-structural capacity, which the JAX
# package sizes from the model too; slack; payload_dtype; faults, where a
# non-plan is a TypeError), and the server's live telemetry (telemetry;
# the engine has no such knob).  A case whose knob is taken holds the port to
# what the JAX package does with the same arguments: the same exception
# class, or an answer from both (without a store the server, like the JAX
# package's, holds its edges resident and ignores residency and the
# budget).  STORE stands for a θ-split store of the same graph.
STORE = "<store>"
TAKEN = ("store", "residency", "store_budget_bytes", "io_retry", "strategy", "obs",
         "capacity", "payload_dtype", "faults", "slack", "telemetry")
# the SPMD knobs, without the process group and DeviceMesh they need
SPMD_TAKEN = {"mesh": (TypeError, "DeviceMesh"), "exchange": (ValueError, "tuple axis_name")}


@pytest.fixture(scope="module")
def knob_store(tmp_path_factory):
    from repro_torch.store import ingest_edges

    root = str(tmp_path_factory.mktemp("knob_store") / "s")
    ingest_edges(rmat(6, 200, seed=0), 64, 2, root, theta=4.0)
    return root


def _outcome(mod, qmod, cls, knob, root, **extra) -> str:
    """Build ``cls`` (an engine or a server) with ``knob`` and answer one
    SSSP solve or query: 'ok', or the class name of what was raised.  A
    server is closed afterwards (it stops a telemetry exporter's thread)."""
    kw = {k: root if v == STORE else v for k, v in knob.items()}
    on_store = kw.get("store") == root
    graph = (None,) if on_store else (rmat(6, 200, seed=0), 64)
    obj = None
    try:
        obj = cls(*graph, **({} if on_store else {"b": 2}), **kw, **extra)
        if hasattr(obj, "serve"):
            obj.serve([qmod.Query("sssp", source=0, tol=0.5)])
        else:
            obj.run(mod.sssp(0), max_iters=3, tol=0.5)
    except Exception as e:  # noqa: BLE001 -- the class is what is compared
        return type(e).__name__
    finally:
        if hasattr(obj, "serve"):
            obj.close()
    return "ok"


@pytest.mark.parametrize("knob", [
    dict(mesh=object()), dict(store="x"), dict(residency="disk"), dict(backend="xla"),
    dict(exchange="hier"), dict(residency="host"), dict(capacity="model"),
    dict(payload_dtype="bfloat16"), dict(capacity="fixed"), dict(obs=True), dict(faults=object()),
    dict(io_retry=object()), dict(backend="pallas"),
    dict(telemetry=True), dict(store_budget_bytes=1 << 20), dict(slack=1.5),
    dict(strategy="hybrid", residency="disk"),
    dict(store=STORE, residency="disk", store_budget_bytes=8),
    dict(store=STORE, residency="disk", strategy="hybrid", theta=4.0),
    dict(store=STORE, residency="disk", strategy="hybrid", theta=9.0),
    dict(store=STORE, residency="host", strategy="hybrid", theta=4.0),
    dict(store=STORE, residency="disk", io_retry=None, strategy="vertical", n=64, b=2),
    dict(store=STORE, residency="disk", strategy="vertical", b=4)])
def test_knobs_outside_the_slice_raise(knob, knob_store):
    """PMVEngine and PMVServer each refuse the knobs they do not take yet;
    the store knobs they take behave as the JAX package's do.  The SPMD
    knobs are taken (tests/test_torch_spmd.py): a mesh that is not a
    DeviceMesh is a TypeError, exchange='hier' without one a ValueError."""
    name = next(iter(knob))
    if name in SPMD_TAKEN:
        exc, text = SPMD_TAKEN[name]
        with pytest.raises(exc, match=text):
            T.PMVEngine(rmat(6, 200, seed=0), 64, b=2, device="cpu", **knob)
        with pytest.raises(exc, match=text):
            TS.PMVServer(rmat(6, 200, seed=0), 64, b=2, device="cpu", **knob)
        return
    if name in TAKEN:
        for mod, qmod, j_cls, t_cls in ((J, JS, J.PMVEngine, T.PMVEngine),
                                        (J, JS, JS.PMVServer, TS.PMVServer)):
            want = _outcome(mod, qmod, j_cls, knob, knob_store)
            got = _outcome(T, TS, t_cls, knob, knob_store, device="cpu")
            assert got == want, (t_cls.__name__, got, want)
        return
    with pytest.raises(NotImplementedError, match=name):
        T.PMVEngine(rmat(6, 200, seed=0), 64, b=2, device="cpu", **knob)
    with pytest.raises(NotImplementedError, match=name):
        TS.PMVServer(rmat(6, 200, seed=0), 64, b=2, device="cpu", **knob)


@pytest.mark.parametrize("knob,exc,text", [
    (dict(mesh=object()), TypeError, "DeviceMesh"),
    (dict(exchange="hier"), ValueError, "tuple axis_name"),
    (dict(backend="pallas"), NotImplementedError, "backend='pallas'"),
    (dict(backend="xla"), NotImplementedError, "backend='xla'")])
def test_remaining_refusals_name_their_knob(knob, exc, text):
    """Each knob the port still refuses raises NotImplementedError naming the
    knob (and its value where the knob takes other values); the SPMD knobs,
    taken now, name what they need when it is missing: a DeviceMesh, and
    for 'hier' a mesh with a tuple axis_name."""
    edges = rmat(6, 200, seed=0)
    with pytest.raises(exc, match=text.replace("'", ".")) as ei:
        T.PMVEngine(edges, 64, b=2, device="cpu", **knob)
    assert text in str(ei.value)
    with pytest.raises(exc) as ei:
        TS.PMVServer(edges, 64, b=2, device="cpu", **knob)
    assert text in str(ei.value)


@pytest.mark.parametrize("module,package", [("repro_torch.store.spmd", "repro_torch.store")])
def test_unported_modules_are_named(module, package):
    """The JAX package's modules outside the port (the SPMD store) do not
    exist in it, and the package that would hold each says so by name."""
    import importlib

    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(module)
    doc = importlib.import_module(package).__doc__
    assert "Not ported yet" in doc and module.rsplit(".", 1)[1] in doc


@pytest.mark.parametrize("module", ["repro_torch.obs", "repro_torch.obs.profiler",
                                    "repro_torch.obs.fleet", "repro_torch.obs.live",
                                    "repro_torch.cli"])
def test_ported_modules_match_reference(module):
    """The observability modules and the CLI the port took over from the JAX
    package export the JAX package's ``__all__``, and each imports in a
    fresh interpreter without pulling in jax or the JAX package."""
    import importlib

    reference = importlib.import_module("repro" + module[len("repro_torch"):])
    assert importlib.import_module(module).__all__ == reference.__all__
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_packed_exchange_and_delta_eps_are_accepted():
    """exchange='packed' / 'auto' and delta_eps are in the slice: the engine
    and the server take them; a negative delta_eps is refused."""
    edges = rmat(6, 200, seed=0)
    for exchange in ("packed", "auto"):
        eng = T.PMVEngine(edges, 64, b=2, strategy="vertical", exchange=exchange,
                          delta_eps=0.0, device="cpu")
        assert eng.prepare(T.pagerank(64))[-1]["exchange"] in ("packed", "sparse")
        TS.PMVServer(edges, 64, b=2, exchange=exchange, device="cpu")
    with pytest.raises(ValueError, match="delta_eps"):
        T.PMVEngine(edges, 64, b=2, delta_eps=-1.0, device="cpu")


def test_checkpointing_and_query_axis_raise(tmp_path):
    """Checkpointing is taken: a run with ``checkpoint_dir`` writes the JAX
    package's ``pmv_state.npz`` and answers as the run without it does (it
    raised here before checkpointing was ported).  A trailing query axis is
    served: a one-column batch [b, n_local, 1] steps exactly as the single
    vector does."""
    eng = T.PMVEngine(rmat(6, 200, seed=0), 64, b=2, strategy="vertical", device="cpu")
    ck = tmp_path / "ckpt"
    res = eng.run(T.sssp(0), checkpoint_dir=str(ck), checkpoint_every=1)
    np.testing.assert_array_equal(res.v, eng.run(T.sssp(0)).v)
    with np.load(ck / "pmv_state.npz") as z:
        assert int(z["it"]) == res.iterations and z["v"].shape == (2, 32)
    matrix, v, ctx, mask, meta = eng.prepare(T.sssp(0))
    one, r_one, _ = T.placement_call(T.sssp(0), meta["cfg"], matrix, v, ctx, mask)
    batched, r_b, stats = T.placement_call(T.sssp(0), meta["cfg"], matrix, v[..., None], ctx,
                                           mask)
    assert tuple(batched.shape) == tuple(v.shape) + (1,)
    assert torch.equal(batched[..., 0], one) and torch.equal(r_b[..., 0], r_one)
    assert float(stats["overflow"]) == 0.0


def test_stream_auto_resolving_on_raises():
    """b=8 with a small capacity makes the JAX package's default
    stream='auto' resolve to 'on'.  The port resolves it the same way (it
    raised here before the streamed executor was ported) and the streamed
    solve equals the JAX package's streamed solve."""
    edges = erdos_renyi(1024, 1500, seed=3)
    ref = J.PMVEngine(edges, 1024, b=8, strategy="vertical", backend="auto")
    assert ref.prepare(J.sssp(0))[-1]["cfg"].stream == "on"
    port = T.PMVEngine(edges, 1024, b=8, strategy="vertical", backend="auto", device="cpu")
    assert port.prepare(T.sssp(0))[-1]["plan"].stream == "on"
    r_port, r_ref = port.run(T.sssp(0)), ref.run(J.sssp(0))
    np.testing.assert_array_equal(r_port.v, r_ref.v)
    assert r_port.iterations == r_ref.iterations and r_port.converged


# (engine knobs, whether the JAX package streams the solve on a forced 'on')
FORCED_STREAM = {
    "horizontal": (dict(strategy="horizontal", backend="auto"), False),
    "torch_backend": (dict(strategy="vertical", backend="torch"), False),
    "dense_exchange": (dict(strategy="vertical", backend="auto", exchange="dense"), False),
    "hybrid_torch": (dict(strategy="hybrid", theta=6.0, backend="torch"), False),
    "planned_hybrid": (dict(strategy="hybrid", theta=6.0, backend="auto"), True),
    "planned_vertical_sparse": (dict(strategy="vertical", backend="auto"), True),
    "planned_vertical_packed": (dict(strategy="vertical", backend="auto",
                                     exchange="packed"), True),
}


@pytest.mark.parametrize("case", sorted(FORCED_STREAM))
def test_forced_stream_on(case):
    """A forced stream='on' resolves as the JAX package resolves it: to
    'off' wherever that package finds nothing to stream, and to 'on'
    (the streamed executor) where it streams.  Either way the engine and
    the server answer bit for bit as stream='off' does, and as the JAX
    package's stream='on' solve does (SSSP: exact).  The server builds its
    engines with the same knobs."""
    knobs, streams = FORCED_STREAM[case]
    edges = rmat(7, 700, seed=5)
    ref_knobs = dict(knobs, backend={"torch": "xla"}.get(knobs["backend"], knobs["backend"]))
    ref = J.PMVEngine(edges, 128, b=4, stream="on", **ref_knobs)
    assert (ref.prepare(J.sssp(0))[-1]["cfg"].stream == "on") == streams
    port = T.PMVEngine(edges, 128, b=4, stream="on", device="cpu", **knobs)
    server = TS.PMVServer(edges, 128, b=4, stream="on", device="cpu", **knobs)
    matrix, *_, meta = port.prepare(T.sssp(0))
    assert meta["cfg"].plan.stream == ("on" if streams else "off")
    assert any(k.startswith("streamed") for k in matrix) == streams
    on = port.run(T.sssp(0), max_iters=30, tol=0.5)
    off = T.PMVEngine(edges, 128, b=4, stream="off", device="cpu", **knobs).run(
        T.sssp(0), max_iters=30, tol=0.5)
    np.testing.assert_array_equal(on.v, off.v)
    assert on.iterations == off.iterations and on.converged
    r_ref = ref.run(J.sssp(0), max_iters=30, tol=0.5)
    np.testing.assert_array_equal(on.v, r_ref.v)
    assert on.iterations == r_ref.iterations
    served = server.serve([TS.Query("sssp", source=0, tol=0.5)])[0]
    np.testing.assert_array_equal(served.vector, off.v)


def test_spec_without_kernel_semiring_resolves_to_torch():
    """(mul, min) has no kernel semiring: 'auto' resolves to the plain backend,
    as the JAX package resolves it to 'xla'."""
    def spec(mod, xp):
        return mod.GimvSpec(name="mulmin", combine2="mul", combine_all="min",
                            dtype=np.float32, assign=lambda v, r, c: xp.minimum(v, r),
                            init=lambda ids, c: (ids % 7).astype(np.float32))
    import jax.numpy as jnp

    edges = rmat(7, 600, seed=2)
    ref = J.PMVEngine(edges, 128, b=4, strategy="vertical", backend="auto")
    port = T.PMVEngine(edges, 128, b=4, strategy="vertical", backend="auto", device="cpu")
    j_spec, t_spec = spec(J, jnp), spec(T, torch)
    assert ref.prepare(j_spec)[-1]["backend"] == "xla"
    assert port.prepare(t_spec)[-1]["backend"] == "torch"
    r_ref = ref.run(j_spec, max_iters=20, tol=0.5)
    r_port = port.run(t_spec, max_iters=20, tol=0.5)
    np.testing.assert_array_equal(r_port.v, r_ref.v)
    assert r_port.iterations == r_ref.iterations


def test_bad_spec_and_partition_arguments_raise():
    with pytest.raises(ValueError, match="combine_all"):
        T.GimvSpec(name="x", combine2="mul", combine_all="prod", dtype=np.float32,
                   assign=None, init=None)
    with pytest.raises(ValueError, match="psi"):
        T.PMVEngine(rmat(6, 200, seed=0), 64, b=2, psi="hash", device="cpu").run(T.sssp(0))
