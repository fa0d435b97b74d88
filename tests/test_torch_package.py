"""Package rules of the PyTorch port: it never imports JAX or the JAX
package, its engine and server run on the GPU unless told otherwise, every
engine and server knob of the JAX package is taken and behaves as the JAX
package's does, and the SPMD knobs name what they need when it is
missing."""
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
            "repro_torch.store.residency", "repro_torch.store.spmd",
            "repro_torch.store.shard", "repro_torch.faults.retry", "repro_torch.faults.plan",
            "repro_torch.graph.io", "repro_torch.obs.profiler", "repro_torch.obs.fleet",
            "repro_torch.obs.live", "repro_torch.cli", "repro_torch.configs",
            "repro_torch.configs.qwen3_1_7b", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.mla", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.models.rglru",
            "repro_torch.models.transformer", "repro_torch.models.model",
            "repro_torch.models.convert", "repro_torch.launch.flops",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.training.optimizer", "repro_torch.training.data",
            "repro_torch.training.train_step",
            "repro_torch.training.checkpoint", "repro_torch.training.pipeline",
            "repro_torch.models.sharding", "repro_torch.models.spmd",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo_analysis",
            "repro_torch.launch.roofline"} <= set(report["modules"])


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
# budget).  STORE stands for a θ-split store of the same graph.  The
# forced backends are taken too: 'pallas' (the flat-ELL layout) and 'xla'
# (the port's 'torch').
STORE = "<store>"
TAKEN = ("store", "residency", "store_budget_bytes", "io_retry", "strategy", "obs",
         "capacity", "payload_dtype", "faults", "slack", "telemetry", "backend")
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
    """PMVEngine and PMVServer take every knob here and behave as the JAX
    package's do (backend='xla' and 'pallas' included, which they refused
    before the flat-ELL backend was ported).  The SPMD knobs are taken,
    under residency='disk' too (tests/test_torch_spmd.py,
    tests/test_torch_spmd_disk.py): a mesh that is not a DeviceMesh is a
    TypeError, exchange='hier' without one a ValueError."""
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
    (dict(pallas_interpret=False), ValueError, "pallas_interpret=False"),
    (dict(parse_computations="HloModule m"), NotImplementedError, "parse_computations")])
def test_remaining_refusals_name_their_knob(knob, exc, text):
    """The engine and the server take every knob of the JAX package's; where
    a knob lacks what it needs they name it: a DeviceMesh, for 'hier' a mesh
    with a tuple axis_name, and for pallas_interpret=False a CUDA device.
    ``launch.hlo_analysis.parse_computations`` reads XLA HLO text, which the
    port never produces: it raises, naming itself."""
    if "parse_computations" in knob:
        from repro_torch.launch.hlo_analysis import parse_computations

        with pytest.raises(exc, match=text) as ei:
            parse_computations(knob["parse_computations"])
        assert "HLO" in str(ei.value)
        return
    edges = rmat(6, 200, seed=0)
    with pytest.raises(exc, match=text.replace("'", ".")) as ei:
        T.PMVEngine(edges, 64, b=2, device="cpu", **knob)
    assert text in str(ei.value)
    with pytest.raises(exc) as ei:
        TS.PMVServer(edges, 64, b=2, device="cpu", **knob)
    assert text in str(ei.value)


@pytest.mark.parametrize("module,package", [
    ("repro_torch.training.pipeline", "repro_torch.training"),
    ("repro_torch.launch.dryrun", "repro_torch.launch"),
    ("repro_torch.launch.hlo_analysis", "repro_torch.launch"),
    ("repro_torch.launch.roofline", "repro_torch.launch"),
    ("repro_torch.launch.mesh", "repro_torch.launch"),
    ("repro_torch.models.sharding", "repro_torch.models")])
def test_unported_modules_are_named(module, package):
    """The JAX package's modules that were outside the port (the
    multi-device LM slice: the GPipe pipeline, the mesh launcher and the
    models' sharding; the dryrun / hlo_analysis / roofline launchers) are
    ported now: each imports, and neither the port's root docstring nor
    its package's lists it as not ported (no module of the JAX package is
    left unported: the docstrings say "Not ported yet" nowhere)."""
    import importlib

    importlib.import_module(module)
    for doc in (importlib.import_module("repro_torch").__doc__,
                importlib.import_module(package).__doc__):
        assert "Not ported yet" not in doc and "not ported" not in doc.lower()


PORTED = ["repro_torch.obs", "repro_torch.obs.profiler", "repro_torch.obs.fleet",
          "repro_torch.obs.live", "repro_torch.cli", "repro_torch.store",
          "repro_torch.store.shard", "repro_torch.store.spmd", "repro_torch.core",
          "repro_torch.configs", "repro_torch.models.config", "repro_torch.models.layers",
          "repro_torch.models.mla", "repro_torch.models.moe", "repro_torch.models.ssm",
          "repro_torch.models.rglru", "repro_torch.models.transformer",
          "repro_torch.models.model", "repro_torch.launch.flops", "repro_torch.launch.serve",
          "repro_torch.training", "repro_torch.training.optimizer", "repro_torch.training.data",
          "repro_torch.training.train_step", "repro_torch.training.checkpoint",
          "repro_torch.launch.train", "repro_torch.training.pipeline",
          "repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis",
          "repro_torch.launch.roofline", "repro_torch.launch.mesh",
          "repro_torch.models.sharding"]


@pytest.fixture(scope="module")
def fresh_imports():
    """One fresh interpreter imports the PORTED modules in turn and lists,
    after each, the jax / jaxlib / repro modules then loaded: a module that
    pulls one in is the first whose list is not empty."""
    code = ("import importlib, json, sys\n"
            "out = {}\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module(m)\n"
            "    out[m] = sorted(k for k in sys.modules\n"
            "                    if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(json.dumps(out))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, *PORTED], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", PORTED)
def test_ported_modules_match_reference(module, fresh_imports):
    """The core (``make_step`` included), the observability modules, the CLI,
    the store (its SPMD group and its physical shards included), the LM
    serving slice (configs, the models, ``launch.flops`` and
    ``launch.serve``), the LM training slice (``training`` and its
    modules, ``launch.train``) and the multi-device slice (``pipeline``,
    ``models.sharding``, ``launch.mesh`` / ``dryrun`` / ``hlo_analysis`` /
    ``roofline``) the port took over from the JAX package export the JAX
    package's ``__all__`` where it has one (the configs and the serve,
    train, dryrun and roofline launchers have none), and each imports in a
    fresh interpreter without pulling in jax or the JAX package."""
    import importlib

    reference = importlib.import_module("repro" + module[len("repro_torch"):])
    port = importlib.import_module(module)
    if hasattr(reference, "__all__"):
        assert port.__all__ == reference.__all__
    else:
        assert not hasattr(port, "__all__")
    assert fresh_imports[module] == []


def test_seq_parallel_is_refused_by_name():
    """cfg.seq_parallel=True was refused before the mesh slice; now the
    model builds and runs with it.  Without a mesh the sequence-parallel
    constraints are the identity, so the loss and its gradients equal the
    plain model's bit for bit (on a mesh: tests/test_torch_mesh_ranks.py).
    A model distributed with seq_parallel on a mesh whose batch axes are not
    cfg.dp_axes is refused, naming both."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import build_model

    base = smoke_config("qwen3_1_7b")
    sp = build_model(dataclasses.replace(base, seq_parallel=True), "cpu")
    plain = build_model(base, "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab, size=(2, 32), dtype=np.int32))}
    losses = []
    for m in (sp, plain):
        loss, _ = m.loss_fn(batch)
        losses.append((loss, torch.autograd.grad(loss, list(m.params().values()))))
    assert torch.equal(losses[0][0], losses[1][0])
    assert all(torch.equal(a, b) for a, b in zip(losses[0][1], losses[1][1]))
    from repro_torch.launch.mesh import AbstractMesh

    with pytest.raises(ValueError, match="dp_axes"):
        sp.distribute(AbstractMesh((2, 2, 2), ("pod", "data", "model")))


def test_compress_pod_is_refused_by_name():
    """TrainConfig(compress_pod=True) was refused before the mesh slice; now
    make_train_step builds it on a mesh with the pod axis (it runs on 8
    gloo ranks against the JAX package's compressed step in
    tests/test_torch_mesh_ranks.py) and refuses it only without one,
    naming the knob and the axis.  init_train_state makes the float32
    error-feedback buffers."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state

    model = build_model(smoke_config("qwen3_1_7b"), "cpu")
    with pytest.raises(ValueError, match="compress_pod") as ei:
        make_train_step(model, TrainConfig(compress_pod=True))
    assert "'pod'" in str(ei.value)
    state = init_train_state(model, model.params(), TrainConfig(compress_pod=True))
    assert sorted(state["ef"]) == sorted(model.params())
    assert all(v.dtype == torch.float32 and not v.any() for v in state["ef"].values())


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
