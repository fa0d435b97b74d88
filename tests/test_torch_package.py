"""Package rules of the PyTorch port: it never imports JAX or the JAX
package, its engine and server run on the GPU unless told otherwise, and
every knob outside the ported slice raises NotImplementedError naming the
knob."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
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
            "repro_torch.serving.batcher", "repro_torch.serving.server"} <= set(report["modules"])


def test_engine_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = rmat(6, 200, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.PMVEngine(edges, 64, b=2)
    with pytest.raises(RuntimeError):
        T.PMVEngine(edges, 64, b=2, device="cuda")
    assert T.PMVEngine(edges, 64, b=2, device="cpu").device.type == "cpu"


ENGINE_ONLY = ()
SERVER_ONLY = ("telemetry", "store_budget_bytes", "slack")


@pytest.mark.parametrize("knob", [
    dict(mesh=object()), dict(store="x"), dict(residency="disk"), dict(backend="xla"),
    dict(exchange="hier"), dict(residency="host"), dict(capacity="model"),
    dict(payload_dtype="bfloat16"), dict(capacity="fixed"), dict(obs=True), dict(faults=object()),
    dict(io_retry=object()), dict(backend="pallas"),
    dict(telemetry=True), dict(store_budget_bytes=1 << 20), dict(slack=1.5)])
def test_knobs_outside_the_slice_raise(knob):
    """PMVEngine and PMVServer both refuse each knob they take."""
    name = next(iter(knob))
    if name not in SERVER_ONLY:
        with pytest.raises(NotImplementedError, match=name):
            T.PMVEngine(rmat(6, 200, seed=0), 64, b=2, device="cpu", **knob)
    if name not in ENGINE_ONLY:
        with pytest.raises(NotImplementedError, match=name):
            TS.PMVServer(rmat(6, 200, seed=0), 64, b=2, device="cpu", **knob)


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


def test_checkpointing_and_query_axis_raise():
    """Checkpointing raises; a trailing query axis is served: a one-column
    batch [b, n_local, 1] steps exactly as the single vector does."""
    eng = T.PMVEngine(rmat(6, 200, seed=0), 64, b=2, strategy="vertical", device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        eng.run(T.sssp(0), checkpoint_dir="ckpt")
    matrix, v, ctx, mask, meta = eng.prepare(T.sssp(0))
    one, r_one, _ = T.placement_call(T.sssp(0), meta["cfg"], matrix, v, ctx, mask)
    batched, r_b, stats = T.placement_call(T.sssp(0), meta["cfg"], matrix, v[..., None], ctx,
                                           mask)
    assert tuple(batched.shape) == tuple(v.shape) + (1,)
    assert torch.equal(batched[..., 0], one) and torch.equal(r_b[..., 0], r_one)
    assert float(stats["overflow"]) == 0.0


def test_stream_auto_resolving_on_raises():
    """b=8 with a small capacity makes the JAX package stream; the port has
    no streamed executor yet and says so."""
    edges = erdos_renyi(1024, 1500, seed=3)
    assert J.PMVEngine(edges, 1024, b=8, strategy="vertical", backend="auto").prepare(
        J.sssp(0))[-1]["cfg"].stream == "on"
    with pytest.raises(NotImplementedError, match="stream"):
        T.PMVEngine(edges, 1024, b=8, strategy="vertical", backend="auto",
                    device="cpu").run(T.sssp(0))


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
    """A forced stream='on' resolves to 'off' wherever the JAX package finds
    nothing to stream, and then solves bit for bit as 'off' does; where that
    package would stream it, the port (no streamed executor) raises at
    prepare.  The server builds its engines with the same knobs."""
    knobs, streams = FORCED_STREAM[case]
    edges = rmat(7, 700, seed=5)
    ref_knobs = dict(knobs, backend={"torch": "xla"}.get(knobs["backend"], knobs["backend"]))
    ref = J.PMVEngine(edges, 128, b=4, stream="on", **ref_knobs).prepare(J.sssp(0))[-1]
    assert (ref["cfg"].stream == "on") == streams
    port = T.PMVEngine(edges, 128, b=4, stream="on", device="cpu", **knobs)
    server = TS.PMVServer(edges, 128, b=4, stream="on", device="cpu", **knobs)
    if streams:
        with pytest.raises(NotImplementedError, match="stream"):
            port.run(T.sssp(0), max_iters=30, tol=0.5)
        with pytest.raises(NotImplementedError, match="stream"):
            server.serve([TS.Query("sssp", source=0, tol=0.5)])
        return
    assert port.prepare(T.sssp(0))[-1]["cfg"].plan.stream == "off"
    on = port.run(T.sssp(0), max_iters=30, tol=0.5)
    off = T.PMVEngine(edges, 128, b=4, stream="off", device="cpu", **knobs).run(
        T.sssp(0), max_iters=30, tol=0.5)
    np.testing.assert_array_equal(on.v, off.v)
    assert on.iterations == off.iterations and on.converged
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
