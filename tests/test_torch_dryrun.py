"""The port's dry run (``repro_torch.launch.dryrun``) at CPU-test scale: the
smoke configs of qwen3-1.7B (dense) and DeepSeek-V2-Lite (MoE with MLA) in
train, prefill and decode, and a PMV step on a small graph, traced under
``FakeTensorMode`` on fake (2, 2) and (2, 2, 2) process groups in one
subprocess.  Each record has the JAX package's record keys, its
``analytic`` is the JAX package's ``launch.flops.cell_cost``, its
``argument_bytes`` the local shards' bytes computed by hand from the
sharding rules, and a sharded step shows its all-gathers (and, training,
its reduce-scatters).  A record fitted from 1 and 2 superblocks (and two
microbatch counts) equals the whole trace's, and each LM record names
the layers its step ran tensor parallel over 'model'.  The scans and the flash
loop the trace runs: RG-LRU at S = 32768 dispatches few ops, and the
RG-LRU and SSD scans and the slab-batched flash attention match the JAX
package's."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("2x2", "2x2x2")
ARCHS = ("qwen3_1_7b", "deepseek_v2_lite_16b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
PMV = "smoke@pagerank@vertical"
CELLS = [("lm", f"{a}@{s}", m) for m in MESHES for a in ARCHS for s in SHAPES] + \
        [("pmv", PMV, m) for m in MESHES]

# fitted against whole: a train cell of 3 superblocks and 4 microbatches
# (fitted from 1, 2 and 2, 3), prefill cells of 4 superblocks and of 3 plus
# a tail layer
FIT_CELLS = [("mamba2_130m@train_4k@ga4", {"n_layers": 3}),
             ("qwen3_1_7b@prefill_32k", {"n_layers": 4}),
             ("recurrentgemma_9b@prefill_32k", {"n_layers": 10})]
FIT_MESH = "2x2x2"

SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
out = []
for kind, name, mesh in json.loads(sys.argv[2]):
    out.append(dryrun.run_cell(kind, name, mesh, force=True, smoke=True, results_dir=sys.argv[1]))
fits, mesh = [], dryrun.production_mesh(sys.argv[4])
for name, over in json.loads(sys.argv[3]):
    arch, shape, *variant = name.split("@")
    over = {**(dryrun.VARIANTS[variant[0]] if variant else {}), **over}
    fits.append([[tr, {k: v for k, v in meta.items() if k != "cfg"}] for tr, meta in (
        dryrun.trace_lm_cell(arch, shape, mesh, over, smoke=True, whole=whole)
        for whole in (False, True))])
print("RECORDS " + json.dumps(out))
print("FITS " + json.dumps(fits))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(d), json.dumps(CELLS),
                          json.dumps(FIT_CELLS), FIT_MESH],
                         capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RECORDS ")]
    assert line, out.stdout[-2000:] + out.stderr[-3000:]
    recs = json.loads(line[0][len("RECORDS "):])
    fits = json.loads(next(ln for ln in out.stdout.splitlines()
                           if ln.startswith("FITS "))[len("FITS "):])
    # written incrementally, one file a cell, outside benchmarks/
    assert len(list(Path(d).glob("*.json"))) == len(CELLS)
    out = {(r["kind"], r["cell"], r["mesh"]): r for r in recs}
    out["fits"] = dict(zip((name for name, _ in FIT_CELLS), fits))
    return out


def _jax_record_keys() -> set:
    """The keys of an ok record of the JAX package's run_cell, read from its
    source (importing it would force 512 host devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                any(isinstance(t, ast.Name) and t.id == "rec" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                and t.value.id == "rec" for t in node.targets):
            keys |= {t.slice.value for t in node.targets if isinstance(t, ast.Subscript)}
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr == "update" and isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "rec" and any(
                    k.arg == "ok" and isinstance(k.value, ast.Constant) and k.value.value
                    for k in node.keywords):
            keys |= {k.arg for k in node.keywords}
    return keys


@pytest.mark.parametrize("cell", CELLS, ids=["-".join(c[1:]) for c in CELLS])
def test_cell_traces_ok_with_jax_keys(records, cell):
    """Every cell traces (ok), with the JAX package's record keys and
    compile_s 0 (nothing is compiled); an LM cell counts its matmul flops
    (FlopCounterMode counts matmuls and attention only: a PMV step, all
    gathers and scatters, counts 0)."""
    rec = records[cell]
    assert rec["ok"], rec.get("error")
    assert set(rec) == _jax_record_keys()
    assert rec["compile_s"] == 0.0
    assert (rec["cost"]["flops"] > 0) == (cell[0] == "lm")
    assert set(rec["memory"]) == {"temp_bytes", "argument_bytes", "output_bytes", "alias_bytes",
                                  "generated_code_bytes", "peak_bytes"}
    assert rec["mesh_shape"] == dict(zip(("pod", "data", "model")[3 - len(cell[2].split("x")):],
                                         map(int, cell[2].split("x"))))


LM = [c for c in CELLS if c[0] == "lm"]


@pytest.mark.parametrize("cell", LM, ids=["-".join(c[1:]) for c in LM])
def test_analytic_is_jax_cell_cost(records, cell):
    """analytic is the JAX package's launch.flops.cell_cost of the same
    (config, mode, seq, batch, grad_accum)."""
    from repro import configs as jconfigs
    from repro.launch import flops as jflops
    from repro_torch.launch.dryrun import SMOKE_SHAPES

    rec = records[cell]
    arch, shape = cell[1].split("@")
    seq, batch, mode = SMOKE_SHAPES[shape]
    cfg = jconfigs.smoke_config(arch)
    want = jflops.cell_cost(cfg, mode, seq, batch, grad_accum=rec["meta"].get("grad_accum", 1),
                            vis_tokens=cfg.n_vision_tokens).as_dict()
    assert rec["analytic"] == want


def _local(shape, spec, sizes) -> int:
    n = int(np.prod(shape))
    for e in spec:
        for a in (() if e is None else (e if isinstance(e, tuple) else (e,))):
            n //= sizes[a]
    return n


@pytest.mark.parametrize("cell", LM, ids=["-".join(c[1:]) for c in LM])
def test_argument_bytes_are_the_local_shards(records, cell):
    """argument_bytes is the bytes of this rank's local shards, computed by
    hand from the sharding rules: the parameters (and, training, both
    float32 moments and the two int32 step counters), the batch rows, and
    for decode the caches."""
    from repro_torch import configs as tconfigs
    from repro_torch.launch.dryrun import SMOKE_SHAPES
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import build_model

    rec = records[cell]
    arch, shape = cell[1].split("@")
    seq, batch, mode = SMOKE_SHAPES[shape]
    shape_ = tuple(int(x) for x in cell[2].split("x"))
    names = ("pod", "data", "model")[3 - len(shape_):]
    mesh = AbstractMesh(shape_, names)
    sizes = dict(zip(names, shape_))
    cfg = tconfigs.smoke_config(arch)
    model = build_model(cfg, "cpu")
    params = model.params()
    specs = sh.param_shardings(params, mesh)
    p_bytes = sum(_local(p.shape, specs[k], sizes) * p.element_size() for k, p in params.items())
    want = p_bytes
    if mode == "train":
        want += sum(_local(p.shape, specs[k], sizes) * 4 * 2 for k, p in params.items()) + 8
        tok = np.zeros((batch, seq), np.int32)
    else:
        tok = np.zeros((batch, seq if mode == "prefill" else 1), np.int32)
    want += _local(tok.shape, sh.batch_shardings({"t": tok}, mesh)["t"], sizes) * 4
    if mode == "decode":
        cache = model.init_cache(batch, seq)
        cspecs = sh.cache_shardings(cache, mesh, cfg)

        def walk(c, s):
            if isinstance(c, dict):
                return sum(walk(c[k], s[k]) for k in c)
            if isinstance(c, list):
                return sum(walk(a, b) for a, b in zip(c, s))
            return _local(c.shape, s, sizes) * c.element_size()
        want += walk(cache, cspecs)
    assert rec["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("cell", LM, ids=["-".join(c[1:]) for c in LM])
def test_record_names_its_tp_layers(records, cell):
    """Each LM record's meta gives the layout its step ran: a train or
    prefill step ``spmd.tp_layout`` of the config on the mesh's 2-wide
    'model' dim (qwen3: attention, MLP and vocab TP; DeepSeek: its MLA
    gathered over 'model', its MLP, MoE experts and vocab TP), named in
    ``parallelism``; a decode step none (every weight gathered)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import spmd

    meta = records[cell]["meta"]
    if cell[1].endswith("decode_32k"):
        assert meta["layout"] == {} and meta["parallelism"].startswith("decode: "), meta
        return
    want = spmd.tp_layout(smoke_config(cell[1].split("@")[0]), 2)
    assert meta["layout"] == want
    tp = [k for k, v in want.items() if v == "tp"]
    assert tp and meta["parallelism"].startswith(f"TP over 'model': {', '.join(tp)}")
    assert ("mla (not ported to TP)" in meta["parallelism"]) == cell[1].startswith("deepseek")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_matmuls_show_their_collectives(records, arch, mesh):
    """A train step all-gathers its 2D-sharded weights and reduce-scatters
    their gradients; prefill and decode all-gather the weights and, dense,
    scatter nothing (the MoE's global dispatch returns each rank's tokens
    by a reduce-scatter in prefill; decode routes each rank's own)."""
    train = records["lm", f"{arch}@train_4k", mesh]["collectives"]
    assert train["counts"]["all-gather"] > 0 and train["counts"]["reduce-scatter"] > 0
    assert train["bytes"]["total"] == sum(v for k, v in train["bytes"].items() if k != "total")
    moe = arch == "deepseek_v2_lite_16b"
    for shape in ("prefill_32k", "decode_32k"):
        c = records["lm", f"{arch}@{shape}", mesh]["collectives"]
        assert c["counts"]["all-gather"] > 0, shape
        assert (c["counts"]["reduce-scatter"] > 0) == (moe and shape == "prefill_32k"), shape


@pytest.mark.parametrize("mesh", MESHES)
def test_pmv_step_records_its_exchange(records, mesh):
    """The PMV vertical step's partials cross ranks by all-to-all: the record
    counts it with its result bytes (a c10d op's output argument), and the
    convergence delta by all-reduce."""
    c = records["pmv", PMV, mesh]["collectives"]
    assert c["counts"]["all-to-all"] > 0 and c["bytes"]["all-to-all"] > 0
    assert c["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("cell", [name for name, _ in FIT_CELLS])
def test_fitted_record_equals_whole_trace(records, cell):
    """An LM cell's counts fitted from its step traced at 1 and 2
    superblocks (and, training, at 2 and 3 microbatches; what run_cell
    records) equal the step traced whole: flops, the collectives' bytes and
    counts by kind, and every memory figure (temp bytes included)."""
    (fitted, f_meta), (whole, w_meta) = records["fits"][cell]
    n_sb = f_meta["fit"]["n_sb"]
    assert f_meta["fit"]["superblocks"] == [1, 2] and n_sb > 2
    assert w_meta["fit"]["superblocks"] == [n_sb]
    if "train" in cell:
        assert f_meta["fit"]["microbatches"] == [2, 3]
        assert w_meta["fit"]["microbatches"] == [f_meta["grad_accum"]] == [4]
    assert fitted["flops"] == whole["flops"] > 0
    for key in ("bytes", "raw_bytes", "counts"):
        assert fitted["collectives"][key] == whole["collectives"][key], key
    assert fitted["memory"] == whole["memory"]


# the RG-LRU block at S = 32768 dispatched 327,757 ops under FakeTensorMode
# with its per-timestep loop (before the associative scan)
RGLRU_LOOP_OPS = 327_757


def test_rglru_block_dispatches_log_depth_ops():
    """One rglru_block at S = 32768 (the prefill_32k cells' length) under
    FakeTensorMode dispatches at most 1/50 of the per-timestep loop's ops."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import configs as tconfigs
    from repro_torch.models import rglru

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    cfg = tconfigs.smoke_config("recurrentgemma_9b")
    with FakeTensorMode():
        p = rglru.init_rglru_block(torch.Generator(device="cpu"), cfg)
        x = torch.zeros((1, 32768, cfg.d_model))
        with Count():
            y = rglru.rglru_block(p, x, cfg)
    assert tuple(y.shape) == (1, 32768, cfg.d_model)
    assert 0 < Count.n <= RGLRU_LOOP_OPS / 50, Count.n


def _t(a):
    import torch

    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("S", [1, 2, 21, 64])
def test_rglru_scan_matches_jax_at_any_length(S):
    """The RG-LRU block's scan (JAX's recursion: odd and even lengths at
    each level) against the JAX package's associative scan at the RG-LRU
    test's tolerance."""
    import jax
    from repro import configs as jcfgs
    from repro.models import rglru as jrglru
    from repro_torch import configs as tconfigs
    from repro_torch.models import rglru as trglru

    cfg, jcfg = tconfigs.smoke_config("recurrentgemma_9b"), jcfgs.smoke_config("recurrentgemma_9b")
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(2), jcfg)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jrglru.rglru_block(p, x, jcfg))(jp, x)
    got = trglru.rglru_block(tp, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S", [8, 24, 56])
def test_ssd_scan_matches_jax_at_any_chunk_count(S):
    """The SSD's inter-chunk scan at 1, 3 and 7 chunks against the JAX
    package's ssd_chunked at the SSD test's tolerance."""
    import jax
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm

    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 4, 8
    args = (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.1, 0.9, size=(B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32))
    y, final = tssm.ssd_chunked(*map(_t, args), chunk=8)
    jy, jfinal = jax.jit(lambda *a: jssm.ssd_chunked(*a, chunk=8))(*args)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("skip", [False, True])
def test_flash_slabs_match_jax(window, skip):
    """flash_attention with more query chunks than a slab (20 chunks: slabs
    of 8, 8 and 4, and with skipping, ranges that start mid-way) against
    the JAX package's flash_attention and the dense attention, at the flash
    test's tolerances."""
    import jax
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    assert tlayers.FLASH_SLAB_CHUNKS < 20
    rng = np.random.default_rng(7)
    B, S, H, KVH, dh = 1, 160, 4, 2, 8
    q, k, v = (rng.standard_normal((B, S, h, dh)).astype(np.float32) for h in (H, KVH, KVH))
    kw = dict(causal=True, window=window, q_chunk=8, k_chunk=8, skip_masked=skip)
    got = tlayers.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = jax.jit(lambda *a: jlayers.flash_attention(*a, **kw))(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    dense = tlayers.attention(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)
