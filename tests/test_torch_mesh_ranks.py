"""The multi-device LM slice on 8 gloo CPU ranks against the JAX package.

One module-scoped spawn (``tests/_torch_mesh.py:mesh_all``) runs every
part on a (2, 2, 2) ('pod', 'data', 'model') mesh: the layout of a batch
and of weights, the sharded train step (tensor parallel over 'model', plain
and ``seq_parallel``) of the qwen3-1.7B and Mixtral smoke configs, what the
TP step reads and sends (each TP layer's weights as 1 / model shards, no
all-gather of them over 'model', no [B, S, vocab] logits), the steps whose
attention (on a (2, 4) ('data', 'model') mesh, 2 KV heads) or vocab (255
tokens) falls back to the gather, the vocab-parallel loss,
``compress_pod``, the serving path
(the prefill forward and serve_steps of qwen3-1.7B, DeepSeek-V2-Lite (MLA +
MoE) and Whisper (cross caches), with decode_seq_shard on and off),
``pipeline_apply``, AdamW's refusal of a gradient off its parameter's
placements, and a checkpoint saved under (2, 2, 2) and restored under
(2, 4), (8,) and on one device.  While the ranks run, the parent computes the JAX package's
one-device train steps, forwards and decodes in-process and its mesh references (the layout,
the compressed step, the pipeline) in one subprocess with 8 forced host
devices, as ``tests/test_distributed.py`` does."""
from __future__ import annotations

import ast
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_spmd
from _torch_lm import Pair, as_np
from _torch_train import assert_trees_close, jax_np, jax_step
from repro_torch.models.convert import flatten_tree, params_to_tree

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 2, 2), ("pod", "data", "model"))
MESH_2x4 = ((2, 4), ("data", "model"))     # 2 KV heads on 4 'model' ranks: no TP attention
VOCAB_ODD, VOCAB_ODD_KEY = 255, "qwen3_1_7b@vocab255"
ARCHS = ("qwen3_1_7b", "mixtral_8x22b")
B, S = 8, 32                   # rows divide pod x data; S > flash_threshold (16)
LAYOUT_PARAMS = {"wq": (64, 64), "wo": (64, 64), "wte": (256, 64), "router": (64, 4),
                 "ln1": (64,), "conv_w": (4, 96)}
LAYOUT_BATCH = (8, 4)
STAGES, MICRO, MB, D = 2, 4, 8, 16          # tests/test_pipeline.py's sizes
SERVE_ARCHS = ("qwen3_1_7b", "deepseek_v2_lite_16b", "whisper_medium")   # dense, MLA + MoE, cross
SERVE_S, SERVE_STEPS = 32, 8     # 8 cache slots: 4 x model (2), so decode_seq_shard splits them
SERVE_CASES = ([{"arch": a, "forward": True, "steps": SERVE_STEPS} for a in SERVE_ARCHS]
               + [{"arch": a, "overrides": {"decode_seq_shard": False}, "steps": SERVE_STEPS}
                  for a in SERVE_ARCHS]
               + [{"arch": a, "overrides": {"seq_parallel": True}, "forward": True}
                  for a in SERVE_ARCHS])
SPAWN_TIMEOUT_S = 150.0

JAX_MESH = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import smoke_config
from repro.models import sharding as jsh
from repro.models.model import build_model
from repro.training import OptConfig, TrainConfig, make_train_step
from repro.training.pipeline import pipeline_apply
from repro.training.train_step import init_train_state

with open(sys.argv[1], "rb") as f:
    pay = pickle.load(f)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
flat = np.asarray(mesh.devices).reshape(-1)
rank_of = {d: i for i, d in enumerate(flat)}        # row-major mesh position = torch rank
out = {"layout": {}}

def slices(shape, spec):
    idx = NamedSharding(mesh, spec).devices_indices_map(shape)
    return {rank_of[d]: tuple((s.start or 0, s.stop if s.stop is not None else n)
                              for s, n in zip(ix, shape)) for d, ix in idx.items()}

shapes = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in pay["params"].items()}
specs = jsh.param_shardings(shapes, mesh)
for k, s in pay["params"].items():
    out["layout"][k] = slices(s, specs[k].spec)
bs = jsh.batch_shardings({"tokens": jax.ShapeDtypeStruct(pay["batch"], jnp.int32)}, mesh)
out["layout"]["tokens"] = slices(pay["batch"], bs["tokens"].spec)

cfg = smoke_config("qwen3_1_7b")
m = build_model(cfg)
tcfg = TrainConfig(opt=OptConfig(), compress_pod=True)
params = jax.tree.map(jnp.asarray, pay["compress_params"])
state = init_train_state(m, params, tcfg)
with mesh:
    p, s, metrics = jax.jit(make_train_step(m, tcfg, mesh))(params, state,
                                                           {"tokens": jnp.asarray(pay["tokens"])})
out["compress"] = jax.tree.map(np.asarray, {"params": p, "ef": s["ef"], "metrics": metrics})

ws, micro = jnp.asarray(pay["ws"]), jnp.asarray(pay["micro"])
stage = lambda w, x: jnp.tanh(x @ w)
with mesh:
    pout = jax.jit(lambda w, mb: pipeline_apply(stage, w, mb, mesh, axis="pod"))(ws, micro)
    g = jax.jit(jax.grad(lambda w: jnp.sum(pipeline_apply(stage, w, micro, mesh,
                                                          axis="pod") ** 2)))(ws)
out["pipeline"] = {"out": np.asarray(pout), "grad": np.asarray(g)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("JAX-MESH-OK")
"""


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)}


def _serve_batch(cfg, seed: int) -> dict:
    """Tokens [B, SERVE_S] and, for the encoder-decoder, its stub encoder
    embeddings (the serve tests' scale)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, SERVE_S), dtype=np.int32)}
    if cfg.family == "encdec":
        batch["enc_emb"] = (rng.standard_normal((B, SERVE_S, cfg.d_model)) * 0.1
                            ).astype(np.float32)
    return batch


def _jax_serving(pair, batch) -> dict:
    """The JAX package's one-device forward logits [B, S, V] and, after
    prefill_cache on the batch's first SERVE_STEPS positions, each
    serve_step's logits [B, V]."""
    import jax
    import jax.numpy as jnp

    (logits, _), _ = pair.jax_forward(batch)
    jb = {k: jnp.asarray(v[:, :SERVE_STEPS]) for k, v in batch.items()}
    cache = pair.jmodel.init_cache(B, SERVE_STEPS, enc_len=SERVE_STEPS)
    cache = jax.jit(pair.jmodel.prefill_cache)(pair.jparams, cache, jb)
    decode = []
    for t in range(SERVE_STEPS):
        lg, cache = pair.jax_step(pair.jparams, cache, jb["tokens"][:, t:t + 1], t)
        decode.append(as_np(lg[:, 0]))
    return {"forward": as_np(logits), "decode": decode}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(rank results, JAX mesh references, one-device JAX steps, pairs)."""
    pairs = {a: Pair(a) for a in ARCHS + SERVE_ARCHS[1:]}
    # a vocab the 'model' dim does not divide: the logits and the loss split
    # the rows over 'model' instead
    pairs[VOCAB_ODD_KEY] = Pair("qwen3_1_7b", vocab=VOCAB_ODD)
    params = {a: {k: v.numpy() for k, v in p.state.items()} for a, p in pairs.items()}
    batches = {a: _batch(pairs[a].tcfg, seed=3) for a in ARCHS + (VOCAB_ODD_KEY,)}
    serve_batches = {a: _serve_batch(pairs[a].tcfg, seed=5) for a in SERVE_ARCHS}
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((STAGES, D, D)) * 0.3).astype(np.float32)
    micro = rng.standard_normal((MICRO, MB, D)).astype(np.float32)
    cases = [{"arch": a, "mesh": MESH, "overrides": ov, "watch": True} for a in ARCHS
             for ov in ({}, {"seq_parallel": True})]
    cases.append({"arch": "qwen3_1_7b", "mesh": MESH, "compress": True})
    cases.append({"arch": "mixtral_8x22b", "mesh": MESH, "grad_accum": 2})
    cases += [{"arch": "qwen3_1_7b", "mesh": MESH_2x4, "overrides": ov, "watch": True}
              for ov in ({}, {"seq_parallel": True})]
    cases += [{"arch": "qwen3_1_7b", "key": VOCAB_ODD_KEY, "mesh": MESH, "watch": True,
               "overrides": {"vocab": VOCAB_ODD, **ov}} for ov in ({}, {"seq_parallel": True})]
    lg_rng = np.random.default_rng(11)
    vocab_logits = (lg_rng.standard_normal((2, 8, 512)) * 4).astype(np.float32)
    vocab_tgt = lg_rng.integers(0, 512, size=(2, 8)).astype(np.int64)
    ckpt_dir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    payload = {
        "layout": {"mesh": MESH, "params": LAYOUT_PARAMS, "batch": LAYOUT_BATCH},
        "steps": {"cases": cases, "params": params, "batch": batches},
        "vocab_loss": {"mesh": MESH, "logits": vocab_logits, "tgt": vocab_tgt},
        "serve": {"mesh": MESH, "cases": SERVE_CASES, "params": params,
                  "batch": serve_batches},
        "pipeline": {"mesh": MESH, "ws": ws, "micro": micro},
        "checkpoint": {"save_mesh": MESH, "arch": "qwen3_1_7b", "params": params["qwen3_1_7b"],
                       "batch": batches["qwen3_1_7b"], "dir": ckpt_dir,
                       "meshes": [((2, 4), ("data", "model")), ((8,), ("data",))]},
    }
    spawned = _torch_spmd.spawn("_torch_mesh:mesh_all", 8, payload, timeout=SPAWN_TIMEOUT_S)
    d = tempfile.mkdtemp(prefix="jax_mesh_")
    try:
        with open(os.path.join(d, "in.pkl"), "wb") as f:
            pickle.dump({"params": LAYOUT_PARAMS, "batch": LAYOUT_BATCH, "ws": ws, "micro": micro,
                         "compress_params": pairs["qwen3_1_7b"].np_params,
                         "tokens": batches["qwen3_1_7b"]["tokens"]}, f)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
        jax_proc = subprocess.Popen([sys.executable, "-c", JAX_MESH, os.path.join(d, "in.pkl"),
                                     os.path.join(d, "out.pkl")], env=env, cwd=str(ROOT),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        one_device = {a: jax_step(pairs[a], batches[a]) for a in ARCHS + (VOCAB_ODD_KEY,)}
        one_device["mixtral_8x22b", 2] = jax_step(pairs["mixtral_8x22b"],
                                                  batches["mixtral_8x22b"], grad_accum=2)
        serving = {a: _jax_serving(pairs[a], serve_batches[a]) for a in SERVE_ARCHS}
        stdout, stderr = jax_proc.communicate(timeout=SPAWN_TIMEOUT_S)
        assert "JAX-MESH-OK" in stdout, stderr[-3000:]
        with open(os.path.join(d, "out.pkl"), "rb") as f:
            jax_mesh = pickle.load(f)
        ranks = spawned.results()
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    return {"ranks": ranks, "jax_mesh": jax_mesh, "one_device": one_device, "pairs": pairs,
            "cases": cases, "serving": serving}


def _port_tree(flat: dict, cfg) -> dict:
    return {k: as_np(v) for k, v in flatten_tree(params_to_tree(
        {n: torch.from_numpy(a) for n, a in flat.items()}, cfg)).items()}


@pytest.mark.parametrize("name", sorted(LAYOUT_PARAMS) + ["tokens"])
def test_local_slices_are_jaxs(world, name):
    """Each rank's local slice of a placed weight and of a batch split over
    ('pod', 'data') is the slice JAX gives the device at the same mesh
    position (major axis first)."""
    shape = LAYOUT_BATCH if name == "tokens" else LAYOUT_PARAMS[name]
    full = np.arange(int(np.prod(shape))).reshape(shape)
    for rank, res in enumerate(world["ranks"]):
        box = world["jax_mesh"]["layout"][name][rank]
        want = full[tuple(slice(a, b) for a, b in box)]
        np.testing.assert_array_equal(res["layout"][name], want, err_msg=f"rank {rank}")


STEP_CASES = {f"{a}-{m}": i for i, (a, m) in enumerate(
    (a, m) for a in ARCHS for m in ("plain", "seq_parallel"))}
STEP_CASES.update({"qwen3_1_7b-2x4-attention_gathered": 6,
                   "qwen3_1_7b-2x4-attention_gathered-seq_parallel": 7,
                   "qwen3_1_7b-vocab255_gathered": 8,
                   "qwen3_1_7b-vocab255_gathered-seq_parallel": 9})
ODD_VOCAB = {k: v for k, v in STEP_CASES.items() if "vocab255" in k}


@pytest.mark.parametrize("case", list(STEP_CASES.values()), ids=list(STEP_CASES))
def test_sharded_step_matches_jax(world, case):
    """One sharded step, tensor parallel over 'model' on (2, 2, 2) (plain
    and with seq_parallel), on (2, 4) with the attention gathered, and with
    a 255-token vocab gathered, against the JAX package's one-device
    make_train_step of the same config with the default OptConfig: loss
    within rel 1e-6, grad_norm within rel 1e-5 and every parameter within
    1e-6 (the same on every rank)."""
    spec = world["cases"][case]
    arch, key = spec["arch"], spec.get("key", spec["arch"])
    (j_params, _, j_metrics), _ = world["one_device"][key]
    got = world["ranks"][0]["steps"][case]
    m = got["metrics"][0]
    np.testing.assert_allclose(m["loss"], float(j_metrics["loss"]), rtol=1e-6)
    np.testing.assert_allclose(m["grad_norm"], float(j_metrics["grad_norm"]), rtol=1e-5)
    for r in world["ranks"][1:]:
        assert r["steps"][case]["metrics"] == got["metrics"]
    cfg = world["pairs"][key].tcfg
    assert_trees_close(_port_tree(got["params"], cfg), jax_np(j_params), rtol=0.0, atol=1e-6,
                       what=f"{arch} {spec.get('overrides')}")


_TP_LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate", "mlp.w_up",
              "mlp.w_down", "moe.w_gate", "moe.w_up", "moe.w_down", "wte", "lm_head")


def _tp_leaf(name: str, layout: dict) -> bool:
    """Whether ``layout`` runs the layer of leaf ``name`` tensor parallel."""
    layer = ("attention" if ".attn." in name else "mlp" if ".mlp." in name
             else "moe" if ".moe." in name else "vocab" if name in ("wte", "lm_head") else None)
    return (layer is not None and layout.get(layer) == "tp"
            and any(name.endswith(t) for t in _TP_LEAVES))


@pytest.mark.parametrize("case", list(STEP_CASES.values()), ids=list(STEP_CASES))
def test_tp_layers_read_model_shards_and_gather_none(world, case):
    """The TP step on every rank: each TP layer reads each of its weights as
    its 1 / model shard (the 'model' dim's size) and never whole, every TP
    leaf is read, and no all-gather over 'model' moves a weight: without
    seq_parallel there is none, with it each is the sequence of an
    activation [S, B_loc, ...] (counted by ``CollectiveRecorder`` on the
    mesh)."""
    spec = world["cases"][case]
    n_model = spec["mesh"][0][spec["mesh"][1].index("model")]
    sp = spec.get("overrides", {}).get("seq_parallel", False)
    for rank, r in enumerate(world["ranks"]):
        got = r["steps"][case]
        layout, watch = got["layout"], got["watch"]
        tp_reads = [x for x in watch["reads"] if _tp_leaf(x[0], layout)]
        assert tp_reads and {x[0] for x in tp_reads} == {
            k for k in world["ranks"][0]["steps"][case]["params"] if _tp_leaf(k, layout)}
        for name, whole, local, how in tp_reads:
            assert how == "shard" and np.prod(local) * n_model == np.prod(whole), (rank, name)
        if set(layout.values()) == {"tp"}:
            if not sp:
                assert watch["model_gathers"] == [], (rank, watch["model_gathers"][:3])
            for line in watch["model_gathers"]:
                shape = ast.literal_eval(line.split(" ", 1)[1])[0]   # the result's shape
                assert shape[0] == S, (rank, line)
        assert watch["by_dim"]["model"]["all-reduce"][0] > 0     # reduce out / copy in


def test_loss_never_builds_full_vocab_logits(world):
    """No op of a step whose vocab runs TP outputs [B_loc, S, vocab] (the
    loss reduces each rank's [B_loc, S, vocab / model] slice over 'model');
    the steps with a 255-token vocab, which gather the logits' weight
    whole, do (the watch sees such tensors)."""
    for rank, r in enumerate(world["ranks"]):
        for name, case in STEP_CASES.items():
            logits = r["steps"][case]["watch"]["logits"]
            assert bool(logits) == (name in ODD_VOCAB), (rank, name, logits)


def test_attention_falls_back_to_the_gather(world):
    """qwen3's smoke config (4 heads, 2 KV heads) on a 4-wide 'model' dim:
    the layout records the attention as gathered over 'model' and why, its
    weights are read whole (all-gathered over 'model'), while the MLP and
    the vocab still read 1 / 4 shards."""
    case = STEP_CASES["qwen3_1_7b-2x4-attention_gathered"]
    for rank, r in enumerate(world["ranks"]):
        got = r["steps"][case]
        assert got["layout"] == {"attention": "gather: 4 heads / 2 kv heads on 4 'model' ranks",
                                 "mlp": "tp", "vocab": "tp"}
        reads = got["watch"]["reads"]
        attn = [x for x in reads if ".attn.w" in x[0]]
        assert attn and all(how == "whole" and local == whole for _, whole, local, how in attn)
        mlp = [x for x in reads if ".mlp." in x[0] or x[0] in ("wte", "lm_head")]
        assert mlp and all(how == "shard" and np.prod(local) * 4 == np.prod(whole)
                           for _, whole, local, how in mlp)
        assert got["watch"]["model_gathers"], rank


def test_vocab_parallel_loss_on_the_mesh(world):
    """``cross_entropy`` of each rank's half of [2, 8, 512] logits on the
    'model' dim: the loss within rel 1e-6 of ``torch.logsumexp`` of the
    whole logits (a loss near 10 has float32 steps of 1e-6), the gradient
    of the rank's slice within 1e-6 of the slice of its gradient."""
    for rank, r in enumerate(world["ranks"]):
        res = r["vocab_loss"]
        assert res["slice"] == (2, 8, 256), rank
        assert res["loss"] <= 1e-6 and res["grad"] <= 1e-6, (rank, res)


def test_vocab_parallel_loss_bitwise_on_one_rank():
    """On one rank ``cross_entropy`` (the vocab-parallel steps, no
    reduction) is ``torch.logsumexp`` minus the target's logit bit for bit
    at float32, its gradient too."""
    from repro_torch.models.model import cross_entropy

    rng = np.random.default_rng(7)
    lg = torch.from_numpy((rng.standard_normal((3, 16, 1000)) * 5).astype(np.float32))
    lg.requires_grad_(True)
    tgt = torch.from_numpy(rng.integers(0, 1000, size=(3, 16)))
    got = cross_entropy(lg, tgt)
    want = torch.logsumexp(lg, -1) - torch.gather(lg, -1, tgt[..., None])[..., 0]
    assert torch.equal(got, want)
    (g_got,) = torch.autograd.grad(got.sum(), [lg])
    (g_want,) = torch.autograd.grad(want.sum(), [lg])
    assert torch.equal(g_got, g_want)


@pytest.mark.parametrize("case", list(ODD_VOCAB.values()), ids=["plain", "seq_parallel"])
def test_odd_vocab_falls_back_to_the_gather(world, case):
    """qwen3's smoke config with a 255-token vocab on (2, 2, 2): the layout
    records the vocab as gathered over 'model' (why: 255 on 2 ranks), the
    attention and the MLP still TP; ``wte`` (tied: the embedding and the
    logits) is read whole on every rank (the step itself is held to the
    JAX package by ``test_sharded_step_matches_jax``)."""
    for rank, r in enumerate(world["ranks"]):
        got = r["steps"][case]
        assert got["layout"] == {"attention": "tp", "mlp": "tp",
                                 "vocab": "gather: vocab 255 on 2 'model' ranks"}, rank
        vocab = [x for x in got["watch"]["reads"] if x[0] in ("wte", "lm_head")]
        assert {x[0] for x in vocab} == {"wte"}, (rank, vocab)
        assert all(how == "whole" and local == whole for _, whole, local, how in vocab), rank


def test_grad_accum_microbatches_match_jax(world):
    """grad_accum=2 of the MoE config on (2, 2, 2): microbatch i holds the
    batch's rows [4 i, 4 i + 4), as the JAX package's reshape does, so the
    capacity-factor routing (per microbatch) and every parameter match its
    one-device step: loss rel 1e-6, parameters 1e-6."""
    (j_params, _, j_metrics), _ = world["one_device"]["mixtral_8x22b", 2]
    got = world["ranks"][0]["steps"][5]
    np.testing.assert_allclose(got["metrics"][0]["loss"], float(j_metrics["loss"]), rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], float(j_metrics["grad_norm"]),
                               rtol=1e-5)
    cfg = world["pairs"]["mixtral_8x22b"].tcfg
    assert_trees_close(_port_tree(got["params"], cfg), jax_np(j_params), rtol=0.0, atol=1e-6,
                       what="mixtral grad_accum=2")


def test_compress_pod_matches_jax(world):
    """compress_pod over 'pod' on (2, 2, 2) against the JAX package's
    compressed step on the same mesh.  The int8 payload rounds g / scale:
    a gradient element that the two packages' float32 sums put on either
    side of a rounding boundary flips by one quantum (scale), so the
    error-feedback residual differs by one quantum there and by rounding
    elsewhere.  Held: flips at most 0.1% of the elements, every other
    residual within 1e-3 quanta; the loss within rel 1e-6; every parameter
    within 1e-6, or, at a flipped element, 2 lr (AdamW's first update is
    lr g / (|g| + eps) plus the decay)."""
    jm = world["jax_mesh"]["compress"]
    got = world["ranks"][0]["steps"][4]
    cfg = world["pairs"]["qwen3_1_7b"].tcfg
    np.testing.assert_allclose(got["metrics"][0]["loss"], float(jm["metrics"]["loss"]), rtol=1e-6)
    ef, j_ef = _port_tree(got["ef"], cfg), jax_np(jm["ef"])
    params, j_params = _port_tree(got["params"], cfg), jax_np(jm["params"])
    lr = float(jm["metrics"]["lr"])
    flips = total = 0
    for name, want in j_ef.items():
        quantum = max(float(np.abs(want).max()), 1e-30) * 2   # the residual spans +-q/2
        diff = np.abs(ef[name] - want)
        flipped = diff > quantum / 2
        flips += int(flipped.sum())
        total += want.size
        assert float(diff[~flipped].max(initial=0.0)) <= 1e-3 * quantum, name
        pdiff = np.abs(params[name] - j_params[name])
        assert float(pdiff[~flipped].max(initial=0.0)) <= 1e-6, name
        assert float(pdiff.max(initial=0.0)) <= 2 * lr + 1e-6, name
    assert flips <= 1e-3 * total, (flips, total)


def test_pipeline_matches_jax(world):
    """pipeline_apply over 'pod' with the tanh(x @ w) stage: forward within
    rtol 1e-5 / atol 1e-6, the stacked weights' gradient within rtol 1e-4 /
    atol 1e-5 of the JAX package's (tests/test_pipeline.py's tolerances),
    the outputs the same on every rank."""
    jp = world["jax_mesh"]["pipeline"]
    for rank, r in enumerate(world["ranks"]):
        np.testing.assert_allclose(r["pipeline"]["out"], jp["out"], rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {rank}")
    np.testing.assert_allclose(world["ranks"][0]["pipeline"]["grad"], jp["grad"], rtol=1e-4,
                               atol=1e-5)


def _rank_rows(rank: int) -> slice:
    """Rank ``rank``'s block of the batch rows split over ('pod', 'data'),
    major axis first (the mesh is row-major over the ranks; the 'model'
    ranks hold the same rows)."""
    idx = rank // 2
    n = B // 4
    return slice(idx * n, (idx + 1) * n)


@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=[
    f"{c['arch']}-{'sp-forward' if c.get('overrides', {}).get('seq_parallel') else 'forward'}"
    if not c.get("steps") else
    f"{c['arch']}-decode_seq_shard_{c.get('overrides', {}).get('decode_seq_shard', True)}"
    for c in SERVE_CASES])
def test_sharded_serving_matches_jax(world, case):
    """The serving path on (2, 2, 2) against the JAX package's one-device
    forward and serve_step, at the serve tests' rtol / atol 1e-4, on every
    rank's own block.  Prefill forward, tensor parallel over 'model' (the
    logits gathered over the vocab): each rank its 2 rows of B = 8 (rows
    over ('pod', 'data'); the 'model' ranks hold the same rows), under
    seq_parallel its half of the sequence of them.  Decode (8 serve_steps after prefill_cache):
    each rank its 2 rows ('model' ranks hold the same rows), the caches
    placed by cache_shardings -- with decode_seq_shard every cache's 8 slots
    split over 'model' (split-KV decode: the owner writes a slot, each rank
    scores its own, the softmax combined over 'model'; MLA's latents and
    whisper's cross caches too), without it whole on each rank."""
    spec = SERVE_CASES[case]
    want = world["serving"][spec["arch"]]
    sp = spec.get("overrides", {}).get("seq_parallel", False)
    seq_shard = spec.get("overrides", {}).get("decode_seq_shard", True)
    for rank, res in enumerate(world["ranks"]):
        got = res["serve"][case]
        m = rank % 2
        if spec.get("forward"):
            if sp:
                half = SERVE_S // 2
                ref = want["forward"][_rank_rows(rank), m * half:(m + 1) * half]
            else:
                ref = want["forward"][_rank_rows(rank)]
            np.testing.assert_allclose(got["forward"], ref, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {rank} forward")
        if spec.get("steps"):
            split = any("Shard(dim=1)" in p for p in got["split"])
            assert split == seq_shard, got["split"]
            for t, lg in enumerate(got["decode"]):
                np.testing.assert_allclose(lg, want["decode"][t][_rank_rows(rank)],
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=f"rank {rank} decode step {t}")


def test_adamw_refuses_a_gradient_off_its_parameters_placements(world):
    """adamw_update raises, naming the leaf and both placements, when a
    gradient arrives under other placements than its parameter's (here
    ``Partial`` over 'pod'): it updates local shards and never
    redistributes."""
    for rank, r in enumerate(world["ranks"]):
        msg = r["adamw_refusal"]
        assert msg and "'w'" in msg and "Partial" in msg and "Shard(dim=0)" in msg, (rank, msg)


@pytest.mark.parametrize("target", ["(2, 4)", "(8,)", "one_device"])
def test_checkpoint_reshards_bitwise(world, target):
    """A train state saved under (2, 2, 2) restores bit for bit under (2, 4)
    ('data', 'model') with the sharding rules, under (8,) ('data',) and on
    one device (plain tensors)."""
    for r in world["ranks"]:
        res = r["checkpoint"][target]
        assert res["equal"]
        if target == "one_device":
            assert res["plain"]
        else:
            assert any("Shard" in p for p in res["placed"])


def test_chip_smoke_mesh_phase_on_cpu(capsys):
    """The smoke's mesh phase rehearsed on the host: part (b), its 8 gloo
    ranks (``chip_smoke.py --mesh-rank``) on CPU tensors, every part held
    against the one-rank run, the TP steps' collectives printed by mesh dim
    (no all-gather over 'model' in a plain step).  Part (a), NCCL, needs the card; part (c) is
    the dry-run CLI (tests/test_torch_dryrun.py)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    failures: list = []
    smoke.mesh_phase(torch, np, torch.device("cpu"), "host", failures, parts="b")
    out = capsys.readouterr().out
    assert failures == [], out[-3000:]
    for part in ("qwen3_1_7b step", "qwen3_1_7b seq_parallel", "mixtral_8x22b step",
                 "mixtral_8x22b seq_parallel", "qwen3_1_7b compress_pod"):
        assert f"(2, 2, 2) {part}:" in out and "raised:" not in out, part
    assert "mesh gloo checkpoint" in out
    assert out.count("-> ok") == 6, out[-3000:]
    for part in ("qwen3_1_7b step", "mixtral_8x22b step"):   # TP, no gather over 'model'
        line = next(ln for ln in out.splitlines() if f"(2, 2, 2) {part} collectives" in ln)
        assert "TP over 'model': attention" in line and line.endswith("over 'model' 0"), line
