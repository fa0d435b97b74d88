"""The port's training slice (``repro_torch.training``) against the JAX
package's: AdamW and its schedule, the data pipeline, one train step on the
dense and SSM smoke configs (the case in ``_torch_train.py``), bfloat16,
gradient accumulation, block remat, checkpoints in both directions and
``quantize_psum``."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_lm import Pair, as_np, np_batch, torch_batch
from _torch_train import (assert_trees_close, jax_np, jax_step, one_torch_thread,  # noqa: F401
                          port_step, test_train_step_matches_jax, tree_np)
from repro.training import SyntheticTokenPipeline as JPipeline, checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.train_step import quantize_psum as j_quantize_psum
from repro_torch import configs as tcfgs
from repro_torch.models import model as model_mod, transformer
from repro_torch.models.convert import flatten_tree, to_torch
from repro_torch.models.model import build_model
from repro_torch.training import OptConfig, SyntheticTokenPipeline, checkpoint
from repro_torch.training.optimizer import adamw_init, adamw_update, lr_at
from repro_torch.training.train_step import _accum_grads, init_train_state, quantize_psum

ARCHS = ["qwen3_1_7b", "qwen3_14b", "stablelm_12b", "phi3_medium_14b", "mamba2_130m"]


@pytest.fixture(scope="module", params=ARCHS)
def step_pair(request):
    return Pair(request.param)


# ------------------------------------------------------------------ optimizer

def _bf16_spacing(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def test_adamw_update_matches_jax():
    """Three AdamW steps on a random tree of float32 and bfloat16 leaves
    (lr 1e-2 with warmup 2, clipping at norm 1 on the steps whose norm is
    larger): every updated parameter, mu, nu, the step, grad_norm and lr
    within rtol 1e-6 of the JAX package's jitted adamw_update; bfloat16
    parameters within one bfloat16 spacing of the JAX value (a last-bit
    float32 difference can move the rounding by one)."""
    rng = np.random.default_rng(11)
    shapes = {"a": ((4, 8), jnp.float32),
              "b": {"c": ((16,), jnp.bfloat16), "d": ((3,), jnp.float32)},
              "e": [((2, 2), jnp.float32), ((5, 3), jnp.bfloat16)]}
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    jp = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s[0]), s[1]), shapes,
                      is_leaf=is_leaf)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    params = {k: to_torch(v) for k, v in flatten_tree(jax.tree.map(np.asarray, jp)).items()}
    state, jstate = adamw_init(params), jopt.adamw_init(jp)
    j_update = jax.jit(lambda p, g, s: jopt.adamw_update(jcfg, p, g, s))
    norms = []
    for scale in (0.05, 3.0, 0.5):
        jg = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale, p.dtype),
                          jp)
        grads = {k: to_torch(v) for k, v in flatten_tree(jax.tree.map(np.asarray, jg)).items()}
        jp, jstate, jm = j_update(jp, jg, jstate)
        params, state, m = adamw_update(cfg, params, grads, state)
        norms.append(float(jm["grad_norm"]))
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        assert int(state["step"]) == int(jstate["step"])
        want = {k: np.asarray(v, np.float32) for k, v in flatten_tree(jp).items()}
        for name, ref in want.items():
            got = as_np(params[name])
            assert params[name].dtype == to_torch(np.asarray(flatten_tree(jp)[name])).dtype
            if params[name].dtype == torch.bfloat16:
                assert np.all(np.abs(got - ref) <= _bf16_spacing(ref)), name
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=name)
        for mom in ("mu", "nu"):
            want = {k: np.asarray(v) for k, v in flatten_tree(jstate[mom]).items()}
            for name, ref in want.items():
                np.testing.assert_allclose(as_np(state[mom][name]), ref, rtol=1e-6, atol=1e-12,
                                           err_msg=f"{mom} {name}")
    assert norms[0] < 1.0 < norms[1]        # unclipped, then clipped


@pytest.mark.parametrize("step", [0, 1, 10, 11, 60, 110])
def test_lr_at_matches_jax(step):
    """lr_at at steps 0, 1, warmup, warmup + 1, mid-decay and total within
    1e-7 relative of the JAX package's (both in float32)."""
    cfg = OptConfig(lr=3e-4, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    want = float(jopt.lr_at(jopt.OptConfig(**dataclasses.asdict(cfg)), jnp.asarray(step)))
    got = lr_at(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-7, atol=0)


def test_adamw_matches_reference_scalar():
    """One AdamW step on a scalar against hand math (the JAX test's case)."""
    cfg = OptConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                    clip_norm=1e9, warmup_steps=0, total_steps=10, min_lr_ratio=1.0)
    params = {"w": torch.tensor(2.0)}
    new_p, _, _ = adamw_update(cfg, params, {"w": torch.tensor(0.5)}, adamw_init(params))
    mu, nu = 0.1 * 0.5, 0.01 * 0.25
    mhat, vhat = mu / 0.1, nu / 0.01
    want = 2.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(float(new_p["w"]), want, rtol=1e-5)


def test_grad_clipping():
    """The global norm is reported before clipping (the JAX test's case)."""
    cfg = OptConfig(lr=0.0, clip_norm=1.0, warmup_steps=0, total_steps=1)
    params = {"w": torch.zeros(4)}
    _, _, m = adamw_update(cfg, params, {"w": torch.full((4,), 100.0)}, adamw_init(params))
    assert float(m["grad_norm"]) == pytest.approx(200.0)


# ----------------------------------------------------------------------- data

@pytest.mark.parametrize("host_slice", [None, slice(1, 3)])
def test_data_pipeline_equals_jax(host_slice):
    """batch_at is array-equal to the JAX package's for the same (seed,
    step, host_slice): tokens, vis_emb and enc_emb; a step drawn again
    after another is the same batch (the restart's contract)."""
    kw = dict(vocab=100, global_batch=4, seq_len=8, seed=7, vis_tokens=3, enc_len=5, d_model=6)
    port, ref = SyntheticTokenPipeline(**kw), JPipeline(**kw)
    for step in (0, 3, 17, 3):
        got = port.batch_at(step, host_slice=host_slice)
        want = ref.batch_at(step, host_slice=host_slice)
        assert sorted(got) == sorted(want) == ["enc_emb", "tokens", "vis_emb"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------ bf16, accum, remat

def test_bfloat16_train_step_matches_jax():
    """qwen3 at dtype='bfloat16', one step at lr 2e-4 (no warmup): the loss
    within rtol 2e-2 of the JAX package's (the bfloat16 forward test's
    tolerance) and every updated parameter within two bfloat16 spacings of
    its leaf's largest value.  The first AdamW step moves an element by
    ~lr * sign(g); where a bfloat16 gradient sits at rounding noise its
    sign may differ, which costs 2 * lr = 4e-4, inside two spacings of the
    smallest leaf maximum (wte, ~0.08: 9.8e-4)."""
    pair = Pair("qwen3_1_7b", dtype="bfloat16")
    batch = np_batch(pair.tcfg, 32, seed=4)
    opt = dict(lr=2e-4, warmup_steps=0, total_steps=10)
    (j_params, _, j_metrics), _ = jax_step(pair, batch, **opt)
    (params, _, metrics), _ = port_step(pair, batch, **opt)
    assert params["wte"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), rtol=2e-2)
    got, want = tree_np(params, pair.tcfg), jax_np(j_params)
    moved = 0
    for name, ref in want.items():
        atol = 2 * _bf16_spacing(np.abs(ref).max())
        np.testing.assert_allclose(got[name], ref, rtol=0, atol=atol, err_msg=name)
        moved += int(np.sum(got[name] != as_np(to_torch(flatten_tree(pair.np_params)[name]))))
    assert moved > 0


def test_grad_accum_matches_jax_and_full_batch():
    """grad_accum=2 over B = 4 (two microbatches of 2): (a) against the JAX
    package's grad_accum=2 at the default OptConfig, at the one-step
    tolerances of test_train_step_matches_jax, with its metrics' keys
    (loss, ce, grad_norm, lr); (b) against the port's own grad_accum=1 at
    the JAX test's config and tolerances (lr 1e-2, no warmup; loss rtol
    1e-5, parameters rtol 2e-2, atol 2e-5)."""
    pair = Pair("qwen3_1_7b")
    halves = [np_batch(pair.tcfg, 16, seed=s)["tokens"] for s in (5, 6)]
    batch = {"tokens": np.concatenate(halves)}
    (j_params, j_state, j_m), _ = jax_step(pair, batch, grad_accum=2)
    (params, state, m), grads = port_step(pair, batch, grad_accum=2)
    assert sorted(m) == sorted(j_m) == ["ce", "grad_norm", "loss", "lr"]
    np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(j_m["grad_norm"]), rtol=1e-4)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert_trees_close(tree_np(params, pair.tcfg), jax_np(j_params), rtol=1e-4, atol=1e-6,
                       what="param")
    for mom in ("mu", "nu"):
        assert_trees_close(tree_np(state["opt"][mom], pair.tcfg), jax_np(j_state["opt"][mom]),
                           rtol=1e-4, atol=1e-6, what=mom)
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    (p1, _, m1), _ = port_step(pair, batch, grad_accum=1, **opt)
    (p2, _, m2), _ = port_step(pair, batch, grad_accum=2, **opt)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for name in p1:
        np.testing.assert_allclose(as_np(p1[name]), as_np(p2[name]), rtol=2e-2, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_remat_block_equals_none(arch, monkeypatch):
    """remat='block' and remat='none' give the same loss and gradients
    (within 1e-6) on every smoke config; with 'block' each scanned
    superblock runs twice (forward, then its recompute in the backward),
    with 'none' once, and under no_grad 'block' recomputes nothing.  The
    decode path, whose cache writes are in place, is never reached."""
    cfg = tcfgs.smoke_config(arch)
    calls = []
    real = model_mod._superblock

    def spy(*a):
        calls.append(1)
        return real(*a)

    def no_decode(*a, **k):
        raise AssertionError("the train step reached decode_block")

    monkeypatch.setattr(model_mod, "_superblock", spy)
    monkeypatch.setattr(transformer, "decode_block", no_decode)
    batch = torch_batch(np_batch(cfg, 16, seed=7))
    out = {}
    for remat in ("block", "none"):
        model = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
        calls.clear()
        loss, _, grads = _accum_grads(model, batch, 1)
        out[remat] = (float(loss), grads, len(calls))
    n_sb = (2 * cfg.n_layers if cfg.family == "encdec" else cfg.scan_plan()["n_sb"])
    assert out["block"][2] == 2 * n_sb and out["none"][2] == n_sb
    np.testing.assert_allclose(out["block"][0], out["none"][0], rtol=1e-6)
    for name, g in out["none"][1].items():
        np.testing.assert_allclose(as_np(out["block"][1][name]), as_np(g), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    calls.clear()
    with torch.no_grad():
        build_model(cfg, "cpu").loss_fn(batch)
    assert len(calls) == n_sb


# ----------------------------------------------------------------- checkpoint

def test_checkpoint_atomic_commit_and_retention(tmp_path):
    """The JAX test's case on tensors: retention keeps the last two, the
    latest restores equal, no .tmp directory is left."""
    state = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for s in [1, 2, 3, 4, 5]:
        checkpoint.save(str(tmp_path), s, state, keep=2)
    assert checkpoint.all_steps(str(tmp_path)) == [4, 5]
    assert checkpoint.latest_step(str(tmp_path)) == 5
    out = checkpoint.restore(str(tmp_path), 5, state)
    assert torch.equal(out["a"], state["a"]) and torch.equal(out["b"]["c"], state["b"]["c"])
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


@pytest.fixture(scope="module")
def qwen3_train_state():
    """The qwen3 smoke pair and a float32 JAX {'params', 'state'} with
    random moments at step 5."""
    pair = Pair("qwen3_1_7b")
    rng = np.random.default_rng(9)
    rand = lambda p: np.abs(rng.standard_normal(p.shape)).astype(np.float32)  # noqa: E731
    state = {"opt": {"mu": jax.tree.map(rand, pair.np_params),
                     "nu": jax.tree.map(rand, pair.np_params), "step": np.int32(5)},
             "step": np.int32(5)}
    return pair, {"params": pair.np_params, "state": state}


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:09d}", "manifest.json")) as f:
        m = json.load(f)
    return {k: m[k] for k in ("keys", "shapes", "dtypes", "step")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(writer, qwen3_train_state, tmp_path):
    """A float32 qwen3 smoke {'params', 'state'} written by one package
    restores array-equal in the other (the port through from_jax_layout into
    its own names); the two packages' manifests for it have equal keys,
    shapes, dtypes and step."""
    pair, jtree = qwen3_train_state
    cfg = pair.tcfg
    params, state = checkpoint.from_jax_layout(cfg, jtree, device="cpu")
    port_tree = checkpoint.to_jax_layout(cfg, params, state)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jdir, 5, jtree)
    checkpoint.save(pdir, 5, port_tree)
    assert _manifest(jdir, 5) == _manifest(pdir, 5)
    want = {k: np.asarray(v) for k, v in flatten_tree(jtree).items()}
    if writer == "jax":
        restored = checkpoint.restore(jdir, 5, port_tree)
        got_params, got_state = checkpoint.from_jax_layout(cfg, restored, device="cpu")
        model = build_model(cfg, "cpu")
        model.load_params(got_params)
        got = flatten_tree(checkpoint.to_jax_layout(cfg, model.params(), got_state))
        got = {k: v.numpy() for k, v in got.items()}
    else:
        got = {k: np.asarray(v) for k, v in flatten_tree(jckpt.restore(pdir, 5, jtree)).items()}
    assert sorted(got) == sorted(want)
    for k, ref in want.items():
        assert got[k].dtype == ref.dtype and got[k].shape == ref.shape, k
        np.testing.assert_array_equal(got[k], ref, err_msg=k)


def test_checkpoint_bfloat16_round_trips_bit_for_bit(tmp_path):
    """A bfloat16 model's {'params', 'state'} after one step saves as the
    JAX package's file holds bfloat16 ('|V2' arrays, dtype 'bfloat16' in
    the manifest) and restores through the port bit for bit.  The JAX
    package's own restore hands such a leaf back as raw '|V2' (a reference
    caveat); its bytes are the same."""
    cfg = dataclasses.replace(tcfgs.smoke_config("qwen3_1_7b"), dtype="bfloat16")
    model = build_model(cfg, "cpu")
    params = model.params()
    from repro_torch.training import TrainConfig, make_train_step

    tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=0, total_steps=10))
    state = init_train_state(model, params, tcfg)
    params, state, _ = make_train_step(model, tcfg)(params, state, np_batch(cfg, 16, seed=2))
    tree = checkpoint.to_jax_layout(cfg, params, state)
    checkpoint.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as z:
        assert z["['params']['wte']"].dtype == np.dtype("V2")
    assert _manifest(str(tmp_path), 1)["dtypes"]["['params']['wte']"] == "bfloat16"
    back = flatten_tree(checkpoint.restore(str(tmp_path), 1, tree))
    for k, v in flatten_tree(tree).items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    raw = jckpt.restore(str(tmp_path), 1, jax.tree.map(lambda t: np.zeros(t.shape), tree))
    wte = raw["params"]["wte"]
    assert wte.dtype == np.dtype("V2")
    np.testing.assert_array_equal(wte.view(np.int16),
                                  tree["params"]["wte"].view(torch.int16).numpy())


# --------------------------------------------------------------- quantize_psum

def test_quantize_psum_world_size_1(tmp_path):
    """On a one-rank gloo group made here: the residual within scale / 2
    of every element and mean_g + residual == g within 1e-6 (the JAX test's
    bounds), and both outputs within 1e-6 of the JAX package's
    quantize_psum on its one-device mesh (XLA fuses g - q * scale into one
    FMA, so a residual differs by the product's rounding, up to one float32
    spacing at |g| = 3: 2.4e-7)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    g = np.linspace(-3.0, 3.0, 64, dtype=np.float32)
    mesh = jax.make_mesh((1,), ("pod",))
    j_mean, j_resid = jax.jit(shard_map(lambda x: j_quantize_psum(x, "pod"), mesh=mesh,
                                        in_specs=P(), out_specs=P(), check_vma=False))(g)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mean_g, resid = quantize_psum(torch.from_numpy(g))
    finally:
        dist.destroy_process_group()
    scale = 3.0 / 127.0
    assert float(resid.abs().max()) <= scale / 2 + 1e-6
    np.testing.assert_allclose((mean_g + resid).numpy(), g, atol=1e-6)
    np.testing.assert_allclose(mean_g.numpy(), np.asarray(j_mean), rtol=0, atol=1e-6)
    np.testing.assert_allclose(resid.numpy(), np.asarray(j_resid), rtol=0, atol=1e-6)
