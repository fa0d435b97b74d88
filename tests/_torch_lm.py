"""Shared set-up and cases of the LM parity tests: one architecture's JAX
model (its parameters, forward and serve_step under ``jax.jit``, compiled
once per shape) and the port's model holding the same parameters, on the
same numpy inputs.  ``test_torch_lm_serve*.py`` import the ``test_*``
cases below and give them a module-scoped ``pair`` fixture over their own
architectures."""
from __future__ import annotations

import dataclasses
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models.model import build_model as jax_build_model
from repro_torch import configs as tcfgs
from repro_torch.models import layers
from repro_torch.models.convert import flatten_tree, params_from_jax, params_to_tree, to_torch
from repro_torch.models.model import build_model

B = 2
DECODE_STEPS = 12


def np_batch(cfg, S: int, seed: int = 0) -> dict:
    """Tokens [B, S] and the stub frontends' embeddings, from a numpy seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S), dtype=np.int32)}
    if cfg.family == "vlm":
        batch["vis_emb"] = (rng.standard_normal((B, cfg.n_vision_tokens, cfg.d_model)) * 0.1
                            ).astype(np.float32)
    if cfg.family == "encdec":
        batch["enc_emb"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def as_np(x) -> np.ndarray:
    """A JAX array or a tensor as float32 numpy (bfloat16 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def smoke_cfg(arch: str, **overrides):
    """The smoke config of both packages (equal field by field)."""
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    if overrides:
        jc, tc = dataclasses.replace(jc, **overrides), dataclasses.replace(tc, **overrides)
    return jc, tc


class Pair:
    """The JAX package's model and the port's, one config, one parameter set."""

    def __init__(self, arch: str, **overrides):
        self.arch = arch
        self.jcfg, self.tcfg = smoke_cfg(arch, **overrides)
        self.jmodel = jax_build_model(self.jcfg)
        self.jparams = jax.jit(self.jmodel.init_params)(jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.jparams)
        self.state = params_from_jax(self.np_params, self.tcfg, device="cpu")
        self.tmodel = self.port_model(self.tcfg)
        self._fwd = jax.jit(lambda p, b: (self.jmodel.forward(p, b),
                                          self.jmodel.loss_fn(p, b)[0]))

    def port_model(self, cfg):
        model = build_model(cfg, "cpu")
        model.load_params(self.state)
        return model

    def jax_forward(self, batch):
        """-> ((logits, aux_loss), loss) of the JAX package."""
        return self._fwd(self.jparams, jax_batch(batch))

    @cached_property
    def jax_step(self):
        return jax.jit(self.jmodel.serve_step)

    def jax_decode(self, batch, steps: int = DECODE_STEPS) -> list:
        """Each step's logits [B, V] of the JAX package's serve_step after
        prefill_cache, over the batch's first ``steps`` tokens."""
        jb = jax_batch(batch)
        cache = self.jmodel.init_cache(B, steps, enc_len=steps)
        cache = jax.jit(self.jmodel.prefill_cache)(self.jparams, cache, jb)
        out = []
        for t in range(steps):
            lg, cache = self.jax_step(self.jparams, cache, jb["tokens"][:, t : t + 1], t)
            out.append(as_np(lg[:, 0]))
        return out

    @staticmethod
    def port_decode(model, batch, steps: int = DECODE_STEPS) -> list:
        tb = torch_batch(batch)
        with torch.inference_mode():
            cache = model.init_cache(B, steps, enc_len=steps)
            cache = model.prefill_cache(cache, tb)
            out = []
            for t in range(steps):
                lg, cache = model.serve_step(cache, tb["tokens"][:, t : t + 1], t)
                out.append(as_np(lg[:, 0]))
        return out


def count_flash_calls(monkeypatch) -> list:
    """Count the model's calls of ``layers.flash_attention``."""
    calls = []
    real = layers.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    return calls


# --------------------------------------------------------------------------
# cases, run per architecture by the files that import them
# --------------------------------------------------------------------------

def test_params_round_trip(pair):
    """params_from_jax then params_to_tree gives back the JAX package's tree:
    the same keys, every leaf equal bit for bit in its dtype, nothing left
    over; the port's model holds exactly those parameters."""
    want = flatten_tree(pair.np_params)
    got = flatten_tree(params_to_tree(pair.tmodel.params(), pair.tcfg))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        ref = to_torch(leaf)
        assert got[name].dtype == ref.dtype and torch.equal(got[name], ref), name
    assert set(pair.state) == set(pair.tmodel.params())


def test_init_params_tree_matches_jax(pair):
    """The port's init_params tree has the keys, shapes and dtypes of
    ``jax.eval_shape(model.init_params, key)``, and the JAX package's init
    scales: deterministic leaves equal, random ones of the same spread."""
    model = build_model(pair.tcfg, "cpu")
    gen = torch.Generator().manual_seed(7)
    got = flatten_tree(params_to_tree(model.init_params(gen), pair.tcfg))
    shapes = flatten_tree(jax.eval_shape(pair.jmodel.init_params, jax.random.PRNGKey(0)))
    assert sorted(got) == sorted(shapes)
    for name, sds in shapes.items():
        assert tuple(got[name].shape) == tuple(sds.shape), name
        assert str(got[name].dtype).removeprefix("torch.") == str(sds.dtype), name
    values = flatten_tree(pair.np_params)
    for name, leaf in values.items():
        ref, mine = as_np(to_torch(leaf)), as_np(got[name])
        if np.allclose(mine, ref, rtol=1e-5, atol=1e-6):
            continue
        n = ref.size
        spread = 6.0 / np.sqrt(2 * n) + 0.02
        assert abs(mine.std() / ref.std() - 1) < spread, (name, mine.std(), ref.std())
        assert abs(mine.mean()) < 6 * ref.std() / np.sqrt(n) + 1e-6, name


@pytest.mark.parametrize("S", [12, 32])
def test_forward_logits_loss_aux(pair, S, monkeypatch):
    """Forward logits within rtol/atol 1e-4 of the JAX package's, loss_fn
    within 1e-5 relative, the MoE aux loss within 1e-5; at S = 32 the
    attention goes through flash_attention (S > flash_threshold = 16), at
    S = 12 it does not."""
    batch = np_batch(pair.tcfg, S, seed=S)
    (j_logits, j_aux), j_loss = pair.jax_forward(batch)
    calls = count_flash_calls(monkeypatch)
    tb = torch_batch(batch)
    t_logits, t_aux = pair.tmodel(tb)
    np.testing.assert_allclose(as_np(t_logits), as_np(j_logits), rtol=1e-4, atol=1e-4)
    t_loss, metrics = pair.tmodel.loss_fn(tb)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    if pair.tcfg.n_experts:
        assert float(t_aux) > 0
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"]), float(t_aux))
    attends = pair.tcfg.family != "ssm"
    assert bool(calls) == (attends and S > pair.tcfg.flash_threshold), calls


def test_decode_trajectory(pair):
    """12 serve_steps after prefill_cache: each step's logits within rtol /
    atol 1e-4 of the JAX package's serve_step, and within the JAX test's
    tolerance of the port's own full forward (MoE at capacity_factor =
    n_experts, so the forward drops no token)."""
    batch = np_batch(pair.tcfg, DECODE_STEPS, seed=1)
    want = pair.jax_decode(batch)
    cfg = pair.tcfg
    model = (pair.port_model(dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts)))
             if cfg.n_experts else pair.tmodel)
    got = Pair.port_decode(model, batch)
    full, _ = model(torch_batch(batch))
    for t in range(DECODE_STEPS):
        np.testing.assert_allclose(got[t], want[t], rtol=1e-4, atol=1e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(got[t], as_np(full[:, t]), rtol=5e-2, atol=5e-4,
                                   err_msg=f"step {t} vs forward")
