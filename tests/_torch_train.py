"""Shared set-up and the per-architecture case of the train-step parity
tests: one train step of the JAX package's ``make_train_step`` (its
gradients from a ``value_and_grad`` compiled in the same ``jax.jit``, so an
architecture costs one compile) against the port's on the same parameters
(``Pair``) and the same numpy batch.  ``test_torch_train*.py`` import the
case below and give it a module-scoped ``step_pair`` fixture over their
own architectures."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import Pair, as_np, np_batch, torch_batch
from repro.training import OptConfig as JOptConfig, TrainConfig as JTrainConfig
from repro.training import make_train_step as j_make_train_step
from repro.training.train_step import init_train_state as j_init_train_state
from repro_torch.models.convert import flatten_tree, params_to_tree
from repro_torch.training import OptConfig, TrainConfig, make_train_step
from repro_torch.training.train_step import _accum_grads, init_train_state

S = 32          # > flash_threshold (16): the attention goes through flash_attention


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The smoke models' ops are too small to gain from torch's intra-op
    threads, and next to other test workers those threads oversubscribe the
    cores: one thread for the module's tests, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_step(pair: Pair, batch: dict, grad_accum: int = 1, **opt):
    """-> ((params', state', metrics), grads) of one JAX train step, numpy leaves."""
    tcfg = JTrainConfig(opt=JOptConfig(**opt), grad_accum=grad_accum)
    step = j_make_train_step(pair.jmodel, tcfg)

    def f(p, s, b):
        (_, _), g = jax.value_and_grad(pair.jmodel.loss_fn, has_aux=True)(p, b)
        return step(p, s, b), g

    state = j_init_train_state(pair.jmodel, pair.jparams, tcfg)
    out = jax.jit(f)(pair.jparams, state, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, out)


def port_step(pair: Pair, batch: dict, grad_accum: int = 1, model=None, **opt):
    """-> ((params', state', metrics), grads) of one port train step from the
    pair's parameters (a fresh model of the pair's config unless given)."""
    model = model or pair.port_model(pair.tcfg)
    tcfg = TrainConfig(opt=OptConfig(**opt), grad_accum=grad_accum)
    _, _, grads = _accum_grads(model, torch_batch(batch), grad_accum)
    params = model.params()
    out = make_train_step(model, tcfg)(params, init_train_state(model, params, tcfg), batch)
    return out, grads


def tree_np(state: dict, cfg) -> dict:
    """The port's state dict as the JAX tree's flat names -> float32 numpy."""
    return {k: as_np(v) for k, v in flatten_tree(params_to_tree(state, cfg)).items()}


def jax_np(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in flatten_tree(tree).items()}


def assert_trees_close(got: dict, want: dict, *, rtol, atol=0.0, atol_of_max=0.0, what=""):
    """Every leaf within atol + atol_of_max * max|leaf| + rtol * |want|."""
    assert sorted(got) == sorted(want), what
    for name, ref in want.items():
        tol = atol + atol_of_max * float(np.abs(ref).max(initial=0.0))
        np.testing.assert_allclose(got[name], ref, rtol=rtol, atol=tol, err_msg=f"{what} {name}")


# --------------------------------------------------------------------------
# the case, run per architecture by the files that import it
# --------------------------------------------------------------------------

def test_train_step_matches_jax(step_pair):
    """One train step at S = 32 (flash attention) with the JAX package's
    default OptConfig: loss and ce within rtol 1e-5, grad_norm within 1e-4,
    every gradient leaf within atol 1e-5 * max|g| of the leaf and rtol
    1e-4, every updated parameter and both moments within atol 1e-6 and
    rtol 1e-4; the metrics carry the JAX package's keys.  The MoE configs
    (capacity factor 1.25: tokens are dropped) match at the same
    tolerances, their routing being the JAX package's exactly.

    The default schedule's first step has lr 3e-6 (warmup 100).  At a
    larger lr AdamW's first update g / (|g| + eps) amplifies last-bit
    gradient differences wherever |g| is near eps = 1e-8 (measured: 2e-5
    on recurrentgemma's parameters at lr 5e-4); the update's arithmetic is
    held at a real lr in ``test_adamw_update_matches_jax``."""
    pair = step_pair
    batch = np_batch(pair.tcfg, S, seed=3)
    (j_params, j_state, j_metrics), j_grads = jax_step(pair, batch)
    (params, state, metrics), grads = port_step(pair, batch)
    assert sorted(metrics) == sorted(j_metrics) == ["aux_loss", "ce", "grad_norm", "loss", "lr"]
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"]), float(j_metrics["aux_loss"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(metrics["lr"]), float(j_metrics["lr"]), rtol=1e-7)
    cfg = pair.tcfg
    assert_trees_close(tree_np(grads, cfg), jax_np(j_grads), rtol=1e-4, atol_of_max=1e-5,
                       what="grad")
    assert_trees_close(tree_np(params, cfg), jax_np(j_params), rtol=1e-4, atol=1e-6,
                       what="param")
    for m in ("mu", "nu"):
        assert_trees_close(tree_np(state["opt"][m], cfg), jax_np(j_state["opt"][m]),
                           rtol=1e-4, atol=1e-6, what=m)
    assert int(state["step"]) == int(j_state["step"]) == 1
    assert int(state["opt"]["step"]) == int(j_state["opt"]["step"]) == 1
