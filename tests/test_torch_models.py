"""The port's LM building blocks held alone against the JAX package's
(attention, flash attention, the SSD and RG-LRU scans, MoE dispatch, RoPE,
RMSNorm), its bfloat16 forwards, and ``launch.flops`` on every full config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import Pair, as_np, np_batch, torch_batch
from repro import configs as jcfgs
from repro.launch import flops as jflops
from repro.models import layers as jlayers, moe as jmoe, rglru as jrglru, ssm as jssm
from repro_torch import configs as tcfgs
from repro_torch.launch import flops as tflops
from repro_torch.models import layers as tlayers, moe as tmoe, rglru as trglru, ssm as tssm
from repro_torch.models.convert import to_torch


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("skip", [False, True])
def test_flash_attention_matches_dense_and_jax(window, skip):
    """flash_attention against the port's dense attention (the JAX test's
    tolerance) and against the JAX package's flash_attention, GQA, windows 0
    and 16, with and without skipping the masked chunks."""
    rng = np.random.default_rng(3)
    B, S, H, KVH, dh = 2, 64, 8, 4, 16
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=16, k_chunk=16, skip_masked=skip)
    got = tlayers.flash_attention(_t(q), _t(k), _t(v), **kw)
    dense = tlayers.attention(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)
    want = jax.jit(lambda *a: jlayers.flash_attention(*a, **kw))(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jd = jax.jit(lambda *a: jlayers.attention(*a, causal=True, window=window))(q, k, v)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_decode_attention_and_cache_write_match_jax():
    """decode_attention after cache_write (in place here, a one-hot blend
    there) equals the JAX package's at every position, windowed too."""
    rng = np.random.default_rng(4)
    B, S, H, KVH, dh = 2, 10, 4, 2, 8
    kc = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, KVH, dh)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    new = rng.standard_normal((B, 1, KVH, dh)).astype(np.float32)
    for pos in (0, 4, 9):
        jk = jlayers.cache_write(jnp.asarray(kc), jnp.asarray(new), pos)
        tk = tlayers.cache_write(_t(kc.copy()), _t(new), pos)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        for window in (0, 3):
            want = jlayers.decode_attention(jnp.asarray(q), jk, jnp.asarray(vc), pos,
                                            window=window)
            got = tlayers.decode_attention(_t(q), tk, _t(vc), pos, window=window)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_rms_norm_match_jax(dtype):
    """rope (float32 inside, cast at the end) and rms_norm (float32, cast,
    then gamma) equal the JAX package's; bfloat16 within one rounding."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    pos = np.arange(7)[None].repeat(2, 0) + np.array([[0], [100]])
    jx = jnp.asarray(x, dtype)
    tx = to_torch(np.asarray(jx))
    jg, tg = jnp.asarray(gamma, dtype), to_torch(np.asarray(jnp.asarray(gamma, dtype)))
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    for theta in (1e4, 1e6):
        want = jlayers.rope(jx, jnp.asarray(pos), theta)
        got = tlayers.rope(tx, _t(pos), theta)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(as_np(got), as_np(want), **tol)
    want = jlayers.rms_norm(jx, jg, 1e-6)
    got = tlayers.rms_norm(tx, tg, 1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def test_ssd_chunked_matches_jax_and_recurrence():
    """The chunked SSD (the chunk states' associative scan in both
    packages) equals the JAX package's and the naive recurrence."""
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 32, 3, 4, 8
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, size=(H,)).astype(np.float32)
    Bs = rng.normal(size=(B, S, N)).astype(np.float32)
    C = rng.normal(size=(B, S, N)).astype(np.float32)
    args = (x, dt, A, Bs, C)
    y, final = tssm.ssd_chunked(*map(_t, args), chunk=8)
    jy, jfinal = jax.jit(lambda *a: jssm.ssd_chunked(*a, chunk=8))(*args)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-4, atol=1e-4)
    h = np.zeros((B, H, P, N))
    y_ref = np.zeros_like(x)
    for t in range(S):
        gamma = np.exp(dt[:, t] * A)
        h = h * gamma[..., None, None] + np.einsum("bn,bh,bhp->bhpn", Bs[:, t], dt[:, t], x[:, t])
        y_ref[:, t] = np.einsum("bn,bhpn->bhp", C[:, t], h)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.ssd_chunked(*map(_t, args), chunk=5)


def test_rglru_scan_matches_jax():
    """The RG-LRU block (the recurrence a float32 associative scan over time
    in both packages) and its one-step decode equal the JAX package's on
    the same parameters."""
    cfg = tcfgs.smoke_config("recurrentgemma_9b")
    jcfg = jcfgs.smoke_config("recurrentgemma_9b")
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(2), jcfg)
    tp = {k: to_torch(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jrglru.rglru_block(p, x, jcfg))(jp, x)
    got = trglru.rglru_block(tp, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    jc = jrglru.init_rglru_cache(jcfg, 2, jnp.float32)
    tc = trglru.init_rglru_cache(cfg, 2, torch.float32)
    jstep = jax.jit(lambda p, x, c: jrglru.rglru_decode(p, x, jcfg, c))
    for t in range(4):
        jy, jc = jstep(jp, x[:, t : t + 1], jc)
        ty, tc = trglru.rglru_decode(tp, _t(x[:, t : t + 1]), cfg, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tc["h"].numpy(), np.asarray(jc["h"]), rtol=1e-5, atol=1e-6)
    # the step's gelu is the tanh form, as jax.nn.gelu's default
    z = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(trglru._gelu(_t(z)).numpy(), np.asarray(jax.nn.gelu(z)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,k,E,capacity", [(16, 2, 4, 3), (16, 2, 4, 32), (9, 1, 3, 2),
                                            (24, 6, 8, 5), (1, 2, 4, 1)])
def test_dispatch_indices_equal_jax(T, k, E, capacity):
    """The MoE slot table [E, C] and its validity equal the JAX package's
    exactly, capacity below and at T*k (invalid slots point at T*k)."""
    rng = np.random.default_rng(T * 100 + E)
    eid = np.stack([rng.choice(E, size=k, replace=False) for _ in range(T)]).astype(np.int32)
    j_slot, j_valid = jmoe._dispatch_indices(jnp.asarray(eid), E, capacity)
    t_slot, t_valid = tmoe._dispatch_indices(_t(eid).long(), E, capacity)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))


@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_ffn_matches_jax(no_drop):
    """moe_ffn with capacity drops (the forward) and without (decode) equals
    the JAX package's, its aux loss too."""
    cfg, jcfg = tcfgs.smoke_config("deepseek_v2_lite_16b"), jcfgs.smoke_config(
        "deepseek_v2_lite_16b")
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    x = (np.random.default_rng(7).standard_normal((2, 8, cfg.d_model)) * 0.5).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg, return_aux=True,
                                                 no_drop=no_drop))(jp, x)
    ty, taux = tmoe.moe_ffn(tp, _t(x), cfg, return_aux=True, no_drop=no_drop)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mixtral_8x22b"])
def test_bfloat16_forward_matches_jax(arch):
    """At dtype='bfloat16' (the configs' own) the forward logits lie within
    rtol 2e-2 and atol 2e-2 of the JAX package's, at S = 12 and at S = 32
    (flash); atol rises to two bfloat16 spacings at the largest logit where
    that is more (mixtral's untied head: logits up to ~4.2, spacing
    0.03125).  The float32 transcendentals (the router's softmax) and the
    products' summation orders differ from XLA's in the last bit, and such a
    bit can move a bfloat16 rounding (a gate, a matmul's output) that the
    next layers carry."""
    pair = Pair(arch, dtype="bfloat16")
    assert pair.tmodel.params()["wte"].dtype == torch.bfloat16
    for S in (12, 32):
        batch = np_batch(pair.tcfg, S, seed=S)
        (j_logits, _), _ = pair.jax_forward(batch)
        t_logits, _ = pair.tmodel(torch_batch(batch))
        assert t_logits.dtype == torch.bfloat16
        ref = as_np(j_logits)
        spacing = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        np.testing.assert_allclose(as_np(t_logits), ref, rtol=2e-2, atol=max(2e-2, 2 * spacing))


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_flops_equal_jax_on_full_configs(arch):
    """param_count, active_param_count and cell_cost of every assigned cell
    equal the JAX package's on the full config; the configs and their cells
    are field for field the JAX package's."""
    cfg, jcfg = tcfgs.config_for(arch), jcfgs.config_for(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tcfgs.cells(arch) == jcfgs.cells(arch)
    assert tflops.param_count(cfg) == jflops.param_count(jcfg)
    assert tflops.active_param_count(cfg) == jflops.active_param_count(jcfg)
    for _, seq, batch, mode in tcfgs.cells(arch):
        kw = dict(enc_len=seq if cfg.family == "encdec" else 0,
                  vis_tokens=cfg.n_vision_tokens)
        assert (tflops.cell_cost(cfg, mode, seq, batch, **kw).as_dict()
                == jflops.cell_cost(jcfg, mode, seq, batch, **kw).as_dict())


def test_registry_equals_jax():
    """ARCHS, SHAPES and LONG_CONTEXT_ARCHS are the JAX package's."""
    assert tcfgs.ARCHS == jcfgs.ARCHS and tcfgs.SHAPES == jcfgs.SHAPES
    assert tcfgs.LONG_CONTEXT_ARCHS == jcfgs.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mamba2_130m", "mixtral_8x22b", "whisper_medium"])
def test_param_count_matches_the_model(arch):
    """flops.param_count is within 5% of the port's parameters (norm and
    scale vectors aside), as the JAX package's test holds it."""
    from repro_torch.models.model import build_model

    cfg = tcfgs.smoke_config(arch)
    actual = sum(p.numel() for p in build_model(cfg, "cpu").parameters())
    assert abs(actual - tflops.param_count(cfg)) / actual < 0.05
