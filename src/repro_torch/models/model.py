"""Public model API: init_params / forward / loss_fn / init_cache / serve_step.

Batch dicts:
  decoder-only:  {"tokens": [B,S] int}
  vlm:           {"tokens": [B,S] int, "vis_emb": [B,Nv,D]}   (stub frontend)
  encdec:        {"enc_emb": [B,Se,D], "tokens": [B,Sd] int}  (stub frontend)

``Model`` is an ``nn.Module`` whose state mirrors the JAX package's
parameter tree, one layer a module: ``wte``, ``ln_f``, ``lm_head``, the
``head`` and ``tail`` layers, and ``blocks`` (``enc_blocks`` /
``dec_blocks`` for encdec), a ``ModuleList`` of superblocks whose layers
are keyed ``l0``, ``l1``, ... (``repro_torch.models.convert`` maps the JAX
package's stacked tree onto it and back).

Every parameter is trainable: ``loss_fn`` under autograd gives the
gradients of the training slice (``repro_torch.training``), and with
``cfg.remat == "block"`` each superblock of a scanned stack is recomputed
in the backward (``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint``).  Decode runs under ``torch.inference_mode``.

serve_step(cache, tokens [B,1], pos) -> (logits [B,1,V], cache): one decode
step against the KV/state caches, which it writes in place; modality caches
(cross K/V over the stub embeddings) are filled once by ``prefill_cache``.

On a device mesh (``distribute``) the parameters are DTensors placed by
``repro_torch.models.sharding``, batches and caches are DTensors placed by
its batch and cache rules, and every call runs each rank's rows in the
layout of ``repro_torch.models.spmd`` (with ``cfg.seq_parallel`` its
sequence slice too): tensor parallel over 'model' where the layers' shards
fall on whole heads and columns (``spmd.tp_layout``, ``self.layout``),
FSDP over 'data'.  The embedding and the logits are vocab-parallel there:
``loss_fn`` reduces each rank's logit slice over 'model' and never holds
[B, S, vocab].  A decode step gathers its weights over 'model'.  The loss
and the logits' values are the one-device model's.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import spmd as spmd_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import flatten_tree
from repro_torch.models.layers import f32, init_dense, normal, rms_norm, torch_dtype
from repro_torch.models.transformer import Block, _sp_constraint, init_block, init_block_cache

__all__ = ["Model", "build_model", "sinusoid_positions"]

AUX_LOSS_COEF = 0.01


def sinusoid_positions(seq: int, d: int, offset=0, *, device=None):
    pos = f32(torch.arange(seq, device=device) + offset)[:, None]
    dim = f32(torch.arange(0, d, 2, device=device))[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def _superblocks(cfg, pattern, n_sb, gen):
    return [{f"l{i}": init_block(gen, cfg, kind) for i, kind in enumerate(pattern)}
            for _ in range(n_sb)]


def _superblock(sb, x, aux_loss, aux):
    """One superblock's layers in order, the aux loss summed as it goes."""
    for blk in sb.values():
        x, a = blk(x, aux)
        aux_loss = aux_loss + a
    return x, aux_loss


def _stack_modules(cfg, pattern, trees):
    return nn.ModuleList(nn.ModuleDict({f"l{i}": Block(kind, cfg, t[f"l{i}"])
                                        for i, kind in enumerate(pattern)}) for t in trees)


class Model(nn.Module):
    """One architecture's LM on one device; see the module docstring."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = None
        self.layout: dict = {}      # spmd.tp_layout on a mesh; {} off one
        tree = self._draw(self._generator(0))
        plan = cfg.scan_plan()
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(key, nn.Parameter(value))
        if cfg.family == "encdec":
            self.enc_blocks = _stack_modules(cfg, ("enc",), tree["enc_blocks"])
            self.dec_blocks = _stack_modules(cfg, ("dec",), tree["dec_blocks"])
        else:
            self.head = nn.ModuleList(Block(k, cfg, t) for k, t in zip(plan["head"], tree["head"]))
            self.blocks = _stack_modules(cfg, plan["pattern"], tree["blocks"])
            self.tail = nn.ModuleList(Block(k, cfg, t) for k, t in zip(plan["tail"], tree["tail"]))

    # ------------------------------------------------------------- params
    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _draw(self, gen: torch.Generator) -> dict:
        """The parameter tree, unstacked: blocks are a list of superblocks."""
        cfg = self.cfg
        if gen.device.type != self.device.type:
            raise ValueError(f"the generator is on {gen.device}, the model on {self.device}")
        plan = cfg.scan_plan()
        dt = torch_dtype(cfg.dtype)
        tree = {
            "wte": normal(gen, (cfg.vocab, cfg.d_model), 0.02, dt),
            "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab, dt)
        if cfg.family == "encdec":
            tree["enc_blocks"] = _superblocks(cfg, ("enc",), cfg.n_layers, gen)
            tree["ln_enc"] = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
            tree["dec_blocks"] = _superblocks(cfg, ("dec",), cfg.n_layers, gen)
            return tree
        tree["head"] = [init_block(gen, cfg, kind) for kind in plan["head"]]
        tree["blocks"] = _superblocks(cfg, plan["pattern"], plan["n_sb"], gen)
        tree["tail"] = [init_block(gen, cfg, kind) for kind in plan["tail"]]
        return tree

    def init_params(self, generator: torch.Generator | None = None) -> dict:
        """Draw every parameter anew from ``generator`` (on the model's
        device; default: seed 0) at the JAX package's scales, in place;
        returns the state dict."""
        generator = generator or self._generator(0)
        with torch.no_grad():
            for name, value in flatten_tree(self._draw(generator)).items():
                self.get_parameter(name).copy_(value)
        return self.params()

    def params(self) -> dict:
        """The state under the JAX package's names, unstacked: 'wte',
        'blocks.3.l0.attn.wq', 'head.0.ln1', ..."""
        return dict(self.named_parameters())

    def load_params(self, state: dict) -> None:
        """Copy ``state`` (as :meth:`params` names it) in; every parameter
        must be given, at its shape, and no other."""
        mine = self.params()
        missing, extra = sorted(set(mine) - set(state)), sorted(set(state) - set(mine))
        if missing or extra:
            raise KeyError(f"parameter names differ: missing {missing[:5]}, unexpected {extra[:5]}")
        with torch.no_grad():
            for name, value in state.items():
                dst = mine[name]
                if tuple(value.shape) != tuple(dst.shape) or value.dtype != dst.dtype:
                    raise ValueError(f"{name}: {tuple(value.shape)} {value.dtype} given for "
                                     f"{tuple(dst.shape)} {dst.dtype}")
                dst.copy_(value)

    def distribute(self, mesh, shardings=None, *, src_data_rank: int | None = 0) -> dict:
        """Place every parameter on ``mesh`` (a named ``DeviceMesh``) as a
        DTensor under its spec (``shardings``, a dict of specs under
        :meth:`params`' names; default ``sharding.param_shardings``), in
        place; returns :meth:`params`.  ``src_data_rank`` as
        ``distribute_tensor`` takes it (0: rank 0's values; None: each rank
        keeps its own, equal on every rank).  On a 'model' dim > 1 the
        layers of ``spmd.tp_layout`` run TP over it (recorded in
        ``self.layout``); the rest gather their weights where they read
        them (FSDP)."""
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.models import sharding as sh

        cfg = self.cfg
        if cfg.seq_parallel and set(cfg.dp_axes) != set(sh.data_axes(mesh)):
            raise ValueError(f"cfg.seq_parallel with dp_axes={cfg.dp_axes}: the mesh's batch axes "
                             f"are {sh.data_axes(mesh)} (set dp_axes=data_axes(mesh))")
        params = self.params()
        specs = shardings if shardings is not None else sh.param_shardings(params, mesh)
        dev = torch.device(mesh.device_type)
        if dev.type == "cuda":      # this rank's card (index 0 under a dry run's fake tensors)
            dev = torch.device("cuda", torch.cuda.current_device()
                               if torch.cuda.is_available() else 0)
        with torch.no_grad():
            for name, p in params.items():
                mod_name, _, leaf = name.rpartition(".")
                mod = self.get_submodule(mod_name) if mod_name else self
                dt = distribute_tensor(p.detach().to(dev), mesh,
                                       sh.placements(specs[name], mesh),
                                       src_data_rank=src_data_rank)
                setattr(mod, leaf, nn.Parameter(dt))
        self.mesh = mesh
        self.device = dev
        n_model = spmd_lib.dim_size(mesh, "model") if "model" in mesh.mesh_dim_names else 1
        self.layout = spmd_lib.tp_layout(cfg, n_model) if n_model > 1 else {}
        return self.params()

    def tp_layers(self, decode: bool = False) -> tuple:
        """The layers that run tensor parallel in a call (none in a decode
        step)."""
        return () if decode else tuple(k for k, v in self.layout.items() if v == "tp")

    def spmd_context(self, batch=None, *, manual: tuple = (), decode: bool = False,
                     microbatches: int = 1):
        """The mesh context of one call: the active one, or one from the
        batch's row placement (``spmd.ONE_RANK`` without a mesh), running
        ``self.layout``'s TP layers (not in a decode step); without TP the
        'model' ranks split the rows too where each gets a multiple of
        ``microbatches`` of them (not in a decode step)."""
        ctx = spmd_lib.active()
        if self.mesh is None or ctx.mesh is not None:
            return ctx
        tokens = None if batch is None else batch.get("tokens", next(iter(batch.values())))
        rows = spmd_lib.batch_rows(tokens, self.mesh)
        names = self.mesh.mesh_dim_names
        model_rows = (not decode and "model" in names and spmd_lib._is_dtensor(tokens)
                      and tokens.to_local().shape[0] % (spmd_lib.dim_size(self.mesh, "model")
                                                        * microbatches) == 0)
        return spmd_lib.Spmd(self.mesh, rows=rows, seq=self.cfg.seq_parallel, manual=manual,
                             model_rows=model_rows, tp=self.tp_layers(decode))

    def _entered(self, batch=None, **kw):
        return self.spmd_context(batch, **kw).entered()

    # ------------------------------------------------------------ forward
    def _p(self, name):
        return spmd_lib.local_param(getattr(self, name))

    def _embed(self, tokens):
        return self._p("wte")[tokens].to(torch_dtype(self.cfg.dtype))

    def _embed_seq(self, tokens, pos_emb: bool = False):
        """(embeddings [B, S_loc, D], positions [1, S_loc]) of a full-sequence
        call in the residual stream's layout: under seq_parallel this
        rank's sequence slice (``_sp_constraint``, as the JAX package
        anchors it) and its global positions.  Vocab-parallel: each rank
        looks up the tokens of its vocab slice (zeros elsewhere), summed
        over 'model' by "reduce out" (under seq_parallel the reduce-scatter
        onto the slice).  ``pos_emb``: the sinusoid position embeddings
        added (the enc-dec's decoder)."""
        cfg = self.cfg
        ctx = spmd_lib.active()
        dt = torch_dtype(cfg.dtype)
        if ctx.tp_on("vocab"):
            w = ctx.tp_shard(self.wte)                    # [V / model, D]
            idx, hit = _vocab_slice(tokens, w.shape[0], ctx)
            e = w[idx].to(dt)
            x = ctx.tp_out(torch.where(hit[..., None], e, torch.zeros_like(e)))
        else:
            x = _sp_constraint(self._embed(tokens), cfg)
        start, positions = _seq_positions(x)
        if pos_emb:
            x = x + sinusoid_positions(x.shape[1], cfg.d_model, offset=start,
                                       device=x.device).to(dt)[None]
        return x, positions

    def _logits(self, x, *, vocab_local: bool = False):
        """Logits [B, S, V] of the residual stream ``x``.  Vocab-parallel on a
        mesh: each rank's [B, S, V / model] slice over the whole sequence
        (``vocab_local``), else gathered over 'model' (and cut to the
        rank's sequence slice under seq_parallel).  A vocab that the
        'model' ranks do not divide, while other layers run TP: each
        computes its block of the rows, gathered over 'model'."""
        cfg = self.cfg
        ctx = spmd_lib.active()
        if not ctx.tp_on("vocab") and ctx.splits_rows(x):
            return ctx.rows_split(self._logits, x)
        x = rms_norm(x, self._p("ln_f"), cfg.norm_eps)
        tied = cfg.tie_embeddings or cfg.family == "encdec"      # whisper ties
        if not ctx.tp_on("vocab"):
            if tied:
                return x @ self._p("wte").T.to(torch_dtype(cfg.dtype))
            return x @ self._p("lm_head")
        h = ctx.tp_in(x)
        w = ctx.tp_shard(self.wte).T.to(torch_dtype(cfg.dtype)) if tied else \
            ctx.tp_shard(self.lm_head)
        logits = h @ w
        if vocab_local:
            return logits
        return ctx.seq_slice(ctx.gather_model(logits, -1))

    def _run_stack(self, stack, x, aux):
        """The scanned superblocks; under autograd with remat='block' each
        one's activations are recomputed in the backward, not kept."""
        aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat == "block" and torch.is_grad_enabled()
        ctx = spmd_lib.active()
        for sb in stack:
            if remat:      # the recompute runs in this call's mesh context
                x, aux_loss = checkpoint(_superblock, sb, x, aux_loss, aux, use_reentrant=False,
                                         context_fn=lambda: (contextlib.nullcontext(),
                                                             ctx.entered()))
            else:
                x, aux_loss = _superblock(sb, x, aux_loss, aux)
        return x, aux_loss

    def forward(self, batch):
        """-> (logits [B,S,V], aux_loss); on a mesh each rank's logits of its
        rows (and with seq_parallel its sequence slice)."""
        with self._entered(batch) as ctx:
            x, aux_loss = self._forward(ctx.local_batch(batch))
            return self._logits(x), aux_loss

    def _forward(self, batch):
        """(the final residual stream [B, S_loc, D], aux_loss)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return self._forward_encdec(batch)
        x, positions = self._embed_seq(batch["tokens"])
        aux = {"positions": positions, "ctx": batch.get("vis_emb")}
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.head:
            x, a = blk(x, aux)
            aux_total = aux_total + a
        x, a = self._run_stack(self.blocks, x, aux)
        aux_total = aux_total + a
        for blk in self.tail:
            x, a = blk(x, aux)
            aux_total = aux_total + a
        return x, aux_total

    def _encode(self, enc_emb):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        enc = enc_emb.to(dt)
        Se = enc.shape[1]
        enc = enc + sinusoid_positions(Se, cfg.d_model, device=enc.device).to(dt)[None]
        enc = _sp_constraint(enc, cfg)
        _, positions = _seq_positions(enc)
        aux_e = {"positions": positions, "ctx": None}
        enc, _ = self._run_stack(self.enc_blocks, enc, aux_e)
        enc = rms_norm(enc, self._p("ln_enc"), cfg.norm_eps)
        return spmd_lib.active().gather_seq(enc)

    def _forward_encdec(self, batch):
        enc = self._encode(batch["enc_emb"])
        y, positions = self._embed_seq(batch["tokens"], pos_emb=True)
        aux_d = {"positions": positions, "ctx": enc}
        y, _ = self._run_stack(self.dec_blocks, y, aux_d)
        return y, torch.zeros((), dtype=torch.float32, device=y.device)

    # --------------------------------------------------------------- loss
    def loss_fn(self, batch):
        """Next-token cross entropy (mean over B*(S-1) tokens) plus the MoE
        aux loss; differentiable in every parameter.  On a mesh the value is
        the global one on every rank and each rank's gradients are its
        share (``repro_torch.models.spmd``); off a mesh one rank holds
        every row and position."""
        with self._entered(batch) as ctx:
            batch = ctx.local_batch(batch)
            x, aux_loss = self._forward(batch)
            tokens = batch["tokens"]
            B, S = tokens.shape
            # the targets; the sequence's last position has none
            tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
            whole = ctx.tp_on("vocab") or ctx.splits_rows(x)
            start = 0 if whole else ctx.seq_start(x.shape[1])
            nll = self._nll(x, tgt.narrow(1, start, S if whole else x.shape[1]))
        n_rows = 1
        for a in ctx.rows:
            n_rows *= spmd_lib.dim_size(ctx.mesh, a)
        valid = (torch.arange(nll.shape[1], device=tokens.device) + start) < S - 1
        part = torch.sum(torch.where(valid[None, :], nll, torch.zeros_like(nll)))
        ce = part / (B * n_rows * (S - 1))
        # whole: every position of the rows, the same on every 'model' rank
        ce = ctx.sum_rows(ce) if whole else ctx.sum_partial(ce)
        aux_loss = ctx.sum_partial(aux_loss / ctx.n_partial)
        loss = ce + AUX_LOSS_COEF * aux_loss
        return loss, {"ce": ce, "aux_loss": aux_loss}

    def _nll(self, x, tgt):
        """-log p(tgt) [B, S'] of the final residual stream ``x``: from each
        rank's vocab slice of the logits of every position where the vocab
        runs TP; where other layers do, each 'model' rank's block of the
        rows, gathered (``[B, S, vocab]`` is never whole on a rank under
        TP); else of this rank's positions."""
        ctx = spmd_lib.active()
        if ctx.tp_on("vocab"):
            return cross_entropy(self._logits(x, vocab_local=True), tgt, ctx)
        if ctx.splits_rows(x):
            return ctx.rows_split(self._nll, x, tgt)
        return cross_entropy(self._logits(x), tgt)

    # -------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_seq: int, enc_len: int = 0, dtype=None):
        """Per-layer cache dicts: {'head': [...], 'blocks': [{'l0': ...}, ...],
        'tail': [...]} ({'dec_blocks': [...]} for encdec)."""
        cfg = self.cfg
        dt = torch_dtype(dtype or cfg.dtype)

        def mk(kind):
            return init_block_cache(cfg, kind, batch, max_seq, dt, enc_len=enc_len,
                                    device=self.device)

        if cfg.family == "encdec":
            return {"dec_blocks": [{"l0": mk("dec")} for _ in range(cfg.n_layers)]}
        plan = cfg.scan_plan()
        return {
            "head": [mk(k) for k in plan["head"]],
            "blocks": [{f"l{i}": mk(kind) for i, kind in enumerate(plan["pattern"])}
                       for _ in range(plan["n_sb"])],
            "tail": [mk(k) for k in plan["tail"]],
        }

    # --------------------------------------------------------- serve step
    def serve_step(self, cache, tokens, pos: int):
        """tokens [B,1] -> (logits [B,1,V], cache), the cache written in place
        (on a mesh each rank's rows; a cache whose sequence dim is split
        over 'model' is read split-KV: each rank its slots, the softmax
        combined across them)."""
        batch = {"tokens": tokens}
        with self._entered(batch, decode=True) as ctx:
            logits, _ = self._serve_step(_local_cache(cache, ctx),
                                         ctx.local_batch(batch)["tokens"], pos)
        return logits, cache

    def _serve_step(self, cache, tokens, pos: int):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        x = self._embed(tokens)
        if cfg.family == "encdec":
            x = x + sinusoid_positions(1, cfg.d_model, offset=pos, device=x.device).to(dt)[None]
            for sb, c_sb in zip(self.dec_blocks, cache["dec_blocks"]):
                x, _ = sb["l0"].decode(x, c_sb["l0"], pos)
            return self._logits(x), cache
        for blk, c in zip(self.head, cache["head"]):
            x, _ = blk.decode(x, c, pos)
        for sb, c_sb in zip(self.blocks, cache["blocks"]):
            for key, blk in sb.items():
                x, _ = blk.decode(x, c_sb[key], pos)
        for blk, c in zip(self.tail, cache["tail"]):
            x, _ = blk.decode(x, c, pos)
        return self._logits(x), cache

    # ------------------------------------------------------------ prefill
    def prefill_cache(self, cache, batch):
        """Fill the static modality caches (cross K/V) from stub embeddings
        (on a mesh each rank its rows of the placed caches)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        KVH, dh = cfg.n_kv_heads, cfg.d_head

        def fill(c, p, emb, mesh_ctx):
            B, Sc = emb.shape[0], emb.shape[1]
            _put(c, "xk", (emb @ p["wk"]).reshape(B, Sc, KVH, dh), mesh_ctx)
            _put(c, "xv", (emb @ p["wv"]).reshape(B, Sc, KVH, dh), mesh_ctx)

        with self._entered(batch, decode=True) as mesh_ctx:
            batch = mesh_ctx.local_batch(batch)
            if cfg.family == "vlm":
                emb = batch["vis_emb"].to(dt)
                for sb, c_sb in zip(self.blocks, cache["blocks"]):
                    fill(c_sb["l0"], sb["l0"]["xattn"], emb, mesh_ctx)
            elif cfg.family == "encdec":
                enc = self._encode(batch["enc_emb"])
                for sb, c_sb in zip(self.dec_blocks, cache["dec_blocks"]):
                    fill(c_sb["l0"], sb["l0"]["xattn"], enc, mesh_ctx)
        return cache


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of logits whose vocab is split
    over 'model': the max and the sum of the exponentials all-reduced, in
    ``torch.logsumexp``'s steps (bitwise it on one rank); the gradient of
    each rank's slice is ``torch.logsumexp``'s, exp(logits - result)."""

    @staticmethod
    def forward(ctx, lg, spmd):
        m = torch.amax(lg, dim=-1)
        if spmd.n_model > 1:
            m = spmd.reduce_model(m, "max")
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        sumexp = torch.sum(torch.exp(lg - m[..., None]), dim=-1)
        if spmd.n_model > 1:
            sumexp = spmd.reduce_model(sumexp, "sum")
        out = torch.log(sumexp) + m
        ctx.save_for_backward(lg, out)
        return out

    @staticmethod
    def backward(ctx, g):
        lg, out = ctx.saved_tensors
        return g[..., None] * torch.exp(lg - out[..., None]), None


def cross_entropy(logits, tgt, ctx=spmd_lib.ONE_RANK):
    """-log softmax(logits)[tgt] [B, S] in float32, of ``logits`` [B, S, V']
    that hold this rank's slice of the vocab (rank r of n on 'model' holds
    columns [r V', (r + 1) V')), never gathered: the log-sum-exp and the
    target's logit reduced over 'model' (``ctx``; ``ONE_RANK``: the whole
    vocab here)."""
    lg = f32(logits)
    idx, hit = _vocab_slice(tgt, lg.shape[-1], ctx)
    gold = torch.gather(lg, -1, idx[..., None])[..., 0]
    gold = ctx.psum_model(torch.where(hit, gold, torch.zeros_like(gold)))
    return _LogSumExp.apply(lg, ctx) - gold


def _vocab_slice(ids, v: int, ctx):
    """(index into this rank's ``v`` vocab rows, clamped; whether the id is
    one of them) of token ids, rank r of 'model' holding [r v, (r + 1) v)."""
    idx = ids.long() - ctx.model_rank * v
    return idx.clamp(0, v - 1), (idx >= 0) & (idx < v)


def _put(c: dict, key: str, value, ctx) -> None:
    """``c[key] = value``; a DTensor leaf (a cache placed on a mesh) keeps
    its placement and takes its local block of ``value`` (``value`` holds
    this rank's rows; a sequence split over 'model' is cut to the rank's
    slots)."""
    if not spmd_lib._is_dtensor(c[key]):
        c[key] = value
        return
    local, off, _ = ctx.cache_view(c[key])
    local.copy_(value.narrow(1, off, local.shape[1]))


def _local_cache(tree, ctx):
    """A cache tree with each DTensor leaf as its local tensor (a view: the
    writes land in the DTensor), except a leaf whose sequence dim is split
    over 'model', which the split-KV decode reads as it is."""
    if isinstance(tree, dict):
        return {k: _local_cache(v, ctx) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_local_cache(v, ctx) for v in tree]
    if spmd_lib._is_dtensor(tree) and not ctx.seq_split(tree):
        return tree.to_local()
    return tree


def _seq_positions(x):
    """(start, positions [1, S_loc]) of ``x``, the residual stream's
    sequence as this rank holds it: under seq_parallel on a mesh its slice
    (``_sp_constraint``), whose global positions start at ``start``."""
    start = spmd_lib.active().seq_start(x.shape[1])
    return start, (torch.arange(x.shape[1], device=x.device) + start)[None, :]


def build_model(cfg: ModelConfig, device=None) -> Model:
    """``Model(cfg)`` on ``device`` (None: the GPU, raising without one), its
    parameters drawn from seed 0 on that device (``init_params`` draws anew,
    ``load_params`` copies in)."""
    return Model(cfg, device)
