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
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import flatten_tree
from repro_torch.models.layers import f32, init_dense, normal, rms_norm, torch_dtype
from repro_torch.models.transformer import Block, init_block, init_block_cache

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
        if cfg.seq_parallel:
            raise NotImplementedError(
                "cfg.seq_parallel=True shards activations over a device mesh's 'model' axis; "
                "the port has no mesh for the LM yet (repro_torch.models.sharding is not "
                "ported)")
        self.cfg = cfg
        self.device = resolve_device(device)
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

    # ------------------------------------------------------------ forward
    def _embed(self, tokens):
        return self.wte[tokens].to(torch_dtype(self.cfg.dtype))

    def _logits(self, x):
        cfg = self.cfg
        x = rms_norm(x, self.ln_f, cfg.norm_eps)
        if cfg.tie_embeddings or cfg.family == "encdec":      # whisper ties
            return x @ self.wte.T.to(torch_dtype(cfg.dtype))
        return x @ self.lm_head

    def _run_stack(self, stack, x, aux):
        """The scanned superblocks; under autograd with remat='block' each
        one's activations are recomputed in the backward, not kept."""
        aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat == "block" and torch.is_grad_enabled()
        for sb in stack:
            if remat:
                x, aux_loss = checkpoint(_superblock, sb, x, aux_loss, aux, use_reentrant=False)
            else:
                x, aux_loss = _superblock(sb, x, aux_loss, aux)
        return x, aux_loss

    def forward(self, batch):
        """-> (logits [B,S,V], aux_loss)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return self._forward_encdec(batch)
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = self._embed(tokens)
        aux = {"positions": torch.arange(S, device=x.device)[None, :], "ctx": batch.get("vis_emb")}
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.head:
            x, a = blk(x, aux)
            aux_total = aux_total + a
        x, a = self._run_stack(self.blocks, x, aux)
        aux_total = aux_total + a
        for blk in self.tail:
            x, a = blk(x, aux)
            aux_total = aux_total + a
        return self._logits(x), aux_total

    def _encode(self, enc_emb):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        enc = enc_emb.to(dt)
        Se = enc.shape[1]
        enc = enc + sinusoid_positions(Se, cfg.d_model, device=enc.device).to(dt)[None]
        aux_e = {"positions": torch.arange(Se, device=enc.device)[None, :], "ctx": None}
        enc, _ = self._run_stack(self.enc_blocks, enc, aux_e)
        return rms_norm(enc, self.ln_enc, cfg.norm_eps)

    def _forward_encdec(self, batch):
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        enc = self._encode(batch["enc_emb"])
        tokens = batch["tokens"]
        Sd = tokens.shape[1]
        y = self._embed(tokens)
        y = y + sinusoid_positions(Sd, cfg.d_model, device=y.device).to(dt)[None]
        aux_d = {"positions": torch.arange(Sd, device=y.device)[None, :], "ctx": enc}
        y, _ = self._run_stack(self.dec_blocks, y, aux_d)
        return self._logits(y), torch.zeros((), dtype=torch.float32, device=y.device)

    # --------------------------------------------------------------- loss
    def loss_fn(self, batch):
        """Next-token cross entropy (mean over B*(S-1) tokens) plus the MoE
        aux loss; differentiable in every parameter."""
        logits, aux_loss = self.forward(batch)
        tokens = batch["tokens"]
        lg = f32(logits[:, :-1])
        tgt = tokens[:, 1:]
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tgt[..., None].long())[..., 0]
        ce = torch.mean(logz - gold)
        loss = ce + AUX_LOSS_COEF * aux_loss
        return loss, {"ce": ce, "aux_loss": aux_loss}

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
        """tokens [B,1] -> (logits [B,1,V], cache), the cache written in place."""
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
        """Fill the static modality caches (cross K/V) from stub embeddings."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        KVH, dh = cfg.n_kv_heads, cfg.d_head

        def fill(c, p, ctx):
            B, Sc = ctx.shape[0], ctx.shape[1]
            c["xk"] = (ctx @ p["wk"]).reshape(B, Sc, KVH, dh)
            c["xv"] = (ctx @ p["wv"]).reshape(B, Sc, KVH, dh)

        if cfg.family == "vlm":
            ctx = batch["vis_emb"].to(dt)
            for sb, c_sb in zip(self.blocks, cache["blocks"]):
                fill(c_sb["l0"], sb["l0"]["xattn"], ctx)
        elif cfg.family == "encdec":
            enc = self._encode(batch["enc_emb"])
            for sb, c_sb in zip(self.dec_blocks, cache["dec_blocks"]):
                fill(c_sb["l0"], sb["l0"]["xattn"], enc)
        return cache


def build_model(cfg: ModelConfig, device=None) -> Model:
    """``Model(cfg)`` on ``device`` (None: the GPU, raising without one), its
    parameters drawn from seed 0 on that device (``init_params`` draws anew,
    ``load_params`` copies in)."""
    return Model(cfg, device)
