"""Rank tasks of the multi-device LM slice (``tests/test_torch_mesh_ranks.py``):
each runs on every gloo rank that ``_torch_spmd.spawn('_torch_mesh:<task>',
...)`` starts, imports only torch, numpy and repro_torch, and returns a
picklable value.  Every rank draws the same parameters and the same numpy
batch, so rank results compare with one-device references computed in the
parent."""
from __future__ import annotations

import dataclasses

import numpy as np


def _mesh(shape, names):
    from _torch_spmd import make_mesh

    return make_mesh(shape, names)


def _np(t) -> np.ndarray:
    from repro_torch.models.spmd import full_tensor

    return full_tensor(t).detach().float().cpu().numpy()


def _model(arch: str, params: dict, **overrides):
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    model = build_model(cfg, "cpu")
    model.load_params({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _watched(model, mesh):
    """A context that records, while a step runs: every collective
    (``CollectiveRecorder`` on ``mesh``), every weight read (name, whole
    shape, the shape the layer got, 'shard' for a TP layer's 'model' shard
    or 'whole'), and the shape of every op output with the vocab as its
    last dim and 3 or more dims (a [B, S, vocab] logits tensor)."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.hlo_analysis import CollectiveRecorder
    from repro_torch.models import spmd

    names = {id(p): k for k, p in model.params().items()}
    vocab = model.cfg.vocab
    reads, logits = [], set()

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if hasattr(t, "shape") and t.ndim >= 3 and t.shape[-1] == vocab:
                    logits.add(tuple(t.shape))
            return out

    def wrap(name, how):
        orig = getattr(spmd.Spmd, name)

        def read(self, p):
            out = orig(self, p)
            reads.append((names.get(id(p)), tuple(p.shape), tuple(out.shape), how))
            return out
        return orig, read

    @contextlib.contextmanager
    def watching():
        saved = {n: wrap(n, how) for n, how in (("param", "whole"), ("tp_shard", "shard"),
                                                 ("tp_replica", "whole"))}
        rec = CollectiveRecorder(mesh)
        try:
            for n, (_, read) in saved.items():
                setattr(spmd.Spmd, n, read)
            with rec, Shapes():
                yield
        finally:
            for n, (orig, _) in saved.items():
                setattr(spmd.Spmd, n, orig)
        watch["by_dim"] = {str(k): v for k, v in rec.by_dim().items()}
        watch["model_gathers"] = [line for (kind, _, line), dim in zip(rec.records, rec.dims)
                                  if kind == "all-gather" and dim == "model"]

    watch = {"reads": reads, "logits": logits}
    return watching, watch


def train_steps(payload) -> list:
    """For each case (arch, mesh, overrides, compress, steps): the port's
    model from the payload's parameters distributed on the mesh, ``steps``
    sharded train steps on the payload's batch; per step the metrics, the
    model's TP layout and,
    for a case marked ``watch``, what its first step read and sent
    (``_watched``); the final parameters (full, float32) on rank 0."""
    import contextlib

    import torch.distributed as dist

    from repro_torch.launch.mesh import data_axes
    from repro_torch.training import OptConfig, TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state

    out = []
    for case in payload["cases"]:
        mesh = _cached_mesh(*case["mesh"])
        over = dict(case.get("overrides", {}))
        if over.get("seq_parallel"):
            over["dp_axes"] = data_axes(mesh)
        key = case.get("key", case["arch"])     # params and batch of an overridden config
        model = _model(case["arch"], payload["params"][key], **over)
        params = model.distribute(mesh, src_data_rank=None)
        tcfg = TrainConfig(opt=OptConfig(**case.get("opt", {})),
                           grad_accum=case.get("grad_accum", 1),
                           compress_pod=case.get("compress", False))
        state = init_train_state(model, params, tcfg)
        step = make_train_step(model, tcfg, mesh)
        watching, watch = (_watched(model, mesh) if case.get("watch")
                           else (contextlib.nullcontext, None))
        metrics = []
        for i in range(case.get("steps", 1)):
            with watching() if i == 0 else contextlib.nullcontext():
                params, state, m = step(params, state, payload["batch"][key])
            metrics.append({k: float(v) for k, v in m.items()})
        full = {k: _np(v) for k, v in params.items()}
        ef = {k: _np(v) for k, v in state.get("ef", {}).items()}
        rec = {"metrics": metrics, "layout": model.layout, "watch": watch}
        if dist.get_rank() == 0:
            rec["params"], rec["ef"] = full, ef
        out.append(rec)
    return out


def vocab_loss(payload) -> dict:
    """``cross_entropy`` of the payload's logits [B, S, V] (the same on every
    rank) from this rank's vocab slice on its mesh's 'model' dim, against
    ``torch.logsumexp`` of the whole logits: the largest relative difference
    of the losses and the largest difference of the gradients (this rank's
    slice)."""
    import torch

    from repro_torch.models import spmd
    from repro_torch.models.model import cross_entropy

    mesh = _cached_mesh(*payload["mesh"])
    ctx = spmd.Spmd(mesh, tp=("vocab",))
    lg = torch.from_numpy(payload["logits"]).requires_grad_(True)
    tgt = torch.from_numpy(payload["tgt"])
    v = lg.shape[-1] // ctx.n_model
    part = lg.detach()[..., ctx.model_rank * v:(ctx.model_rank + 1) * v].requires_grad_(True)
    got = cross_entropy(part, tgt, ctx)
    (g_got,) = torch.autograd.grad(got.sum(), [part])
    want = torch.logsumexp(lg, -1) - torch.gather(lg, -1, tgt[..., None].long())[..., 0]
    (g_want,) = torch.autograd.grad(want.sum(), [lg])
    g_want = g_want[..., ctx.model_rank * v:(ctx.model_rank + 1) * v]
    return {"loss": float(((got - want).abs() / want.abs()).max()),
            "grad": float((g_got - g_want).abs().max()),
            "slice": tuple(part.shape)}


def pipeline(payload) -> dict:
    """``pipeline_apply`` of the JAX test's ``tanh(x @ w)`` stage on the
    payload's mesh: the outputs, sum(out ** 2)'s gradient in the stacked
    weights (stage weights sharded over 'pod') on rank 0."""
    import torch

    from repro_torch.models import sharding as sh
    from repro_torch.training.pipeline import pipeline_apply

    mesh = _cached_mesh(*payload["mesh"])
    ws = torch.from_numpy(payload["ws"])
    micro = torch.from_numpy(payload["micro"])
    w = sh.sds_with({"w": ws}, {"w": ("pod", None, None)}, mesh)["w"].detach()
    w.requires_grad_(True)
    out = pipeline_apply(lambda p, x: torch.tanh(x @ p), w, micro, mesh, axis="pod")
    (g,) = torch.autograd.grad(torch.sum(out ** 2), [w])
    return {"out": out.detach().numpy(), "grad": _np(g)}


_MESHES: dict = {}


def _cached_mesh(shape, names):
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = _mesh(shape, names)
    return _MESHES[key]


def layout(payload) -> dict:
    """This rank's local slices of an arange batch [B, S] placed by
    ``batch_shardings`` and of arange weights placed by
    ``param_shardings`` on the payload's mesh."""
    import torch

    from repro_torch.models import sharding as sh

    mesh = _cached_mesh(*payload["mesh"])
    out = {}
    tree = {k: torch.arange(int(np.prod(s)), dtype=torch.float32).reshape(s)
            for k, s in payload["params"].items()}
    placed = sh.sds_with(tree, sh.param_shardings(tree, mesh), mesh)
    out.update({k: v.to_local().numpy() for k, v in placed.items()})
    batch = {"tokens": torch.arange(int(np.prod(payload["batch"])),
                                    dtype=torch.int32).reshape(payload["batch"])}
    placed = sh.sds_with(batch, sh.batch_shardings(batch, mesh), mesh)
    out["tokens"] = placed["tokens"].to_local().numpy()
    return out


def checkpoint_reshard(payload) -> dict:
    """A train state saved under the first mesh, restored under each other
    mesh and on one device: whether every leaf is bitwise what was saved."""
    import torch

    from repro_torch.models import sharding as sh
    from repro_torch.training import TrainConfig, checkpoint, make_train_step
    from repro_torch.training.train_step import init_train_state

    mesh = _cached_mesh(*payload["save_mesh"])
    model = _model(payload["arch"], payload["params"])
    params = model.distribute(mesh)
    tcfg = TrainConfig()
    state = init_train_state(model, params, tcfg)
    params, state, _ = make_train_step(model, tcfg, mesh)(params, state, payload["batch"])
    tree = {"params": params, "state": state}
    want = {k: _np(v) for k, v in checkpoint._flatten(tree).items()}
    checkpoint.save(payload["dir"], 1, tree)
    out = {}
    for shape, names in payload["meshes"]:
        target = _cached_mesh(shape, names)

        def spec(name, leaf):
            if "model" in names:
                return sh._spec_for(name, len(leaf.shape), tuple(leaf.shape), target)
            ok = len(leaf.shape) and leaf.shape[0] % target.size() == 0
            return ("data",) + (None,) * (len(leaf.shape) - 1) if ok else (None,) * len(leaf.shape)

        specs = sh._map(spec, tree)
        got = checkpoint.restore(payload["dir"], 1, tree, shardings=specs, mesh=target)
        flat = checkpoint._flatten(got)
        out[str(shape)] = {
            "equal": all(np.array_equal(_np(flat[k]), v) for k, v in want.items()),
            "placed": sorted({str(tuple(v.placements)) for v in flat.values()
                              if hasattr(v, "placements")})}
    one = checkpoint.restore(payload["dir"], 1, tree, shardings="cpu")
    flat = checkpoint._flatten(one)
    out["one_device"] = {"equal": all(np.array_equal(_np(flat[k]), v) for k, v in want.items()),
                         "plain": all(type(v) is torch.Tensor for v in flat.values())}
    return out


def adamw_refusal(payload) -> str | None:
    """adamw_update given a gradient whose placements are not its
    parameter's (``Partial`` over 'pod'): the error it raises, or None."""
    import torch
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.models import sharding as sh
    from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update

    mesh = _cached_mesh(*payload["mesh"])
    w = sh.sds_with({"w": torch.ones(8, 4)}, {"w": ("data", None)}, mesh)["w"]
    pls = (Partial(),) + tuple(w.placements)[1:]
    g = DTensor.from_local(torch.ones_like(w.to_local()), mesh, pls, run_check=False,
                           shape=w.shape, stride=w.stride())
    try:
        adamw_update(OptConfig(), {"w": w}, {"w": g}, adamw_init({"w": w}))
    except ValueError as e:
        return str(e)
    return None


def mesh_all(payload) -> dict:
    """Every part of one spawn: the layout, the train steps (tensor
    parallel plain and seq_parallel, compress_pod), the vocab-parallel loss,
    the serving path, the pipeline and the checkpoint."""
    return {"layout": layout(payload["layout"]),
            "steps": train_steps(payload["steps"]),
            "vocab_loss": vocab_loss(payload["vocab_loss"]),
            "serve": serve(payload["serve"]),
            "adamw_refusal": adamw_refusal(payload["layout"]),
            "pipeline": pipeline(payload["pipeline"]),
            "checkpoint": checkpoint_reshard(payload["checkpoint"])}


def serve(payload) -> list:
    """For each case (arch, overrides): the port's model from the payload's
    parameters distributed on the mesh, its prefill forward on the placed
    batch, and ``steps`` serve_steps after prefill_cache on caches placed
    by ``cache_shardings`` (the tokens placed by ``batch_shardings`` each
    step): this rank's local logits of each."""
    import torch

    from repro_torch.launch.mesh import data_axes
    from repro_torch.models import sharding as sh

    mesh = _cached_mesh(*payload["mesh"])
    out = []
    for case in payload["cases"]:
        over = dict(case.get("overrides", {}))
        if over.get("seq_parallel"):
            over["dp_axes"] = data_axes(mesh)
        model = _model(case["arch"], payload["params"][case["arch"]], **over)
        model.distribute(mesh, src_data_rank=None)
        cfg = model.cfg
        batch = {k: torch.from_numpy(v) for k, v in payload["batch"][case["arch"]].items()}
        placed = sh.sds_with(batch, sh.batch_shardings(batch, mesh), mesh, src_data_rank=None)
        rec = {}
        with torch.inference_mode():
            if case.get("forward"):
                logits, _ = model(placed)
                rec["forward"] = logits.float().numpy()
            steps = case.get("steps", 0)
            if steps:
                B = batch["tokens"].shape[0]
                cache = model.init_cache(B, steps, enc_len=steps)
                cache = sh.sds_with(cache, sh.cache_shardings(cache, mesh, cfg), mesh,
                                    src_data_rank=None)
                rec["split"] = sorted({str(tuple(v.placements)) for v in _leaves(cache)})
                prompt = {k: v[:, :steps] for k, v in batch.items()}
                prompt = sh.sds_with(prompt, sh.batch_shardings(prompt, mesh), mesh,
                                     src_data_rank=None)
                cache = model.prefill_cache(cache, prompt)
                rec["decode"] = []
                for t in range(steps):
                    tok = {"tokens": batch["tokens"][:, t:t + 1]}
                    tok = sh.sds_with(tok, sh.batch_shardings(tok, mesh), mesh,
                                      src_data_rank=None)
                    lg, cache = model.serve_step(cache, tok["tokens"], t)
                    rec["decode"].append(lg[:, 0].float().numpy())
        out.append(rec)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
