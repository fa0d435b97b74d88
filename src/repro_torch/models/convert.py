"""The JAX package's parameter tree <-> the port's module state.

The JAX package keeps a model's parameters as nested dicts and lists whose
scanned stacks (``blocks``, ``enc_blocks``, ``dec_blocks``) carry a leading
scan axis.  The port's ``Model`` holds one module a layer; its state is a
flat dict under dotted names that follow the tree's keys, the scan axis
unstacked into an index: ``blocks.3.l0.attn.wq``, ``head.0.ln1``, ``wte``.

Leaves cross as numpy arrays (``np.asarray`` of a JAX array).  bfloat16
crosses bit for bit through int16, so nothing here needs a bfloat16 numpy
type.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["params_from_jax", "params_to_tree", "flatten_tree", "to_torch"]

_STACKED = ("blocks", "enc_blocks", "dec_blocks")


def to_torch(a) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes, or a tensor) as a
    CPU tensor of its own, bfloat16 bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts and lists -> {dotted name: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _scan_length(cfg: ModelConfig, key: str) -> int:
    return cfg.n_layers if key in ("enc_blocks", "dec_blocks") else cfg.scan_plan()["n_sb"]


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The JAX package's ``init_params`` tree (numpy or tensor leaves) ->
    the port's state dict on ``device`` (None: the GPU), ready for
    ``Model.load_params``: each stacked leaf [n, ...] becomes n leaves."""
    dev = resolve_device(device)
    out = {}
    for key, sub in tree.items():
        if key in _STACKED:
            n = _scan_length(cfg, key)
            for path, leaf in flatten_tree(sub).items():
                a = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
                if a.shape[:1] != (n,):
                    raise ValueError(f"{key}.{path}: leading axis {a.shape[:1]}, expected ({n},)")
                for i in range(n):
                    out[f"{key}.{i}.{path}"] = to_torch(a[i]).to(dev)
        else:
            for path, leaf in flatten_tree({key: sub}).items():
                out[path] = to_torch(leaf).to(dev)
    return out


def params_to_tree(state: dict, cfg: ModelConfig) -> dict:
    """The port's state dict -> the JAX package's tree layout: nested dicts,
    ``head`` / ``tail`` lists, the scanned stacks stacked on a leading axis;
    leaves are CPU tensors."""
    tree: dict = {}
    stacks: dict = {}
    for name, value in state.items():
        value = value.detach().cpu()
        key, _, rest = name.partition(".")
        if key in _STACKED:
            i, _, path = rest.partition(".")
            stacks.setdefault((key, path), {})[int(i)] = value
            continue
        if key in ("head", "tail"):
            i, _, path = rest.partition(".")
            lst = tree.setdefault(key, [])
            while len(lst) <= int(i):
                lst.append({})
            _set(lst[int(i)], path, value)
            continue
        _set(tree, name, value)
    for (key, path), rows in stacks.items():
        n = _scan_length(cfg, key)
        if sorted(rows) != list(range(n)):
            raise ValueError(f"{key}.*.{path}: layers {sorted(rows)}, expected 0..{n - 1}")
        _set(tree.setdefault(key, {}), path, torch.stack([rows[i] for i in range(n)]))
    if cfg.family != "encdec":
        tree.setdefault("head", [])
        tree.setdefault("tail", [])
    return tree


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value
