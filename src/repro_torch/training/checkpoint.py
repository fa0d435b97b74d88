"""Checkpointing with atomic commit (the JAX package's
``repro.training.checkpoint``, in its on-disk format).

Layout:
    <dir>/step_000123.tmp/   (written)   -> os.replace -> <dir>/step_000123/
        manifest.json        (a description of the tree, keys, shapes, dtypes, step)
        arrays.npz           (flat arrays keyed by path)

- Atomic commit: a checkpoint directory either fully exists or not at all
  (rename is atomic); partial writes are left as .tmp and ignored.
- One format for both packages: a tree is nested dicts and lists of
  tensors, flattened in ``jax.tree_util`` order (dict keys sorted) under
  ``jax.tree_util.keystr`` paths such as ``['params']['wte']``, so a
  checkpoint written by either package restores in the other.  A train
  state crosses in the JAX package's layout (``to_jax_layout`` /
  ``from_jax_layout``: its ``{'params', 'state'}`` with stacked ``blocks``).
- bfloat16 is stored as numpy keeps it without a bfloat16 type (``|V2``,
  as the JAX package's file holds it) and restored bit for bit through
  int16, guided by the manifest's dtypes.
- On a device mesh (DTensor leaves) every rank calls ``save``: each leaf
  is gathered whole (``full_tensor``) and rank 0 writes the same files and
  commits; the ranks leave together.  ``restore(..., shardings=)`` places
  each leaf under the given placements on any mesh, or on one device: the
  arrays are stored unsharded, so scaling the mesh up or down is a
  restore-time decision (elastic re-shard), bit for bit.
- Retention: keep the last `keep` checkpoints.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.models.convert import params_from_jax, params_to_tree

__all__ = ["save", "restore", "latest_step", "all_steps"]

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _children(tree, path: str):
    """(path, child) pairs of a dict (sorted keys) or a list, as keystr
    names them; None for a leaf."""
    if isinstance(tree, dict):
        return [(f"{path}[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"{path}[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, path: str = "") -> dict:
    kids = _children(tree, path)
    if kids is None:
        return {} if tree is None else {path: tree}
    out = {}
    for p, v in kids:
        out.update(_flatten(v, p))
    return out


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name as the JAX package's manifest names it)."""
    if _is_dtensor(leaf):
        from repro_torch.models.spmd import full_tensor

        leaf = full_tensor(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save(ckpt_dir: str, step: int, state, *, keep: int = 3) -> str:
    """state: nested dicts / lists of tensors (or numpy arrays).  With
    DTensor leaves every rank of their process group calls it; rank 0
    writes."""
    name = f"step_{step:09d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    flat = _flatten(state)
    sharded = any(_is_dtensor(v) for v in flat.values())
    arrays, dtypes = {}, {}
    for k, leaf in flat.items():        # every rank gathers, in the same order
        arrays[k], dtypes[k] = _to_numpy(leaf)
    if sharded and torch.distributed.get_rank() != 0:
        torch.distributed.barrier()     # rank 0 has committed
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "treedef": "repro_torch " + _structure(state),
        "keys": list(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": dtypes,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit

    for old in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:09d}"), ignore_errors=True)
    if sharded:
        torch.distributed.barrier()
    return final


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like, *, shardings=None, mesh=None):
    """Restore into the structure of ``like`` (nested dicts / lists whose
    leaves have a ``.shape``): tensors in the stored dtypes, each on its
    ``like`` tensor's device (the CPU for any other leaf).

    ``shardings``: the *target* layout (elastic re-shard): one device for
    every leaf, or a matching tree whose leaves are each a spec
    (``models.sharding``'s tuples; needs ``mesh``), a ``(DeviceMesh,
    placements)`` pair or a device.  A placed leaf is a DTensor on its
    mesh: every rank of it calls ``restore`` and reads the same files."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f)["dtypes"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def place(t, sharding):
        if sharding is None:
            return t
        if isinstance(sharding, (str, torch.device)):
            return t.to(sharding)
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.models.sharding import placements

        if len(sharding) == 2 and hasattr(sharding[0], "mesh_dim_names"):
            target, pls = sharding
        else:
            if mesh is None:
                raise ValueError("restore(shardings=<specs>) needs mesh=")
            target, pls = mesh, placements(tuple(sharding), mesh)
        return distribute_tensor(t.to(target.device_type), target, pls, src_data_rank=None)

    def sub(sh, key):
        return sh if sh is None or isinstance(sh, (str, torch.device)) else sh[key]

    def build(tree, p, sh):
        kids = _children(tree, p)
        if kids is None:
            if tree is None:
                return None
            arr = arrays[p]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"{p}: stored shape {arr.shape}, expected {tuple(tree.shape)}")
            if sh is not None:
                return place(_to_tensor(arr, dtypes[p]), sh)
            dev = tree.device if isinstance(tree, torch.Tensor) else "cpu"
            if _is_dtensor(tree):
                return place(_to_tensor(arr, dtypes[p]), (tree.device_mesh, tree.placements))
            return _to_tensor(arr, dtypes[p]).to(dev)
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{p}[{k!r}]", sub(sh, k)) for k in tree}
        return type(tree)(build(v, q, sub(sh, i)) for i, (q, v) in enumerate(kids))

    return build(like, "", shardings)


def to_jax_layout(cfg, params: dict, state: dict) -> dict:
    """The port's parameters and train state (``init_train_state``) as the
    JAX package's ``{'params': ..., 'state': ...}``: the moments in the
    parameters' tree, the scanned stacks stacked; CPU tensors."""
    opt = state["opt"]
    tree_state = {"opt": {"mu": params_to_tree(opt["mu"], cfg),
                          "nu": params_to_tree(opt["nu"], cfg),
                          "step": opt["step"].detach().cpu()},
                  "step": state["step"].detach().cpu()}
    if "ef" in state:
        tree_state["ef"] = params_to_tree(state["ef"], cfg)
    return {"params": params_to_tree(params, cfg), "state": tree_state}


def from_jax_layout(cfg, tree: dict, *, device=None) -> tuple[dict, dict]:
    """Inverse of ``to_jax_layout``: (params, state) under the port's names
    on ``device`` (None: the GPU)."""
    st = tree["state"]
    unstack = lambda t: params_from_jax(t, cfg, device=device)  # noqa: E731
    params = unstack(tree["params"])
    dev = next(iter(params.values())).device
    state = {"opt": {"mu": unstack(st["opt"]["mu"]), "nu": unstack(st["opt"]["nu"]),
                     "step": torch.as_tensor(st["opt"]["step"]).to(dev)},
             "step": torch.as_tensor(st["step"]).to(dev)}
    if "ef" in st:
        state["ef"] = unstack(st["ef"])
    return params, state
