"""Train step factory: loss -> grad -> AdamW, with gradient accumulation
and optional int8 error-feedback gradient compression on the cross-pod axis
(the JAX package's ``repro.training.train_step``).

Gradient accumulation splits the batch into ``grad_accum`` equal
microbatches, one forward and backward each, and sums their gradients in
float32: a memory knob (the activation live-set divides by
``grad_accum``).  On a mesh each rank splits its own rows.

The step trains the model's own parameters (``Model.params()``), in place,
as the JAX package's train CLI donates its buffers; the state's moments
are updated in place too.  On a device mesh (``Model.distribute(mesh)``)
the parameters and the state are DTensors placed by
``repro_torch.models.sharding`` and the same step runs on them: each rank
computes on its rows of the batch (tensor parallel over 'model' where the
model's layout says so) and the gradients come back reduced to the
parameters' placements (``repro_torch.models.spmd``: a TP leaf's over the
data axes only, never over 'model').

Cross-pod compression (``compress_pod``): the pod axis crosses the slower
inter-pod links, so its all-reduce is the one worth compressing.  Each pod
computes the gradients of its B / npods rows (reduced within the pod only),
the loss is averaged over the pods, and each gradient leaf (the JAX
package's leaf: a scanned stack's layers together) is quantized to int8
with a pod-shared scale and all-reduced over the pod axis as int32, its
quantization residual kept in the error-feedback buffers ``state['ef']``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.models import spmd as spmd_lib
from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.training.optimizer import _is_dtensor, _leaf_key, _local, _zeros32

__all__ = ["TrainConfig", "make_train_step", "init_train_state", "quantize_psum"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    grad_accum: int = 1
    compress_pod: bool = False
    pod_axis: str = "pod"


def init_train_state(model, params: dict, tcfg: TrainConfig) -> dict:
    """{'opt': adamw_init(params), 'step': int32 0} on the parameters'
    device (and the error-feedback buffers under compress_pod); on a mesh
    the moments and the buffers are DTensors under their parameters'
    placements."""
    state = {"opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if tcfg.compress_pod:
        state["ef"] = {k: _zeros32(p) for k, p in params.items()}
    return state


def quantize_psum(g: torch.Tensor, group=None):
    """int8 error-feedback all-reduce of one tensor over ``group`` (None:
    the default process group); returns (mean_g, residual)."""
    npods = dist.get_world_size(group)
    scale = torch.amax(torch.abs(g))
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    wire = q.to(torch.int32)                  # int payload on the wire
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    mean_g = wire.to(torch.float32) * scale / npods
    residual = g - q.to(torch.float32) * scale
    return mean_g, residual


def _quantize_leaf(gs: list, mesh, axis: str):
    """``quantize_psum`` of one JAX leaf given as the port's tensors (a
    scanned stack's layers; DTensors of the same placements): one scale,
    the max over every tensor's full extent and every pod, then each
    tensor's int8 payload all-reduced over ``axis``."""
    local = [_local(g) for g in gs]
    scale = torch.amax(torch.stack([torch.amax(torch.abs(g)) for g in local]))
    for group in (mesh.get_group(a) for a in mesh.mesh_dim_names):
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale / 127.0 + 1e-12
    npods = spmd_lib.dim_size(mesh, axis)
    out = []
    for g, lg in zip(gs, local):
        q = torch.clamp(torch.round(lg / scale), -127, 127).to(torch.int8)
        wire = q.to(torch.int32)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
        mean_g = wire.to(torch.float32) * scale / npods
        residual = lg - q.to(torch.float32) * scale
        out.append((_like(g, mean_g), _like(g, residual)))
    return out


def _like(ref, local: torch.Tensor):
    """``local`` as a DTensor under ``ref``'s placements (``ref`` plain: as is)."""
    if not _is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def _grads(model, batch: dict):
    """(loss, metrics, grads) of one batch; grads in the parameters' dtype,
    zeros for a parameter the loss does not reach (as JAX's are)."""
    params = model.params()
    with torch.enable_grad():
        loss, metrics = model.loss_fn(batch)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _accum_grads(model, batch: dict, grad_accum: int, manual: tuple = ()):
    """Microbatch loop; grads accumulated in float32.  Each microbatch runs
    in its own mesh context (backward and remat included; off a mesh the
    one-rank context) on each rank's local rows; microbatch i holds the
    batch's rows [i B / n, (i + 1) B / n), as the JAX package's reshape
    does (each pod's batch under a manual pod axis)."""
    if grad_accum == 1:
        with model.spmd_context(batch, manual=manual).entered() as ctx:
            return _grads(model, ctx.local_batch(batch))
    mesh = model.mesh
    rows = [a for a in spmd_lib.batch_rows(batch["tokens"], mesh) if a not in manual]
    full = {k: _rows_gathered(v, mesh, manual) for k, v in batch.items()}
    n = full["tokens"].shape[0] // grad_accum
    acc = {k: _zeros32(p) for k, p in model.params().items()}
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(grad_accum):
        mb = {k: v[i * n:(i + 1) * n] for k, v in full.items()}
        ctx = spmd_lib.Spmd.for_rows(mesh, n, rows, seq=model.cfg.seq_parallel, manual=manual,
                                     tp=model.tp_layers())
        with ctx.entered():
            loss, _, grads = _grads(model, ctx.take_rows(mb))
        for k, g in grads.items():
            acc[k].add_(g.to(torch.float32))
        loss_sum = loss_sum + loss
    grads = {k: g / grad_accum for k, g in acc.items()}
    loss = loss_sum / grad_accum
    return loss, {"ce": loss}, grads


def _rows_gathered(v, mesh, manual: tuple):
    """A batch leaf's rows whole on this rank (split only over the manual
    dims, as placed): all-gathered over the other dims that split them."""
    if not _is_dtensor(v):
        return v
    rows = [a for a in spmd_lib.batch_rows(v, mesh) if a not in manual]
    with torch.no_grad():
        return spmd_lib._Gather.apply(v.to_local(), mesh, tuple((0, a) for a in reversed(rows)))


def _place_batch(model, batch: dict) -> dict:
    """The batch on the model's device; on a mesh, each leaf not yet a
    DTensor (the same global batch on every rank) placed by
    ``batch_shardings``."""
    batch = {k: v if _is_dtensor(v) else torch.as_tensor(v, device=model.device)
             for k, v in batch.items()}
    if model.mesh is None:
        return batch
    from repro_torch.models import sharding as sh

    plain = {k: v for k, v in batch.items() if not _is_dtensor(v)}
    placed = sh.sds_with(plain, sh.batch_shardings(plain, model.mesh), model.mesh,
                         src_data_rank=None)
    return {**batch, **placed}


def make_train_step(model, tcfg: TrainConfig, mesh=None):
    """Returns step(params, state, batch) -> (params', state', metrics).

    ``params`` must be the model's own (``model.params()``, or what the
    last step returned); they are updated in place.  ``batch`` holds tensors
    or numpy arrays, moved onto the model's device; on a mesh the same
    global batch on every rank (or DTensors), placed by ``batch_shardings``.
    Metrics: 'loss', 'ce', 'aux_loss' (at grad_accum=1; only 'ce' above
    it), 'grad_norm', 'lr'.

    ``mesh``: the DeviceMesh the model was distributed on (None: the
    model's own, if any).  ``compress_pod`` needs a mesh with the
    ``tcfg.pod_axis`` dim.
    """
    mesh = mesh if mesh is not None else model.mesh
    if mesh is not None and model.mesh is not mesh:
        raise ValueError("make_train_step(mesh=...): distribute the model on that mesh first "
                         "(model.distribute(mesh)) and pass its params")
    if tcfg.compress_pod and (mesh is None or tcfg.pod_axis not in mesh.mesh_dim_names):
        raise ValueError(f"TrainConfig(compress_pod=True) runs the step over a mesh's "
                         f"{tcfg.pod_axis!r} dim: pass a mesh that has one (got "
                         f"{None if mesh is None else mesh.mesh_dim_names})")

    def check(params):
        own = model.params()
        if params.keys() != own.keys() or any(params[k] is not p for k, p in own.items()):
            raise ValueError("the step trains the model's own parameters: pass model.params() "
                             "(Model.load_params copies other values in)")
        return own

    def plain_step(params, state, batch):
        own = check(params)
        loss, metrics, grads = _accum_grads(model, _place_batch(model, batch), tcfg.grad_accum)
        new_params, new_opt, om = adamw_update(tcfg.opt, own, grads, state["opt"])
        new_state = dict(state, opt=new_opt, step=state["step"] + 1)
        return new_params, new_state, {"loss": loss, **metrics, **om}

    if not tcfg.compress_pod:
        return plain_step

    axis = tcfg.pod_axis

    def pod_step(params, state, batch):
        own = check(params)
        # each pod its rows; gradients reduced within the pod only
        loss, metrics, grads = _accum_grads(model, _place_batch(model, batch), tcfg.grad_accum,
                                            manual=(axis,))
        npods = spmd_lib.dim_size(mesh, axis)
        pod = mesh.get_group(axis)
        for v in [loss, *metrics.values()]:
            dist.all_reduce(v, op=dist.ReduceOp.SUM, group=pod)
            v.div_(npods)
        groups: dict = {}
        for name in grads:
            groups.setdefault(_leaf_key(name), []).append(name)
        new_g, new_ef = {}, {}
        for key in sorted(groups):
            names = groups[key]
            pairs = _quantize_leaf([grads[n].to(torch.float32) + state["ef"][n] for n in names],
                                   mesh, axis)
            for n, (g, r) in zip(names, pairs):
                new_g[n], new_ef[n] = g, r
        new_params, new_opt, om = adamw_update(tcfg.opt, own, new_g, state["opt"])
        new_state = dict(state, opt=new_opt, ef=new_ef, step=state["step"] + 1)
        return new_params, new_state, {"loss": loss, **metrics, **om}

    return pod_step
