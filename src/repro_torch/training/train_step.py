"""Train step factory: loss -> grad -> AdamW, with gradient accumulation
(the JAX package's ``repro.training.train_step``, on one device).

Gradient accumulation splits the batch into ``grad_accum`` equal
microbatches, one forward and backward each, and sums their gradients in
float32: a memory knob (the activation live-set divides by
``grad_accum``).

The step trains the model's own parameters (``Model.params()``), in place,
as the JAX package's train CLI donates its buffers; the state's moments
are updated in place too.

Cross-pod compression (``compress_pod``) runs the step over a mesh's pod
axis: the port has no mesh for the LM yet, so ``make_train_step`` refuses
it.  ``quantize_psum``, its int8 error-feedback all-reduce of one tensor,
is here over a ``torch.distributed`` process group.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update

__all__ = ["TrainConfig", "make_train_step", "init_train_state", "quantize_psum"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    grad_accum: int = 1
    compress_pod: bool = False
    pod_axis: str = "pod"


def init_train_state(model, params: dict, tcfg: TrainConfig) -> dict:
    """{'opt': adamw_init(params), 'step': int32 0} on the parameters'
    device (and the error-feedback buffers under compress_pod)."""
    state = {"opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if tcfg.compress_pod:
        state["ef"] = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for k, p in params.items()}
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


def _accum_grads(model, batch: dict, grad_accum: int):
    """Microbatch loop; grads accumulated in float32."""
    if grad_accum == 1:
        return _grads(model, batch)
    micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in model.params().items()}
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(grad_accum):
        loss, _, grads = _grads(model, {k: v[i] for k, v in micro.items()})
        for k, g in grads.items():
            acc[k].add_(g.to(torch.float32))
        loss_sum = loss_sum + loss
    grads = {k: g / grad_accum for k, g in acc.items()}
    loss = loss_sum / grad_accum
    return loss, {"ce": loss}, grads


def make_train_step(model, tcfg: TrainConfig):
    """Returns step(params, state, batch) -> (params', state', metrics).

    ``params`` must be the model's own (``model.params()``, or what the
    last step returned); they are updated in place.  ``batch`` holds tensors
    or numpy arrays, moved onto the model's device.  Metrics: 'loss', 'ce',
    'aux_loss' (at grad_accum=1; only 'ce' above it), 'grad_norm', 'lr'.
    """
    if tcfg.compress_pod:
        raise NotImplementedError(
            "TrainConfig(compress_pod=True) runs the step over a mesh's "
            f"{tcfg.pod_axis!r} axis; the port has no mesh for the LM yet (the mesh slice, "
            "repro_torch.models.sharding and repro_torch.launch.mesh, is not ported)")

    def step(params, state, batch):
        own = model.params()
        if params.keys() != own.keys() or any(params[k] is not p for k, p in own.items()):
            raise ValueError("the step trains the model's own parameters: pass model.params() "
                             "(Model.load_params copies other values in)")
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        loss, metrics, grads = _accum_grads(model, batch, tcfg.grad_accum)
        new_params, new_opt, om = adamw_update(tcfg.opt, own, grads, state["opt"])
        new_state = dict(state, opt=new_opt, step=state["step"] + 1)
        return new_params, new_state, {"loss": loss, **metrics, **om}

    return step
