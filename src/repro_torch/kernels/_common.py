"""Semiring ids, argument checks and the launch path shared by the kernel
wrappers."""
from __future__ import annotations

import torch

SEMIRINGS = ("plus_times", "min_plus", "max_plus", "min_src")
SEMIRING_ID = {name: i for i, name in enumerate(SEMIRINGS)}   # csrc/semiring.cuh
VALUE_TYPE_ID = {torch.float32: 0, torch.int32: 1}
REDUCE = {"plus_times": "sum", "min_plus": "amin", "max_plus": "amax", "min_src": "amin"}

_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def identity(semiring: str, dtype: torch.dtype):
    """combineAll identity of ``semiring`` for a float32 / int32 value type."""
    if semiring == "plus_times":
        return 0
    floating = dtype.is_floating_point
    if semiring == "max_plus":
        return float("-inf") if floating else _I32_MIN
    return float("inf") if floating else _I32_MAX


def from_float(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 -> value type: identity for float32; for int32, truncation
    toward zero saturating at the int32 range, NaN -> 0 (what the kernels'
    conversion does)."""
    if dtype == torch.float32:
        return x
    y = torch.nan_to_num(x, nan=0.0).clamp(float(_I32_MIN), 2147483520.0).to(dtype)
    return torch.where(x >= 2.0**31, torch.full((), _I32_MAX, dtype=dtype, device=x.device), y)


def check_semiring(semiring: str) -> None:
    if semiring not in SEMIRING_ID:
        raise ValueError(f"unknown semiring {semiring!r}; expected one of {SEMIRINGS}")


def check_tensor(name: str, t: torch.Tensor, *, dtypes, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d tensor of one of
    ``dtypes`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; expected one of {tuple(dtypes)}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}; expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def use_plain(device: torch.device) -> bool:
    """True for a CPU tensor (the wrapper runs the plain version); False for
    a CUDA tensor (the wrapper launches the kernel); raises otherwise."""
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"kernels run on 'cuda' tensors (plain version on 'cpu'), got {device}")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
