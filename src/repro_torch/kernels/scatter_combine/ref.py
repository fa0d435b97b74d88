"""Plain PyTorch versions of the scatter-combine kernels
(csrc/scatter_combine.cu, csrc/scatter_combine_multi.cu) and of their
packed-id forms (csrc/packed_scatter_combine.cu,
csrc/packed_scatter_combine_multi.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels._common import REDUCE, identity


def scatter_combine_ref(idx: torch.Tensor, val: torch.Tensor, n_local: int, *,
                        semiring: str) -> torch.Tensor:
    """r[s, n] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t] on the flat
    layout: each set s gets its own (n_local + 1)-wide segment whose last
    slot catches every idx outside [0, n_local).  Accepts any idx.
    idx: int32 [S, B, cap]; val: [S, B, cap] -> r: [S, n_local]."""
    sets = idx.shape[0]
    seg_w = n_local + 1
    flat = idx.reshape(sets, -1).to(torch.int64)
    flat = torch.where((flat >= 0) & (flat < n_local), flat, n_local)
    flat = flat + torch.arange(sets, dtype=torch.int64, device=idx.device)[:, None] * seg_w
    out = torch.full((sets * seg_w,), identity(semiring, val.dtype), dtype=val.dtype,
                     device=val.device)
    out.scatter_reduce_(0, flat.reshape(-1), val.reshape(-1), reduce=REDUCE[semiring],
                        include_self=True)
    return out.reshape(sets, seg_w)[:, :n_local]


def scatter_combine_multi_ref(idx: torch.Tensor, val: torch.Tensor, n_local: int, *,
                              semiring: str) -> torch.Tensor:
    """r[s, n, q] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t,q] on the
    flat layout of :func:`scatter_combine_ref`, columnwise.  Accepts any idx.
    idx: int32 [S, B, cap]; val: [S, B, cap, Q] -> r: [S, n_local, Q]."""
    sets = idx.shape[0]
    nq = val.shape[-1]
    seg_w = n_local + 1
    flat = idx.reshape(sets, -1).to(torch.int64)
    flat = torch.where((flat >= 0) & (flat < n_local), flat, n_local)
    flat = flat + torch.arange(sets, dtype=torch.int64, device=idx.device)[:, None] * seg_w
    out = torch.full((sets * seg_w, nq), identity(semiring, val.dtype), dtype=val.dtype,
                     device=val.device)
    out.scatter_reduce_(0, flat.reshape(-1, 1).expand(-1, nq), val.reshape(-1, nq),
                        reduce=REDUCE[semiring], include_self=True)
    return out.reshape(sets, seg_w, nq)[:, :n_local]


def packed_targets(words: torch.Tensor, n_slots: int, n_out: int, *, set_slots: int,
                   n_local: int, width: int) -> torch.Tensor:
    """Flat output row of each of ``n_slots`` slots, decoded from the
    bit-packed ``words`` (32 / width ids per uint32 word, LSB first): slot t
    of set s = t // set_slots targets decode(t) + s * (n_local + 1).  A slot
    whose id is n_local or more (the sentinel), or whose row is n_out or
    more, targets n_out, the catch-all that the caller drops.  int64 [T]."""
    per_word = 32 // width
    t = torch.arange(n_slots, dtype=torch.int64, device=words.device)
    w = words.to(torch.int64)[t // per_word]
    ids = (w >> ((t % per_word) * width)) & ((1 << width) - 1)
    rows = ids + (t // set_slots) * (n_local + 1)
    return torch.where((ids < n_local) & (rows < n_out), rows, n_out)


def packed_scatter_combine_ref(words: torch.Tensor, val: torch.Tensor, n_out: int, *,
                               set_slots: int, n_local: int, width: int,
                               semiring: str) -> torch.Tensor:
    """r[o] = combineAll_{t : target(t) == o} val[t] (see :func:`packed_targets`);
    an unreached o, and so every set's drop slot (row n_local of the set),
    gets the identity.  Accepts any ids.  words: uint32 [T * width / 32];
    val: [T] -> r: [n_out]."""
    rows = packed_targets(words, val.shape[0], n_out, set_slots=set_slots,
                          n_local=n_local, width=width)
    out = torch.full((n_out + 1,), identity(semiring, val.dtype), dtype=val.dtype,
                     device=val.device)
    out.scatter_reduce_(0, rows, val, reduce=REDUCE[semiring], include_self=True)
    return out[:n_out]


def packed_scatter_combine_multi_ref(words: torch.Tensor, val: torch.Tensor, n_out: int, *,
                                     set_slots: int, n_local: int, width: int,
                                     semiring: str) -> torch.Tensor:
    """Columnwise :func:`packed_scatter_combine_ref`: every slot's Q values
    go to its one target row.  words: uint32 [T * width / 32]; val: [T, Q]
    -> r: [n_out, Q]."""
    nq = val.shape[1]
    rows = packed_targets(words, val.shape[0], n_out, set_slots=set_slots,
                          n_local=n_local, width=width)
    out = torch.full((n_out + 1, nq), identity(semiring, val.dtype), dtype=val.dtype,
                     device=val.device)
    out.scatter_reduce_(0, rows[:, None].expand(-1, nq), val, reduce=REDUCE[semiring],
                        include_self=True)
    return out[:n_out]
