"""The layout the packed scatter-combine kernel (``csrc/packed_scatter_combine.cu``)
relies on, held on the port's exchange plan (``repro_torch.exchange.plan``).

The kernel finds, per sender row, the slots whose ids fall in its output
tile by a search over the ids it decodes from the words.  That needs every
sender row of ``recv_rows`` to be strictly ascending below ``n_local`` and
followed only by the sentinel ``n_local``.  This file checks that on every
fuzz topology of ``test_fuzz_parity`` (b = 2 and 4) and on the RMAT graph of
``test_torch_exchange``, both for ``recv_rows`` and for the ids decoded with
``codec.unpack_uniform`` from the rows packed at each device width (4, 8,
16 and 32 bits) and from the plan's own ``recv_words``.
"""
import numpy as np
import pytest
from test_fuzz_parity import TOPOLOGIES, _fuzz_edges

import repro_torch.core as T
from repro.graph import rmat
from repro_torch.core.partition import partition_graph
from repro_torch.exchange import codec, plan


def _assert_sorted_then_sentinel(rows: np.ndarray, n_local: int, what: str) -> None:
    """rows [..., p]: a strictly ascending run of ids below n_local, then
    only the sentinel n_local."""
    rows = rows.astype(np.int64)
    valid = rows < n_local
    assert not np.any(~valid[..., :-1] & valid[..., 1:]), f"{what}: an id after the sentinel"
    both = valid[..., :-1] & valid[..., 1:]
    assert np.all(np.diff(rows, axis=-1)[both] > 0), f"{what}: ids not strictly ascending"
    assert np.all(rows[~valid] == n_local), f"{what}: padding other than the sentinel"
    assert np.all(rows >= 0), f"{what}: negative id"


def _check_plan(edges: np.ndarray, n: int, b: int) -> int:
    pm, _ = partition_graph(edges, n, b, T.sssp(0))
    n_local = pm.part.n_local
    sets = plan.row_sets_from_stripes(pm.vertical, b)
    xp, arrays = plan.build_exchange(sets, n_local, scatter="kernel")
    recv = arrays["recv_rows"]                                  # [b, b, p_dev]
    assert recv.shape == (b, b, xp.p_dev)
    _assert_sorted_then_sentinel(recv, n_local, "recv_rows")
    plan.check_sorted_rows(recv, n_local)
    # the plan's own words, decoded at its device width, in sender order
    got = codec.unpack_uniform(arrays["recv_words"], xp.width_dev, b * xp.p_dev)
    np.testing.assert_array_equal(got.reshape(b, b, xp.p_dev), recv)
    checked = 0
    for width in codec.DEVICE_WIDTHS:
        if width < codec.device_width(n_local):
            continue
        per = 32 // width
        p = -(-xp.p_dev // per) * per                           # word-aligned rows
        rows = np.full((b, b, p), n_local, np.int64)
        rows[..., :xp.p_dev] = recv
        words = codec.pack_uniform(rows, width)
        ids = codec.unpack_uniform(words, width, p)
        np.testing.assert_array_equal(ids, rows)
        _assert_sorted_then_sentinel(ids, n_local, f"decoded at width {width}")
        checked += 1
    return checked


@pytest.mark.parametrize("b", [2, 4])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_recv_rows_sorted_then_sentinel_on_fuzz_topologies(topology, b):
    """Every width holds the fuzz graphs' small id domains, so all four are
    checked."""
    n = b * 11
    edges = _fuzz_edges(topology, n, b, np.random.default_rng(len(topology) * 10 + b))
    assert _check_plan(edges, n, b) == len(codec.DEVICE_WIDTHS)


def test_recv_rows_sorted_then_sentinel_on_rmat():
    """The RMAT graph of test_torch_exchange (n_local 32: widths 8, 16, 32)."""
    assert _check_plan(rmat(7, 700, seed=13), 128, 4) == 3


BROKEN_ROWS = {"descending": [[3, 0, 7, 9, 9]], "id_after_sentinel": [[0, 3, 9, 7, 9]],
               "other_padding": [[0, 3, 7, 10, 10]], "repeated_id": [[0, 3, 3, 9, 9]],
               "negative_id": [[-1, 3, 7, 9, 9]]}


def test_layout_check_catches_a_broken_row():
    """The test's check itself: a descending pair, an id after the sentinel
    and a padding value other than the sentinel each fail it."""
    good = np.array([[0, 3, 7, 9, 9]])
    _assert_sorted_then_sentinel(good, 9, "good")
    for bad in BROKEN_ROWS.values():
        with pytest.raises(AssertionError):
            _assert_sorted_then_sentinel(np.array(bad), 9, "bad")


@pytest.mark.parametrize("kind", sorted(BROKEN_ROWS))
def test_plan_check_refuses_a_broken_row(kind):
    """plan.check_sorted_rows, which build_exchange runs on recv_rows before
    it packs them for the kernel, accepts the layout and refuses each break
    of it; all-sentinel and full rows pass."""
    plan.check_sorted_rows(np.array([[0, 3, 7, 9, 9], [9, 9, 9, 9, 9], [0, 1, 2, 3, 8]]), 9)
    with pytest.raises(ValueError):
        plan.check_sorted_rows(np.array(BROKEN_ROWS[kind]), 9)
