"""The five readers of the port's host-detail spans on made-up skims: kind
sums a skim, the query span's byte counter, and the unattributed share
over nested and overlapping leaves; a program without host detail gives
none of them."""

from types import SimpleNamespace

import pytest

from portbench.context import Context
from portbench.metrics import (
    device_wait_s_per_skim,
    fetch_s_per_skim,
    h2d_bytes_per_skim,
    pack_s_per_skim,
    unattributed_share,
)

READERS = (fetch_s_per_skim, pack_s_per_skim, device_wait_s_per_skim, h2d_bytes_per_skim,
           unattributed_share)


def span(sid, parent, kind, t0, t1, **attrs):
    return SimpleNamespace(sid=sid, parent=parent, name=kind, kind=kind, t0=t0, t1=t1,
                           attrs=attrs)


def skim_a(detail=True):
    """A query of 10 s: leaves cover [0, 1] (fetch), [1, 4] (decompress
    holding pack [1, 2] and device_wait [2, 3]), [5, 6] and [5.5, 7]
    (overlapping, from two threads) and [8, 9] (a write with no children);
    the window's own time [4, 5], [7, 8] and [9, 10] is under no leaf.
    The plan span lies before the query and is left out."""
    q = {"clock_ns": 123, "h2d_bytes": 4096} if detail else {}
    return [span(1, None, "query", 0.0, 10.0, **q),
            span(2, 1, "plan", -2.0, 0.0),
            span(3, 1, "window", 0.0, 8.0),
            span(4, 3, "load_window", 0.0, 4.0),
            span(5, 4, "fetch", 0.0, 1.0),
            span(6, 4, "decompress", 1.0, 4.0),
            span(7, 6, "pack", 1.0, 2.0),
            span(8, 6, "device_wait", 2.0, 3.0),
            span(9, 3, "pack", 5.0, 6.0),
            span(10, 3, "unpack", 5.5, 7.0),
            span(11, 1, "write", 8.0, 9.0)]


def skim_b():
    """A query of 4 s under leaves for 3 of them."""
    return [span(1, None, "query", 100.0, 104.0, clock_ns=456, h2d_bytes=1024),
            span(2, 1, "fetch", 100.0, 101.0),
            span(3, 1, "ledger", 101.0, 102.0),
            span(4, 1, "device_wait", 102.5, 103.5)]


def ctx(*span_lists):
    return Context(cell={}, config={}, traffic={},
                   skims=[SimpleNamespace(spans=s) for s in span_lists])


def test_kind_sums_and_counters_a_skim():
    c = ctx(skim_a(), skim_b())
    assert fetch_s_per_skim.read(c) == pytest.approx((1.0 + 1.0) / 2)
    assert pack_s_per_skim.read(c) == pytest.approx((1.0 + 1.0) / 2)
    assert device_wait_s_per_skim.read(c) == pytest.approx((1.0 + 1.0) / 2)
    assert h2d_bytes_per_skim.read(c) == pytest.approx((4096 + 1024) / 2)


def test_unattributed_share_takes_the_union_of_nested_and_overlapping_leaves():
    # skim a: leaves cover [0, 4] + [5, 7] + [8, 9] = 7 of 10 s; skim b: 3 of 4 s
    assert unattributed_share.read(ctx(skim_a())) == pytest.approx(0.3)
    assert unattributed_share.read(ctx(skim_b())) == pytest.approx(0.25)
    assert unattributed_share.read(ctx(skim_a(), skim_b())) == pytest.approx(1 - 10 / 14)


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[-1])
def test_no_host_detail_reads_nothing(reader):
    assert reader.read(ctx(skim_a(detail=False))) is None
    assert reader.read(ctx(skim_a(), skim_a(detail=False))) is None
    assert reader.read(ctx()) is None
