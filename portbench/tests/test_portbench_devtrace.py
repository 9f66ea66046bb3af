"""The device trace's arithmetic on made-up events: busy time is the union
of the events inside the window, kernels leave copies and sets out, and
an idle gap goes to the innermost host span open at its middle."""

from types import SimpleNamespace

from portbench import devtrace


def span(kind, t0, t1):
    return SimpleNamespace(kind=kind, t0=t0, t1=t1)


def test_window_trace_adds_up_and_labels_gaps():
    events = [("kernel_a", 100, 200), ("Memcpy HtoD (Pinned -> Device)", 150, 300),
              ("kernel_b", 500, 600), ("Memset (Device)", 590, 700), ("kernel_a", 900, 1200)]
    wt = devtrace.WindowTrace(events, 0, 1000)
    assert wt.busy == [(100, 300), (500, 700), (900, 1000)]
    assert wt.busy_s == 500 / 1e9 and wt.window_s == 1000 / 1e9
    assert wt.kernel_s() == 300 / 1e9
    assert wt.count("Memcpy HtoD") == 1
    assert wt.device_ops()[0] == ["kernel_a", 200 / 1e9]
    assert wt.gaps() == [(0, 100), (300, 500), (700, 900)]
    # perf_counter 10.0 s is epoch 0 ns: the spans in seconds map onto the gaps
    spans = [span("query", 10.0, 10.0 + 750e-9), span("window", 10.0 + 250e-9, 10.0 + 600e-9),
             span("decode", 10.0 + 350e-9, 10.0 + 450e-9)]
    got = {label: round(s * 1e9) for label, s in wt.idle_gaps(spans, (10.0, 0))}
    assert got == {"decode": 200, "harness": 200, "query": 100}
