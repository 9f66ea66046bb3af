"""Whether the timed skims produced what the reference says they must.

Every skim of the window is held to the reference of its file, once the
window has closed:

* ``windows_wrong``: windows whose survivor count differs from the
  reference's (a missing or extra window counts once);
* ``passed_gap``: the gap between the skim's ``n_passed`` and the
  reference's survivors;
* ``baskets_wrong``: output baskets whose bytes differ from the
  reference's output written in the bitpack format, a basket or a branch
  missing or extra included;
* ``values_wrong``: values of those baskets that differ bit for bit.

Each is an exact comparison: its limit is 0.
"""

from __future__ import annotations

import numpy as np

from portbench import codec, reference

LIMITS = {"windows_wrong": 0, "passed_gap": 0, "baskets_wrong": 0, "values_wrong": 0}


class FileReference:
    """The reference's survivors and output for one file."""

    def __init__(self, query: dict, cols: dict, jagged: dict, basket_events: int,
                 precision: str = "stated"):
        self.query, self.basket_events = query, basket_events
        self.cols = reference.Columns(cols, jagged, precision)
        self.mask = reference.evaluate(query, self.cols)
        self._output = None

    def output(self) -> tuple[np.ndarray, dict, dict]:
        """(window counts, basket values, basket bytes) of the survivors."""
        if self._output is None:
            values = reference.expected_output(self.query, self.cols, self.mask,
                                               self.basket_events)
            blobs = {k: [codec.encode(v) for v in vs] for k, vs in values.items()}
            self._output = (reference.window_counts(self.mask, self.basket_events),
                            values, blobs)
        return self._output


def _differing(got: bytes, want: np.ndarray) -> int:
    """Values of a basket that differ, bit for bit (all of them when the
    basket does not decode or has another length)."""
    try:
        vals = codec.decode(got, want.dtype)
    except ValueError:
        return max(len(want), 1)
    if len(vals) != len(want):
        return max(len(vals), len(want))
    return int(np.count_nonzero(vals.view(np.uint8).reshape(len(vals), -1)
                                != want.view(np.uint8).reshape(len(want), -1), axis=1).sum()
               if len(vals) else 0)


def judge_skim(skim, ref: FileReference) -> dict:
    """The compared numbers of one skim: ``skim`` has ``window_rows``,
    ``n_passed`` and ``blobs`` (``{branch: [basket bytes, ...]}``)."""
    counts, values, blobs = ref.output()
    got_counts = np.array([k for _, _, k in skim.window_rows], dtype=np.int64)
    n = min(len(counts), len(got_counts))
    out = {
        "windows_wrong": int((counts[:n] != got_counts[:n]).sum()
                             + abs(len(counts) - len(got_counts))),
        "passed_gap": abs(int(skim.n_passed) - int(counts.sum())),
        "baskets_wrong": 0,
        "values_wrong": 0,
    }
    for name in set(blobs) | set(skim.blobs):
        want, want_vals = blobs.get(name, []), values.get(name, [])
        got = skim.blobs.get(name, [])
        for i in range(max(len(want), len(got))):
            if i < len(want) and i < len(got):
                if got[i] != want[i]:
                    out["baskets_wrong"] += 1
                    out["values_wrong"] += _differing(got[i], want_vals[i])
            else:
                out["baskets_wrong"] += 1
                out["values_wrong"] += len(want_vals[i]) if i < len(want) else 1
    return out


def judge(skims, refs: list) -> dict:
    """The numbers of every skim added up; ``correct`` when each compared
    number is within its limit."""
    total = dict.fromkeys(LIMITS, 0)
    failed = 0
    for skim in skims:
        one = judge_skim(skim, refs[skim.file])
        failed += any(one[k] > LIMITS[k] for k in LIMITS)
        for k, v in one.items():
            total[k] += v
    return {"numbers": total, "failed": failed,
            "correct": all(total[k] <= LIMITS[k] for k in LIMITS)}
