"""The least device memory traffic a correct skim needs on one file.

Counted from the configuration's data and the reference's survivors alone,
whatever code computes the skim: the compressed and the decoded bytes of
every basket of the query's filter branches, of every basket of its other
output branches in a window holding a survivor, and one int32 index a
survivor written.  Each byte once: what a kernel reads twice, or pads, is
not counted.  This is the least work only where every window scans and
every stage runs in every window; with pruning or a cascade that skips
stages a correct skim does less.
"""

from __future__ import annotations

import numpy as np

from portbench import codec, reference


def least_bytes(query: dict, cols: dict, jagged: dict, mask: np.ndarray,
                basket_events: int) -> int:
    filt = set(reference.filter_branches(query, cols))
    live = reference.window_counts(mask, basket_events) > 0
    total = 4 * int(mask.sum())
    names = dict.fromkeys(sorted(filt) + reference.output_branches(query, cols, jagged))
    for name in names:
        counts = np.asarray(cols[jagged[name]]) if name in jagged else None
        parts = codec.baskets(np.asarray(cols[name]), counts, basket_events)
        for w, part in enumerate(parts):
            if name in filt or live[w]:
                total += len(codec.encode(part)) + part.nbytes
    return total
