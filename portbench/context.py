"""What a per-layer metric's reader reads: the window's skims, the card's
trace over the window, and the reference of each file."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    skims: list  # window.Skim, in the order they ran
    trace: object = None  # devtrace.WindowTrace, in a traced run
    refs: list = field(default_factory=list)  # judge.FileReference a file
    _least: dict = field(default_factory=dict)

    def mean(self, values) -> float | None:
        values = [v for v in values if v is not None]
        return sum(values) / len(values) if values else None

    def least_bytes(self, file: int) -> int:
        """The roofline's byte count for one skim of ``file``."""
        if file not in self._least:
            from portbench import roofline

            ref = self.refs[file]
            self._least[file] = roofline.least_bytes(
                self.traffic["query"], ref.cols.raw, ref.cols.jagged, ref.mask,
                self.config["basket_events"])
        return self._least[file]
