"""The repo's five example scripts, on the PyTorch/CUDA port.

Each module is the counterpart of the script of the same name under
``examples/``: the same queries, store shapes, seeds, default sizes,
network models, quotas and fault injections, printing the same lines.
Each runs on the card unless told otherwise::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.skim_service --device cpu

Every example takes ``--device`` (``cuda`` by default, ``cpu`` for the
host backends) and prints one line naming it before its own output.
Without a card, ``--device cuda`` raises, naming ``--device cpu``.

:data:`CLOCK_FIELDS` lists, per example, the printed values that carry
wall-clock time (measured stage seconds, or modeled link times with
measured compute added).  :func:`mask_clock` blanks exactly those, so two
runs of one example (JAX against the port, the card against the host)
can be compared line for line.
"""

from __future__ import annotations

import re

from repro_torch.device import resolve_device

EXAMPLES = ("quickstart", "skim_expr", "skim_service", "skim_service_async",
            "skim_cluster")

_STAGES = "decompress|deserialize|filter|write|total"

# example -> ((field names, pattern), ...): each group of a pattern is one
# value of the named field, blanked in every line the pattern matches.
# Modeled transfer times alone (``fetch``, ``output_transfer``, the price
# estimates) are exact and stay compared.
CLOCK_FIELDS = {
    "quickstart": (
        (("Breakdown stage seconds",), rf"^   (?:{_STAGES})( +\d+\.\d+)s$"),
        (("speedup vs legacy client",), r"speedup vs legacy client-side: (\d+\.\d+)x"),
    ),
    "skim_expr": (),
    "skim_service": (
        (("Breakdown.total() at 1 Gb/s", "Breakdown.total() at 10 Gb/s",
          "Breakdown.total() at 100 Gb/s", "busy_fraction"),
         r"^(?:client_plain|client_opt|server_side|near_data)"
         r"( +\d+\.\d+)s( +\d+\.\d+)s( +\d+\.\d+)s( +\d+)%$"),
        (("Breakdown stage seconds",), rf"(?:{_STAGES})=(\d+\.\d+)s"),
    ),
    "skim_service_async": (),
    "skim_cluster": (
        (("modeled makespan",), r"modeled (\d+\.\d+) ms"),
        (("merge_s",), r"\+ (\d+\.\d+) ms merge"),
        (("wall_s",), r"realized (\d+) ms"),
    ),
}


def mask_clock(name: str, text: str) -> tuple[list[str], set[str]]:
    """``text``'s lines with :data:`CLOCK_FIELDS` of example ``name``
    replaced by ``<field>``, and the set of fields that matched."""
    seen: set[str] = set()

    def masker(fields):
        def repl(m):
            out, pos = [], m.start()
            for i, field in enumerate(fields, 1):
                out.append(m.string[pos:m.start(i)] + f"<{field}>")
                pos = m.end(i)
                seen.add(field)
            return "".join(out) + m.string[pos:m.end()]
        return repl

    lines = []
    for line in text.splitlines():
        for fields, pattern in CLOCK_FIELDS[name]:
            line = re.sub(pattern, masker(fields), line)
        lines.append(line)
    return lines, seen


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default) or cpu")


def open_device(name: str):
    """``--device`` -> a torch device, after printing the line naming it.
    Raises without a card unless ``name`` is ``cpu``."""
    try:
        dev = resolve_device(name)
    except RuntimeError:
        raise RuntimeError(
            "no CUDA device is available; run with --device cpu to use the CPU"
        ) from None
    if dev.type == "cuda":
        import torch

        print(f"device: {dev} ({torch.cuda.get_device_name(dev)})")
    else:
        print(f"device: {dev}")
    return dev


__all__ = ["CLOCK_FIELDS", "EXAMPLES", "add_device_arg", "mask_clock",
           "open_device"]
