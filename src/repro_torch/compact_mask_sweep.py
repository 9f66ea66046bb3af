"""Time stream_compact's and the predicate mask's design choices on one card.

    python3 src/repro_torch/compact_mask_sweep.py [--out FILE]

Two sweeps, each beside the earlier design of its kernel
(``chip_smoke.PARENT_CU``) on the same inputs, every variant of a design
choice checked against the plain version before it is timed (the split at
the end times partial kernels, which compute no mask):

* ``stream_compact``: the kernel of ``csrc/stream_compact.cu`` rebuilt
  (into ``build/``) at other block sizes, tiles and least blocks an SM
  (``__launch_bounds__``), at a 1,000,000 x 8 float32 payload kept at
  3.1% (the quickstart cell's rate) and at 50%, at
  ``benchmarks/bench_kernels.py``'s (2^17 x 16, 5%) and the same at
  2^20, and at one window (4096 x 1); with ``payload[mask]`` per call.
* the mask launch of ``predicate_eval``: lanes an event (1, 2, 4, 8 and
  ``predicate_eval.mask_lanes``) by where the planes are read (shared
  memory by the stage's plan, or device memory; ``mask_plan`` picks
  one by the program's groups), for bench_kernels' program at E = 4096, 2^17 and 2^20
  and for each kind of group of ``chip_smoke.sweep_programs`` at 2^17
  (K = 1, 4, 8, 16) and 2^16 (K = 64); then, at bench_kernels' 2^17 and
  2^20, the kernel rebuilt without its evaluation (the copies alone),
  without its copies (the evaluation alone, of whatever shared memory
  holds) and without both, to split its time.

Device times are ``chip_smoke.device_ms`` (CUDA-graph replay).  One JSON
object per line goes to ``--out`` and to standard output, with the card's
name and power limit; needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# name: (threads a block, events a tile, least blocks an SM or None)
COMPACT_VARIANTS = {
    "512 x 2048, 4 an SM (the kernel)": (512, 2048, 4),
    "512 x 2048": (512, 2048, None),
    "512 x 1024": (512, 1024, None),
    "512 x 1024, 4 an SM": (512, 1024, 4),
    "256 x 1024, 8 an SM": (256, 1024, 8),
    "512 x 4096, 4 an SM": (512, 4096, 4),
    "1024 x 2048, 2 an SM": (1024, 2048, 2),
}
# (E, D, keep rate)
COMPACT_CASES = ((1_000_000, 8, 0.031), (1_000_000, 8, 0.5), (1 << 17, 16, 0.05),
                 (1 << 20, 16, 0.05), (4096, 1, 0.3))
# (sweep program, E, K)
MASK_CASES = (("any", 1 << 17, 1), ("any", 1 << 17, 8), ("count", 1 << 17, 4),
              ("ht", 1 << 17, 16), ("ht", 1 << 16, 64), ("mass_pair", 1 << 17, 8),
              ("dr_pair", 1 << 17, 8), ("mass_same", 1 << 17, 16), ("expr", 1 << 17, 16))


def build_compact_variants(build, csrc: Path) -> dict:
    """{name: ctypes launch function} of each :data:`COMPACT_VARIANTS`,
    all ``nvcc`` runs at once."""
    src = (csrc / "stream_compact.cu").read_text()
    marks = ("constexpr int kThreads = 512;", "constexpr int kTile = 2048;",
             "__launch_bounds__(kThreads, 4)")
    for mark in marks:
        if mark not in src:
            raise RuntimeError(f"stream_compact.cu no longer holds {mark!r}")
    out_dir = build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (threads, tile, least)) in enumerate(COMPACT_VARIANTS.items()):
        bounds = f"__launch_bounds__(kThreads, {least})" if least else "__launch_bounds__(kThreads)"
        text = (src.replace(marks[0], f"constexpr int kThreads = {threads};")
                .replace(marks[1], f"constexpr int kTile = {tile};").replace(marks[2], bounds))
        cu = out_dir / f"compact_variant_{i}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the variant {name}:\n{out}{err}")
        fns[name] = ctypes.CDLL(str(lib)).stream_compact_launch
    return fns


def build_mask_parts(build, csrc: Path) -> dict:
    """{name: library path} of ``predicate_eval.cu`` rebuilt with the mask
    launch's copies or evaluation (or both) left out: timing variants
    only, their masks are wrong."""
    src = (csrc / "predicate_eval.cu").read_text()
    copy = "  if (st.mode == kModeBulk) {\n    const uint32_t bar_a"
    evaluate = "    if (__any_sync(kFull, live)) live = eval_lanes(p, tile, row, ln) && live;"
    for mark in (copy, evaluate):
        if mark not in src:
            raise RuntimeError(f"predicate_eval.cu no longer holds {mark!r}")
    no_copy = copy.replace("(st.mode", "(!kMask && st.mode")
    no_eval = evaluate.replace("(__any_sync", "(!kMask && __any_sync")
    texts = {"copies alone": src.replace(evaluate, no_eval),
             "evaluation alone": src.replace(copy, no_copy),
             "neither": src.replace(copy, no_copy).replace(evaluate, no_eval)}
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = build.build_dir() / f"mask_part_{i}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the mask variant {name}:\n{out}{err}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "compact_mask_sweep.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import predicate_eval as pe
    from repro_torch.kernels import stream_compact as sc
    from repro_torch.kernels.skim_fused import Workspace

    if not torch.cuda.is_available():
        print("compact_mask_sweep: no card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    parent_build = cs.start_parent_build()
    _build.build_all()
    ops.load_kernels()
    variants = build_compact_variants(_build, _build._CSRC)
    mask_parts = build_mask_parts(_build, _build._CSRC)
    parent = cs.finish_parent_build(*parent_build)
    rng = np.random.default_rng(0)
    records = []

    def variant_call(fn):
        fn.argtypes, fn.restype = sc._fn().argtypes, ctypes.c_int

        def call(payload, mask):
            E, D = payload.shape
            out = torch.empty_like(payload)
            total = torch.empty((), dtype=torch.int32, device=device)
            stream = _build.stream_id(device)
            status, ticket, epoch = Workspace.reserve(device, stream, -(-E // 256), 1)
            p = _build.ptr
            _build.check_launch("variant", fn(
                p(payload), p(mask), mask.element_size(), E, D, payload.element_size(),
                p(status), p(ticket), epoch, p(out), p(total), ctypes.c_void_p(stream)))
            return out, total

        return call

    for E, D, rate in COMPACT_CASES:
        payload = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32)).to(device)
        mask = torch.from_numpy(rng.random(E) < rate).to(device)
        want, n = ref.stream_compact_ref(payload, mask)
        row = {"sweep": "stream_compact", "E": E, "D": D, "rate": rate,
               "earlier design": cs.device_ms(lambda: parent.compact(payload, mask)),
               "payload[mask] per call": cs.stream_ms(lambda: payload[mask])}
        for name, fn in variants.items():
            call = variant_call(fn)
            got, count = call(payload, mask)
            torch.cuda.synchronize()
            cs.check(int(count) == int(n) and cs.bit_err(got, want) == 0.0,
                     f"stream_compact variant {name} differs from the plain version")
            row[name] = cs.device_ms(lambda call=call: call(payload, mask))
        records.append(row)
        print(json.dumps(row, sort_keys=True), flush=True)

    cases = [("bench_kernels",) + tuple(cs.bench_predicate(rng, E, device))
             for E in (4096, 1 << 17, 1 << 20)]
    sweep = dict(cs.sweep_programs())
    for name, E, K in MASK_CASES:
        host = cs.batch_inputs(rng, sweep[name], 1, E, K, 4096)
        cases.append((name, sweep[name], *(torch.from_numpy(x[0]).to(device)
                                           for x in host[:3])))
    lanes_of, plan_of = pe.mask_lanes, pe.mask_plan
    try:
        for name, program, t, v, w in cases:
            T, E, K = t.shape
            want = ref.predicate_mask(program, t, v, w).int()
            row = {"sweep": "predicate_eval mask", "program": name, "E": E, "K": K,
                   "plan": list(plan_of((t, v, w), (T * E * K, v.shape[0] * E * K), E, K,
                                        program)),
                   "earlier design": cs.device_ms(
                       lambda: parent.mask(t[None], v[None], w[None], program))}
            for lanes in sorted({1, 2, 4, 8, lanes_of(K)}):
                if lanes > max(K, 1):
                    continue
                for where in ("shared memory", "device memory"):
                    # the stage's plan (copies where they fit), or device memory
                    def plan(planes, strides, E, K, program, lanes=lanes, where=where):
                        tile, mode, smem = pe.launch_plan(planes, strides, E, K, program, lanes)
                        if where == "device memory":
                            mode, smem = pe.MODE_DIRECT, 0
                        return tile, mode, smem, lanes

                    pe.mask_plan = plan
                    got = pe.predicate_eval(t, v, w, program)
                    torch.cuda.synchronize()
                    cs.check(torch.equal(got, want), f"mask {name} lanes={lanes} differs")
                    row[f"{lanes} lanes, {where}"] = cs.device_ms(
                        lambda: pe.predicate_eval(t, v, w, program))
                    pe.mask_plan = plan_of
            records.append(row)
            print(json.dumps(row, sort_keys=True), flush=True)
    finally:
        pe.mask_plan = plan_of
    package = _build.load("predicate_eval")
    try:
        for _, program, t, v, w in cases[1:3]:
            T, E, K = t.shape
            row = {"sweep": "predicate_eval mask, split", "program": "bench_kernels", "E": E,
                   "K": K, "kernel": cs.device_ms(lambda: pe.predicate_eval(t, v, w, program))}
            for name, lib in mask_parts.items():
                _build._LIBS["predicate_eval"] = ctypes.CDLL(str(lib))
                row[name] = cs.device_ms(lambda: pe.predicate_eval(t, v, w, program))
            _build._LIBS["predicate_eval"] = package
            records.append(row)
            print(json.dumps(row, sort_keys=True), flush=True)
    finally:
        _build._LIBS["predicate_eval"] = package
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for rec in records:
            f.write(json.dumps({"card": card, **rec}, sort_keys=True) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
