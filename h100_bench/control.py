"""The readings that a cell's correctness limits are set from, without a
timed window (a training cell's readings need none):

    python3 h100_bench/control.py --workload <cell> --seeds 1 2 3 ... \
        [--faults 3]

For each seed, in one process: the program's set-up and first three
steps through the trainer's own call and feed, held against the
reference (the sound readings: the lower end of each limit). For the
first ``--faults`` seeds also, each against the float32 reference:

- ``control``: the reference computed in float8 (the precision below the
  configuration's bf16: e4m3 operands, e5m2 gradients) in the program's
  place;
- ``half_batch``: the reference on the first half of each batch, the
  means taken over it (a step that leaves half the batch out);
- ``feed_rolled``: the program's batches with their rows moved by one (an
  answer altered where it is produced), for the feed's numbers.

A state left unchanged reads 1 on ``grad``, ``change`` and ``stats`` by
their definition and needs no run. Prints one JSON line a seed and kind,
then one line with, for each number, the largest sound reading and the
smallest reading of each fault.
"""

import argparse
import json
import sys
import time

import numpy as np


def readings(spec, seeds, faults: int, device="cuda", overrides=None,
             tree_base=None, out=print):
    import harness
    from reference import nets

    kw = {} if tree_base is None else {"tree_base": tree_base}
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        s = harness.Session(spec, seed, device, overrides, **kw)
        s.first_steps()
        prog, c = s.readings, s.c
        batches = {k: v.cpu() for k, v in s.checked.items()}
        s.close()
        t1 = time.perf_counter()
        ref = harness.reference_readings(spec, seed, device, overrides)
        leaves = {}
        feed = harness.feed_numbers(c, seed, batches)
        kinds = {"sound": harness.numbers(prog, ref, feed, leaves)}
        if i < faults:
            zero = {k: 0.0 for k in feed}
            kinds["control"] = harness.numbers(harness.reference_readings(
                spec, seed, device, overrides, q=nets.FP8), ref, zero)
            kinds["half_batch"] = harness.numbers(harness.reference_readings(
                spec, seed, device, overrides, half_batch=True), ref, zero)
            kinds["feed_rolled"] = harness.feed_numbers(
                c, seed, batches, lambda a: np.roll(a, 1, axis=0))
        for kind, vals in kinds.items():
            row = {"seed": seed, "kind": kind, "numbers": vals}
            if kind == "sound":
                row["losses"] = {"program": prog["losses"],
                                 "reference": ref["losses"]}
            if kind == "sound":
                row["worst_leaf"] = leaves
                row["program_s"] = t1 - t0
                row["reference_s"] = time.perf_counter() - t1
            rows.append(row)
            out(json.dumps(row))
    summary = {}
    for kind in ("sound", "control", "half_batch", "feed_rolled"):
        got = [r["numbers"] for r in rows if r["kind"] == kind]
        if got:
            pick = max if kind == "sound" else min
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    out(json.dumps({"summary": summary, "seeds": list(seeds)}))
    return rows, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    import harness

    if not torch.cuda.is_available():
        print("control.py reads the card and found none", file=sys.stderr)
        return 2
    readings(harness.Spec(args.workload), args.seeds, args.faults,
             out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
