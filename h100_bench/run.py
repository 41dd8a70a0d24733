"""The port's benchmark, one cell a run:

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json`` ``workloads``)
names a configuration and a traffic mix; their files, the cell's own file
``workloads/<cell>.json`` and one reader a per-layer metric
(``metrics/<name>.py``) are found by name. See ``harness.py`` for what is
driven and what is compared, and README.md for adding a cell.

With ``--trace 0`` the run prints the cell's end-to-end metrics; with
``--trace 1`` it times the same window, then traces ``trace_steps`` more
steps with ``torch.profiler`` and prints the per-layer metrics, ``busy_s``,
``window_s`` and a ``breakdown``. The last line of standard output is one
JSON object; the numbers compared with the reference, each beside its
limit, are the last lines of standard error and the object's last key.
Every number computed, compared or not, is one ``[numbers]`` line of
standard error before them. The object's ``first_run`` says what set-up
built that a later run in the checkout reuses (the program's CUDA
libraries, the JPEG tree): a run that built something paid for it in
``setup_s``. A run without the CUDA devices the cell asks for, or with
JAX or the JAX package loaded, prints no result and exits with 2 or 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.replace("\n", "; ")


def forbidden_modules() -> List[str]:
    import harness

    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(harness.FORBIDDEN))


def end_to_end(spec, win: Dict, setup_s: float) -> Dict:
    import numpy as np

    values = {"train_img_per_s": lambda: win["images"] / win["wall_s"],
              "step_ms_p95": lambda: float(np.percentile(
                  win["intervals_ms"], 95)),
              "setup_s": lambda: setup_s}
    return {m["name"]: {"value": values[m["name"]](), "unit": m["unit"]}
            for m in spec.end_to_end()}


def per_layer(spec, ctx: Dict) -> Dict:
    out = {}
    for m in spec.per_layer():
        v = spec.reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(spec, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = T0, overrides: Optional[Dict] = None,
             tree_base=None, step_fault: Optional[Callable] = None,
             feed_alter: Optional[Callable] = None, ref_q=None
             ) -> Tuple[Optional[Dict], List[str]]:
    """(result, problems): one run of ``spec`` on ``device``; the result is
    None when a problem forbids one. ``step_fault``, ``feed_alter`` and
    ``ref_q`` plant faults for the tests (a broken step, altered batches,
    the reference at another precision in the program's place)."""
    import torch

    import harness
    import tracing

    kw = {} if tree_base is None else {"tree_base": tree_base}
    s = harness.Session(spec, seed, device, overrides,
                        step_fault=step_fault, **kw)
    s.first_steps()
    setup_s = time.perf_counter() - t0
    if s.cuda:
        torch.cuda.reset_peak_memory_stats(s.device)
    checks = harness.window_check_steps(spec, seed)
    decoded0 = s.decoded()
    win = s.window(seconds, checks)
    if decoded0 is not None:
        win["decoded"] = s.decoded() - decoded0
    tr = s.traced(spec.cell["trace_steps"]) if trace else None
    s.read_sums()
    peak = torch.cuda.max_memory_allocated(s.device) if s.cuda else 0
    prog, batches = s.readings, {k: v.cpu() for k, v in s.checked.items()}
    nonfinite, attempted = s.nonfinite_steps, win["steps"] + (
        tr["steps"] if tr else 0)
    c, first_run, devices = s.c, s.first_run(), s.devices
    s.close()
    found = forbidden_modules()
    if found:
        return None, [f"loaded after the window: {', '.join(found)}"]

    if ref_q is None:
        ref = harness.reference_readings(spec, seed, device, overrides)
    else:  # the reference at another precision stands in for the program
        prog = harness.reference_readings(spec, seed, device, overrides,
                                          q=ref_q)
        ref = harness.reference_readings(spec, seed, device, overrides)
    values = harness.numbers(prog, ref, harness.feed_numbers(
        c, seed, batches, feed_alter))
    values["nonfinite_steps"] = float(nonfinite)
    judged = harness.judge(spec, values)

    if trace:
        metrics = per_layer(spec, {"config": c, "reference": spec.reference,
                                   "costs": harness.costs(), "window": win,
                                   "trace": tr})
    else:
        metrics = end_to_end(spec, win, setup_s)
    dev = {"platform": "gpu" if s.cuda else s.device.type,
           "kind": torch.cuda.get_device_name(s.device) if s.cuda
           else "cpu", "count": devices,
           "memory_peak_bytes": peak}
    result = {"correct": all(j["ok"] for j in judged.values()),
              "attempted": attempted, "failed": nonfinite,
              "metrics": metrics, "device": dev, "first_run": first_run}
    if trace:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tracing.breakdown(tr)
        result["trace_info"] = {"steps": tr["steps"],
                                "kernels": tr["kernels"],
                                "reduce_s": tr["reduce_s"]}
    result["window"] = {"steps": win["steps"], "wall_s": win["wall_s"],
                        "setup_s": setup_s}
    if "decoded" in win:
        result["window"]["decoded"] = win["decoded"]
    result["numbers"] = values
    result["checks"] = {k: {"value": j["value"], "limit": j["limit"]}
                        for k, j in judged.items()}
    return result, [k for k, j in judged.items() if not j["ok"]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    import harness

    spec = harness.Spec(args.workload)
    chips = spec.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result, failed = run_cell(spec, args.seed, args.seconds,
                              bool(args.trace))
    if result is None:
        print(f"[bench] no result: {'; '.join(failed)}", file=sys.stderr)
        return 3
    print(f"[bench] card: {card_line()}", file=sys.stderr)
    print(f"[bench] first_run {json.dumps(result['first_run'])} setup_s "
          f"{result['window']['setup_s']!r}", file=sys.stderr)
    print(f"[numbers] {json.dumps(result.pop('numbers'))}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r} "
              f"{'FAIL' if k in failed else 'ok'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
