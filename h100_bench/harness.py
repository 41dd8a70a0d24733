"""Runs one cell of the benchmark: it builds the trainer's own run of
the cell's configuration on its traffic, drives its first steps from the
seed, times a window of the trainer's stepping, traces some more steps on
request, and holds what the timed path produced against the plain
reference.

What the window drives is ``_Run`` of ``disentangle_mlp_tpu_torch/train/
loop.py``, built as ``_run_vaegan`` / ``_run_vae`` build it, on one device
and without a mesh (a cell on more chips is refused: the harness has no
mesh path yet); where the loader keeps a decode cache, set-up waits until
the loader's own warm-up has filled it, so the window reads the epochs
after the first; the loop body is ``_Run.train_epoch``'s, copied: the
next batch from ``_Run.train_loader``, ``_Run.step(x)`` (an eager first
step, then one replay a step of the CUDA graph it captures), the step's
epoch sums kept on the device and read when the loader is spent, then the
loader iterated again. FID and checkpoints are off (the configuration's
``calc_fid`` and ``checkpoint_every``), logs go under the temporary
directory.

Inputs, made from the seed and handed to both the program and the
reference: the initial weights (through the experiment's
``load_states``), the images (the traffic's, :mod:`traffic`) and every
step's random draws (the experiment's ``draw``, replaced by the
reference's on the program's experiment).

Correctness (:func:`numbers`, :func:`judge`): the first three steps run
in set-up through the window's own call and feed; the reference follows
them. The numbers that can be compared; a cell's file gives the limit of
each one it compares, and PERF.md why those:

- ``feed``, ``feed_mean``: the largest and the mean |difference| between
  the batches the feed handed to the step (the first three and a seeded
  sample of the window's) and the reference's batches of the same step;
- ``loss.<name>``: the largest relative gap of each of the step's
  metrics over the three steps; ``loss<s>.<name>``: step s's alone (step 1
  is eager, steps 2 and 3 replay the CUDA graph);
- ``grad``: after step 1, the gap between the program's and the
  reference's norm of each parameter's Adam first moment (the gradients
  as the optimizer took them), over the reference's norm of that leaf or
  of the median leaf of its optimizer, whichever is larger; the worst
  leaf, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (biases ahead of a BatchNorm: their
  gradient is nought, and only round-off moves them); ``grad.<optimizer>``
  the worst leaf of one optimizer;
- ``change``: the same of each parameter's change over the three steps;
- ``stats``: the same of each BatchNorm running statistic's change;
  ``stats1`` of its change in step 1 alone, each BatchNorm's own update;
- ``<grad|change|stats|stats1>_median``: the median leaf's gap;
- ``nonfinite_steps``: the window's steps in epochs whose summed metrics
  were not finite.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
for _p in (str(HERE), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import tracing  # noqa: E402
import traffic  # noqa: E402
from reference import celeba, nets  # noqa: E402
from reference import feed as ref_feed  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "disentangle_mlp_tpu")
FIRST_STEPS = 3


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """A cell of ``BENCHMARK.json`` with its files, found by name."""

    def __init__(self, workload: str, bench: Optional[Dict] = None):
        self.bench = bench or json.loads((REPO / "BENCHMARK.json")
                                         .read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.entry = cells[workload]
        if self.entry["chips"] != 1:
            raise ValueError(f"{workload} asks for {self.entry['chips']} "
                             f"chips; the harness drives one device, with "
                             f"no mesh")
        self.cell = json.loads((HERE / "workloads" / f"{workload}.json")
                               .read_text())
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = json.loads((REPO / configs[self.entry["config"]]
                                  ["file"]).read_text())
        self.experiment = self.config["experiment"]
        self.reference = importlib.import_module(
            f"reference.{self.experiment}")

    def sizes(self, overrides: Optional[Dict] = None) -> Dict:
        """The configuration's sizes with the cell's flags and
        ``overrides`` over them, and the cell's ``feed`` (overridden by
        ``overrides["feed"]``)."""
        overrides = dict(overrides or {})
        feed = {**self.cell["feed"], **overrides.pop("feed", {})}
        return {**self.config, **self.cell.get("flags", {}), **overrides,
                "feed": feed}

    def adapter(self):
        return importlib.import_module(f"experiments.{self.experiment}")

    def _applies(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[Dict]:
        return [m for m in self.bench["per_layer"] if self._applies(m)]

    def reader(self, name: str):
        return load_module(HERE / "metrics" / f"{name}.py")


def costs():
    return load_module(HERE / "metrics" / "costs.py")


def _config(spec: Spec, c: Dict, loader_seed: int, tree_base: Path):
    """(the program's ``Config`` of the cell, whether the JPEG tree was
    made for it)."""
    from disentangle_mlp_tpu_torch.config import Config
    import dataclasses

    fields = {f.name for f in dataclasses.fields(Config)}
    tmp = Path(tempfile.gettempdir()) / "h100_bench" / spec.name
    flags = {k: (list(v) if isinstance(v, list) else v)
             for k, v in c.items() if k in fields}
    feed_flags, made = traffic.program_flags(c["feed"], tree_base)
    flags.update(feed_flags)
    flags.update(name=spec.name, seed=loader_seed,
                 save_path=str(tmp / "run"), log_path=str(tmp / "log"),
                 image_root_val=str(tmp / "no_val"),
                 image_root_test=str(tmp / "no_test"),
                 fid_path_pretrained=str(tmp / "no_stats.npz"))
    return Config(**flags).finalize(make_dirs=True), made


def _built_libraries() -> set:
    from disentangle_mlp_tpu_torch.ops._build import BUILD_DIR

    return {p.name for p in BUILD_DIR.glob("*.so")}


def _norms(tensors: Dict[str, torch.Tensor],
           base: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    with torch.no_grad():
        return {k: float((t.float() - base[k] if base is not None
                          else t.float()).norm())
                for k, t in tensors.items()}


def _clone(tensors: Dict[str, torch.Tensor]) -> Dict:
    return {k: t.detach().float().clone() for k, t in tensors.items()}


def loader_seed(seed: int) -> int:
    return seed % 2 ** 31


def draw_seed(seed: int) -> int:
    return (seed + 1) % 2 ** 63


class Session:
    """The program's run of a cell: set-up, the first steps and their
    readings, the window, the traced steps."""

    def __init__(self, spec: Spec, seed: int, device,
                 overrides: Optional[Dict] = None,
                 tree_base: Path = traffic.TREE_DIR,
                 step_fault: Optional[Callable] = None):
        from disentangle_mlp_tpu_torch.train.loop import _Run

        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.devices = 1
        self.c = spec.sizes(overrides)
        self.ad = spec.adapter()
        self.ref = spec.reference
        self.libraries = _built_libraries()
        self.cfg, self.made_tree = _config(spec, self.c, loader_seed(seed),
                                           tree_base)
        self.run = _Run(self.cfg, self.ad.EXPERIMENT, None, self.device)
        # _Run started the loader's warm-up of its decode cache (None
        # without a cache); a second call hands back the live thread
        warm = self.run.train_loader.start_cache_warmup()
        if warm is not None:
            warm.join()
        w = celeba.init_weights(self.ref.layers(self.c), seed, self.device)
        self.ad.load(self.run.exp, w, self.c)
        del w
        gen = torch.Generator(device=self.device).manual_seed(
            draw_seed(seed))
        self.tracing = False

        def draw(batch: int):
            with self._span("draw"):
                return self.ref.draw(gen, self.c, batch, self.device)

        self.run.exp.draw = draw
        self.step_fault = step_fault
        self.batch = self.c["batch_size_train"]
        self.it = iter(self.run.train_loader)
        self.sums = None
        self.epoch_steps = 0
        self.steps = 0
        self.nonfinite_steps = 0
        self.checked: Dict[int, torch.Tensor] = {}
        self.readings: Dict = {}

    def _span(self, name: str):
        return (torch.profiler.record_function(name) if self.tracing
                else contextlib.nullcontext())

    # -- the trainer's loop body (train/loop.py _Run.train_epoch) -----------

    def read_sums(self) -> None:
        """Read the open epoch's sums, as ``train_epoch`` does at its end;
        the epoch's steps count as failed when one is not finite."""
        if self.sums is not None and not all(
                math.isfinite(float(v)) for v in self.sums.values()):
            self.nonfinite_steps += self.epoch_steps
        self.sums, self.epoch_steps = None, 0

    def _end_epoch(self) -> None:
        with self._span("epoch_end"):
            self.read_sums()
            self.it = iter(self.run.train_loader)

    def next_batch(self) -> torch.Tensor:
        while True:
            try:
                return next(self.it)[0]
            except StopIteration:
                self._end_epoch()

    def step(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.steps += 1
        m = (self.run.step(x) if self.step_fault is None
             else self.step_fault(self, x))
        keep = {k: m[k] for k in self.ad.EPOCH_SUMS}
        self.sums = keep if self.sums is None else \
            {k: self.sums[k] + keep[k] for k in self.sums}
        self.epoch_steps += 1
        return m

    # -- set-up: the first steps and their readings ---------------------------

    def first_steps(self) -> None:
        st = self.ad.state(self.run.exp)
        p0, s0 = _clone(st["params"]), _clone(st["stats"])
        losses = []
        for s in range(1, FIRST_STEPS + 1):
            x = self.next_batch()
            self.checked[s] = x.detach().clone()
            m = self.step(x)
            losses.append({k: float(v) for k, v in
                           self.ad.metrics(m).items()})
            if s == 1:
                st = self.ad.state(self.run.exp)
                grad = _norms(st["moments"])
                stats1 = _norms(st["stats"], s0)
        st = self.ad.state(self.run.exp)
        self.readings = {"losses": losses, "grad": grad,
                         "change": _norms(st["params"], p0),
                         "stats": _norms(st["stats"], s0),
                         "stats1": stats1}
        del p0, s0
        self.sync()

    def first_run(self) -> Dict:
        """What this run built that a later run in the checkout finds:
        the program's CUDA libraries and the JPEG tree."""
        return {"built_libraries": sorted(_built_libraries()
                                          - self.libraries),
                "made_jpeg_tree": self.made_tree}

    def decoded(self) -> Optional[int]:
        """Images the train source has decoded so far (None for a source
        that decodes nothing)."""
        return getattr(self.run.train_loader.source, "decoded", None)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # -- the window -------------------------------------------------------------

    def _mark(self):
        """The device's clock after the work queued so far (a CUDA event),
        or the host's on the CPU."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def window(self, seconds: float, check_steps=()) -> Dict:
        """Step for ``seconds`` of host time, between two synchronises;
        keep the batches of ``check_steps`` (global step numbers)."""
        check = set(check_steps)
        waits: List[float] = []
        self.sync()
        first = self.steps
        t0 = time.perf_counter()
        marks = [self._mark()]
        while time.perf_counter() - t0 < seconds:
            tw = time.perf_counter()
            x = self.next_batch()
            waits.append(time.perf_counter() - tw)
            if self.steps + 1 in check:
                self.checked[self.steps + 1] = x.detach().clone()
            self.step(x)
            marks.append(self._mark())
        self.sync()
        wall = time.perf_counter() - t0
        intervals = [a.elapsed_time(b) if self.cuda else (b - a) * 1e3
                     for a, b in zip(marks, marks[1:])]
        steps = self.steps - first
        return {"steps": steps, "wall_s": wall,
                "images": steps * self.batch, "feed_waits_s": waits,
                "intervals_ms": intervals}

    def traced(self, steps: int) -> Dict:
        """``steps`` more steps under ``torch.profiler``, reduced."""
        from disentangle_mlp_tpu_torch.ops import fused_linear as fl

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.sync()
        launches0 = fl.launches
        self.tracing = True
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("traced_window"):
                for _ in range(steps):
                    with self._span("feed"):
                        x = self.next_batch()
                    with self._span("step"):
                        self.step(x)
                self.sync()
        self.tracing = False
        launches = fl.launches - launches0
        t0 = time.perf_counter()
        tr = tracing.from_profiler(prof, steps)
        tr["reduce_s"] = time.perf_counter() - t0
        tr["fused_linear_launches"] = launches
        return tr

    def close(self) -> None:
        """Free the program's state (and stop its loader's thread)."""
        it = self.it
        self.it = None
        if it is not None and hasattr(it, "close"):
            it.close()
        self.run = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


# -- the reference ---------------------------------------------------------------

def reference_batch(c: Dict, seed: int, step: int) -> np.ndarray:
    return ref_feed.batch(c["feed"], c["img_size"],
                          c["input_channels"], c["batch_size_train"],
                          loader_seed(seed), step)


def reference_readings(spec: Spec, seed: int, device,
                       overrides: Optional[Dict] = None,
                       q: nets.Precision = nets.EXACT,
                       half_batch: bool = False) -> Dict:
    """The reference's readings of the first steps from the seed's
    weights, batches and draws (float32, TF32 off), optionally computed
    in a lower precision ``q`` (the control) or on the first half of each
    batch only (a planted fault)."""
    nets.tf32_off()
    c = spec.sizes(overrides)
    ref = spec.reference
    device = torch.device(device)
    w = celeba.init_weights(ref.layers(c), seed, device)
    model = ref.Model(c, w)
    gen = torch.Generator(device=device).manual_seed(draw_seed(seed))
    params = {k: t for k, t in w.items() if t.requires_grad}
    stats = {k: t for k, t in w.items() if not t.requires_grad}
    p0, s0 = _clone(params), _clone(stats)
    b = c["batch_size_train"]
    losses = []
    for s in range(1, FIRST_STEPS + 1):
        x = torch.as_tensor(reference_batch(c, seed, s),
                            dtype=torch.float32, device=device)
        d = ref.draw(gen, c, b, device)
        if half_batch:
            x = x[:b // 2]
            d = {k: v[:b // 2] if v.dim() == 2 else v for k, v in d.items()}
        m = model.step(x, d, q)
        losses.append({k: float(v) for k, v in m.items()})
        if s == 1:
            grad = _norms(model.moments())
            stats1 = _norms(stats, s0)
    out = {"losses": losses, "grad": grad, "change": _norms(params, p0),
           "stats": _norms(stats, s0), "stats1": stats1,
           "groups": dict(model.groups)}
    del w, model, params, stats, p0, s0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _rel(p: float, r: float) -> float:
    if p == r:
        return 0.0
    return abs(p - r) / abs(r) if r != 0 else math.inf


def worst_leaf(p: Dict[str, float], r: Dict[str, float],
               keys: List[str]):
    """((gap, leaf) of the worst leaf, {leaf: gap}): each leaf's |p - r|
    over the reference's norm of that leaf or of the median leaf of
    ``keys``, whichever is larger."""
    med = statistics.median(r[k] for k in keys)

    def gap(k):
        den = max(r[k], med)
        if den > 0:
            return abs(p[k] - r[k]) / den
        return 0.0 if p[k] == r[k] else math.inf

    gaps = {k: gap(k) for k in keys}
    return max((g, k) for k, g in gaps.items()), gaps


def numbers(prog: Dict, ref: Dict, feed: Dict[str, float],
            leaves: Optional[Dict] = None) -> Dict:
    """The numbers that can be compared (see the module docstring); a
    cell's file gives the limits of those it compares. The median leaf
    of ``grad`` and ``change`` is that of the leaf's optimizer (one
    network's loss can be orders of magnitude above another's). Both leave
    out the leaves whose reference gradient is under a thousandth of it:
    their gradient is nought but for round-off on either side.
    ``loss<s>.<name>`` is step s's gap alone, ``grad.<optimizer>`` the
    worst leaf of one optimizer, ``<number>_median`` the median leaf's gap.
    ``leaves``, when given, receives the worst leaf of each."""
    out = dict(feed)
    for k in ref["losses"][0]:
        gaps = [_rel(p[k], r[k]) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
        out[f"loss.{k}"] = max(gaps)
        for s, g in enumerate(gaps, 1):
            out[f"loss{s}.{k}"] = g
    worst: Dict = {"grad": [], "change": []}
    medians: Dict = {"grad": [], "change": []}
    for group, keys in ref["groups"].items():
        med = statistics.median(ref["grad"][k] for k in keys)
        moving = [k for k in keys if ref["grad"][k] >= 1e-3 * med]
        for what in ("grad", "change"):
            w, gaps = worst_leaf(prog[what], ref[what], moving)
            worst[what].append((w, gaps))
            medians[what] += list(gaps.values())
            if what == "grad":
                out[f"grad.{group}"] = w[0]
    for what in ("stats", "stats1"):
        w, gaps = worst_leaf(prog[what], ref[what], list(ref[what]))
        worst[what], medians[what] = [(w, gaps)], list(gaps.values())
    for what in ("grad", "change", "stats", "stats1"):
        (v, leaf), _ = max(worst[what], key=lambda t: t[0])
        out[what] = v
        out[what + "_median"] = statistics.median(medians[what])
        if leaves is not None:
            leaves[what] = leaf
    return out


def feed_numbers(c: Dict, seed: int,
                 batches: Dict[int, torch.Tensor],
                 alter: Optional[Callable] = None) -> Dict[str, float]:
    """Largest and mean |difference| of the program's batches from the
    reference's; ``alter`` plants a fault in the batches compared."""
    worst, total, count = 0.0, 0.0, 0
    for step, x in sorted(batches.items()):
        want = reference_batch(c, seed, step)
        got = x.detach().double().cpu().numpy()
        if alter is not None:
            got = alter(got)
        if got.shape != want.shape:
            return {"feed": math.inf, "feed_mean": math.inf}
        d = np.abs(got - want)
        worst = max(worst, float(d.max()))
        total += float(d.sum())
        count += d.size
    return {"feed": worst, "feed_mean": total / count}


def window_check_steps(spec: Spec, seed: int) -> List[int]:
    """The window's steps whose batches are compared: a sample drawn from
    the seed among the window's first ``within`` steps."""
    wc = spec.cell["window_checks"]
    rng = np.random.default_rng(seed % 2 ** 63)
    pick = rng.choice(wc["within"], size=wc["count"], replace=False)
    return sorted(int(FIRST_STEPS + 1 + i) for i in pick)


def judge(spec: Spec, values: Dict[str, float]) -> Dict:
    """{name: {"value", "limit", "ok"}} of the numbers the cell's file
    gives a limit."""
    limits = spec.cell["limits"]
    unknown = set(limits) - set(values)
    if unknown:
        raise KeyError(f"the cell's file limits numbers that are not "
                       f"computed: {sorted(unknown)}")
    return {k: {"value": values[k], "limit": lim,
                "ok": bool(math.isfinite(values[k]) and values[k] <= lim)}
            for k, lim in limits.items()}
