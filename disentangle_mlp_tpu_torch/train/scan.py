"""K training steps of an experiment per device dispatch: the port's
counterpart of disentangle_mlp_tpu/train/scan.py (``make_multi_step``, K
steps under one ``jax.jit`` of ``lax.scan``).

The port's steps are eager PyTorch: hundreds to thousands of kernels a
step, each launched from Python. On a CUDA device :class:`MultiStep`
captures K calls of the experiment's ``train_step`` into one
``torch.cuda.CUDAGraph`` and replays it, so a call launches one graph.
On the CPU it runs the K steps eagerly, one after another.

- **Inputs.** A call takes a (K, B, H, W, C) batch and, optionally, K
  steps of draws (the dicts of the experiment's ``draw``). Without draws
  it makes them from the experiment's generators, in the order and number
  that K eager steps would, so the eager and the graphed runs consume the
  same random streams. The draws are made outside the graph and copied with
  the batch into the graph's input buffers before each replay. Each metric
  comes back stacked to (K,), copied out of the graph's buffers.
- **Warm-up and capture.** The first call warms up on a side stream (the
  K steps run eagerly on a copy of the state, which is then put back) and
  captures the K steps on that stream with ``capture_error_mode=
  "thread_local"``, so that CUDA work of other threads (the FID's host
  half, the checkpoint writer, a β group) cannot break the capture.
  :meth:`MultiStep.step_and_capture` instead keeps its warm-up steps: they
  are the run's own first steps (the trainer's loop does this). A capture
  that fails raises; nothing falls back to eager.
- **State.** The steps update the experiment's parameters, running
  statistics, Adam moments and Adam counts in place, and the graph holds
  their addresses. ``donate`` has no counterpart: JAX donates the old
  state's buffers to the new one, the port never makes a new one. Each
  replay checks that every one of those tensors still lies where it lay at
  the capture, and raises if not (load a checkpoint with ``load_states``,
  which copies in place).
- **What a capture bakes in.** β is the experiment's (``exp.beta``), the
  cuDNN/TF32 switches those in force at the capture, as for an eager step
  at that moment; ``fused_linear``'s TMA descriptors hold the graph's
  addresses. The graph owns its ``fused_linear`` split-K scratch
  (ops/fused_linear.py ``GraphScope``), and each replay adds the kernel
  launches its capture recorded to the kernels' counts (``fused_linear``'s
  and the BatchNorms', ops/batchnorm.py ``capture_scope``).
- **Meshes.** An experiment on a NCCL mesh (parallel/mesh.py) is captured
  with its collectives: BatchNorm's all-reduces forward and backward, the
  gradients' and the metrics'. The process group exists and its
  communicator has run (the state's broadcast, the warm-up steps) before
  the capture. gloo stages CUDA tensors through the host, which no graph
  can hold: an experiment on a gloo mesh of CUDA devices is refused here,
  and the trainer steps it eagerly.
- **Tracing.** ``captures`` and ``replays`` count the graph's captures and
  replays. While the port's spans are on (utils/runtime.py) the host's
  parts carry ``dmt.graph.capture``, ``dmt.graph.copy_in`` and
  ``dmt.graph.replay``, and a capture places a ``dmt.step.begin`` and a
  ``dmt.step.end`` mark around each captured step (the BatchNorms place
  theirs inside it); ``marks`` is the capture's table, the tags in the
  order each replay runs them. A graph captured with spans off holds no
  mark, and its table is empty.
"""

from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..ops import batchnorm as bn
from ..ops import fused_linear as fl
from ..utils import runtime
from .common import Adam, Adamax, label_tensor

Draws = Sequence[Dict]


def state_tensors(exp) -> List[torch.Tensor]:
    """Every tensor an experiment's step updates in place: the parameters
    and buffers of its modules, the moments and counts of its optimizers."""
    out, seen = [], set()
    for v in vars(exp).values():
        for o in (v.values() if isinstance(v, dict) else (v,)):
            if isinstance(o, nn.Module):
                tensors = itertools.chain(o.parameters(), o.buffers())
            elif isinstance(o, (Adam, Adamax)):
                tensors = o.state_tensors()
            else:
                continue
            for t in tensors:
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
    return out


class MultiStep:
    """K calls of ``exp.train_step`` per call; see the module docstring."""

    def __init__(self, exp, k: int):
        if k < 1:
            raise ValueError(f"K must be at least 1, got {k}")
        self.exp, self.k = exp, k
        self.device = torch.device(exp.device)
        mesh = getattr(exp, "mesh", None)
        if self.device.type == "cuda" and mesh is not None \
                and mesh.backend != "nccl":
            raise ValueError(
                f"a CUDA graph cannot hold {mesh.backend}'s host-staged "
                f"collectives; step an experiment on a {mesh.backend} mesh "
                f"eagerly")
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._state = state_tensors(exp)
        self.captures = self.replays = 0
        self.marks: List[str] = []

    def __call__(self, batches: torch.Tensor, draws: Optional[Draws] = None
                 ) -> Dict[str, torch.Tensor]:
        draws = self._draws(batches, draws)
        if self.device.type != "cuda":
            return self._eager(batches, draws)
        if self.graph is None:
            self._warm_up_and_capture(batches, draws, keep=False)
        return self._replay(batches, draws)

    def capture(self, batches: torch.Tensor,
                draws: Optional[Draws] = None) -> None:
        """Warm up on a copy of the state (put back afterwards) and capture,
        without replaying; ``draws`` default to the generators' next."""
        if self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA experiment")
        self._warm_up_and_capture(batches, self._draws(batches, draws),
                                  keep=False)

    def step_and_capture(self, batches: torch.Tensor,
                         draws: Optional[Draws] = None
                         ) -> Dict[str, torch.Tensor]:
        """Run these K steps eagerly on the capture stream (the state
        advances: they are the run's steps), then capture the graph that
        later calls replay; returns their metrics."""
        draws = self._draws(batches, draws)
        if self.device.type != "cuda":
            return self._eager(batches, draws)
        return self._warm_up_and_capture(batches, draws, keep=True)

    # -- internals ---------------------------------------------------------

    def _draws(self, batches: torch.Tensor, draws: Optional[Draws]) -> list:
        if batches.shape[0] != self.k:
            raise ValueError(f"batches hold {batches.shape[0]} steps, the "
                             f"multi-step takes K={self.k}")
        if draws is None:
            return [self.exp.draw(batches.shape[1]) for _ in range(self.k)]
        if len(draws) != self.k:
            raise ValueError(f"{len(draws)} steps of draws for K={self.k}")
        if self.device.type != "cuda":
            return list(draws)
        return [{key: label_tensor(v, self.device) if key == "labels" else
                 torch.as_tensor(v, dtype=torch.float32, device=self.device)
                 for key, v in d.items()} for d in draws]

    def _eager(self, batches: torch.Tensor, draws: list
               ) -> Dict[str, torch.Tensor]:
        outs = [self.exp.train_step(batches[i], draws=draws[i])
                for i in range(self.k)]
        return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    def _warm_up_and_capture(self, batches, draws, keep: bool):
        main = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        scope = fl.GraphScope()
        # detached: a clone of a parameter would keep the parameter's
        # autograd node, made on the caller's stream, alive into the
        # capture, which then refuses the wait on that stream
        saved = None if keep else [t.detach().clone() for t in self._state]
        stream.wait_stream(main)
        with fl.graph_scope(scope), torch.cuda.stream(stream):
            out = self._eager(batches, draws)
            if saved is not None:
                with torch.no_grad():
                    for t, s in zip(self._state, saved):
                        t.copy_(s)
        main.wait_stream(stream)
        for v in out.values():
            v.record_stream(main)
        # the graph allocates from a pool of its own: give it back what the
        # warm-up steps left cached (NVAE's activations fill half the card)
        torch.cuda.empty_cache()
        # the graph's inputs, outside its memory pool
        self._batches = torch.empty_like(batches)
        self._inputs = [{key: v.clone() for key, v in d.items()}
                        for d in draws]
        graph = torch.cuda.CUDAGraph()
        marks: List[str] = []
        bn_launches: collections.Counter = collections.Counter()
        with runtime.span("dmt.graph.capture"), \
                runtime.mark_table(stream, marks), \
                bn.capture_scope(stream, bn_launches), \
                fl.graph_scope(scope, capturing=True), torch.cuda.graph(
                    graph, stream=stream, capture_error_mode="thread_local"):
            outs = []
            for i in range(self.k):
                runtime.mark("dmt.step.begin", self._batches)
                outs.append(self.exp.train_step(self._batches[i],
                                                draws=self._inputs[i]))
                runtime.mark("dmt.step.end", self._batches)
            self._keys = list(outs[0])
            self._out = torch.stack([torch.stack(
                [o[key].float() for key in self._keys]) for o in outs])
        self.graph, self._scope, self.marks = graph, scope, marks
        self._bn_launches = bn_launches
        self.captures += 1
        self._ptrs = [t.data_ptr() for t in self._state]
        return out

    def _replay(self, batches: torch.Tensor, draws: list
                ) -> Dict[str, torch.Tensor]:
        if batches.shape != self._batches.shape:
            raise ValueError(f"batches of shape {tuple(batches.shape)}; the "
                             f"graph was captured for "
                             f"{tuple(self._batches.shape)}")
        if [t.data_ptr() for t in self._state] != self._ptrs:
            raise RuntimeError("the experiment's state tensors moved since "
                               "the graph was captured; load states in "
                               "place (load_states) and keep the modules "
                               "where they are")
        with runtime.span("dmt.graph.copy_in"):
            self._batches.copy_(batches)
            for dst, src in zip(self._inputs, draws):
                for key, v in dst.items():
                    v.copy_(src[key])
        with runtime.span("dmt.graph.replay"):
            self.graph.replay()
        self.replays += 1
        fl.replayed(self._scope)
        bn.replayed(self._bn_launches)
        out = self._out.clone()
        return {key: out[:, j] for j, key in enumerate(self._keys)}


def make_multi_step(exp, k: int) -> MultiStep:
    """``multi(batches (K, B, H, W, C), draws=None) -> {metric: (K,)}``:
    K steps of ``exp`` per call, a CUDA graph on the card (the JAX
    package's ``make_multi_step(step_fn, n_states)``; the states are the
    experiment's own, updated in place)."""
    return MultiStep(exp, k)
