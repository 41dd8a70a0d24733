"""Training on the card against training on the CPU: the port's toy-width
β-VAE-GAN (3 steps, the configuration of tests/test_torch_port_vaegan.py,
both freeze modes) and its MNIST family step (3 steps at 28×28), in float32
with TF32 off for matmuls and cuDNN, one initialization and the same
injected draws on both devices. These tests need a CUDA GPU and skip
without one; they import neither PIL nor the JAX package:

    python -m pytest tests/test_torch_port_card_training.py -m cuda -q

Then, on the card only, the CUDA graphs of train/scan.py: each experiment's
3 steps (both β-VAE-GAN freeze modes, in float32 and once in bf16 through
fused_linear, the VAE, the DCGAN, the birds and MNIST families) replayed
from a graph against the same steps run eagerly twice (the graphed run
within the two eager runs' difference, tensor by tensor), and the
AsyncCheckpointer writing card tensors.

Tolerances: those the port is held to against the JAX package on the CPU
(tests/test_torch_trajectory.py, a step that updates every parameter): the
two devices sum the same float32 products in other orders (cuDNN's and
cuBLAS's algorithms against the CPU's), and Adam's g/(|g| + ε) turns such
differences near g = 0 into ±lr updates. Metrics within rtol 5e-3;
parameters within atol 6e-3 (rtol 1e-3); a bias that feeds a BatchNorm has
no true gradient and random-walks on rounding noise: atol 4e-2; running
statistics atol 2e-2.

The β-VAE-GAN once more in bfloat16 (the port's default compute dtype),
both freeze modes: every bf16 ``Linear`` launches ``fused_linear`` on the
card (21 a step, counted) and takes its plain version on the CPU, and the
convolutions run cuDNN's bf16 kernels against the CPU's. Every layer's
output is rounded to bf16 (a relative half-ulp of 2⁻⁹ ≈ 2e-3) after sums
in other orders, so the two devices differ by a rounding or so of each
activation, not by float32 noise. The tolerances are set by what bf16
rounding does on one device: on the CPU, the bf16 run of these 3 steps
differs from the float32 run by up to 1.4e-3 (relative) in the pixel loss
and D(x), 7.2e-2 in the KL term, 7.5e-2 in the feature-similarity term,
9.9e-3 in a parameter and 8.6e-2 in a running statistic (measured with
this file's ``__main__`` on the GPU machine, PERF.md §6). So: the pixel
loss and D(x) within rtol 1e-2; the KL and similarity terms, sums of squares of differences of bf16
activations (μ² + σ² − log σ² − 1, (f(x̃) − f(x))²) where cancellation
amplifies the operands' rounding, within rtol 1e-1; parameters within
atol 1.2e-2, the bound of Adam itself: an update moves a parameter by at
most about lr, an 'observed' step updates the VAE twice, so two runs of
3 steps from one start stay within 2·6·lr whatever their gradients;
BatchNorm-fed biases 4e-2 as in float32; running statistics 6e-2, under
the 8.6e-2 that bf16 moves them from float32. Those differences, and the
card's against the CPU's, are printed by

    PYTHONPATH=. python tests/test_torch_port_card_training.py
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.train.families import FamilyExperiment
from disentangle_mlp_tpu_torch.train.gan import GANExperiment
from disentangle_mlp_tpu_torch.train.scan import state_tensors
from disentangle_mlp_tpu_torch.train.vae import VAEExperiment
from disentangle_mlp_tpu_torch.train.vaegan import VAEGANExperiment

STEPS, BATCH, LR = 3, 4, 1e-3
METRIC_RTOL, PARAM_ATOL, CANCELLED_ATOL, STATS_ATOL = 5e-3, 6e-3, 4e-2, 2e-2
# the bf16 run's (module docstring): per metric, then the leaves
BF16_METRIC_RTOL = {"recon_enc": 1e-2, "recon_dec": 1e-2, "dis": 1e-2,
                    "D_x": 1e-2, "kld": 1e-1, "sim": 1e-1}
BF16_PARAM_ATOL, BF16_STATS_ATOL = 1.2e-2, 6e-2
FUSED_LINEAR_PER_STEP = 21  # the β-VAE-GAN step's bf16 Linear calls
# tests/test_torch_compat.py's toy widths of the β-VAE-GAN
TOY = dict(n_hidden=16, n_z=[8, 4, 4], representation_size=4, head_width=32,
           decoder_channels=[8, 8, 8], disc_channels=[4, 8, 8, 8],
           disc_feature_dim=32, img_size=32)
# layers whose bias feeds a BatchNorm (tests/test_torch_trajectory.py)
BN_CANCELLED = {"conv1", "conv2", "conv3", "conv4", "mu_fc1", "lv_fc1",
                "preprocess", "deconv1", "deconv2", "deconv3"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@contextlib.contextmanager
def _tf32_off():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@contextlib.contextmanager
def _cudnn_deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _make(which, dtype="float32"):
    """(config, experiment class, batch, per-step draws) of one case."""
    rng = np.random.default_rng(0)
    if which == "birds":
        cfg = Config(name="card_birds", dataset="birds", img_size=128,
                     n_hidden=16, batch_size_train=BATCH, dtype=dtype,
                     lr=LR, beta=1.0)
        x = rng.uniform(-1, 1, (BATCH, 128, 128, 3))
        draws = [{"labels": {"real": 0.9, "fake": 0.1},
                  "z_prior": rng.normal(size=(BATCH, 16)),
                  "eps": rng.normal(size=(BATCH, 16))} for _ in range(STEPS)]
        return cfg, FamilyExperiment, x, draws
    if which in ("vae", "gan"):
        cfg = Config(name=f"card_{which}", batch_size_train=BATCH,
                     dtype=dtype, lr=LR, **TOY)
        x = rng.uniform(-1, 1, (BATCH, 32, 32, 3))
        if which == "vae":
            draws = [{"eps": rng.normal(size=(BATCH, 16))}
                     for _ in range(STEPS)]
            return cfg, VAEExperiment, x, draws
        draws = [{"labels": {"real": 0.9, "fake": 0.1},
                  "noise": rng.normal(size=(BATCH, 16))}
                 for _ in range(STEPS)]
        return cfg, GANExperiment, x, draws
    if which == "mnist":
        cfg = Config(name="card_mnist", dataset="mnist", img_size=28,
                     input_channels=1, batch_size_train=BATCH,
                     dtype="float32", lr=LR, beta=1.0)
        x = (rng.uniform(0, 1, (BATCH, 28, 28, 1)) - 0.1307) / 0.3081
        z = 7 * 7 * 4
        draws = [{"labels": {"real": 0.9, "fake": 0.1},
                  "z_prior": rng.normal(size=(BATCH, z)),
                  "eps": rng.normal(size=(BATCH, z))} for _ in range(STEPS)]
        return cfg, FamilyExperiment, x, draws
    mode = which.split("_")[1]  # betavaegan_<freeze mode>[_bf16]
    cfg = Config(name=f"card_{which}", batch_size_train=BATCH,
                 dtype=dtype, lr=LR, beta=25.0, freeze_mode=mode, **TOY)
    x = rng.uniform(-1, 1, (BATCH, 32, 32, 3))
    draws = [{"labels": {"real": 0.9, "fake": 0.1},
              **{k: rng.normal(size=(BATCH, 16))
                 for k in ("noise", "eps_dec", "eps_enc")}}
             for _ in range(STEPS)]
    return cfg, VAEGANExperiment, x, draws


def _cancelled(name: str, which: str) -> bool:
    parts = name.split(".")
    if parts[-1] != "bias":
        return False
    if which in ("mnist", "birds"):
        return parts[-2].startswith("Conv_")
    return parts[-2] in BN_CANCELLED


def _train_both(which, dtype="float32"):
    """The case's steps on the CPU and on the card; returns {device:
    (experiment, per-step metrics)} and the fused_linear launches the
    card's steps made."""
    from disentangle_mlp_tpu_torch.ops import fused_linear

    cfg, make, x, draws = _make(which, dtype)
    runs, launches = {}, 0
    with _tf32_off():
        for dev in ("cpu", "cuda"):
            exp = make(cfg, dev)  # one seeded initialization on the host
            xt = torch.from_numpy(x.astype(np.float32)).to(dev)
            before = fused_linear.launches
            metrics = [{k: v.item() for k, v in exp.train_step(
                xt, draws={k: (v if k == "labels" else
                               np.asarray(v, np.float32))
                           for k, v in d.items()}).items()}
                       for d in draws]
            launches = fused_linear.launches - before
            runs[dev] = (exp, metrics)
    return runs, launches


def _compare(runs, which, metric_rtol, param_atol, cancelled_atol,
             stats_atol):
    (cpu, m_cpu), (gpu, m_gpu) = runs["cpu"], runs["cuda"]
    for step, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for k in b:
            rtol = metric_rtol[k] if isinstance(metric_rtol, dict) \
                else metric_rtol
            np.testing.assert_allclose(a[k], b[k], rtol=rtol,
                                       err_msg=f"{which} step {step} {k}")
    for (name, p), (_, q) in zip(_modules(gpu), _modules(cpu)):
        atol = cancelled_atol if _cancelled(name, which) else param_atol
        if "running_" in name:
            atol = stats_atol
        np.testing.assert_allclose(p.detach().cpu().float().numpy(),
                                   q.detach().cpu().float().numpy(),
                                   rtol=1e-3, atol=atol,
                                   err_msg=f"{which} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["betavaegan_observed", "betavaegan_intent",
                                   "mnist"])
def test_port_training_on_the_card_matches_the_cpu(card, which):
    runs, _ = _train_both(which)
    _compare(runs, which, METRIC_RTOL, PARAM_ATOL, CANCELLED_ATOL,
             STATS_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["betavaegan_observed", "betavaegan_intent"])
def test_port_bf16_training_through_fused_linear_matches_the_cpu(card,
                                                                 which):
    runs, launches = _train_both(which, "bfloat16")
    assert launches == FUSED_LINEAR_PER_STEP * STEPS
    _compare(runs, which, BF16_METRIC_RTOL, BF16_PARAM_ATOL, CANCELLED_ATOL,
             BF16_STATS_ATOL)


def _modules(exp):
    for attr in ("vae", "generator", "discriminator"):
        net = getattr(exp, attr, None)
        if net is not None:
            yield from net.named_parameters()
            yield from net.named_buffers()


def _device_draws(d, dev):
    return {k: v if k == "labels" else
            torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in d.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["betavaegan_observed", "betavaegan_intent",
                                   "betavaegan_observed_bf16", "vae", "gan",
                                   "birds", "mnist"])
def test_port_graphed_steps_match_the_eager_steps_on_the_card(card, which):
    """make_multi_step's CUDA graph of the case's 3 steps against the same
    3 steps run eagerly, twice, on the card, from one initialization with
    the same draws (float32 with TF32 off; the β-VAE-GAN once more in bf16,
    where every dense layer launches fused_linear from the graph, 21 a
    step). The graph replays the eager step's kernels, so every metric and
    every parameter, running statistic, Adam moment and count of the
    graphed run must lie within the largest |Δ| between the two eager runs
    of that tensor, and be bit-identical where they are. cuDNN runs
    deterministic algorithms: with its default choice these float32 steps
    differ from run to run, and a third run lies as often outside that
    spread as inside it, tensor by tensor; deterministic, the eager runs
    are bit-identical and so must the graph be. The replay adds its
    capture's fused_linear launches to the count."""
    from disentangle_mlp_tpu_torch.ops import fused_linear
    from disentangle_mlp_tpu_torch.train.scan import make_multi_step

    bf16 = which.endswith("_bf16")
    cfg, make, x, draws = _make(which.removesuffix("_bf16"),
                                "bfloat16" if bf16 else "float32")
    xt = torch.from_numpy(x.astype(np.float32)).cuda()
    batches = xt.expand((STEPS,) + tuple(xt.shape))
    dev_draws = [_device_draws(d, "cuda") for d in draws]

    def tensors(exp, metrics):
        """The run's metrics, each stacked over the steps, then its
        state."""
        return [metrics[k] for k in sorted(metrics)] + [
            t.detach().clone() for t in state_tensors(exp)]

    with _tf32_off(), _cudnn_deterministic():
        runs = []
        for _ in range(2):
            exp = make(cfg, "cuda")
            ms = [exp.train_step(xt, draws=d) for d in dev_draws]
            runs.append(tensors(exp, {k: torch.stack([m[k] for m in ms])
                                      for k in ms[0]}))
        exp = make(cfg, "cuda")
        multi = make_multi_step(exp, STEPS)
        multi.capture(batches, dev_draws)
        before = fused_linear.launches
        graphed = tensors(exp, multi(batches, dev_draws))
        launches = fused_linear.launches - before
    assert launches == (FUSED_LINEAR_PER_STEP * STEPS if bf16 else 0)
    worse = []
    for i, (a, b, g) in enumerate(zip(*runs, graphed)):
        d_ee = (a.double() - b.double()).abs().max().item()
        d_ge = (g.double() - a.double()).abs().max().item()
        if d_ge > d_ee:
            worse.append((i, d_ge, d_ee))
    assert not worse, (f"{which}: {len(worse)} of {len(graphed)} tensors "
                       f"(index, |graph - eager|, |eager - eager|): "
                       f"{worse[:8]}")


@pytest.mark.cuda
def test_port_graph_replay_refuses_moved_state(card):
    """A replay after a parameter was replaced by a copy elsewhere raises:
    the graph would go on updating the old memory."""
    from disentangle_mlp_tpu_torch.train.scan import make_multi_step

    cfg, make, x, _ = _make("vae")
    exp = make(cfg, "cuda")
    xt = torch.from_numpy(x.astype(np.float32)).cuda()[None]
    multi = make_multi_step(exp, 1)
    multi(xt)
    exp.params[0].data = exp.params[0].data.clone()
    with pytest.raises(RuntimeError, match="moved"):
        multi(xt)


@contextlib.contextmanager
def _spans(on: bool):
    from disentangle_mlp_tpu_torch.utils import runtime

    prev = runtime.spans_on()
    runtime.set_spans(on)
    try:
        yield
    finally:
        runtime.set_spans(prev)


def _graphed_run(which: str, spans_on: bool):
    """The case's 3 steps as one graph captured with spans ``on`` or off,
    replayed once under the profiler; returns the multi-step, its outputs
    and state, and the replay's device kernels (name, start), in order."""
    from disentangle_mlp_tpu_torch.train.scan import make_multi_step

    cfg, make, x, draws = _make(which)
    xt = torch.from_numpy(x.astype(np.float32)).cuda()
    batches = xt.expand((STEPS,) + tuple(xt.shape))
    dev_draws = [_device_draws(d, "cuda") for d in draws]
    with _tf32_off(), _cudnn_deterministic():
        exp = make(cfg, "cuda")
        multi = make_multi_step(exp, STEPS)
        with _spans(spans_on):
            multi.capture(batches, dev_draws)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            out = multi(batches, dev_draws)
            torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False))
    tensors = [out[k] for k in sorted(out)] + [
        t.detach().clone() for t in state_tensors(exp)]
    return multi, tensors, [n for _, n in kernels]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["vae", "betavaegan_observed"])
def test_port_graph_marks_replay_in_table_order(card, which):
    """A graph captured with spans off holds no dmt_trace_mark and an empty
    table; captured with spans on, a replay runs one mark a table entry
    and the plain graph's kernels in their order, with work between each
    BatchNorm's forward marks; its outputs and state are
    bit-identical to the graph without marks."""
    plain, want, k_plain = _graphed_run(which, False)
    assert plain.marks == [] and "dmt_trace_mark" not in k_plain
    marked, got, k_marked = _graphed_run(which, True)
    table = marked.marks
    assert table[0] == "dmt.step.begin" and table[-1] == "dmt.step.end"
    assert table.count("dmt.step.begin") == STEPS
    assert all(t.startswith("dmt.") and t.endswith((".begin", ".end"))
               for t in table)
    ends = {t[:-len(".end")]: i for i, t in enumerate(table)
            if t.endswith(".end") and t.startswith("dmt.bn")}
    begins = {t[:-len(".begin")]: i for i, t in enumerate(table)
              if t.endswith(".begin") and t.startswith("dmt.bn")}
    assert begins and begins.keys() == ends.keys()
    assert all(begins[k] < ends[k] for k in begins)
    assert k_marked.count("dmt_trace_mark") == len(table)
    at = [i for i, n in enumerate(k_marked) if n == "dmt_trace_mark"]
    for tag, i in begins.items():
        if tag.endswith(".fwd"):
            assert at[ends[tag]] - at[i] > 1, tag  # kernels between
    # a graph's memcpy or memset node may run on a copy engine or as
    # CUDA's own kernel (memcpy32_post, memset32), as its neighbours suit
    def kind(n):
        low = n.lower()
        return next((k for k in ("memcpy", "memset") if k in low), n)

    work = [kind(n) for n in k_marked if n != "dmt_trace_mark"]
    plain_work = [kind(n) for n in k_plain]
    assert len(work) == len(plain_work), (len(work), len(plain_work))
    assert work == plain_work, next(
        (i, a, b) for i, (a, b) in enumerate(zip(work, plain_work))
        if a != b)
    assert marked.replays == plain.replays == 1
    assert marked.captures == plain.captures == 1
    for i, (a, b) in enumerate(zip(want, got)):
        assert torch.equal(a, b), f"{which} tensor {i}"


@pytest.mark.cuda
def test_port_async_checkpoint_on_the_card(card, tmp_path):
    """The AsyncCheckpointer on card tensors: its file byte-identical to
    save_checkpoint's, taken from the snapshot (the parameters changed right
    after save() returned do not reach it), and rotated to the newest 2."""
    from disentangle_mlp_tpu_torch.utils import checkpoint as ckpt

    cfg, make, x, draws = _make("betavaegan_intent")
    exp = make(cfg, "cuda")
    exp.train_step(torch.from_numpy(x.astype(np.float32)).cuda(),
                   draws=_device_draws(draws[0], "cuda"))
    want = str(tmp_path / "want")

    def same(a, b) -> bool:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            return fa.read() == fb.read()

    ckpt.save_checkpoint(want, 1, exp.states(), "bfloat16")
    saver = ckpt.AsyncCheckpointer("bfloat16")
    saver.save(str(tmp_path / "model_1"), 1, exp.states(), rotate_keep=2)
    with torch.no_grad():
        for t in state_tensors(exp):
            t.add_(1)
    saver.wait()
    assert same(want, tmp_path / "model_1")
    for n in (2, 3):
        saver.save(str(tmp_path / f"model_{n}"), n, exp.states(),
                   rotate_keep=2)
    saver.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "model_2", "model_3", "want"]
    ckpt.save_checkpoint(want, 3, exp.states(), "bfloat16")
    assert same(want, tmp_path / "model_3")


def _largest_differences(ra, rb, which) -> dict:
    """The largest relative difference of each metric over the steps, and
    the largest leaf difference beyond rtol 1e-3 of each kind of leaf."""
    (a, ma), (b, mb) = ra, rb
    out = {"metric_rel": {k: max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                                 for x, y in zip(ma, mb)) for k in mb[0]},
           "param": 0.0, "cancelled": 0.0, "stats": 0.0}
    for (name, p), (_, q) in zip(_modules(a), _modules(b)):
        q = q.detach().cpu().float()
        d = ((p.detach().cpu().float() - q).abs() - 1e-3 * q.abs()).clamp(
            min=0).max().item()
        kind = ("stats" if "running_" in name else
                "cancelled" if _cancelled(name, which) else "param")
        out[kind] = max(out[kind], d)
    return out


if __name__ == "__main__":
    # the measurements behind the bf16 tolerances (needs a CUDA GPU)
    for which in ("betavaegan_observed", "betavaegan_intent"):
        bf16, launches = _train_both(which, "bfloat16")
        f32, _ = _train_both(which, "float32")
        print(json.dumps({
            "which": which, "fused_linear_launches": launches,
            "card_vs_cpu_bf16": _largest_differences(
                bf16["cuda"], bf16["cpu"], which),
            "cpu_bf16_vs_cpu_float32": _largest_differences(
                bf16["cpu"], f32["cpu"], which),
            "card_vs_cpu_float32": _largest_differences(
                f32["cuda"], f32["cpu"], which),
            "card": torch.cuda.get_device_name(0)}))
