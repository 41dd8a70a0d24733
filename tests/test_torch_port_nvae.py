"""The port's NVAE (models/nvae.py, train/nvae.py, ops/losses.py) on the CPU
at toy widths (2 latent scales of 2 groups, 8 channels, 32×32 images,
batch 4), held against the benchmark's plain reference
(h100_bench/reference/nvae.py, written from NVAE's code, not from the
port) from the same seeded weights (through the reference's ``derive``,
which both sides take), batch and draws, both in float32. The reference
imports neither package; this file imports no JAX.

Tolerances, each from what differs between the two sides: the port's
convolutions run channels-last, the reference's NCHW (other summation
orders, about 1e-7 of a value), and the port's BatchNorm takes
E[x²] − E[x]² where the reference takes the two-pass variance.

- the loss terms and each group's KL: 1e-5 relative (sums of float32
  terms, which agree to 1e-7);
- the gradients (the Adamax first moments after one step, 0.1·(g +
  wd·p)) and the second moments (max(|g| + eps)): each leaf's gap within
  1e-3 of its norm or of the median leaf's, whichever is larger (measured
  1.5e-4 at worst; biases ahead of a BatchNorm have a gradient that is
  round-off only, so they are held to the median leaf's scale);
- the parameters after the step: within 5 % of one step, lr: Adamax turns
  a gradient's round-off δg into at most lr·δg/eps of the step, and eps is
  1e-3 (measured 1.1 %);
- the running statistics: 1e-4 of the largest value of each leaf plus
  1e-5 (a running mean near 0 carries the round-off of a batch mean of
  values near 1, measured 7.8e-7);
- the power iteration's vectors after 40 iterations: 1e-3 (each converges
  to a singular vector; the round-off of the kernels moves it by about
  1e-6).
"""

import dataclasses
import json
import math
import statistics
import sys
from pathlib import Path

import pytest
import torch

from disentangle_mlp_tpu_torch.config import Config
from disentangle_mlp_tpu_torch.models import nvae as port
from disentangle_mlp_tpu_torch.ops import losses
from disentangle_mlp_tpu_torch.train import nvae as train_nvae
from disentangle_mlp_tpu_torch.train.nvae import NVAEExperiment

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import celeba as ref_celeba  # noqa: E402
from reference import nvae as ref  # noqa: E402

TOY = dict(num_channels_enc=8, num_channels_dec=8, num_preprocess_blocks=1,
           num_preprocess_cells=2, num_postprocess_blocks=1,
           num_postprocess_cells=2, num_latent_scales=2,
           num_groups_per_scale=2, ada_groups=False, num_latent_per_group=4,
           num_cell_per_cond_enc=2, num_cell_per_cond_dec=2,
           num_mixture_dec=10, img_size=32, input_channels=3,
           batch_size_train=4, lr=1e-2, weight_decay=3e-4,
           weight_decay_norm=0.1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The toy model's tensors are small: one thread each, so that the
    suite's parallel workers do not fight over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _experiment(seed):
    cfg = Config(**{k: v for k, v in TOY.items()
                    if k in Config.__dataclass_fields__}, dtype="float32")
    exp = NVAEExperiment(cfg, "cpu")
    w = ref_celeba.init_weights(ref.layers(TOY), seed, "cpu")
    ref.derive(w, TOY)
    named = {**{f"nvae.{k}": p for k, p in exp.model.named_parameters()},
             **{f"nvae.{k}": b for k, b in exp.model.named_buffers()}}
    assert set(named) == set(w)
    with torch.no_grad():
        for k, t in named.items():
            t.copy_(w[k])
    return exp, named


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(4, 32, 32, 3, generator=g) * 2 - 1
    return x, ref.draw(torch.Generator().manual_seed(seed + 1), TOY, 4,
                       "cpu")


@pytest.fixture(scope="module", params=[11, 2 ** 31 + 5])
def stepped(request):
    """One step of each side from the same seed: the reference's model,
    its weights and metrics; the port's experiment, its tensors by the
    reference's names and metrics; the port's per-group KL of the same
    forward (a second experiment, which takes no step)."""
    seed = request.param
    x, d = _inputs(seed)
    w = ref_celeba.init_weights(ref.layers(TOY), seed, "cpu")
    model = ref.Model(TOY, w)
    want = model.step(x, d)
    exp, named = _experiment(seed)
    got = exp.train_step(x, d)
    fresh, _ = _experiment(seed)
    kl_groups = fresh.terms(x, d["eps"])["kl_groups"]
    return {"model": model, "w": w, "want": want, "exp": exp,
            "named": named, "got": got, "kl_groups": kl_groups}


@pytest.mark.parametrize("term", ref.METRICS)
def test_loss_terms_match_the_reference(stepped, term):
    want, got = float(stepped["want"][term]), float(stepped["got"][term])
    assert got == pytest.approx(want, rel=1e-5), term


def test_each_groups_kl_matches_the_reference(stepped):
    want = stepped["model"].kl_groups
    torch.testing.assert_close(stepped["kl_groups"].detach(), want,
                               rtol=1e-5, atol=1e-5)
    assert want.shape == (4,)


@pytest.mark.parametrize("moment", ["mu", "nu"])
def test_every_gradient_matches_the_reference(stepped, moment):
    model, exp, named = stepped["model"], stepped["exp"], stepped["named"]
    want = dict(zip(model.keys, getattr(model.opt, moment)))
    index = {id(p): i for i, p in enumerate(exp.opt.params)}
    got = {k: getattr(exp.opt, moment)[index[id(named[k])]] for k in want}
    med = statistics.median(float(t.norm()) for t in want.values())
    for k, t in want.items():
        gap = float((got[k] - t).norm())
        assert gap <= 1e-3 * max(float(t.norm()), med), (moment, k, gap)


def test_one_adamax_step_matches_the_reference(stepped):
    model, w, named = stepped["model"], stepped["w"], stepped["named"]
    lr = TOY["lr"]
    for k in model.keys:
        gap = float((named[k].detach() - w[k].detach()).abs().max())
        assert gap <= 0.05 * lr, (k, gap)
    assert int(stepped["exp"].opt.count) == model.opt.t == 1


def test_running_statistics_and_power_vectors_match(stepped):
    w, named = stepped["w"], stepped["named"]
    stats = [k for k, t in w.items() if not t.requires_grad]
    assert any(k.endswith("running_var") for k in stats)
    assert any(".sr_u_" in k for k in stats)
    for k in stats:
        want = w[k]
        tol = (1e-3 if ".sr_" in k
               else 1e-4 * float(want.abs().max()) + 1e-5)
        gap = float((named[k] - want).abs().max())
        assert gap <= tol, (k, gap)


def test_the_mixture_sums_to_one_over_all_levels():
    """A pixel's probabilities over all 256³ colour levels sum to 1: each
    channel's 256 bins tile the line for every component and every value
    of the colours before it (a 2-component mixture, every level of one
    pixel's red a batch of the 256² green and blue levels)."""
    m = 2
    logits = torch.randn(1, 1, 1, 10 * m,
                         generator=torch.Generator().manual_seed(0)) * 2
    levels = torch.arange(256, dtype=torch.float32) * (2.0 / 255) - 1
    gg, bb = torch.meshgrid(levels, levels, indexing="ij")
    gb = torch.stack([gg, bb], -1).reshape(256 * 256, 1, 1, 2)
    per_pixel = logits.expand(256 * 256, 1, 1, 10 * m)
    total = 0.0
    for r in levels:   # 256² one-pixel images: this red, every green, blue
        x = torch.cat([torch.full_like(gb[..., :1], float(r)), gb], -1)
        total += float(torch.exp(
            -losses.disc_mix_logistic_nll(per_pixel, x, m)).sum())
    assert total == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("ada,want", [(True, [20, 10, 5]),
                                      (False, [20, 20, 20])])
def test_groups_per_scale(ada, want):
    assert port.groups_per_scale(3, 20, ada) == want
    assert ref.groups_per_scale({"num_latent_scales": 3,
                                 "num_groups_per_scale": 20,
                                 "ada_groups": ada}) == want
    assert port.groups_per_scale(4, 3, True) == [3, 1, 1, 1]


def test_published_widths_draw_and_shapes():
    """At the published widths: 35 groups, 467,200 latents an image (5 at
    8×8, 10 at 16×16, 20 at 32×32, 20 channels each), and the port's
    layout of them is the reference's. The port's defaults and constants
    are the published configuration's (h100_bench/configs/
    nvae_celeba64.json)."""
    arch = port.Arch()
    shapes = port.latent_shapes(arch)
    assert len(shapes) == 35 and shapes[0] == (20, 8, 8) \
        and shapes[-1] == (20, 32, 32)
    assert port.latent_width(arch) == 467200 == 20 * (5 * 64 + 10 * 256
                                                      + 20 * 1024)
    c = json.loads((BENCH / "configs" / "nvae_celeba64.json").read_text())
    assert dataclasses.asdict(arch) == {
        f.name: c[f.name] for f in dataclasses.fields(arch)}
    assert (port.PRE_BLOCKS, port.PRE_CELLS, port.POST_BLOCKS,
            port.POST_CELLS, port.CELLS_ENC, port.CELLS_DEC, port.MIXTURE,
            train_nvae.WEIGHT_DECAY, train_nvae.WEIGHT_DECAY_NORM) == tuple(
        c[k] for k in ("num_preprocess_blocks", "num_preprocess_cells",
                       "num_postprocess_blocks", "num_postprocess_cells",
                       "num_cell_per_cond_enc", "num_cell_per_cond_dec",
                       "num_mixture_dec", "weight_decay",
                       "weight_decay_norm"))
    assert ref.latent_shapes(c) == shapes


def test_layouts_stay_channels_last_in_bf16():
    """Every BatchNorm input and convolution output of a bf16 step is
    channels-last, so the BatchNorm kernels take no copy."""
    from disentangle_mlp_tpu_torch.models.layers import BatchNorm, Conv

    cfg = Config(**{k: v for k, v in TOY.items()
                    if k in Config.__dataclass_fields__}, dtype="bfloat16")
    exp = NVAEExperiment(cfg, "cpu")
    bad = []
    for n, mod in exp.model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.register_forward_pre_hook(
                lambda _, a, n=n: bad.append(n)
                if not a[0].movedim(1, -1).is_contiguous() else None)
        elif isinstance(mod, Conv):
            mod.register_forward_hook(
                lambda _, a, o, n=n: bad.append(n)
                if not o.movedim(1, -1).is_contiguous() else None)
    x, d = _inputs(3)
    m = exp.train_step(x, d)
    assert bad == []
    assert all(math.isfinite(float(v)) for v in m.values())


TOY_FLAGS = ["--num_channels_enc", "8", "--num_channels_dec", "8",
             "--num_latent_scales", "2", "--num_groups_per_scale", "2",
             "--ada_groups", "False", "--num_latent_per_group", "4",
             "--img_size", "32", "--lr", "0.01", "--dtype", "float32"]


def _train(tmp_path, *extra):
    from disentangle_mlp_tpu_torch.cli import train as cli_train

    return cli_train.main(["--model", "nvae", "--name", "nvae_cli",
                           "--device", "cpu", "--synthetic_data", "True",
                           "--synthetic_train_size", "8",
                           "--batch_size_train", "4",
                           "--fid_path_pretrained",
                           str(tmp_path / "no_stats.npz"),
                           "--save_path", str(tmp_path / "%"),
                           "--log_path", str(tmp_path / "%" / "log"),
                           *TOY_FLAGS, *extra])


def test_the_trainer_trains_resumes_and_evaluates_nvae(tmp_path, capsys):
    """``--model nvae`` through the trainer's ``_Run``: an epoch of two
    steps, its record, the checkpoint in the experiment's layout; resumed
    from it, one more epoch from the restored state (Adamax count 2 → 4);
    FID, which finds no statistics here, logs N/A; the evaluation CLI's
    sweep of the checkpoint writes its reconstructions and samples."""
    from disentangle_mlp_tpu_torch.utils import msgpack

    out = _train(tmp_path, "--epochs", "1")
    assert set(out) >= {"Avg Loss", "Avg Recon Loss", "Avg KL", "FID",
                        "images_per_sec", "step_metrics"}
    assert out["FID"] == "N/A"
    assert all(math.isfinite(out[k]) for k in ("Avg Loss", "Avg KL"))
    assert set(out["step_metrics"]) == set(ref.METRICS)
    ckpt = tmp_path / "nvae_cli" / "models" / "model_1"
    raw = msgpack.load(str(ckpt))
    assert int(raw["epoch"]) == 1
    model = raw["states"]["model"]
    assert int(model["opt_state"]["count"]) == 2
    assert "stem.log_weight_norm" in model["params"]
    assert any(k.startswith("sr_u_") for k in model["batch_stats"])
    assert set(model["opt_state"]["mu"]) == set(model["params"])
    resumed = _train(tmp_path, "--epochs", "2", "--load_path", str(ckpt))
    raw2 = msgpack.load(str(tmp_path / "nvae_cli" / "models" / "model_2"))
    assert int(raw2["states"]["model"]["opt_state"]["count"]) == 4
    assert math.isfinite(resumed["Avg Loss"])
    assert "====> Epoch: 1 Average loss" in capsys.readouterr().out
    from disentangle_mlp_tpu_torch.cli import evaluate

    sweep = evaluate.main(["--model", "nvae", "--name", "nvae_cli",
                           "--device", "cpu", "--synthetic_data", "True",
                           "--batch_size_test", "2", "--calc_fid", "False",
                           "--test_recons", "True", "--test_samples", "True",
                           "--load_path", str(ckpt),
                           "--save_path", str(tmp_path / "%"),
                           "--log_path", str(tmp_path / "%" / "log"),
                           *TOY_FLAGS])
    assert sweep["sweep"] == [{"path": str(ckpt), "Epoch": 1, "FID": "N/A"}]
    printed = capsys.readouterr().out
    assert "Generated reconstructions" in printed
    assert "Generated samples" in printed


def test_cells_mark_their_passes_with_spans_on(monkeypatch):
    """With spans on every cell places ``dmt.nvae.<tower><k>#<call>`` marks
    around its forward and its backward (recorded here in place of the
    card's mark kernels), and the step computes what it computes with spans
    off: the mark's view gathers the gradients of a cell's input from the
    skip and the ops before a third consumer's (a combiner's) is added, so
    a sum of three may associate otherwise, float32 round-off that Adamax
    turns into at most a few % of a step (as against the reference)."""
    from disentangle_mlp_tpu_torch.utils import runtime

    x, d = _inputs(5)
    results, tags = [], []
    for on in (False, True):
        exp, named = _experiment(5)
        monkeypatch.setattr(runtime, "mark",
                            lambda tag, like: tags.append(tag))
        runtime.set_spans(on)
        try:
            m = exp.train_step(x, d)
        finally:
            runtime.set_spans(False)
        results.append(({k: float(v) for k, v in m.items()},
                        {k: t.detach().clone() for k, t in named.items()}))
    (m_off, t_off), (m_on, t_on) = results
    for k, v in m_off.items():
        assert m_on[k] == pytest.approx(v, rel=1e-5), k
    for k, t in t_off.items():
        assert float((t_on[k] - t).abs().max()) <= 0.05 * TOY["lr"], k
    cells = [t for t in tags if t.startswith("dmt.nvae.")]
    towers = {"pre": 2, "enc": 9, "dec": 7, "post": 2}
    for tower, n in towers.items():
        for k in range(n):
            for part in ("fwd.begin", "fwd.end", "bwd.begin", "bwd.end"):
                assert f"dmt.nvae.{tower}{k}#1.{part}" in cells, \
                    (tower, k, part)
    assert len(cells) == 4 * sum(towers.values())
    assert cells[:2] == ["dmt.nvae.pre0#1.fwd.begin",
                         "dmt.nvae.pre0#1.fwd.end"]
