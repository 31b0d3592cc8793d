"""The port's G+D training step against the JAX package's, and its trainer.

One G step then one D step at the JAX package's tiny training config
(tests/test_training.py: ngf 8, ndf 8, crop 64, batch 2, `normal`
upsampling; here with --random_expand_mask and one extra dilation), from the
same initial weights (JAX's init, carried over by `state_dicts_from_flax`)
on the same seeded numpy batch:

- per-term losses within rtol 1e-4, atol 1e-5;
- netG's and netD's parameters after their steps by the scale-aware rule of
  tests/test_training.py (Adam's first step moves every parameter by about
  +-lr, so a near-zero gradient whose sign differs between the two
  frameworks gives a difference up to 2 lr; at most 0.1% of the elements, or
  8, may differ beyond float noise).  The D step starts from JAX's post-G
  state: after the port's own G step those few flipped netG elements move
  the recomputed fake by ~1e-3, which the D gradient (a difference of fake
  and real terms through D's shared label and orientation channels) carries
  into more sign flips;
- buffers written exactly where JAX writes them: netG's running statistics
  and spectral u / v after the G step within 1e-5 and untouched by the D
  step, netD's u / v never written; netIG and VGG19 unchanged.

The JAX side runs with MICHIGAN_FILTERBANK=direct, whose bank-conv gradient
is fp32 autodiff, as the port's is (its default s2d path takes the gradient
in bf16; tests/test_torch_losses.py holds the port against both).  The JAX
steps are jitted once for the module; the port's trainer CLI and checkpoint
round trip run at the same tiny size.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu.config import Options
from michigan_tpu.training.state import TrainState
from michigan_tpu.training.state import learning_rates as jax_learning_rates
from michigan_tpu.training.train_step import make_train_steps
from michigan_tpu_torch.convert import state_dicts_from_flax
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.training import checkpoint as CK
from michigan_tpu_torch.training.state import learning_rates
from michigan_tpu_torch.training.train_step import TrainStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "datasets", "FFHQ_single")
EXTRA = 1
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
BUF_TOL = dict(rtol=0, atol=1e-5)
G_TERMS = ("GAN", "GAN_Feat", "VGG", "content", "style", "background", "rgb", "lab",
           "ORIENT", "CONFIDENCE")


def tiny_opt(**kw):
    d = dict(isTrain=True, crop_size=64, load_size=64, ngf=8, ndf=8, batchSize=2,
             use_encoder=True, use_ig=True, noise_background=True, random_expand_mask=True,
             num_upsampling_layers="normal", donate_buffers=False)
    d.update(kw)
    return Options(**d).finalize()


def tiny_batch(opt, seed=0, paired=True):
    """tests/test_training.py's batch; paired (ref planes = tag planes) unless
    asked, so the ref_is_tag gate keeps every term."""
    rng = np.random.default_rng(seed)
    n, s = opt.batchSize, opt.crop_size
    b = {
        "label_tag": rng.integers(0, 2, (n, s, s, 1)),
        "image_tag": rng.uniform(-1, 1, (n, s, s, 3)),
        "orient": rng.uniform(0, 255, (n, s, s, 1)),
        "hole": rng.integers(0, 2, (n, s, s, 1)),
        "orient_rgb": rng.uniform(0, 1, (n, s, s, 3)),
        "noise": rng.uniform(0, 1, (n, s, s, 3)),
        "label_ref": rng.integers(0, 2, (n, s, s, 1)),
        "image_ref": rng.uniform(-1, 1, (n, s, s, 3)),
    }
    if paired:
        b["label_ref"], b["image_ref"] = b["label_tag"], b["image_tag"]
    return {k: v.astype(np.float32) for k, v in b.items()}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's initial variables, and its G step then D step on the paired
    batch and (G step only) on an unpaired one."""
    opt = tiny_opt()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MICHIGAN_FILTERBANK", "direct")
        model, g_step, d_step = make_train_steps(opt)
        batch = tiny_batch(opt)
        rng = jax.random.PRNGKey(0)
        variables = model.init_variables(rng, {k: jnp.asarray(v) for k, v in batch.items()})
        state0 = TrainState.create(opt, variables)
        extra = jnp.asarray(EXTRA, jnp.int32)
        state1, g_losses, _fake, orient = g_step(state0, batch, rng, extra)
        state2, d_losses = d_step(state1, batch, rng, extra, orient=orient)
        unpaired = tiny_batch(opt, seed=1, paired=False)
        _, g_unpaired, _, _ = g_step(state0, unpaired, rng, extra)
    return dict(
        opt=opt, batch=batch, unpaired=unpaired,
        v0=to_np(variables), v1=to_np(state1.variables), v2=to_np(state2.variables),
        g_losses=to_np(g_losses), d_losses=to_np(d_losses), g_unpaired=to_np(g_unpaired))


def port_model(opt, variables):
    model = MichiGANModel(opt, "cpu")
    model.load_state_dicts(state_dicts_from_flax(variables, opt))
    return model


def snapshot(model):
    return {name: {k: v.detach().clone() for k, v in net.state_dict().items()}
            for name, net in model.nets().items()}


@pytest.fixture(scope="module")
def port_run(jax_run):
    opt = jax_run["opt"]
    model = port_model(opt, jax_run["v0"])
    trainer = TrainStep(model)
    s0 = snapshot(model)
    g_losses, _fake, orient = trainer.g_step(batch_from_numpy(jax_run["batch"], "cpu"), EXTRA)
    s1 = snapshot(model)
    d_losses = trainer.d_step(batch_from_numpy(jax_run["batch"], "cpu"), EXTRA, orient)
    s2 = snapshot(model)
    from_jax_g = TrainStep(port_model(opt, jax_run["v1"]))
    d_from_jax_g = from_jax_g.d_step(batch_from_numpy(jax_run["batch"], "cpu"), EXTRA)
    unpaired = port_model(opt, jax_run["v0"])
    g_unpaired, _, _ = TrainStep(unpaired).g_step(
        batch_from_numpy(jax_run["unpaired"], "cpu"), EXTRA)
    return dict(s0=s0, s1=s1, s2=s2, g_losses=g_losses, d_losses=d_losses,
                g_unpaired=g_unpaired, d_from_jax_g=d_from_jax_g,
                s2_from_jax_g=snapshot(from_jax_g.model))


def assert_losses(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **LOSS_TOL)


def count_beyond_noise(got: dict, want: dict, max_lr: float):
    """(elements beyond float noise, elements) of tests/test_training.py:
    212-247's rule over a set of parameters, after asserting its bound of
    2.5 max_lr on every element."""
    n_bad = n_tot = 0
    for k, w in want.items():
        a = got[k].double().numpy()
        b = w.double().numpy()
        diff = np.abs(a - b)
        assert diff.max() <= 2.5 * max_lr, f"{k}: diff {diff.max():.2e} > {2.5 * max_lr:.2e}"
        n_bad += int((diff > (1e-4 * np.abs(b) + 1e-5)).sum())
        n_tot += diff.size
    return n_bad, n_tot


def within_count(n_bad: int, n_tot: int) -> bool:
    return n_bad <= max(1e-3 * n_tot, 8)


def assert_params_scale_aware(got: dict, want: dict, max_lr: float):
    """tests/test_training.py:212-247's rule over a set of parameters."""
    n_bad, n_tot = count_beyond_noise(got, want, max_lr)
    assert within_count(n_bad, n_tot), f"{n_bad}/{n_tot} elements beyond float noise"


def jax_state(jax_run, key, net):
    return state_dicts_from_flax(jax_run[key], jax_run["opt"])[net]


def params_of(state: dict, net: torch.nn.Module) -> dict:
    names = {k for k, _ in net.named_parameters()}
    return {k: v for k, v in state.items() if k in names}


def test_g_step_losses_match_jax(jax_run, port_run):
    assert tuple(port_run["g_losses"]) == G_TERMS
    assert_losses(port_run["g_losses"], jax_run["g_losses"])


def test_unpaired_batch_gates_the_paired_terms_as_jax(jax_run, port_run):
    """ref != tag: GAN_Feat, VGG, background, rgb and lab are multiplied by
    the ref_is_tag factor 0; the other terms stay."""
    assert_losses(port_run["g_unpaired"], jax_run["g_unpaired"])
    for k in ("GAN_Feat", "VGG", "background", "rgb", "lab"):
        assert float(port_run["g_unpaired"][k]) == 0.0
    assert float(port_run["g_unpaired"]["style"]) > 0


def test_g_step_updates_netg_as_jax(jax_run, port_run):
    model = port_model(jax_run["opt"], jax_run["v0"])
    want = params_of(jax_state(jax_run, "v1", "netG"), model.netG)
    assert_params_scale_aware(params_of(port_run["s1"]["netG"], model.netG), want,
                              jax_run["opt"].lr / 2)
    moved = sum(int((port_run["s1"]["netG"][k] != port_run["s0"]["netG"][k]).sum())
                for k in want)
    assert moved > 0.5 * sum(v.numel() for v in want.values())


def test_g_step_writes_netg_buffers_as_jax(jax_run, port_run):
    """The G step's forward writes netG's running statistics and spectral
    u / v (JAX: mutable batch_stats and spectral); the D step's recompute
    writes nothing."""
    want = jax_state(jax_run, "v1", "netG")
    before = jax_state(jax_run, "v0", "netG")
    bufs = [k for k in want if k.endswith(("running_mean", "running_var", "weight_u",
                                           "weight_v"))]
    assert bufs
    for k in bufs:
        torch.testing.assert_close(port_run["s1"]["netG"][k], want[k], **BUF_TOL, msg=k)
        torch.testing.assert_close(port_run["s2"]["netG"][k], port_run["s1"]["netG"][k],
                                   rtol=0, atol=0, msg=k)
    assert any(not torch.equal(want[k], before[k]) for k in bufs)


def test_d_step_losses_match_jax(jax_run, port_run):
    assert tuple(port_run["d_from_jax_g"]) == ("D_Fake", "D_real")
    assert_losses(port_run["d_from_jax_g"], jax_run["d_losses"])
    assert_losses(port_run["d_losses"], jax_run["d_losses"])  # after the port's G step


def test_d_step_updates_netd_as_jax(jax_run, port_run):
    model = port_model(jax_run["opt"], jax_run["v0"])
    want = params_of(jax_state(jax_run, "v2", "netD"), model.netD)
    assert_params_scale_aware(params_of(port_run["s2_from_jax_g"]["netD"], model.netD), want,
                              2 * jax_run["opt"].lr)
    for k in want:  # the G step leaves netD's parameters alone
        torch.testing.assert_close(port_run["s1"]["netD"][k], port_run["s0"]["netD"][k],
                                   rtol=0, atol=0, msg=k)


def test_netd_spectral_state_and_frozen_nets_never_change(jax_run, port_run):
    """netD's u / v stay the initial ones in both packages; netIG and VGG19
    are bit-identical after the step."""
    want = jax_state(jax_run, "v2", "netD")
    for k, v in port_run["s2"]["netD"].items():
        if k.endswith(("weight_u", "weight_v")):
            torch.testing.assert_close(want[k], port_run["s0"]["netD"][k], rtol=0, atol=0)
            torch.testing.assert_close(v, port_run["s0"]["netD"][k], rtol=0, atol=0)
    for net in ("netIG", "vgg"):
        for k, v in port_run["s2"][net].items():
            assert torch.equal(v, port_run["s0"][net][k]), (net, k)


@pytest.mark.parametrize("kw", [dict(niter=10, niter_decay=10), dict(niter=3, niter_decay=0),
                                dict(niter=10, niter_decay=10, no_TTUR=True)])
def test_learning_rates_match_jax(kw):
    opt = tiny_opt(lr=0.0002, **kw)
    for epoch in range(1, opt.niter + opt.niter_decay + 2):
        assert learning_rates(opt, epoch) == pytest.approx(jax_learning_rates(opt, epoch))


def test_checkpoint_round_trip(tmp_path):
    """One step, save, restore into fresh nets and optimizers built as the
    trainer builds them (same --seed: VGG19 is frozen and not saved): the
    next step is the same."""
    opt = tiny_opt(checkpoints_dir=str(tmp_path), name="t", use_ig=False, batchSize=1)
    batch = batch_from_numpy(tiny_batch(opt), "cpu")
    a = TrainStep(MichiGANModel(opt, "cpu"))
    a.model.init_weights(0)
    a.g_step(batch, EXTRA)
    a.d_step(batch, EXTRA)
    CK.save_checkpoint(opt, "latest", a)
    b = TrainStep(MichiGANModel(opt, "cpu"))
    b.model.init_weights(0)
    assert CK.load_checkpoint(opt, "latest", b) and b.step == 1
    assert not CK.load_checkpoint(opt, "missing", b)
    losses = [t.g_step(batch, EXTRA)[0] for t in (a, b)]
    losses += [t.d_step(batch, EXTRA) for t in (a, b)]
    for got, want in ((losses[1], losses[0]), (losses[3], losses[2])):
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for net in ("netG", "netD"):
        sa, sb = a.model.nets()[net].state_dict(), b.model.nets()[net].state_dict()
        for k in sa:
            torch.testing.assert_close(sb[k], sa[k], rtol=0, atol=0, msg=k)


BLOCK_JAX = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "michigan_tpu"):
    sys.modules[name] = None
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("michigan_tpu_torch.train", run_name="__main__")
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "michigan_tpu" or m.startswith("michigan_tpu.")))
assert not leaked, leaked
print("ok")
"""
TRAIN_FLAGS = ["--gpu_ids", "-1", "--name", "t", "--netG", "spadeb", "--use_encoder",
               "--use_ig", "--noise_background", "--random_expand_mask", "--ngf", "8",
               "--ndf", "8", "--crop_size", "64", "--load_size", "64", "--batchSize", "1",
               "--nThreads", "1", "--print_freq", "1",
               "--label_dir", os.path.join(DATA, "val_labels"),
               "--image_dir", os.path.join(DATA, "val_images"),
               "--orient_dir", os.path.join(DATA, "val_dense_orients")]


def test_trainer_cli_trains_saves_resumes_and_feeds_inference(tmp_path):
    """The CLI with jax unimportable: two epochs of the one sample, then a
    resume from 'latest' for a third; the saved generator restores into the
    inference model and renders as it did in training."""
    env = dict(os.environ, PYTHONPATH=REPO)
    ck = str(tmp_path / "checkpoints")
    run = lambda *extra: subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, *TRAIN_FLAGS, "--checkpoints_dir", ck, *extra],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    first = run("--niter", "2")
    assert first.returncode == 0, first.stdout + first.stderr
    assert first.stdout.count("(epoch: ") == 2 and first.stdout.strip().endswith("ok")
    for f in ("1_net_G.pth", "2_net_D.pth", "latest_optim.pth", "iter.txt", "loss_log.txt"):
        assert (tmp_path / "checkpoints" / "t" / f).exists(), f
    second = run("--niter", "3", "--continue_train")
    assert second.returncode == 0, second.stdout + second.stderr
    assert "resumed checkpoint 'latest'" in second.stdout
    assert "(epoch: 3, iters: 1" in second.stdout and "(epoch: 1," not in second.stdout

    from michigan_tpu import config
    from michigan_tpu_torch.inference import load_released

    inf = config.test_options(["--netG", "spadeb", "--use_encoder", "--noise_background",
                               "--use_ig", "--ngf", "8", "--crop_size", "64", "--load_size",
                               "64", "--checkpoints_dir", ck, "--name", "t",
                               "--which_epoch", "latest"])
    model = MichiGANModel(inf, "cpu")
    model.init_weights(0)
    assert load_released(model, inf)
    saved = torch.load(tmp_path / "checkpoints" / "t" / "latest_net_G.pth", weights_only=True)
    for k, v in model.netG.state_dict().items():
        assert torch.equal(v, saved[k]), k
    # the generator as the trainer held it (train-time options, eval mode)
    trained = MichiGANModel(dataclasses.replace(inf, isTrain=True), "cpu")
    trained.netG.load_state_dict(saved)
    trained.netIG.load_state_dict(model.netIG.state_dict())
    trained.netG.eval()
    batch = batch_from_numpy(tiny_batch(inf), "cpu")
    with torch.no_grad():
        got, _ = model.infer(batch)
        pre = trained.preprocess(batch)
        want = trained.generate_fake(pre, trained.orient_for_training(pre))[0]
    assert got.shape == (1, 3, 64, 64) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_debug_nans_names_the_loss_and_the_step():
    from michigan_tpu_torch.train import check_finite

    check_finite({"GAN": torch.tensor(1.0), "D_real": torch.tensor(-2.0)}, 3)
    with pytest.raises(FloatingPointError, match="non-finite loss VGG=nan at step 7"):
        check_finite({"GAN": torch.tensor(1.0), "VGG": torch.tensor(float("nan"))}, 7)
    with pytest.raises(FloatingPointError, match="D_Fake=inf"):
        check_finite({"D_Fake": torch.tensor(float("inf"))}, 1)


def test_trainer_cli_checks_losses_and_profiles_one_step(tmp_path):
    """--debug_nans on finite losses runs through; --profile_dir writes one
    trace, of the step at 3 * batchSize samples."""
    env = dict(os.environ, PYTHONPATH=REPO)
    prof = tmp_path / "profile"
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, *TRAIN_FLAGS, "--checkpoints_dir",
         str(tmp_path / "checkpoints"), "--niter", "3", "--debug_nans", "--profile_dir",
         str(prof)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("profiler trace written") == 1
    trace = (prof / "trace.json").read_text()
    assert "ProfilerStep" in trace or "traceEvents" in trace
