"""The port's unpaired two-stage training (--unpairTrain) against the JAX
package's.

At the tiny training config of tests/test_torch_training.py (crop 64, ngf 8,
ndf 8, batch 2, `normal` upsampling, MICHIGAN_FILTERBANK=direct) with
torch's default init (--init_type none, as the card's runs), from JAX's
initial weights carried over by `state_dicts_from_flax` (netD2 its own
init, so that the stage's discriminator shows), on a seeded unpaired batch.
(Under the config's xavier gain 0.02 the blend is nearly flat, std 0.015:
there the two frameworks' bank sums put one hair pixel of 8,192 on another
orientation, which alone moves ORIENT by 1.1e-4 of itself; the last test
shows that effect on such a blend.)

- stage 2 (--curr_step 2) without the blender, one G step then one D step:
  per-term losses (GAN through netD2, ORIENT, CONFIDENCE, hairAvgLab,
  background; no paired term) within rtol 1e-4, atol 1e-5; netG after the G
  step and netD2 after the D step (from JAX's post-G state) by the
  scale-aware rule of tests/test_training.py; netD untouched;
- stage 2 with the blender (hairAvgLab of the blend against the fake), the
  G step: losses, netG and netB;
- stage 2 then stage 1 on one TrainStep, each stage training its own D;
  netD2 under --same_netD_model a copy of netD in storage of its own;
- hair_avg and hair_avg_lab_loss (both --balance_Lab branches, values and
  gradients) against JAX on seeded inputs;
- the iteration counter's resume of an unpair run (two passes an epoch);
- the stage-2 loader drawing the same ref sample as JAX's for the same host
  seed, on the three samples of datasets/FFHQ_demo;
- the trainer CLI with jax unimportable, --unpairTrain --same_netD_model
  --use_blender --use_vae on those samples: it trains, saves net_E, net_B
  and net_D2, resumes, and the inference CLI restores them and renders;
- the orientation of a near-flat blend (xavier gain 0.02) against JAX's:
  the same but at a few near-tied pixels.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu import losses as JL
from michigan_tpu.config import Options as JOptions
from michigan_tpu.data.dataset import CustomDataset as JDataset
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.ops.stats import hair_avg as j_hair_avg
from michigan_tpu.training.state import TrainState
from michigan_tpu.training.train_step import make_train_steps
from michigan_tpu.utils.iter_counter import IterationCounter as JCounter
from michigan_tpu_torch.config import Options
from michigan_tpu_torch.convert import state_dicts_from_flax
from michigan_tpu_torch.data.dataset import CustomDataset
from michigan_tpu_torch.losses.color import hair_avg_lab_loss, load_ab_count
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.ops.stats import hair_avg
from michigan_tpu_torch.training.state import init_netd2_from_netd
from michigan_tpu_torch.training.train_step import TrainStep
from michigan_tpu_torch.utils.iter_counter import IterationCounter
from tests.test_torch_training import (
    BLOCK_JAX,
    EXTRA,
    LOSS_TOL,
    REPO,
    assert_losses,
    assert_params_scale_aware,
    tiny_batch,
    tiny_opt,
    to_np,
)

DEMO = os.path.join(REPO, "datasets", "FFHQ_demo")
AB_COUNT = os.path.join(REPO, "data_assets", "ab_count.npy")
STAGE2_TERMS = ("GAN", "ORIENT", "CONFIDENCE", "hairAvgLab", "background")
CONFIGS = {"plain": dict(unpairTrain=True, curr_step=2, init_type="none"),
           "blender": dict(unpairTrain=True, curr_step=2, use_blender=True, init_type="none")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here in one thread, restored after the module:
    beside the other workers of a parallel run, torch's pool of a thread a
    core waits on its barriers for cores the others hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's initial variables (one jitted init with the blender), the
    stage-2 G step then D step without the blender, and the G step with."""
    rng = jax.random.PRNGKey(0)
    both = tiny_opt(**CONFIGS["blender"])
    batch = tiny_batch(both, seed=1, paired=False)
    v_all = to_np(jax.jit(JModel(both).init_variables)(
        rng, {k: jnp.asarray(v) for k, v in batch.items()}))
    out = {"batch": batch}
    extra = jnp.asarray(EXTRA, jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MICHIGAN_FILTERBANK", "direct")
        for name, kw in CONFIGS.items():
            opt = tiny_opt(**kw)
            v0 = v_all if opt.use_blender else {k: v for k, v in v_all.items() if k != "netB"}
            _, g_step, d_step = make_train_steps(opt)
            state1, g_losses, _, orient = g_step(TrainState.create(opt, v0), batch, rng, extra)
            run = dict(opt=opt, v0=v0, v1=to_np(state1.variables), g_losses=to_np(g_losses))
            if name == "plain":
                state2, d_losses = d_step(state1, batch, rng, extra, orient=orient)
                run.update(v2=to_np(state2.variables), d_losses=to_np(d_losses))
            out[name] = run
    return out


def port_model_from(opt, variables):
    model = MichiGANModel(opt, "cpu")
    model.load_state_dicts(state_dicts_from_flax(variables, opt))
    return model


def snapshot(model):
    return {name: {k: v.detach().clone() for k, v in net.state_dict().items()}
            for name, net in model.nets().items()}


def params_of(state, net):
    names = {k for k, _ in net.named_parameters()}
    return {k: v for k, v in state.items() if k in names}


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    out = {}
    batch = batch_from_numpy(jax_runs["batch"], "cpu")
    for name in CONFIGS:
        run = jax_runs[name]
        model = port_model_from(run["opt"], run["v0"])
        trainer = TrainStep(model)
        s0 = snapshot(model)
        g_losses, _, orient = trainer.g_step(batch, EXTRA)
        s1 = snapshot(model)
        res = dict(model=model, s0=s0, s1=s1, g_losses=g_losses)
        if name == "plain":
            res["d_losses"] = trainer.d_step(batch, EXTRA, orient)
            res["s2"] = snapshot(model)
            from_jax_g = TrainStep(port_model_from(run["opt"], run["v1"]))
            res["d_from_jax_g"] = from_jax_g.d_step(batch, EXTRA)
            res["s2_from_jax_g"] = snapshot(from_jax_g.model)
        out[name] = res
    return out


def jax_sd(jax_runs, name, key, net):
    return state_dicts_from_flax(jax_runs[name][key], jax_runs[name]["opt"])[net]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage2_g_step_losses_match_jax(jax_runs, port_runs, name):
    got = port_runs[name]["g_losses"]
    assert tuple(got) == STAGE2_TERMS
    assert_losses(got, jax_runs[name]["g_losses"])
    assert float(got["hairAvgLab"]) > 0 and float(got["background"]) > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage2_g_step_updates_as_jax(jax_runs, port_runs, name):
    """netG (and netB) by the scale-aware rule at G's rate; neither
    discriminator changes in a G step."""
    model, run = port_runs[name]["model"], port_runs[name]
    nets = ("netG", "netB") if name == "blender" else ("netG",)
    for net in nets:
        want = params_of(jax_sd(jax_runs, name, "v1", net), model.nets()[net])
        assert_params_scale_aware(params_of(run["s1"][net], model.nets()[net]), want,
                                  jax_runs[name]["opt"].lr / 2)
        moved = sum(int((run["s1"][net][k] != run["s0"][net][k]).sum()) for k in want)
        assert moved > 0.5 * sum(v.numel() for v in want.values()), net
    for net in ("netD", "netD2"):
        assert all(torch.equal(v, run["s0"][net][k]) for k, v in run["s1"][net].items()), net


def test_stage2_d_step_trains_netd2_as_jax(jax_runs, port_runs):
    """D_Fake and D_real through netD2, netD2 by the scale-aware rule at D's
    rate, netD and its Adam untouched, netD2's spectral u / v never written."""
    run, model = port_runs["plain"], port_runs["plain"]["model"]
    assert_losses(run["d_from_jax_g"], jax_runs["plain"]["d_losses"])
    assert_losses(run["d_losses"], jax_runs["plain"]["d_losses"])
    want = params_of(jax_sd(jax_runs, "plain", "v2", "netD2"), model.netD2)
    assert_params_scale_aware(params_of(run["s2_from_jax_g"]["netD2"], model.netD2), want,
                              2 * jax_runs["plain"]["opt"].lr)
    assert any(not torch.equal(v, run["s1"]["netD2"][k]) for k, v in run["s2"]["netD2"].items())
    for k, v in run["s2"]["netD"].items():
        assert torch.equal(v, run["s0"]["netD"][k]), k
    for k, v in run["s2"]["netD2"].items():
        if k.endswith(("weight_u", "weight_v")):
            assert torch.equal(v, run["s0"]["netD2"][k]), k


def test_stages_alternate_on_one_train_step_each_training_its_own_d():
    """--same_netD_model: netD2 starts equal to netD in storage of its own.
    A stage-2 step then trains netD2 alone, a stage-1 step netD alone (the
    stage read from opt.curr_step on each call), and the stage-1 losses are
    the paired ones."""
    opt = tiny_opt(unpairTrain=True, same_netD_model=True, curr_step=2, use_ig=False)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    init_netd2_from_netd(model)
    d, d2 = model.netD.state_dict(), model.netD2.state_dict()
    for k in d:
        assert torch.equal(d[k], d2[k]) and d[k].data_ptr() != d2[k].data_ptr(), k
    trainer = TrainStep(model)
    assert set(trainer.optimizers) == {"G", "D", "D2"}
    s0 = snapshot(model)
    g2, _, o = trainer.g_step(batch_from_numpy(tiny_batch(opt, 1, paired=False), "cpu"), EXTRA)
    trainer.d_step(batch_from_numpy(tiny_batch(opt, 1, paired=False), "cpu"), EXTRA, o)
    s1 = snapshot(model)
    opt.curr_step = 1
    g1, _, o = trainer.g_step(batch_from_numpy(tiny_batch(opt), "cpu"), EXTRA)
    trainer.d_step(batch_from_numpy(tiny_batch(opt), "cpu"), EXTRA, o)
    s2 = snapshot(model)
    same = lambda a, b, net: all(torch.equal(v, b[net][k]) for k, v in a[net].items())
    assert same(s1, s0, "netD") and not same(s1, s0, "netD2")
    assert not same(s2, s1, "netD") and same(s2, s1, "netD2")
    assert not same(s1, s0, "netG") and not same(s2, s1, "netG")
    assert tuple(g2) == STAGE2_TERMS
    assert "VGG" in g1 and "hairAvgLab" not in g1


def test_hair_avg_matches_jax(rng):
    x = rng.normal(size=(3, 8, 9, 4)).astype(np.float32)
    m = (rng.uniform(size=(3, 8, 9, 1)) > 0.5).astype(np.float32)
    m[1] = 0  # an empty mask divides by 1
    got = hair_avg(nchw(x), nchw(m))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_hair_avg(x, m)), **LOSS_TOL)


@pytest.mark.parametrize("balance", [False, True])
def test_hair_avg_lab_loss_matches_jax(rng, balance):
    """Value and gradient with respect to the fake, with and without
    --balance_Lab (data_assets/ab_count.npy)."""
    opt = tiny_opt(balance_Lab=balance)
    n, s = 3, 16
    fake, real = (rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32) for _ in range(2))
    mf, mr = ((rng.uniform(size=(n, s, s, 1)) > 0.4).astype(np.float32) for _ in range(2))
    ab = load_ab_count(AB_COUNT, "cpu")
    ft = nchw(fake).requires_grad_()
    got = hair_avg_lab_loss(ft, nchw(real), nchw(mf), nchw(mr), opt, ab)
    got.backward()
    j_ab = jnp.asarray(np.load(AB_COUNT).astype(np.float32))
    f = lambda fk: JL.hair_avg_lab_loss(fk, real, mf, mr, opt, j_ab)
    want, grad = jax.value_and_grad(f)(jnp.asarray(fake))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    g = np.asarray(grad)
    np.testing.assert_allclose(ft.grad.permute(0, 2, 3, 1).numpy(), g, rtol=1e-4,
                               atol=1e-4 * np.abs(g).max())
    plain = JL.hair_avg_lab_loss(fake, real, mf, mr, tiny_opt(), j_ab)
    assert (abs(float(plain) - float(want)) > 1e-3) == balance


@pytest.mark.parametrize("record", ["3,16,100", "3,16"])
def test_iter_counter_resumes_an_unpair_run_as_jax(tmp_path, record):
    """iter.txt of an --unpairTrain run, in the 3-column form and the
    reference's 2-column one (total steps rebuilt: two passes an epoch)."""
    kw = dict(isTrain=True, continue_train=True, unpairTrain=True, batchSize=2,
              checkpoints_dir=str(tmp_path), name="u", niter=5)
    os.makedirs(tmp_path / "u")
    (tmp_path / "u" / "iter.txt").write_text(record.replace(",", "\n") + "\n")
    ours = IterationCounter(Options(**kw).finalize(), 10)
    theirs = JCounter(JOptions(**kw).finalize(), 10)
    for a in ("first_epoch", "epoch_iter", "total_steps_so_far", "total_epochs"):
        assert getattr(ours, a) == getattr(theirs, a), a
    assert ours.total_steps_so_far == (100 if record.count(",") == 2 else 2 * 2 * 10 + 16)
    assert list(ours.training_epochs()) == list(theirs.training_epochs())


def demo_opts(**kw):
    d = dict(isTrain=True, crop_size=64, load_size=64, use_ig=True, unpairTrain=True,
             label_dir=os.path.join(DEMO, "labels"), image_dir=os.path.join(DEMO, "images"),
             orient_dir=os.path.join(DEMO, "orients"))
    d.update(kw)
    return Options(**d).finalize(), JOptions(**d).finalize()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stage2_loader_draws_the_ref_sample_as_jax(seed):
    """CustomDataset(opt, 2) on FFHQ_demo's three samples: for the same
    host seed, the ref label and image (of the sample the rng drew), the
    tag planes, the orientation planes and the noise equal the JAX loader's
    (its uint8 wire decoded)."""
    ours_opt, jax_opt = demo_opts()
    ours, theirs = CustomDataset(ours_opt, 2), JDataset(jax_opt, 2)
    for index in range(len(ours)):
        got = ours.get_sample(index, random.Random(seed * 10 + index))
        want = theirs.get_sample(index, random.Random(seed * 10 + index))
        assert sorted(got) == sorted(want)
        for k in ("label_ref", "label_tag", "hole", "orient", "orient_rgb", "noise"):
            np.testing.assert_array_equal(got[k], want[k].astype(np.float32), err_msg=k)
        for k in ("image_ref", "image_tag"):
            np.testing.assert_array_equal(got[k], want[k].astype(np.float32) / 127.5 - 1.0,
                                          err_msg=k)


def run_cli(tmp_path, module, *flags):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # as one_torch_thread
    code = BLOCK_JAX.replace('"michigan_tpu_torch.train"', repr(module)).replace(
        '["train"]', repr([module.rsplit(".", 1)[-1]]))
    proc = subprocess.run([sys.executable, "-c", code, *flags], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


CLI_FLAGS = ["--gpu_ids", "-1", "--name", "u", "--netG", "spadeb", "--use_encoder", "--use_ig",
             "--noise_background", "--random_expand_mask", "--ngf", "8", "--ndf", "8",
             "--crop_size", "64", "--load_size", "64", "--batchSize", "3", "--nThreads", "1",
             "--print_freq", "1", "--unpairTrain", "--same_netD_model", "--use_blender",
             "--use_vae", "--label_dir", os.path.join(DEMO, "labels"),
             "--image_dir", os.path.join(DEMO, "images"),
             "--orient_dir", os.path.join(DEMO, "orients")]


def test_trainer_cli_unpair_vae_blender_trains_saves_resumes_and_renders(tmp_path):
    """Each epoch runs the stage-2 pass then the stage-1 pass (a step each:
    the 3 samples at batch 3); the checkpoints hold net_E, net_B and net_D2
    and resume; the inference CLI restores netG, netE and netB and
    renders."""
    ck = tmp_path / "checkpoints"
    first = run_cli(tmp_path, "michigan_tpu_torch.train", *CLI_FLAGS, "--checkpoints_dir",
                    str(ck), "--niter", "1")
    steps = [line for line in first.splitlines() if line.startswith("(epoch: 1,")]
    assert len(steps) == 2 and first.strip().endswith("ok")
    assert "hairAvgLab" in steps[0] and "KLD" in steps[0] and "VGG" not in steps[0]
    assert "VGG" in steps[1] and "KLD" in steps[1] and "hairAvgLab" not in steps[1]
    for x in ("G", "D", "E", "B", "D2"):
        for label in ("1", "latest"):
            assert (ck / "u" / f"{label}_net_{x}.pth").exists(), (label, x)
    assert {"opt_G", "opt_D", "opt_D2", "step"} <= set(
        torch.load(ck / "u" / "latest_optim.pth", weights_only=True))
    second = run_cli(tmp_path, "michigan_tpu_torch.train", *CLI_FLAGS, "--checkpoints_dir",
                     str(ck), "--niter", "2", "--continue_train")
    assert "resumed checkpoint 'latest'" in second
    assert second.count("(epoch: 2,") == 2 and "(epoch: 1," not in second

    data = os.path.join(REPO, "datasets", "FFHQ_single")
    out = run_cli(tmp_path, "michigan_tpu_torch.inference", "--gpu_ids", "-1", "--netG",
                  "spadeb", "--use_encoder", "--noise_background", "--use_ig", "--use_vae",
                  "--use_blender", "--ngf", "8", "--crop_size", "64", "--load_size", "64",
                  "--data_dir", data, "--checkpoints_dir", str(ck), "--name", "u",
                  "--which_epoch", "latest")
    for net in ("netG", "netE", "netB"):
        assert f"loaded {net} from" in out, net
    from PIL import Image

    img = Image.open(tmp_path / "inference_samples" / "inpaint_fake_image.jpg")
    assert img.size == (64, 64)


def test_orientation_of_a_near_flat_blend_differs_only_at_near_ties(rng):
    """JAX's blender at its xavier gain-0.02 init gives a nearly flat image
    (16 samples); the port's bank (plain version) and JAX's direct bank
    conv give it the same (sin, cos) map within 1e-4 but at no more than
    0.1% of the pixels (5 of 65,536 here), where float64's two best
    responses tie within 1e-4 of the largest."""
    from michigan_tpu.models.blend import Blend2Generator as JBlend
    from michigan_tpu.ops.filters import cal_orientation_two_channel as j_orient
    from michigan_tpu_torch.ops.filters import cal_orientation_two_channel as p_orient

    opt = tiny_opt(use_blender=True, batchSize=16)
    b = tiny_batch(opt, seed=1, paired=False)
    mask = np.concatenate([1 - b["label_tag"], b["label_tag"]], axis=-1)
    args = [jnp.asarray(a) for a in (b["image_ref"], b["image_tag"], mask, b["noise"])]
    blend = JBlend(opt).apply(jax.jit(JBlend(opt).init)(jax.random.PRNGKey(0), *args), *args)
    blend = np.asarray(blend)
    assert blend.std() < 0.05
    want, _ = j_orient(jnp.asarray(blend), "gabor", None)
    got, _ = p_orient(torch.from_numpy(blend), "gabor", None)
    diff = np.abs(got.numpy() - np.asarray(want)).max(-1)
    off = diff > 1e-4
    assert off.mean() <= 1e-3, off.sum()
    # where they differ, float64's two best clamped responses tie within 1e-4
    # of the largest response
    from michigan_tpu_torch.ops.filters import bank, rgb_to_gray255

    gray = rgb_to_gray255(torch.from_numpy(blend).double()).permute(0, 3, 1, 2)
    res = torch.nn.functional.conv2d(gray, bank("gabor", "cpu").double().permute(3, 2, 0, 1),
                                     padding=8).clamp_min(0)
    top2 = res.topk(2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).numpy()
    assert (gap[off] <= 1e-4 * float(res.max())).all(), gap[off]
