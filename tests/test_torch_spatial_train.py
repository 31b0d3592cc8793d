"""Spatial sharding of training (michigan_tpu_torch/parallel/spatial.py,
training/train_step.py with a Space) on CPU ranks over gloo, against the
port's unsharded TrainStep and the JAX package's unsharded g_step and
d_step.

- the halo's float64 torch.autograd.gradcheck (zeros and reflection) of a
  function of the whole plane that every rank computes in lockstep, and
  for every conv case of tests/test_torch_spatial_ranks.py a stack of two
  band convs against the whole stack's input and weight gradients
  (GRAD_TOL of the largest gradient), and the band orientation loss (the
  bank on a band with its halo, its backward) on an image whose Gabor
  confidence is live, at P = 4 and P = 2 in one launch;
- one G step then one D step in row bands through TrainStep on the JAX
  test's options (tests/test_spatial_sharding.py: crop 64, ngf 8, ndf 8,
  batch 2, --random_expand_mask), with --no_vgg_loss at P = 4 and with
  the VGG tower at P = 2 (STEP_RANKS: one launch a config, so that each
  stays well inside its join timeout under the whole suite's load), from JAX's initial weights
  (carried over by ``state_dicts_from_flax``): against the port's
  unsharded step, per-term losses within PORT_RTOL (ORIENT ORIENT_TOL) and
  netG after the G step and netD after the D step by tests/test_training.py's
  scale-aware rule, and against the JAX package's, losses within the JAX
  test's own limit (JAX_TOL, ORIENT ORIENT_TOL, relative to 1 + |loss|)
  and the nets by the same rule calibrated on the port's unsharded step:
  at these sizes and JAX's init (xavier, gain 0.02) the port's own step
  already has 0.2-0.3% of netG's elements beyond float noise from JAX's
  at XLA's optimisation level 0 (near-zero gradients whose Adam sign
  flips), so the bands may have as many as it plus the rule's 0.1%.  Both D steps start from JAX's post-G
  netG, as tests/test_torch_training.py's does; every rank's nets equal
  rank 0's bit for bit after the step;
- two controls (with the VGG tower, P = 2), zeros in place of the
  neighbours' halo rows and each band's own batch-norm statistics, fail
  the losses' gate against both;
- ``train.py --mesh_shape space:2`` on two CPU ranks for one step, whose
  checkpoint one process loads; the data x space grid and --dtype bfloat16
  in bands raise NotImplementedError.

The JAX side runs as tests/test_torch_training.py's (MICHIGAN_FILTERBANK=
direct), its init and steps compiled at XLA's optimisation level 0.  Every
rank runs one torch thread with subnormals flushed.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_spatial_train_ranks as R
from michigan_tpu.config import Options
from michigan_tpu.training.state import TrainState
from michigan_tpu.training.train_step import make_train_steps
from michigan_tpu_torch.convert import state_dicts_from_flax
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.parallel import dist as DP
from michigan_tpu_torch.parallel.spatial import (
    Space,
    batch_spec,
    check_spatial_train,
    shard_batch,
    train_plane_plan,
)
from michigan_tpu_torch.train import parse_options as train_options
from michigan_tpu_torch.training import checkpoint as CK
from michigan_tpu_torch.training.state import learning_rates
from michigan_tpu_torch.training.train_step import TrainStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "datasets", "FFHQ_single")
# the JAX test's options (tests/test_spatial_sharding.py), with and without VGG
CONFIGS = {"no_vgg": {"no_vgg_loss": True}, "vgg": {}}
STEP_RANKS = {"no_vgg": 4, "vgg": 2}  # the ranks each config's step runs on
CONTROLLED = "vgg"  # the config whose controls run (at P = 2)
STEP_CASES = list(STEP_RANKS.items())
GRAD_TOL = 1e-5     # band gradients vs the whole layer's, of the largest gradient
PORT_RTOL = 1e-4    # the bands' losses vs the port's unsharded step
JAX_TOL = 1e-3      # vs the JAX package's step (its own spatial test's limit)
ORIENT_TOL = 2e-2   # ORIENT's argmax near-ties (the same test's limit)
O0 = {"xla_backend_optimization_level": 0}
JOIN_TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def one_thread_subnormals_flushed():
    n = torch.get_num_threads()
    flushed = torch.tensor([1e-39]).mul(1.0).item() == 0.0
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(flushed)
    torch.set_num_threads(n)


def jax_opt(**kw):
    d = dict(isTrain=True, crop_size=64, load_size=64, ngf=8, ndf=8, batchSize=2,
             use_encoder=True, use_ig=True, noise_background=True, random_expand_mask=True,
             donate_buffers=False, gpu_ids="-1")
    d.update(kw)
    return Options(**d).finalize()


def jax_batch(opt, seed=0):
    """tests/test_spatial_sharding.py's batch (paired: the ref is the tag, so
    the ref_is_tag gate keeps every term)."""
    r = np.random.default_rng(seed)
    n, s = opt.batchSize, opt.crop_size
    b = {"label_tag": r.integers(0, 2, (n, s, s, 1)), "image_tag": r.uniform(-1, 1, (n, s, s, 3)),
         "orient": r.uniform(0, 255, (n, s, s, 1)), "hole": r.integers(0, 2, (n, s, s, 1)),
         "orient_rgb": r.uniform(0, 1, (n, s, s, 3)), "noise": r.uniform(0, 1, (n, s, s, 3))}
    b["label_ref"], b["image_ref"] = b["label_tag"], b["image_tag"]
    return {k: v.astype(np.float32) for k, v in b.items()}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def params_of(model, net):
    return {k: v.detach().clone() for k, v in getattr(model, net).named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each config: JAX's G step then D step, the port's unsharded G step
    then D step (from JAX's post-G netG), and a launch of 4 ranks
    (R.steps): the band steps at P = 4 and P = 2, with the controls for
    CONTROLLED."""
    out = tmp_path_factory.mktemp("steps")
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MICHIGAN_FILTERBANK", "direct")
        mp.setenv("MICHIGAN_COMPILER_OPTIONS", "xla_backend_optimization_level=0")
        v0 = None
        for name, kw in CONFIGS.items():
            opt = jax_opt(**kw)
            data = jax_batch(opt)
            jb = {k: jnp.asarray(v) for k, v in data.items()}
            rng = jax.random.PRNGKey(0)
            jm, g_step, d_step = make_train_steps(opt)
            if v0 is None:  # the configs differ in their losses alone: one init for both
                v0 = jax.jit(jm.init_variables).lower(rng, jb).compile(
                    compiler_options=O0)(rng, jb)
            state1, gl, _, orient = g_step(TrainState.create(opt, v0), data, rng,
                                           jnp.asarray(R.EXTRA, jnp.int32))
            state2, dl = d_step(state1, data, rng, jnp.asarray(R.EXTRA, jnp.int32), orient=orient)
            states = state_dicts_from_flax(to_np(v0), opt)
            post_g = state_dicts_from_flax(to_np(state1.variables), opt)["netG"]
            jax_d = state_dicts_from_flax(to_np(state2.variables), opt)["netD"]
            # the port's unsharded step
            model = MichiGANModel(opt, "cpu")
            model.load_state_dicts(states)
            tr = TrainStep(model)
            batch = batch_from_numpy(data, "cpu")
            g, fake, port_orient = tr.g_step(batch, R.EXTRA)
            port = {"losses": {k: v.item() for k, v in g.items()}, "fake": fake,
                    "params": {"netG": params_of(model, "netG")}}
            model.netG.load_state_dict(post_g)
            d = tr.d_step(batch, R.EXTRA, port_orient)
            port["losses"].update({k: v.item() for k, v in d.items()})
            port["params"]["netD"] = params_of(model, "netD")
            names = {n: {k for k, _ in getattr(model, n).named_parameters()}
                     for n in ("netG", "netD")}
            jax_params = {"netG": {k: v for k, v in post_g.items() if k in names["netG"]},
                          "netD": {k: v for k, v in jax_d.items() if k in names["netD"]}}
            jax_losses = {k: float(v) for k, v in {**to_np(gl), **to_np(dl)}.items()}
            torch.save({"opt": opt, "states": states, "batch": batch, "post_g": post_g},
                       out / f"{name}.pt")
            res[name] = {"opt": opt, "port": port, "jax": {"losses": jax_losses,
                                                            "params": jax_params}}
    for name, p in STEP_RANKS.items():  # a launch a config, well inside its join timeout
        DP.launch(R.steps, (str(out), name, name == CONTROLLED), p, timeout=JOIN_TIMEOUT)
        ranks = [torch.load(out / f"steps_{name}{r}.pt", weights_only=False) for r in range(p)]
        res[name]["bands"] = {(p_, run): [rk[(name, p_, run)] for rk in ranks]
                              for (n, p_, run) in ranks[0] if n == name}
    return res


@pytest.fixture(scope="module")
def gradient_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("gradients")
    DP.launch(R.gradients, (str(out),), 4, timeout=JOIN_TIMEOUT)
    return [torch.load(out / f"gradients{r}.pt") for r in range(4)]


# ---------------------------------------------------------------------------
# the halo's adjoint and the band layers' gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [4, 2])
@pytest.mark.parametrize("case", [h[0] for h in R.HALOS])
def test_halo_gradcheck_float64(gradient_results, case, ranks):
    for r, res in enumerate(gradient_results):
        assert res[(case, ranks)] is True, r


@pytest.mark.parametrize("ranks", [4, 2])
@pytest.mark.parametrize("case", [c[0] for c in R.CONVS])
def test_band_conv_stack_gradients_match_the_whole(gradient_results, case, ranks):
    for r, res in enumerate(gradient_results):
        got = res[(case, ranks)]
        assert got["err_x"] <= GRAD_TOL * got["scale"], (r, got)
        assert got["err_w"] <= GRAD_TOL * got["scale"], (r, got)


@pytest.mark.parametrize("ranks", [4, 2])
def test_band_vgg19_gradients_match_the_whole_in_float64(gradient_results, ranks):
    for r, res in enumerate(gradient_results):
        got = res[("vgg19", ranks)]
        assert got["err"] <= 1e-10 * got["scale"], (r, got)


@pytest.mark.parametrize("ranks", [4, 2])
def test_band_orientation_loss_and_its_gradient(gradient_results, ranks):
    for r, res in enumerate(gradient_results):
        got = res[("orient_loss", ranks)]
        (sums, whole) = got["values"]
        np.testing.assert_allclose(sums, whole, rtol=1e-5)
        assert got["live"] > 0.5 and got["err"] <= GRAD_TOL * got["scale"], (r, got)


# ---------------------------------------------------------------------------
# the G and D steps in row bands
# ---------------------------------------------------------------------------

def loss_tol(k):
    return ORIENT_TOL if k == "ORIENT" else None


def losses_within(got, want, rtol, jax_form=False):
    """The keys whose losses lie outside the limit: rtol relative to |want|
    (plus 1e-5), or the JAX test's form, relative to 1 + |want|."""
    bad = []
    for k, w in want.items():
        tol = loss_tol(k) or rtol
        lim = tol * (1.0 + abs(w)) if jax_form else tol * abs(w) + 1e-5
        if not abs(got[k] - w) <= lim:
            bad.append((k, got[k], w))
    return bad


def beyond_noise(got, want, max_lr):
    """tests/test_training.py's scale-aware rule: (every element within 2.5
    max_lr, elements beyond float noise, elements)."""
    worst, n_bad, n_tot = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        worst = max(worst, d.max().item())
        n_bad += int((d > 1e-4 * w.double().abs() + 1e-5).sum())
        n_tot += d.numel()
    return worst <= 2.5 * max_lr, n_bad, n_tot


def assert_rule(got, want, opt, calibration=None):
    """The scale-aware rule on netG and netD; with `calibration` (another
    run's nets) the count beyond float noise may be that run's own count
    against `want` plus the rule's allowance."""
    g_lr, d_lr = learning_rates(opt, 1)
    for net, lr in (("netG", g_lr), ("netD", d_lr)):
        ok, n_bad, n_tot = beyond_noise(got[net], want[net], lr)
        own = beyond_noise(calibration[net], want[net], lr)[1] if calibration else 0
        assert ok and n_bad <= own + max(1e-3 * n_tot, 8), (net, n_bad, own, n_tot)


@pytest.mark.parametrize("config,ranks", STEP_CASES)
def test_band_step_matches_the_unsharded_port(runs, config, ranks):
    res = runs[config]
    port = res["port"]
    for r, band in enumerate(res["bands"][(ranks, "step")]):
        assert list(band["losses"]) == list(port["losses"])
        assert not losses_within(band["losses"], port["losses"], PORT_RTOL), r
        assert (band["fake"] - port["fake"]).abs().max().item() <= 1e-5
        assert_rule(band["params"], port["params"], res["opt"])


@pytest.mark.parametrize("config,ranks", STEP_CASES)
def test_band_step_matches_jax(runs, config, ranks):
    res = runs[config]
    band = res["bands"][(ranks, "step")][0]
    assert sorted(band["losses"]) == sorted(res["jax"]["losses"])
    assert not losses_within(band["losses"], res["jax"]["losses"], JAX_TOL, jax_form=True)
    assert_rule(band["params"], res["jax"]["params"], res["opt"], res["port"]["params"])


@pytest.mark.parametrize("config,ranks", STEP_CASES)
def test_ranks_stay_bit_identical(runs, config, ranks):
    bands = runs[config]["bands"][(ranks, "step")]
    assert all(b["identical"] for b in bands)
    for b in bands[1:]:
        assert b["losses"] == bands[0]["losses"]


@pytest.mark.parametrize("control", ["zero_halo", "local_stats"])
def test_controls_fail_the_gate(runs, control):
    res = runs[CONTROLLED]
    got = res["bands"][(2, control)][0]["losses"]
    g_terms = {k: v for k, v in res["port"]["losses"].items() if k in got}
    assert losses_within(got, g_terms, PORT_RTOL)
    jax_g = {k: v for k, v in res["jax"]["losses"].items() if k in got}
    assert losses_within(got, jax_g, JAX_TOL, jax_form=True)


# ---------------------------------------------------------------------------
# the trainer's CLI, shard_batch, the plans and what the path refuses
# ---------------------------------------------------------------------------

def test_trainer_cli_space_2_writes_a_checkpoint_one_process_loads(tmp_path):
    argv = ["--gpu_ids", "-1", "--name", "space2", "--netG", "spadeb", "--use_encoder",
            "--use_ig", "--noise_background", "--random_expand_mask", "--ngf", "8", "--ndf", "8",
            "--crop_size", "64", "--load_size", "64", "--batchSize", "1", "--niter", "1",
            "--niter_decay", "0", "--print_freq", "1", "--nThreads", "1", "--no_html",
            "--mesh_shape", "space:2", "--checkpoints_dir", str(tmp_path),
            "--label_dir", os.path.join(DATA, "val_labels"),
            "--image_dir", os.path.join(DATA, "val_images"),
            "--orient_dir", os.path.join(DATA, "val_dense_orients")]
    DP.launch(R.train_cli, (argv,), 2, timeout=JOIN_TIMEOUT)
    ck = tmp_path / "space2"
    assert (ck / "latest_net_G.pth").exists() and (ck / "1_net_D.pth").exists()
    log = (ck / "loss_log.txt").read_text()
    assert "GAN" in log and "D_real" in log
    opt = train_options([a for a in argv if a not in ("space:2", "--mesh_shape")])
    model = MichiGANModel(opt, "cpu")
    model.init_weights(opt.seed)
    before = params_of(model, "netG")
    tr = TrainStep(model)
    assert CK.load_checkpoint(opt, "latest", tr) and tr.step == 1
    after = params_of(model, "netG")
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.isfinite(v).all() for v in after.values())


def test_shard_batch_cuts_each_ranks_rows():
    x = torch.arange(2 * 3 * 8 * 5, dtype=torch.float32).view(2, 3, 8, 5)
    parts = [shard_batch({"image_tag": x}, Space(None, r, 4, torch.device("cpu")))["image_tag"]
             for r in range(4)]
    assert all(p.shape == (2, 3, 2, 5) and p.is_contiguous() for p in parts)
    assert torch.equal(torch.cat(parts, dim=2), x)
    assert batch_spec(Space(None, 0, 4, torch.device("cpu"))) == (None, None, "space", None)
    with pytest.raises(ValueError, match="do not divide into 3 bands"):
        shard_batch({"image_tag": x}, Space(None, 0, 3, torch.device("cpu")))


def test_train_plane_plan_names_netD_whole():
    opt = train_options("--netG spadeb --use_encoder --use_ig --noise_background "
                        "--random_expand_mask --num_upsampling_layers most --crop_size 1024 "
                        "--load_size 1136 --gpu_ids -1".split())
    plan = train_plane_plan(opt, 2)
    assert all(v.startswith("band") for v in plan["generator"].values())
    assert list(plan["generator"]) == [8 << i for i in range(8)]
    assert plan["vgg19"][64] == "band of 32 rows"
    assert "[[513, 257, 129, 130, 131], [257, 129, 65, 66, 67]]" in plan["netD"]


TRAIN_FLAGS = ("--netG spadeb --use_encoder --use_ig --noise_background --random_expand_mask "
               "--crop_size 64 --load_size 64 --ngf 8 --ndf 8 --gpu_ids -1").split()


def test_mesh_shapes():
    assert DP.mesh_axes("space:2") == (1, 2) and DP.mesh_axes("data:1,space:4") == (1, 4)
    assert DP.mesh_axes("data:-1") == (-1, 1) and DP.data_axis_size("space:2") == 1
    for grid in ("data:2,space:2", "space:2,data:4", "data:-1,space:2"):
        with pytest.raises(NotImplementedError, match="data x space grid .* next slice"):
            DP.mesh_axes(grid)


@pytest.mark.parametrize("added,what", [
    (["--dtype", "bfloat16"], "--dtype bfloat16 .bfloat16 in row bands is the next slice"),
    (["--use_vae"], "--use_vae"), (["--unpairTrain"], "--unpairTrain"),
    (["--remat"], "--remat"), (["--reuse_fake_for_d"], "--reuse_fake_for_d"),
    (["--orient_filter", "dog"], "--orient_filter dog"),
    (["--Image_encoder_mode", "norm"], "--Image_encoder_mode norm"),
])
def test_training_options_outside_the_path_raise(added, what):
    opt = train_options(TRAIN_FLAGS + added)
    with pytest.raises(NotImplementedError, match=what):
        check_spatial_train(opt, 2)
    with pytest.raises(NotImplementedError, match=what):
        TrainStep(MichiGANModel(opt, "cpu"), Space(None, 0, 2, torch.device("cpu")))


@pytest.mark.parametrize("crop,ranks,what", [
    (64, 8, r"--crop_size 64 / 8 to be a multiple of 16"),
    (96, 4, r"--crop_size 96 / 4 to be a multiple of 16 .*; it is 24"),
    (64, 1, r"at least 2 ranks"),
])
def test_misaligned_crops_raise(crop, ranks, what):
    opt = train_options(TRAIN_FLAGS + ["--crop_size", str(crop), "--load_size", str(crop)])
    with pytest.raises(ValueError, match=what):
        check_spatial_train(opt, ranks)


def test_data_parallel_model_with_a_space_raises():
    opt = train_options(TRAIN_FLAGS)
    model = MichiGANModel(opt, "cpu")
    model.group = object()  # a data-parallel group
    with pytest.raises(NotImplementedError, match="data x space grid"):
        TrainStep(model, Space(None, 0, 2, torch.device("cpu")))
