"""The port's VAE (--use_vae) and blender (--use_blender) configurations
against the JAX package's.

One G step then one D step of each config at the tiny training config of
tests/test_torch_training.py (crop 64, ngf 8, ndf 8, batch 2, `normal`
upsampling, --random_expand_mask, MICHIGAN_FILTERBANK=direct), from JAX's
initial weights carried over by `state_dicts_from_flax`, on the same seeded
paired batch; the VAE's eps is JAX's own draw for the step's rng:

- per-term losses within rtol 1e-4, atol 1e-5 (KLD first, as JAX orders
  them; under --use_blender every term judges the blend);
- netG and the config's own net (netE, netB) after the G step, netD after
  the D step (from JAX's post-G state), by the scale-aware rule of
  tests/test_training.py; the VAE's netG and netE, and the blender's
  netG and netB at torch's default init, pass instead, where the rule's
  count fails, by the float64 witness below;
- netE runs in eval mode as JAX applies it: its spectral u / v are never
  written; netIG and VGG19 stay bit-identical.

Then the pieces alone: kld_loss, the ConvEncoder forward and its bridge
round trip through the JAX package's convert_vae_encoder, the blender's
forward (with and without --hair_random_disturb; the transposed convs'
output_padding), inference of each config (and --only_blend) against JAX's
``infer`` with the same eps, --only_blend and --fix_netG in training, and
the refusals.  The float64 G step of chip_smoke.py's phase 16 witness
(tools/float64_step.py) is tested in
tests/test_torch_vae_blender_default_init.py.

JAX's variables come from one jitted init of a config with both nets; the
blender config's netG swaps the VAE's Linear seed for an init of the
partial-conv encoder alone.  The blender's G step is also held at torch's
default init (``blender_default_init``, its own JAX init, in
tests/test_torch_vae_blender_default_init.py), where it flips the sign of
Adam's first update at 0.10-0.15% of netG's elements, all at near-zero
gradients, against the rule's 0.1%.

The float64 witness (tools/float64_step.py; chip_smoke.py's phase 16 uses
its plain form).  Adam's first step moves each element by +-lr by its
gradient's sign, so where the gradient lies within the step's rounding
error the two frameworks' signs differ at random, and the count reads the
step's conditioning, not the port.  The VAE's step is ill-conditioned at
one element: a ReLU of VGG19's relu3_1 on the fake whose pre-activation
lies within float32 rounding of zero; the port's float32 sums take it,
and the sign of the VGG term's L1 there, on the other side than float64,
JAX's on float64's, and that one element moves netG's gradient by 2.75e-3
and netE's by 3.62e-3 relative to float64 (JAX's float32 1.57e-6 and
2.27e-6), which flips 10,554 of netG's 4,459,467 elements (on some CPUs
the sums land on float64's side and the count passes).  So the witness holds each float32 gradient to a float64 G step
of the same weights, batch and eps: the port's against the float64 step on
the port's float32 branches (``branch_masks``: every ReLU, leaky ReLU,
max-pool window and |.| decided as the float32 step decided), JAX's (read
back from its Adam state) against the float64 step as it runs; the
port's error must be at most F64_CAL times JAX's.  The replay may absorb
rounding flips alone: at most MAX_FLIPS of the step's choices differ from
float64's, each within MAX_FLIP_ULPS float32 ulps of its switch
(``branch_margins``).  A control, the port's G step on the first sample
only, must fail the witness.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu import losses as JL
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.models.blend import Blend2Generator as JBlend
from michigan_tpu.models.encoders import ConvEncoder as JEncoder
from michigan_tpu.models.encoders import ImageEncoder3 as JImageEncoder3
from michigan_tpu.training.convert import convert_vae_encoder
from michigan_tpu.training.state import TrainState
from michigan_tpu.training.train_step import make_train_steps
from michigan_tpu_torch import model as port_model
from michigan_tpu_torch.convert import (
    B_RENAMES,
    B_TRANSPOSED,
    E_RENAMES,
    module_state_dict,
    state_dicts_from_flax,
)
from michigan_tpu_torch.losses.color import kld_loss
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.models.blend import Blend2Generator
from michigan_tpu_torch.models.encoders import ConvEncoder
from michigan_tpu_torch.tools import float64_step
from michigan_tpu_torch.training.train_step import TrainStep
from tests.test_torch_training import (
    EXTRA,
    G_TERMS,
    LOSS_TOL,
    assert_losses,
    assert_params_scale_aware,
    count_beyond_noise,
    tiny_batch,
    tiny_opt,
    to_np,
    within_count,
)

# the config's own init (xavier, gain 0.02), as tests/test_torch_training.py;
# --hair_random_disturb is held in the blender's forward test: on this
# batch's pixel-noise labels its edge band covers every pixel, and the blend
# would not depend on the fake
CONFIGS = {"vae": dict(use_vae=True), "blender": dict(use_blender=True)}
# the G step alone is also held at torch's default init (the blender), in
# tests/test_torch_vae_blender_default_init.py: a file of its own, with its
# own JAX init, so that the two files' JAX work runs in two workers
G_CASES = dict(CONFIGS)
OWN_NET = {"vae": "netE", "blender": "netB", "blender_default_init": "netB"}
# the cases whose netG and own net may pass by the float64 witness, and
# how much farther from float64 the port's gradient may lie than JAX's
# (chip_smoke.py's phase-16 F64_CAL)
WITNESSED = ("vae",)
F64_CAL = 2.0
# the float64 step replays the port's float32 branches only where float32's
# rounding can flip them: at most this many choices of the step (of ~5e7)
# differ from the float64 step's own, each within this many float32 ulps of
# its call's largest input of the switch (branch_margins; measured at most
# 30 choices and 4.8 ulps for vae, 42 and 48.8 for blender_default_init, in
# the frozen IG's and VGG19's ReLUs and one |.| of the VGG term)
MAX_FLIPS, MAX_FLIP_ULPS = 128, 128.0


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


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_init(opt, batch, rng):
    return to_np(jax.jit(JModel(opt).init_variables)(
        rng, {k: jnp.asarray(v) for k, v in batch.items()}))


def plain_netg(opt, v_netg, batch):
    """The VAE config's netG variables with the partial-conv encoder in
    place of z's Linear: the blender config's netG.  Flax derives each
    submodule's init from its path, so every other subtree is what a
    full init of the blender config gives."""
    pre = JModel(opt).preprocess({k: jnp.asarray(v) for k, v in batch.items()})
    enc = JImageEncoder3(opt, *opt.latent_size())
    fc = jax.jit(enc.init)(jax.random.PRNGKey(5), pre["image_ref"], pre["input_ref"][..., 1:2],
                           pre["input_tag"][..., 1:2])
    return {**v_netg, "params": {**v_netg["params"], "fc": to_np(fc["params"])}}


def adam_mu(opt_state):
    """JAX's G-step gradient: optax's Adam first moment after one step with
    TTUR's b1 = 0 is the gradient itself."""
    (mu,) = [s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return to_np(mu)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's initial variables of each config, its G step (with its
    gradient) then D step, the blender's G step at torch's default init,
    and the VAE's eps of the step's rng."""
    rng = jax.random.PRNGKey(0)
    both = tiny_opt(**{**CONFIGS["vae"], **CONFIGS["blender"]})
    batch = tiny_batch(both)
    v_all = jax_init(both, batch, rng)
    g_plain = plain_netg(tiny_opt(**CONFIGS["blender"]), v_all["netG"], batch)
    out = {"batch": batch, "eps": np.asarray(jax.random.normal(rng, (both.batchSize, 256)))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MICHIGAN_FILTERBANK", "direct")
        for name, kw in CONFIGS.items():
            opt = tiny_opt(**kw)
            v0 = {k: v for k, v in v_all.items() if k != {"vae": "netB", "blender": "netE"}[name]}
            if name == "blender":
                v0["netG"] = g_plain
            _, g_step, d_step = make_train_steps(opt)
            state0 = TrainState.create(opt, v0)
            extra = jnp.asarray(EXTRA, jnp.int32)
            state1, g_losses, _fake, orient = g_step(state0, batch, rng, extra)
            state2, d_losses = d_step(state1, batch, rng, extra, orient=orient)
            out[name] = dict(opt=opt, v0=v0, v1=to_np(state1.variables),
                             v2=to_np(state2.variables), g_losses=to_np(g_losses),
                             d_losses=to_np(d_losses), grads=adam_mu(state1.opt_g_state))
    return out


def jax_g_step(opt, batch, rng):
    """JAX's initial variables of `opt` (its own jitted init) and its G
    step (with its gradient), under MICHIGAN_FILTERBANK=direct."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MICHIGAN_FILTERBANK", "direct")
        v0 = jax_init(opt, batch, rng)
        _, g_step, _ = make_train_steps(opt)
        state1, _, _, _ = g_step(TrainState.create(opt, v0), batch, rng,
                                 jnp.asarray(EXTRA, jnp.int32))
    return dict(opt=opt, v0=v0, v1=to_np(state1.variables), grads=adam_mu(state1.opt_g_state))


def port_model_from(opt, variables):
    model = MichiGANModel(opt, "cpu")
    model.load_state_dicts(state_dicts_from_flax(variables, opt))
    return model


def snapshot(model):
    return {name: {k: v.detach().clone() for k, v in net.state_dict().items()}
            for name, net in model.nets().items()}


def port_g_step(jax_runs, name):
    """The port's G step of case `name` from JAX's initial variables, on
    float64_step.branch_masks: (its run, the trainer, the batch, orient)."""
    run = jax_runs[name]
    eps = torch.from_numpy(jax_runs["eps"])
    batch = batch_from_numpy(jax_runs["batch"], "cpu")
    model = port_model_from(run["opt"], run["v0"])
    trainer = TrainStep(model)
    s0 = snapshot(model)
    with float64_step.branch_masks() as branches:
        g_losses, fake, orient = trainer.g_step(batch, EXTRA, eps)
    grads = float64_step.adam_grads(trainer, ("netG", OWN_NET[name]))
    out = dict(s0=s0, s1=snapshot(model), model=model, branches=branches, grads=grads,
               g_losses=g_losses, fake=fake)
    return out, trainer, batch, orient


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    out = {}
    eps = torch.from_numpy(jax_runs["eps"])
    for name in G_CASES:
        run = jax_runs[name]
        out[name], trainer, batch, orient = port_g_step(jax_runs, name)
        model = out[name]["model"]
        d_losses = trainer.d_step(batch, EXTRA, orient)  # the G step's eps
        s2 = snapshot(model)
        from_jax_g = TrainStep(port_model_from(run["opt"], run["v1"]))
        d_from_jax_g = from_jax_g.d_step(batch, EXTRA, eps=eps)
        out[name].update(s2=s2, d_losses=d_losses, d_from_jax_g=d_from_jax_g,
                         s2_from_jax_g=snapshot(from_jax_g.model))
    return out


def witness_of(jax_runs, port_runs, witnessed):
    """{case: {net: gradient errors relative to float64}} of the `witnessed`
    cases' G steps: 'plain' the port's float32 step against the float64
    step as it runs, 'port' against the float64 step on its branches, 'jax' JAX's float32 step against the float64 step as
    it runs, 'control' the port's step on the first sample only against the
    former float64 step."""
    out = {}
    eps = torch.from_numpy(jax_runs["eps"])
    batch = batch_from_numpy(jax_runs["batch"], "cpu")
    for name in witnessed:
        run, port = jax_runs[name], port_runs[name]
        opt, nets = run["opt"], ("netG", OWN_NET[name])
        init = state_dicts_from_flax(run["v0"], opt)
        inputs64 = []
        with float64_step.branch_masks(inputs=inputs64) as exact_branches:
            _, exact, _ = float64_step.g_step64(opt, init, batch, eps, nets, EXTRA)
        _, on_branches, _ = float64_step.g_step64(opt, init, batch, eps, nets, EXTRA,
                                                  branches=port["branches"])
        half = TrainStep(port_model_from(opt, run["v0"]))
        half.g_step({k: v[:1] for k, v in batch.items()}, EXTRA, eps[:1])
        control = float64_step.adam_grads(half, nets)
        jax_grads = state_dicts_from_flax(
            {net: {**run["v0"][net], "params": run["grads"][net]} for net in nets}, opt)
        errors = {net: dict(
            plain=float64_step.rel_err(port["grads"][net], exact[net]),
            port=float64_step.rel_err(port["grads"][net], on_branches[net]),
            jax=float64_step.rel_err({k: jax_grads[net][k] for k in exact[net]}, exact[net]),
            control=float64_step.rel_err(control[net], on_branches[net])) for net in nets}
        out[name] = dict(errors=errors, branches=float64_step.branch_margins(
            port["branches"], exact_branches, inputs64))
        del inputs64
        # what `pytest -s -k witness` shows: the witness's numbers, and the
        # branches the port's float32 step took apart from float64's
        print(f"\n{name}: {out[name]}")
    return out


@pytest.fixture(scope="module")
def witness_runs(jax_runs, port_runs):
    return witness_of(jax_runs, port_runs, WITNESSED)


def jax_sd(jax_runs, name, key, net):
    return state_dicts_from_flax(jax_runs[name][key], jax_runs[name]["opt"])[net]


def params_of(state, net):
    names = {k for k, _ in net.named_parameters()}
    return {k: v for k, v in state.items() if k in names}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_g_step_losses_match_jax(jax_runs, port_runs, name):
    got = port_runs[name]["g_losses"]
    assert tuple(got) == (("KLD",) if name == "vae" else ()) + G_TERMS
    assert_losses(got, jax_runs[name]["g_losses"])
    assert all(float(v) != 0 for k, v in got.items() if k != "CONFIDENCE")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_d_step_losses_match_jax(jax_runs, port_runs, name):
    assert tuple(port_runs[name]["d_from_jax_g"]) == ("D_Fake", "D_real")
    assert_losses(port_runs[name]["d_from_jax_g"], jax_runs[name]["d_losses"])
    assert_losses(port_runs[name]["d_losses"], jax_runs[name]["d_losses"])


@pytest.mark.parametrize("name", list(G_CASES))
def test_g_step_updates_netg_and_own_net_as_jax(request, jax_runs, port_runs, name):
    check_g_step_updates(request, jax_runs, port_runs, name, WITNESSED)


def check_g_step_updates(request, jax_runs, port_runs, name, witnessed):
    """netG and netE (netB) by the scale-aware rule at G's rate (in the
    `witnessed` cases its count, where it fails, by the float64 witness); most
    of each net's elements moved; netD untouched by the G step."""
    model, run = port_runs[name]["model"], port_runs[name]
    lr = jax_runs[name]["opt"].lr
    for net in ("netG", OWN_NET[name]):
        want = params_of(jax_sd(jax_runs, name, "v1", net), model.nets()[net])
        got = params_of(run["s1"][net], model.nets()[net])
        if name not in witnessed:
            assert_params_scale_aware(got, want, lr / 2)
        else:
            n_bad, n_tot = count_beyond_noise(got, want, lr / 2)
            if not within_count(n_bad, n_tot):
                witness = request.getfixturevalue("witness_runs")[name]
                err = witness["errors"][net]
                assert err["port"] <= F64_CAL * err["jax"], \
                    f"{net}: {n_bad}/{n_tot} elements beyond float noise, and gradient " \
                    f"error {err['port']:.2e} > {F64_CAL:g} x JAX's {err['jax']:.2e}"
                flips = witness["branches"]
                assert sum(f[3] for f in flips) <= MAX_FLIPS, flips
                assert all(f[4] <= MAX_FLIP_ULPS for f in flips), flips
        moved = sum(int((run["s1"][net][k] != run["s0"][net][k]).sum()) for k in want)
        assert moved > 0.5 * sum(v.numel() for v in want.values()), net
    for k, v in run["s1"]["netD"].items():
        assert torch.equal(v, run["s0"]["netD"][k]), k


@pytest.mark.parametrize("name", WITNESSED)
def test_half_batch_control_fails_the_float64_witness(witness_runs, name):
    check_half_batch_control(witness_runs, name)


def check_half_batch_control(witness_runs, name):
    """The witness can fail: the port's G step on the first sample alone
    lies farther from the float64 step than F64_CAL x JAX's error, in each
    net."""
    for net, err in witness_runs[name]["errors"].items():
        assert err["control"] > F64_CAL * err["jax"], (net, err)
        assert err["jax"] < 1e-2 and err["control"] > 0.1, (net, err)


def test_branch_margins_measure_the_distance_from_the_switch():
    """branch_margins of a float32 record against a float64 one: the choices
    that differ, and the float64 input's distance from the switch there in
    float32 ulps of the call's largest input (|x| for a relu or an abs; for
    a max pool, the window's maximum less the element float32 took)."""
    ulp = float(torch.finfo(torch.float32).eps)
    x64 = torch.tensor([[[[4.0, -3 * ulp, 1.0, 0.5]]]], dtype=torch.float64)
    x32 = x64.float()
    x32[0, 0, 0, 1] = 1e-9  # a flip across the relu's switch and the abs's sign
    x32[0, 0, 0, 3] = 2.0  # and the pool's choice in the second window
    records = {}
    for name, x in (("f32", x32), ("f64", x64)):
        inputs = []
        with float64_step.branch_masks(inputs=inputs) as records[name]:
            torch.nn.functional.relu(x)
            torch.nn.functional.max_pool2d(x, (1, 2))
            x.abs()
        records[name + "_inputs"] = inputs
    got = float64_step.branch_margins(records["f32"], records["f64"], records["f64_inputs"])
    assert [g[:4] for g in got] == [(0, "relu", (1, 1, 1, 4), 1),
                                    (1, "max_pool", (1, 1, 1, 2), 1),
                                    (2, "abs", (1, 1, 1, 4), 1)]
    for (_, _, _, _, margin), want in zip(got, (3 * ulp / (4 * ulp), 0.5 / (4 * ulp),
                                                3 * ulp / (4 * ulp))):
        assert margin == pytest.approx(want, rel=1e-12)
    assert float64_step.branch_margins(records["f64"], records["f64"],
                                       records["f64_inputs"]) == []


@pytest.mark.parametrize("name", list(CONFIGS))
def test_d_step_updates_netd_as_jax(jax_runs, port_runs, name):
    model, run = port_runs[name]["model"], port_runs[name]
    want = params_of(jax_sd(jax_runs, name, "v2", "netD"), model.netD)
    assert_params_scale_aware(params_of(run["s2_from_jax_g"]["netD"], model.netD), want,
                              2 * jax_runs[name]["opt"].lr)
    for net in ("netG", OWN_NET[name]):  # the D step trains netD alone
        for k, v in run["s2"][net].items():
            assert torch.equal(v, run["s1"][net][k]), (net, k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_buffers_and_frozen_nets_as_jax(jax_runs, port_runs, name):
    """netG's buffers after the G step as JAX writes them; netE's spectral
    u / v and netD's never written; netIG and VGG19 bit-identical."""
    run = port_runs[name]
    want = jax_sd(jax_runs, name, "v1", "netG")
    for k, v in run["s1"]["netG"].items():
        if k.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
            torch.testing.assert_close(v, want[k], rtol=0, atol=1e-5, msg=k)
    for net in ("netE", "netD") if name == "vae" else ("netD",):
        for k, v in run["s2"][net].items():
            if k.endswith(("weight_u", "weight_v")):
                assert torch.equal(v, run["s0"][net][k]), (net, k)
                torch.testing.assert_close(jax_sd(jax_runs, name, "v2", net)[k], v,
                                           rtol=0, atol=0)
    for net in ("netIG", "vgg"):
        for k, v in run["s2"][net].items():
            assert torch.equal(v, run["s0"][net][k]), (net, k)


def test_kld_loss_matches_jax(rng):
    mu = rng.normal(0, 1.5, (3, 256)).astype(np.float32)
    logvar = rng.normal(0, 1, (3, 256)).astype(np.float32)
    got = kld_loss(torch.from_numpy(mu), torch.from_numpy(logvar))
    np.testing.assert_allclose(float(got), float(JL.kld_loss(mu, logvar)), **LOSS_TOL)


@pytest.mark.parametrize("crop", [64, 256])
def test_conv_encoder_and_its_bridge_round_trip(rng, crop):
    """JAX's ConvEncoder init through state_dicts_from_flax: the same
    (mu, logvar) (5 layers below a 256^2 crop, 6 from it); the port's
    state_dict back through convert_vae_encoder gives JAX's variables."""
    opt = tiny_opt(use_vae=True, crop_size=crop, load_size=crop)
    x = rng.uniform(-1, 1, (2, crop, crop, 3)).astype(np.float32)
    variables = to_np(jax.jit(JEncoder(opt).init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    net = ConvEncoder(opt).eval()
    net.load_state_dict(module_state_dict(variables, E_RENAMES), strict=True)
    assert net.n_layers == (6 if crop >= 256 else 5)
    with torch.no_grad():
        mu, logvar = net(nchw(x))
    j_mu, j_logvar = JEncoder(opt).apply(variables, jnp.asarray(x))
    for got, want in ((mu, j_mu), (logvar, j_logvar)):
        assert got.shape == (2, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    back = convert_vae_encoder(net.state_dict(), opt)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    want, got = flat(variables), flat(back)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=str(k))


@pytest.mark.parametrize("disturb", [False, True])
def test_blender_forward_matches_jax(rng, disturb):
    """Blend2Generator through the bridge (its three transposed convs with
    output_padding 1 give JAX's sizes exactly): the same blend, with and
    without --hair_random_disturb's noise band."""
    opt = tiny_opt(use_blender=True, hair_random_disturb=disturb)
    n, s = 2, 64
    hair, bg = (rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32) for _ in range(2))
    mask = np.zeros((n, s, s, 2), np.float32)
    mask[:, 16:48, 12:40, 1] = 1
    mask[..., 0] = 1 - mask[..., 1]
    noise = rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32)
    args = [jnp.asarray(a) for a in (hair, bg, mask, noise)]
    variables = to_np(jax.jit(JBlend(opt).init)(jax.random.PRNGKey(2), *args))
    net = Blend2Generator(opt)
    net.load_state_dict(module_state_dict(variables, B_RENAMES, B_TRANSPOSED), strict=True)
    got = net(*(nchw(a) for a in (hair, bg, mask, noise)))
    want = np.asarray(JBlend(opt).apply(variables, *args, train=True))
    assert got.shape == (n, 3, s, s)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=2e-5)
    other = np.asarray(JBlend(dataclasses.replace(opt, hair_random_disturb=not disturb))
                       .apply(variables, *args))
    assert np.abs(other - want).max() > 1e-3  # the band matters


@pytest.mark.parametrize("name", ["vae", "blender", "only_blend"])
def test_inference_matches_jax_infer(jax_runs, name):
    """Each config's ``infer`` (the blend under --use_blender, of the ref
    image under --only_blend) against JAX's with the same eps, on the
    training runs' initial variables without the IG, within rtol 1e-4 and
    1e-5 of the image's largest magnitude (xavier gain 0.02 makes outputs
    small); under --use_vae another eps gives another image."""
    kw = {"vae": CONFIGS["vae"], "blender": CONFIGS["blender"],
          "only_blend": dict(CONFIGS["blender"], only_blend=True)}[name]
    opt = tiny_opt(isTrain=False, use_ig=False, **kw)
    v0 = jax_runs["vae" if name == "vae" else "blender"]["v0"]
    variables = {k: v0[k] for k in ("netG", "netE", "netB") if k in v0}
    batch = tiny_batch(opt, seed=3, paired=False)
    rng = jax.random.PRNGKey(0)
    want, _ = jax.jit(lambda v, b: JModel(opt).infer(v, b, rng=rng))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(want)
    model = port_model_from(opt, variables)
    got, _ = model.infer(batch_from_numpy(batch, "cpu"), eps=torch.from_numpy(jax_runs["eps"]))
    scale = np.abs(want).max()
    assert got.shape == (opt.batchSize, 3, 64, 64) and torch.isfinite(got).all()
    assert want.std() > 0.1 * scale  # not a constant image
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-5 * scale)
    if name == "vae":
        other, _ = model.infer(batch_from_numpy(batch, "cpu"))
        assert (other - got).abs().max() > 1e-2 * scale


def test_only_blend_trains_the_blender_alone():
    """--only_blend --use_blender in training, as the JAX package's step:
    netB blends the ref image and trains; netG runs nowhere and stays."""
    opt = tiny_opt(use_blender=True, only_blend=True, use_ig=False)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    trainer = TrainStep(model)
    s0 = snapshot(model)
    g_losses, fake, orient = trainer.g_step(batch_from_numpy(tiny_batch(opt), "cpu"), EXTRA)
    d_losses = trainer.d_step(batch_from_numpy(tiny_batch(opt), "cpu"), EXTRA, orient)
    s1 = snapshot(model)
    assert fake is None
    assert all(np.isfinite(float(v)) for v in {**g_losses, **d_losses}.values())
    assert all(torch.equal(v, s0["netG"][k]) for k, v in s1["netG"].items())
    assert any(not torch.equal(v, s0["netB"][k]) for k, v in s1["netB"].items())
    assert any(not torch.equal(v, s0["netD"][k]) for k, v in s1["netD"].items())


@pytest.mark.parametrize("kw", [dict(use_vae=True), {}])
def test_fix_netg_keeps_netg_out_of_gs_optimizer(kw):
    """--fix_netG: G's Adam trains the JAX package's g_net_names without
    netG (netE under --use_vae; nothing, and no optimizer, alone); netG
    stays, D still trains."""
    opt = tiny_opt(fix_netG=True, use_ig=False, **kw)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    trainer = TrainStep(model)
    assert (trainer.optimizers["G"] is None) == (not kw)
    s0 = snapshot(model)
    _, _, orient = trainer.g_step(batch_from_numpy(tiny_batch(opt), "cpu"), EXTRA)
    trainer.d_step(batch_from_numpy(tiny_batch(opt), "cpu"), EXTRA, orient)
    s1 = snapshot(model)
    moved = {k: any(not torch.equal(v, s0[k][n]) for n, v in s1[k].items()
                    if n in dict(model.nets()[k].named_parameters())) for k in s1}
    assert not moved["netG"] and moved["netD"] and moved.get("netE", True)


def test_refusals_name_their_flags():
    """--only_blend where the JAX package returns no image or fails, and
    --use_blender with the padded generator planes are refused by name;
    every config builds under float32 and (since they were ported under
    the bf16 policy) under --dtype bfloat16."""
    for kw in (dict(use_vae=True), dict(use_blender=True), dict(unpairTrain=True, curr_step=2),
               dict(use_blender=True, only_blend=True)):
        opt = tiny_opt(**kw)
        port_model.check_supported(opt)
        port_model.check_supported(dataclasses.replace(opt, dtype="bfloat16"))
        port_model.check_supported(dataclasses.replace(opt, dtype="bfloat16", isTrain=False))
    with pytest.raises(NotImplementedError, match="--only_blend without --use_blender"):
        port_model.check_supported(tiny_opt(only_blend=True))
    with pytest.raises(NotImplementedError, match="--only_blend with --unpairTrain"):
        port_model.check_supported(tiny_opt(use_blender=True, only_blend=True,
                                            unpairTrain=True))
    with pytest.raises(NotImplementedError, match="--use_blender with --add_feat_zeros"):
        port_model.check_supported(tiny_opt(use_blender=True, add_feat_zeros=True))
    with pytest.raises(NotImplementedError, match="--curr_step 3"):
        port_model.check_supported(tiny_opt(unpairTrain=True, curr_step=3))
