"""The VAE, blender and unpaired two-stage configs under the bf16 compute
policy (--dtype bfloat16) against the JAX package's, on the CPU, at the tiny
training config of tests/test_torch_training.py (crop 64, ngf 8, ndf 8,
batch 2).

- One bf16 G step then one D step per config: the VAE (vae) and the
  unpaired stage 2 (unpair2, netD2) here, the blender and --only_blend in
  tests/test_torch_bf16_configs_blender.py.  Both packages start from the
  same float32 numpy weights (the port's seeded init at the config's own
  --init_type, carried to JAX by the JAX package's converters, netB by
  ``flax_blender``), on the same seeded batch whose hair labels are blobs
  (on pixel-noise labels --hair_random_disturb's band covers every pixel);
  the VAE's eps is JAX's draw for the step's rng.  JAX runs its default
  bank path (s2d), whose bf16 forward is the port's bf16-operand bank.  The
  D steps start from JAX's post-G netG (netE, netB).
- The gate is tests/test_torch_bf16_training.py's: port-bf16 vs JAX-bf16
  at most CAL = 2 x JAX-bf16 vs the port's float32 step (which
  tests/test_torch_vae_blender.py and tests/test_torch_unpair.py hold to
  JAX's float32 step), per loss, and per net (netG, netE, netB, netD /
  netD2) the count of elements beyond float noise of the scale-aware rule.
- Controls: each config's bf16 G step on the first of the two samples must
  fail the loss gate.

Every config runs at its own init (xavier, gain 0.02), as
tests/test_torch_bf16_training.py holds the paired step: at torch's default
init bf16 rounding in either framework moves these steps' scalar losses
and gradients by more than this gate can tell from a fault
(tests/test_torch_bf16_configs_blender.py says by how much).  JAX compiles
one G step and one D step per config (~30 s each here); the port runs in
one torch thread.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu.training.convert import (
    conv_w,
    convert_discriminator,
    convert_generator,
    convert_inpaint,
    convert_vae_encoder,
    convert_vgg19,
    convT_w,
)
from michigan_tpu.training.state import TrainState
from michigan_tpu.training.train_step import make_train_steps
from michigan_tpu_torch.convert import B_RENAMES, B_TRANSPOSED, module_state_dict
from michigan_tpu_torch.convert import state_dicts_from_flax
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.training.state import init_netd2_from_netd
from michigan_tpu_torch.training.train_step import TrainStep
from tests.test_torch_bf16_training import CAL, beyond_noise, loss_gate
from tests.test_torch_training import EXTRA, tiny_batch, tiny_opt

CONFIGS = {"vae": dict(use_vae=True),
           "unpair2": dict(unpairTrain=True, curr_step=2, same_netD_model=True)}
B_TRANSPOSED_NAMES = {p[0] for p in B_TRANSPOSED}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here in one thread, restored after the module:
    beside the other workers of a parallel run, torch's pool of a thread a
    core waits on its barriers for cores the others hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config_opt(kw, **more):
    return tiny_opt(**{**kw, **more})


def blob_batch(opt, seed=0, paired=True):
    """tiny_batch's batch with each sample's hair label (and, unpaired, the
    ref's) an ellipse at a seeded place, so that the hair has an edge band."""
    b = tiny_batch(opt, seed, paired)
    n, s = opt.batchSize, opt.crop_size
    yy, xx = np.mgrid[:s, :s]
    rng = np.random.default_rng(seed + 100)

    def blobs():
        out = []
        for _ in range(n):
            cy, cx = rng.uniform(0.35, 0.65, 2) * s
            ry, rx = rng.uniform(0.15, 0.3, 2) * s
            out.append(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)
        return np.stack(out)[..., None].astype(np.float32)

    b["label_tag"] = blobs()
    b["label_ref"] = b["label_tag"] if paired else blobs()
    return b


def flax_blender(sd):
    """The port's netB state_dict -> the JAX package's Blend2Generator
    variables (the inverse of module_state_dict with B_RENAMES)."""
    params = {}
    for key, w in sd.items():
        *mods, leaf = key.split(".")
        path = []
        while mods:
            m = mods.pop(0)
            path.append(f"{m}_{mods.pop(0)}" if m == "model_middle" else m)
        node = params
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "bias":
            node["bias"] = w.numpy()
        else:
            node["kernel"] = convT_w(w) if path[0] in B_TRANSPOSED_NAMES else conv_w(w)
    return {"params": params}


def jax_variables(sd, opt):
    """The JAX package's variables of every net of `sd` (the port's float32
    state_dicts)."""
    vgg = {k.removeprefix("features."): v for k, v in sd["vgg"].items()}
    out = {"netG": convert_generator(sd["netG"], opt), "netD": convert_discriminator(sd["netD"], opt),
           "netIG": convert_inpaint(sd["netIG"]), "vgg": convert_vgg19(vgg)}
    if "netD2" in sd:
        out["netD2"] = convert_discriminator(sd["netD2"], opt)
    if "netE" in sd:
        out["netE"] = convert_vae_encoder(sd["netE"], opt)
    if "netB" in sd:
        out["netB"] = flax_blender(sd["netB"])
    return out


def snapshot(model):
    return {name: {k: v.detach().clone() for k, v in net.state_dict().items()}
            for name, net in model.nets().items()}


def floats(losses):
    return {k: float(v) for k, v in losses.items()}


def g_nets(opt):
    """The nets of the G step's optimizer (training/state.py g_net_names)."""
    return ([] if opt.only_blend else ["netG"]) + ["netE"] * opt.use_vae + \
        ["netB"] * opt.use_blender


def run_config(kw, seed=0):
    """JAX's bf16 G step then D step of one config; the port's bf16 and
    float32 G steps from the same weights and D steps from JAX's post-G
    G-side nets; the port's bf16 G step on the first sample alone."""
    opt32, opt16 = config_opt(kw), config_opt(kw, dtype="bfloat16")
    init = MichiGANModel(opt32, "cpu")
    init.init_weights(0)
    if opt32.unpairTrain:
        init_netd2_from_netd(init)
    sd = snapshot(init)
    batch = blob_batch(opt16, seed, paired=not opt16.unpairTrain)
    rng, extra = jax.random.PRNGKey(0), jnp.asarray(EXTRA, jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MICHIGAN_FILTERBANK", raising=False)  # the s2d bank: fwd_bf16
        model, g_step, d_step = make_train_steps(opt16)
        state0 = TrainState.create(opt16, model.compact_frozen_variables(jax_variables(sd, opt16)))
        state1, g_losses, _fake, orient = g_step(state0, batch, rng, extra)
        state2, d_losses = d_step(state1, batch, rng, extra, orient=orient)
    tree = lambda s: jax.tree_util.tree_map(np.asarray, s.variables)
    out = {"opt": opt16, "jax": dict(g=floats(g_losses), d=floats(d_losses),
                                     s1=state_dicts_from_flax(tree(state1), opt16),
                                     s2=state_dicts_from_flax(tree(state2), opt16))}
    eps = torch.from_numpy(np.asarray(jax.random.normal(rng, (opt16.batchSize, 256))))
    tbatch = batch_from_numpy(batch, "cpu")
    for name, opt in (("bfloat16", opt16), ("float32", opt32)):
        m = MichiGANModel(opt, "cpu")
        m.load_state_dicts(sd)
        tr = TrainStep(m)
        g, _, _ = tr.g_step(tbatch, EXTRA, eps)
        s1 = snapshot(m)
        for k in g_nets(opt):
            m.nets()[k].load_state_dict(out["jax"]["s1"][k])
        d = tr.d_step(tbatch, EXTRA, eps=eps)
        out[name] = dict(g=floats(g), d=floats(d), s1=s1, s2=snapshot(m), model=m)
    m = MichiGANModel(opt16, "cpu")
    m.load_state_dicts(sd)
    g, _, _ = TrainStep(m).g_step({k: v[:1] for k, v in tbatch.items()}, EXTRA, eps[:1])
    out["half"] = dict(g=floats(g))
    return out


@pytest.fixture(scope="module")
def runs():
    return {}


@pytest.fixture
def config_run(runs, request):
    """run_config of the test's `name` (in the module's CONFIGS), once for
    the module."""
    name = request.node.callspec.params["name"]
    if name not in runs:
        runs[name] = run_config(request.module.CONFIGS[name])
    return runs[name]


def assert_losses_within_gate(run):
    """Per loss of the G and D steps: the calibrated gate."""
    jax16, port16, port32 = run["jax"], run["bfloat16"], run["float32"]
    for part in ("g", "d"):
        assert set(port16[part]) == set(jax16[part])
        assert all(np.isfinite(v) for v in port16[part].values())
        rows, past = loss_gate(port16[part], jax16[part], port32[part])
        print(f"{part} losses, port-bf16 vs JAX-bf16 / JAX-bf16 vs fp32: "
              + ", ".join(f"{k} {v}" for k, v in rows.items()))
        assert not past, (past, rows)


def assert_nets_within_gate(run):
    """Per trained net, its count beyond float noise and its largest
    difference (2.5 lr)."""
    opt = run["opt"]
    jax16, port16, port32 = run["jax"], run["bfloat16"], run["float32"]
    d_net = "netD2" if opt.unpairTrain else "netD"
    nets = [(k, "s1", opt.lr / 2) for k in g_nets(opt)] + [(d_net, "s2", 2 * opt.lr)]
    module_nets = port16["model"].nets()
    for net, stage, lr in nets:
        names = {k for k, _ in module_nets[net].named_parameters()}
        want = {k: v for k, v in jax16[stage][net].items() if k in names}
        got16 = {k: v for k, v in port16[stage][net].items() if k in names}
        got32 = {k: v for k, v in port32[stage][net].items() if k in names}
        assert all(v.dtype == torch.float32 for v in got16.values())
        bad, worst = beyond_noise(got16, want, lr)
        cal_bad, _ = beyond_noise(got32, want, lr)
        total = sum(v.numel() for v in want.values())
        print(f"{net}: port-bf16 vs JAX-bf16 {bad} of {total} beyond float noise (largest "
              f"{worst:.2e}); float32 vs JAX-bf16 {cal_bad}")
        assert worst <= 2.5 * lr, net
        assert bad <= CAL * cal_bad + max(1e-3 * total, 8), net


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_step_matches_jax(config_run, name):
    run = config_run
    assert_losses_within_gate(run)
    assert_nets_within_gate(run)
    # a step that silently ran float32 would give the float32 losses
    assert any(run["bfloat16"]["g"][k] != run["float32"]["g"][k] for k in run["float32"]["g"])
    if name == "vae":
        assert "KLD" in run["bfloat16"]["g"]
    if name == "unpair2":
        assert {"hairAvgLab", "background"} <= set(run["bfloat16"]["g"])
        assert "VGG" not in run["bfloat16"]["g"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_loss_gate_fails_half_the_batch(config_run, name):
    rows, past = loss_gate(config_run["half"]["g"], config_run["jax"]["g"],
                           config_run["float32"]["g"])
    print("half the batch, port-bf16 vs JAX-bf16 / JAX-bf16 vs fp32: "
          + ", ".join(f"{k} {v}" for k, v in rows.items()))
    assert past, rows


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_step_stores_float32_and_keeps_the_frozen_nets(config_run, name):
    """The trained nets keep float32 parameters under bf16 (Adam's master
    weights); netIG and VGG19 are stored in bfloat16 and unchanged."""
    run = config_run["bfloat16"]
    for net, state in run["s2"].items():
        for k, v in state.items():
            if net in ("netIG", "vgg"):
                assert v.dtype == torch.bfloat16 or not v.is_floating_point(), (net, k)
                assert torch.equal(v, run["s1"][net][k]), (net, k)
            elif v.is_floating_point():
                assert v.dtype == torch.float32, (net, k)


def test_flax_blender_inverts_the_bridge():
    opt = config_opt(dict(use_blender=True))
    m = MichiGANModel(opt, "cpu")
    m.init_weights(0)
    sd = m.netB.state_dict()
    back = module_state_dict(flax_blender(sd), B_RENAMES, B_TRANSPOSED)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())

