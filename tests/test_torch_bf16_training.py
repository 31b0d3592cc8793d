"""The port's bf16 training step (--dtype bfloat16 --isTrain) against the
JAX package's, on the CPU, at the tiny training config of
tests/test_torch_training.py (ngf 8, ndf 8, crop 64, batch 2).

- One G step then one D step, both packages from the same float32 numpy
  weights (the port's seeded init, carried to JAX by the JAX package's own
  converters) and the same seeded batch; the frozen towers rounded by
  ``compact_frozen_nets`` on the port's side and
  ``compact_frozen_variables`` on JAX's.  JAX runs its default bank path
  (s2d), whose forward under bf16 is ``fwd_bf16``, the function the port's
  bf16-operand bank computes (its bank gradient is the bf16 VJP, which the
  port does not port: the ORIENT / CONFIDENCE gradient is a tiny share of
  netG's).  The D step starts from JAX's post-G state, as in
  tests/test_training.py's comparison.
- The gate is calibrated on the policy's own effect, as the bf16 serving
  paths' is: port-bf16 vs JAX-bf16 at most CAL = 2x JAX-bf16 vs float32,
  where the float32 step is the port's (tests/test_torch_training.py holds
  it to JAX's float32 step within rtol 1e-4 per loss and the scale-aware
  rule per parameter, far inside the bf16 differences), plus that float32
  agreement as a floor.  Per loss term; for netG's and netD's parameters
  the count of elements beyond float noise of the scale-aware rule, and its
  2.5 lr bound; for netG's buffers the largest difference.  bf16 rounds at
  other places in the two frameworks (XLA may keep a fused chain of bf16
  ops in float32), so equality is not expected; the factor 2 leaves the
  port at most twice as far from JAX's bf16 step as bf16 itself moves it.
  Readings (port-bf16 vs JAX-bf16 / JAX-bf16 vs float32; torch 2.13 and
  jax on an x86 CPU): GAN 7.2e-7/7.6e-6, GAN_Feat 6.5e-4/3.3e-4, ORIENT
  1.0e-2/9.6e-2, VGG 1.2e-4/3.9e-4, background 2.2e-6/9.5e-7 (inside the
  float32 floor), content 6.3e-4/1.3e-3, lab 7.3e-5/1.8e-4, rgb
  9.2e-7/3.5e-6, style 1.0e-3/2.6e-3, CONFIDENCE 0/0 (zero at this size),
  D_Fake 5.8e-6/6.6e-6, D_real 7.0e-6/8.1e-6; beyond float noise netG
  545256 of 4426267 (float32: 617314), netD 2677 of 89874 (3053); netG's
  buffers 2.8e-3 (3.1e-3).  The parameter counts hardly tell bf16 from
  float32: bf16's rounding alone flips the sign of Adam's first step on
  ~14% of netG's elements, so the losses are what the gate can see.
- Controls: the bf16 G step on the first of the two samples fails the loss
  gate (GAN_Feat 3.4e-3, background 2.5e-3, lab 6.1e-2, rgb 1.6e-3, style
  1.7e-2 past it).  The float32 bank passes it (ORIENT 8.8e-2 within 2 x
  9.6e-2: the bank is most of the policy's own effect on that loss), so
  the bank is held on its own: the float32 bank's ORIENT sits 8.8x further
  from JAX's than the bf16-operand bank's.
- The bf16 norm Functions against ``jax.vjp`` of ``_instance_norm_b16`` and
  ``_bn_train_b16`` on the same bf16 inputs (atol 1e-2, rtol 1.6e-2, about
  two bf16 ulps), and what they keep for the backward (bf16 x and
  per-channel float32 statistics).
- ``conv3x3_same_lowch_plain`` in bf16 against the Pallas
  ``conv3x3_same_lowch`` in bf16 (interpret mode, both strategies); the
  bank's bf16-operand plain version against ``filter_bank_conv_s2d(...,
  fwd_bf16=True)`` and JAX's clamp, argmax and max.
- float32 is unchanged: the float32 step reaches neither bf16 Function.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu.ops import filters as jax_filters
from michigan_tpu.ops import norms as jax_norms
from michigan_tpu.ops.pallas.conv_lowch import conv3x3_same_lowch as pallas_lowch
from michigan_tpu.training.convert import (
    convert_discriminator,
    convert_generator,
    convert_inpaint,
    convert_vgg19,
)
from michigan_tpu.training.state import TrainState
from michigan_tpu.training.train_step import make_train_steps
from michigan_tpu_torch.convert import state_dicts_from_flax
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.ops import filters, norms
from michigan_tpu_torch.ops.cuda import lowch as L
from michigan_tpu_torch.ops.cuda import orient as O
from michigan_tpu_torch.training.train_step import TrainStep
from tests.test_torch_training import EXTRA, G_TERMS, tiny_batch, tiny_opt

CAL = 2.0
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)  # the float32 step's agreement with JAX's
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)


def port_state(model):
    return {name: {k: v.detach().clone() for k, v in net.state_dict().items()}
            for name, net in model.nets().items()}


def jax_variables(sd, opt):
    """The JAX package's variables from the port's float32 state dicts."""
    vgg = {k.removeprefix("features."): v for k, v in sd["vgg"].items()}
    return {"netG": convert_generator(sd["netG"], opt),
            "netD": convert_discriminator(sd["netD"], opt),
            "netIG": convert_inpaint(sd["netIG"]), "vgg": convert_vgg19(vgg)}


@pytest.fixture(scope="module")
def runs():
    """JAX's bf16 G step then D step; the port's bf16 and float32 G steps
    from the initial weights and D steps from JAX's post-G state."""
    opt32, opt16 = tiny_opt(), tiny_opt(dtype="bfloat16")
    init = MichiGANModel(opt32, "cpu")
    init.init_weights(0)
    sd = port_state(init)
    batch = tiny_batch(opt16)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MICHIGAN_FILTERBANK", raising=False)  # the s2d bank: fwd_bf16
        model, g_step, d_step = make_train_steps(opt16)
        state0 = TrainState.create(opt16, model.compact_frozen_variables(
            jax_variables(sd, opt16)))
        rng, extra = jax.random.PRNGKey(0), jnp.asarray(EXTRA, jnp.int32)
        state1, g_losses, _fake, orient = g_step(state0, batch, rng, extra)
        state2, d_losses = d_step(state1, batch, rng, extra, orient=orient)
    tree = lambda s: jax.tree_util.tree_map(np.asarray, s.variables)
    out = {"jax": dict(g=jax.tree_util.tree_map(float, g_losses),
                       d=jax.tree_util.tree_map(float, d_losses),
                       s1=state_dicts_from_flax(tree(state1), opt16),
                       s2=state_dicts_from_flax(tree(state2), opt16))}
    tbatch = batch_from_numpy(batch, "cpu")
    for name, opt in (("bfloat16", opt16), ("float32", opt32)):
        m = MichiGANModel(opt, "cpu")
        m.load_state_dicts(sd)
        g, _, _ = TrainStep(m).g_step(tbatch, EXTRA)
        s1 = port_state(m)
        # the D step from JAX's post-G state (float32 netG; the frozen nets as
        # loaded), and the batch's orientation recomputed by the frozen IG
        m.netG.load_state_dict(out["jax"]["s1"]["netG"])
        d = TrainStep(m).d_step(tbatch, EXTRA)
        out[name] = dict(g={k: float(v) for k, v in g.items()},
                         d={k: float(v) for k, v in d.items()}, s1=s1, s2=port_state(m))
    # controls: the bf16 G step on the first half of the batch, and on the
    # float32 bank (the port before it had the bf16-operand form)
    half = batch_from_numpy({k: v[:1] for k, v in batch.items()}, "cpu")
    for name, opt, b in (("half", opt16, half),
                         ("bank_fp32", tiny_opt(dtype="bfloat16", orient_bank_fp32=True), tbatch)):
        m = MichiGANModel(opt, "cpu")
        m.load_state_dicts(sd)
        g, _, _ = TrainStep(m).g_step(b, EXTRA)
        out[name] = dict(g={k: float(v) for k, v in g.items()})
    return out


def loss_gate(got: dict, want: dict, ref: dict):
    """({name: "gap/policy"}, [names past the gate]) of one step's losses:
    got within CAL x |want - ref| of want, plus the float32 floor."""
    rows, past = {}, []
    for k, w in want.items():
        gap, policy = abs(got[k] - w), abs(w - ref[k])
        rows[k] = f"{gap:.2e}/{policy:.2e}"
        if not gap <= CAL * policy + LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(w):
            past.append(k)
    return rows, past


def beyond_noise(got: dict, want: dict, max_lr: float):
    """(elements beyond float noise, largest difference) of the scale-aware
    rule of tests/test_training.py."""
    n_bad, worst = 0, 0.0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        n_bad += int((d > 1e-4 * w.double().abs() + 1e-5).sum())
        worst = max(worst, d.max().item())
    return n_bad, worst


def params(state: dict, net: torch.nn.Module) -> dict:
    names = {k for k, _ in net.named_parameters()}
    return {k: v for k, v in state.items() if k in names}


def test_bf16_step_losses_match_jax(runs):
    jax16, port16, port32 = runs["jax"], runs["bfloat16"], runs["float32"]
    assert tuple(port16["g"]) == G_TERMS and tuple(port16["d"]) == ("D_Fake", "D_real")
    for part in ("g", "d"):
        assert all(np.isfinite(v) for v in port16[part].values())
        rows, past = loss_gate(port16[part], jax16[part], port32[part])
        print("port-bf16 vs JAX-bf16 / JAX-bf16 vs fp32 per loss: "
              + ", ".join(f"{k} {v}" for k, v in rows.items()))
        assert not past, (past, rows)
    # a step that silently ran float32 would match the float32 losses
    assert any(port16["g"][k] != port32["g"][k] for k in G_TERMS)


def test_bf16_loss_gate_fails_half_the_batch(runs):
    """The loss gate is not vacuous: the bf16 G step on the first of the two
    samples fails it."""
    rows, past = loss_gate(runs["half"]["g"], runs["jax"]["g"], runs["float32"]["g"])
    print("half the batch, port-bf16 vs JAX-bf16 / JAX-bf16 vs fp32 per loss: "
          + ", ".join(f"{k} {v}" for k, v in rows.items()))
    assert past, rows


def test_bf16_orient_loss_needs_the_bf16_operand_bank(runs):
    """JAX's bf16 ORIENT loss is the bf16-operand bank's: the float32 bank
    lands several times further from it.  (Both pass the calibrated gate:
    the bank is most of the policy's own effect on this loss.)"""
    want = runs["jax"]["g"]["ORIENT"]
    gap16, gap32 = (abs(runs[k]["g"]["ORIENT"] - want) for k in ("bfloat16", "bank_fp32"))
    print(f"ORIENT vs JAX-bf16: bf16-operand bank {gap16:.2e}, float32 bank {gap32:.2e}")
    assert gap16 * 4 <= gap32


@pytest.mark.parametrize("net,stage,lr_scale", [("netG", "s1", 0.5), ("netD", "s2", 2.0)])
def test_bf16_step_updates_parameters_as_jax(runs, net, stage, lr_scale):
    """netG after the G step (Adam at lr / 2, TTUR) and netD after the D
    step from JAX's post-G state (2 lr)."""
    opt = tiny_opt(dtype="bfloat16")
    module = getattr(MichiGANModel(opt, "cpu"), net)
    want = params(runs["jax"][stage][net], module)
    got16 = params(runs["bfloat16"][stage][net], module)
    got32 = params(runs["float32"][stage][net], module)
    assert all(v.dtype == torch.float32 for v in got16.values())
    bad, worst = beyond_noise(got16, want, lr_scale * opt.lr)
    cal_bad, cal_worst = beyond_noise(got32, want, lr_scale * opt.lr)
    total = sum(v.numel() for v in want.values())
    print(f"{net}: port-bf16 vs JAX-bf16 {bad} of {total} beyond float noise (largest "
          f"{worst:.2e}); float32 vs JAX-bf16 {cal_bad} (largest {cal_worst:.2e})")
    assert worst <= 2.5 * lr_scale * opt.lr
    assert bad <= CAL * cal_bad + max(1e-3 * total, 8)


def test_bf16_step_writes_netg_buffers_as_jax(runs):
    want = runs["jax"]["s1"]["netG"]
    bufs = [k for k in want if k.endswith(("running_mean", "running_var", "weight_u",
                                           "weight_v"))]
    assert bufs
    gap = max((runs["bfloat16"]["s1"]["netG"][k] - want[k]).abs().max().item() for k in bufs)
    policy = max((runs["float32"]["s1"]["netG"][k] - want[k]).abs().max().item() for k in bufs)
    print(f"netG buffers: port-bf16 vs JAX-bf16 {gap:.2e}, float32 vs JAX-bf16 {policy:.2e}")
    assert gap <= CAL * policy + 1e-5


def test_bf16_step_keeps_the_frozen_nets(runs):
    """netIG and VGG19 are bfloat16 and unchanged by the step; netG and netD
    keep float32 parameters."""
    s0 = MichiGANModel(tiny_opt(dtype="bfloat16"), "cpu")
    for name in ("netIG", "vgg"):
        for k, v in runs["bfloat16"]["s2"][name].items():
            assert v.dtype == torch.bfloat16 or not v.is_floating_point(), (name, k)
            assert torch.equal(v, runs["bfloat16"]["s1"][name][k]), (name, k)
    for name in ("netG", "netD"):
        for k, v in getattr(s0, name).named_parameters():
            assert runs["bfloat16"]["s2"][name][k].dtype == torch.float32, (name, k)


# ---------------------------------------------------------------------------
# the bf16 norm Functions against the JAX package's custom VJPs
# ---------------------------------------------------------------------------

def bf16_pair(rng, shape, scale=1.0, shift=0.0):
    """The same bf16 values as an NCHW torch tensor and an NHWC jax array."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))
    x = x.bfloat16()
    return x, jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def saved_by(fn, x):
    """(output, [(dtype, shape)] of every tensor autograd keeps for fn(x))."""
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(x)
    return out, saved


@pytest.mark.parametrize("which", ["instance", "batch"])
def test_bf16_norm_functions_match_jax_vjps(rng, which):
    x, xj = bf16_pair(rng, (2, 8, 12, 12), 3.0, 1.5)
    g, gj = bf16_pair(rng, (2, 8, 12, 12))
    xg = x.clone().requires_grad_()
    if which == "instance":
        y, saved = saved_by(lambda t: norms.instance_norm(t), xg)
        yj, vjp = jax.vjp(lambda t: jax_norms._instance_norm_b16(t, 1e-5), xj)
        (dxj,) = vjp(gj)
    else:
        rm, rv = torch.zeros(8), torch.ones(8)
        (y, new_mean, new_var), saved = saved_by(
            lambda t: norms.batch_norm_train(t, rm, rv), xg)
        yj, vjp = jax.vjp(lambda t: jax_norms._bn_train_b16(t, 1e-5, None)[0], xj)
        (dxj,) = vjp(gj)
        _, jm, jv = jax_norms.batch_norm_train(xj, jnp.zeros(8), jnp.ones(8))
        np.testing.assert_allclose(new_mean.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(new_var.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    (dx,) = torch.autograd.grad(y, xg, g)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert yj.dtype == dxj.dtype == jnp.bfloat16
    np.testing.assert_allclose(nhwc(y), np.asarray(yj, np.float32), **BF16_TOL)
    np.testing.assert_allclose(nhwc(dx), np.asarray(dxj, np.float32), **BF16_TOL)
    # kept for the backward: the bf16 x and per-channel float32 statistics
    full = [s for s in saved if s[1] == tuple(x.shape)]
    assert full == [(torch.bfloat16, tuple(x.shape))], saved
    assert all(dt == torch.float32 and int(np.prod(sh)) <= 16 for dt, sh in saved
               if sh != tuple(x.shape)), saved


def test_float32_step_reaches_no_bf16_function(monkeypatch):
    """The float32 norms keep their float32 code: a float32 G+D step runs
    with both bf16 Functions made to raise."""
    def refuse(*_args):
        raise AssertionError("a bf16 norm Function ran in float32")

    monkeypatch.setattr(norms.InstanceNormB16, "apply", refuse)
    monkeypatch.setattr(norms.BatchNormTrainB16, "apply", refuse)
    opt = tiny_opt(use_ig=False, batchSize=1)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    batch = batch_from_numpy(tiny_batch(opt), "cpu")
    trainer = TrainStep(model)
    _g, _f, orient = trainer.g_step(batch, EXTRA)
    assert np.isfinite(float(trainer.d_step(batch, EXTRA, orient)["D_real"]))


# ---------------------------------------------------------------------------
# the two kernels' bf16 plain versions against the JAX package
# ---------------------------------------------------------------------------

# (im2col, (n, c, co, h, w)): features_2's channels at 16^2; odd C = 7 with
# W = 13 and C = 33 with W = 11 (neither a multiple of 8: the CUDA kernel's
# zero-filled channels and narrower halo copies)
LOWCH_CASES = [
    pytest.param(True, (2, 64, 64, 16, 16), id="True"),
    pytest.param(False, (2, 64, 64, 16, 16), id="False"),
    pytest.param(True, (1, 7, 64, 8, 13), id="True-c7-w13"),
    pytest.param(False, (2, 33, 40, 16, 11), id="False-c33-w11"),
]


@pytest.mark.parametrize("im2col,shape", LOWCH_CASES)
def test_lowch_plain_bf16_matches_pallas(rng, im2col, shape):
    """bf16 x, the float32 weight at VGG's kaiming scale: the Pallas kernel
    (interpret mode, tile_rows 8) casts w to bf16, sums in float32 and rounds
    once, as the plain version does; within BF16_TOL."""
    n, c, co, h, wd = shape
    x, xj = bf16_pair(rng, (n, c, h, wd))
    x, xj = x.relu(), jnp.maximum(xj, 0)
    w = (rng.standard_normal((co, c, 3, 3)) * np.sqrt(2 / (9 * c))).astype(np.float32)
    ref = pallas_lowch(xj, jnp.asarray(w.transpose(2, 3, 1, 0)), tile_rows=8, im2col=im2col)
    got = L.conv3x3_same_lowch(x, torch.from_numpy(w))
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(ref, np.float32), **BF16_TOL)
    # and with the weight stored in bf16 (compact_frozen_nets): the same values
    torch.testing.assert_close(L.conv3x3_same_lowch(x, torch.from_numpy(w).bfloat16()), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["gabor", "dog"])
def test_bank_bf16_operands_plain_matches_fwd_bf16(mode):
    """On gray planes of seeded images in [-1, 1]: the responses are bf16
    values in both, so conf matches to float32 rounding of the sums that
    decide a bf16 rounding (atol 1e-3, rtol 1e-2: one bf16 ulp where the
    two sum orders round apart); the argmax may differ only where the
    responses of the two orientations tie within that tolerance, and on at
    most 1% of the pixels."""
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
    gray_j = jax_filters.rgb_to_gray255(jnp.asarray(img))
    res = jnp.maximum(jax_filters.filter_bank_conv_s2d(gray_j, mode, fwd_bf16=True), 0.0)
    idx_j, conf_j = np.asarray(jnp.argmax(res, axis=-1)), np.asarray(jnp.max(res, axis=-1))
    gray = torch.from_numpy(np.asarray(gray_j)).permute(0, 3, 1, 2).contiguous()
    idx, conf = O.filterbank_orientation(gray, filters.bank(mode, gray.device), True)
    np.testing.assert_allclose(conf.numpy(), conf_j, atol=1e-3, rtol=1e-2)
    differ = idx.numpy() != idx_j
    resp = np.asarray(res)
    n_, y_, x_ = np.nonzero(differ)
    a, b = resp[n_, y_, x_, idx.numpy()[differ]], resp[n_, y_, x_, idx_j[differ]]
    assert np.all(np.abs(a - b) <= 1e-3 + 1e-2 * np.abs(b))
    assert differ.mean() <= 1e-2, differ.mean()
    # and the float32 bank differs from it: the flag is not ignored
    _, conf32 = O.filterbank_orientation(gray, filters.bank(mode, gray.device))
    assert not torch.equal(conf32, conf)
