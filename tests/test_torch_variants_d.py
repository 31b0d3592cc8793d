"""The discriminator, netE, netFE and training-step options against the JAX
package's, on the CPU (the generator's options: tests/test_torch_variants.py).

- netD --netD n_layer and --norm_D spectralbatch, spectralsync_batch,
  spectralnone and instance: the train-mode features and the input's
  gradient against the JAX package's ``apply`` + ``vjp`` on the same seeded
  variables; the running statistics and spectral u / v unchanged by the
  forward;
- --netD n_layer through ``discriminate`` and the GAN, GAN-feature and D
  losses against the JAX package's, at batch 1 and 2, with
  --remove_background and --wide_edge: the same values where the JAX
  package computes them, an error where it raises;
- netFE and the other MaskGAN modules against the JAX package's
  ``maskgan.py``, and netE with --norm_E spectralbatch (eval: its running
  statistics);
- one G+D step with --reuse_fake_for_d: the D step takes the G step's fake
  without running netG, and its losses equal the JAX package's
  ``discriminator_loss(fake_image=...)`` on that fake;
- --add_zeros: the host prep's arrays equal the JAX package's
  ``single_inference_data``;
- the weight bridge: each new key kind, through the JAX package's
  ``convert_generator`` where it covers the key, else against the JAX
  tree's leaves;
- the combined option sets through ``TrainStep``, a checkpoint and its
  restore, and ``infer``; netD's and netE's running statistics unchanged
  by the step; each option of the port's last model slice constructs, and
  --fused_step is still refused;
- the flag matrix's instance_feat row through the trainer and inference
  CLIs (jax unimportable), its checkpoint holding _net_FE.pth.

The JAX references are compiled at XLA's backend optimisation level 0
(tests/test_torch_variants.py ``jax_compiled``).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu import config as jconfig
from michigan_tpu import losses as JL
from michigan_tpu import models as jnets
from michigan_tpu.data.single import single_inference_data as jax_data
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.models import encoders as jenc
from michigan_tpu.models import maskgan as jmg
from michigan_tpu.training.convert import convert_generator
from michigan_tpu_torch import convert
from michigan_tpu_torch import config as pconfig
from michigan_tpu_torch.data.single import single_inference_data as port_data
from michigan_tpu_torch.data.synthetic import synthetic_inference_data, synthetic_train_data
from michigan_tpu_torch.losses import feat, gan
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy, check_supported
from michigan_tpu_torch.models import maskgan
from michigan_tpu_torch.models.discriminator import define_D
from michigan_tpu_torch.models.encoders import ConvEncoder
from michigan_tpu_torch.models.generator import SPADEBGenerator
from michigan_tpu_torch.training.checkpoint import NETS as CHECKPOINTED
from michigan_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from michigan_tpu_torch.training.train_step import TrainStep
from test_torch_most import BLOCK_JAX, DATA_DIR, REPO, ROW_COMMON, nchw, nhwc, to_np
from test_torch_variants import jax_compiled, port_options, seeded_all

REL = 1e-4   # features and outputs: max abs over the largest magnitude
# the input's gradient through the D's norms (n_layer, spectralinstance: 4.5e-4)
GRAD_REL = 1e-3
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
D_BASE = dict(isTrain=True, netG="spadeb", ndf=8, ngf=8, crop_size=64, load_size=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) <= rel * max(np.abs(want).max(), 1e-6)


def jax_d(opt, x):
    """The JAX package's netD for `opt` and seeded variables for input x."""
    d = jnets.define_D(opt)
    return d, seeded_all(jax.eval_shape(functools.partial(d.init, train=False),
                                        jax.random.PRNGKey(2), x), 2)


# ---------------------------------------------------------------------------
# (b) the discriminators
# ---------------------------------------------------------------------------

D_CASES = {"n_layer": dict(netD="n_layer"), "spectralbatch": dict(norm_D="spectralbatch"),
           "spectralsync_batch": dict(norm_D="spectralsync_batch"),
           "spectralnone": dict(norm_D="spectralnone"), "instance": dict(norm_D="instance")}


@pytest.mark.parametrize("case", sorted(D_CASES))
def test_discriminator_option_matches_jax(case):
    opt = jconfig.Options(**{**D_BASE, **D_CASES[case]}).finalize()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64, 64, opt.d_input_nc())).astype(np.float32)
    d, v = jax_d(opt, x)
    flat = lambda out: out if case == "n_layer" else [t for s in out for t in s]
    cots = [rng.standard_normal(t.shape).astype(np.float32)
            for t in flat(jax.eval_shape(functools.partial(d.apply, train=True), v, x))]

    def run(v, x, cots):
        y, vjp = jax.vjp(lambda x: flat(d.apply(v, x, train=True)), x)
        return y, vjp(cots)[0]

    y, dx = to_np(jax_compiled(run, v, x, cots)(v, x, cots))
    net = define_D(port_options(opt)).train()
    net.load_state_dict(convert.state_dicts_from_flax({"netD": v}, opt)["netD"], strict=True)
    before = {k: t.clone() for k, t in net.state_dict().items()}
    xt = nchw(x).requires_grad_(True)
    got = flat(net(xt))
    torch.autograd.backward(got, [nchw(c) for c in cots])
    assert len(got) == len(y) == (5 if case == "n_layer" else 10)
    for g, w in zip(got, y):
        assert close(nhwc(g), w), case
    assert close(nhwc(xt.grad), dx, GRAD_REL), case
    for k, t in net.state_dict().items():  # nothing written, as in JAX
        assert torch.equal(t, before[k]), (case, k)
    if "batch" in case:
        assert any(k.endswith(".0.1.running_mean") for k in before)


N_LAYER_LOSSES = {"n1": (1, {}), "n1_remove_background": (1, dict(remove_background=True)),
                  "n1_remove_background_no_feat": (1, dict(remove_background=True,
                                                           no_ganFeat_loss=True)),
                  "n1_wide_edge": (1, dict(wide_edge=2.0)),
                  "n2_no_feat": (2, dict(no_ganFeat_loss=True)), "n2": (2, {})}


@pytest.mark.parametrize("case", sorted(N_LAYER_LOSSES))
def test_n_layer_losses_read_the_features_as_jax_does(case):
    """--netD n_layer: ``discriminate`` and the losses on its one list of
    features, as the JAX package's (model.py:372-373; gan.py:65-75,
    feat.py:24-33) read it: where the JAX package computes a loss, the same
    value; where it raises (features of different shapes), the port raises
    too."""
    n, kw = N_LAYER_LOSSES[case]
    opt = jconfig.Options(**{**D_BASE, "netD": "n_layer", "use_ig": False, **kw}).finalize()
    popt = port_options(opt)
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:64, 0:64] / 64
    hair = np.stack([(((yy - 0.45) / (0.25 + 0.05 * i)) ** 2 + ((xx - 0.5) / 0.3) ** 2 < 1)
                     for i in range(n)])[..., None].astype(np.float32)
    tag = np.concatenate([1 - hair, hair], -1)
    fake, real = (rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32) for _ in range(2))
    orient = (rng.uniform(0, 255, (n, 64, 64, 1)) * hair).astype(np.float32)
    d, v = jax_d(opt, np.zeros((2 * n, 64, 64, opt.d_input_nc()), np.float32))
    jm, label = JModel(opt), tag[..., 1:2]

    def losses(dis, lib, feat_loss, args, lab):
        pf, pr = dis(*args)
        out = [lib.multiscale_gan_loss(pf, True, False, opt, lab),
               lib.multiscale_gan_loss(pf, False, True, opt, lab),
               lib.multiscale_gan_loss(pr, True, True, opt, lab)]
        if not opt.no_ganFeat_loss:
            out.append(feat_loss(pf, pr, opt, lab))
        return out

    def jax_losses(v):
        return losses(lambda *a: jm.discriminate({"netD": v}, *a, train=True), JL,
                      JL.gan_feat_loss, (tag, fake, real, orient), label)

    try:  # a shape error raises while the function is traced
        want = [float(x) for x in jax_compiled(jax_losses, v)(v)]
    except (TypeError, ValueError):
        want = None
    model = MichiGANModel(popt, "cpu")
    model.netD.load_state_dict(convert.state_dicts_from_flax({"netD": v}, popt)["netD"],
                               strict=True)
    args = [nchw(a) for a in (tag, fake, real, orient)]
    port = lambda: [float(x) for x in losses(model.discriminate, gan, feat.gan_feat_loss,
                                             args, nchw(label))]
    if case in ("n1", "n2_no_feat"):
        assert want is not None, case
    if want is None:
        with pytest.raises(RuntimeError):
            port()
    else:
        np.testing.assert_allclose(port(), want, **LOSS_TOL, err_msg=case)


# ---------------------------------------------------------------------------
# (c) netFE, the MaskGAN modules and netE
# ---------------------------------------------------------------------------

def _fe():
    rng = np.random.default_rng(5)
    inst = (np.arange(64)[None, :, None, None] >= rng.integers(16, 48, 2)[:, None, None, None])
    inst = np.broadcast_to(inst, (2, 64, 64, 1)).astype(np.float32)
    inst = inst + (np.arange(64)[None, None, :, None] >= 40)  # three ids
    return (jmg.FeatureEncoder(3, 3, 8), maskgan.FeatureEncoder(3, 3, 8),
            (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32), inst), convert.FE_TRANSPOSED)


def _sft():
    rng = np.random.default_rng(6)
    return (jmg.SFTLayer(16), maskgan.SFTLayer(16, 5),
            (rng.standard_normal((2, 8, 8, 16)), rng.standard_normal((2, 8, 8, 5))), ())


def _style():
    rng = np.random.default_rng(7)
    return (jmg.StyleEncoder(3, 4, 8, "in", "lrelu", "zero"),
            maskgan.StyleEncoder(3, 3, 4, 8, 6, "in", "lrelu", "zero"),
            (rng.standard_normal((2, 32, 32, 3)), rng.standard_normal((2, 8, 8, 6)),
             rng.standard_normal((2, 4, 4, 6))), ())


def _label():
    rng = np.random.default_rng(8)
    return (jmg.LabelEncoder(4, 4, "none", "relu", "replicate"),
            maskgan.LabelEncoder(4, 2, 4, "none", "relu", "replicate"),
            (rng.standard_normal((2, 32, 32, 2)),), ())


MASKGAN = {"FeatureEncoder": _fe, "SFTLayer": _sft, "StyleEncoder": _style,
           "LabelEncoder": _label}


@pytest.mark.parametrize("name", sorted(MASKGAN))
def test_maskgan_module_matches_jax(name):
    jmod, pmod, args, transposed = MASKGAN[name]()
    args = [np.asarray(a, np.float32) for a in args]
    v = seeded_all(jax.eval_shape(jmod.init, jax.random.PRNGKey(1), *args), 1)
    want = to_np(jax_compiled(jmod.apply, v, *args)(v, *args))
    pmod.load_state_dict(convert.module_state_dict(v, (), transposed), strict=True)
    with torch.no_grad():
        got = pmod(*(nchw(a) for a in args))
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert close(nhwc(g), w), name
    if name == "FeatureEncoder":  # one value a channel inside each instance
        assert len(np.unique(np.round(nhwc(got)[0, ..., 0], 5))) <= 3


def test_maskgan_functions_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    scale, bias = rng.standard_normal(4).astype(np.float32), rng.standard_normal(4).astype(
        np.float32)
    assert close(nhwc(maskgan.adaptive_instance_norm(nchw(x), torch.from_numpy(scale),
                                                     torch.from_numpy(bias))),
                 jmg.adaptive_instance_norm(x, scale, bias))
    ln = jmg.LayerNorm2d(4)
    v = {"params": {"gamma": rng.uniform(0, 1, 4).astype(np.float32),
                    "beta": rng.standard_normal(4).astype(np.float32)}}
    pln = maskgan.LayerNorm2d(4)
    pln.load_state_dict({k: torch.from_numpy(a) for k, a in v["params"].items()})
    assert close(nhwc(pln(nchw(x)).detach()), ln.apply(v, x))
    for norm, act in (("none", "relu"), ("ln", "lrelu"), ("ln", "tanh")):
        lb = jmg.LinearBlock(7, norm, act)
        xv = rng.standard_normal((3, 5)).astype(np.float32)
        lv = seeded_all(jax.eval_shape(lb.init, jax.random.PRNGKey(0), xv), 3)
        plb = maskgan.LinearBlock(5, 7, norm, act)
        plb.load_state_dict(convert.module_state_dict(lv, ()), strict=True)
        assert close(plb(torch.from_numpy(xv)).detach(), lb.apply(lv, xv)), (norm, act)


def test_batch_norm_net_e_matches_jax_in_eval():
    opt = jconfig.Options(**{**D_BASE, "use_vae": True, "norm_E": "spectralbatch",
                             "crop_size": 128, "load_size": 128}).finalize()
    x = np.random.default_rng(10).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    e = jenc.ConvEncoder(opt)
    v = seeded_all(jax.eval_shape(e.init, jax.random.PRNGKey(3), x), 3)
    mu, logvar = to_np(jax_compiled(e.apply, v, x)(v, x))
    net = ConvEncoder(port_options(opt)).eval()
    net.load_state_dict(convert.state_dicts_from_flax({"netE": v}, opt)["netE"], strict=True)
    with torch.no_grad():
        got = net(nchw(x))
    assert close(got[0], mu) and close(got[1], logvar)
    assert "layer1.1.running_var" in net.state_dict()


# ---------------------------------------------------------------------------
# (d) --reuse_fake_for_d
# ---------------------------------------------------------------------------

REUSE = dict(D_BASE, use_encoder=True, noise_background=True, use_ig=False,
             reuse_fake_for_d=True, init_type="none")


@pytest.mark.parametrize("case,kw", [("spectralbatch", dict(norm_D="spectralbatch")),
                                     ("n_layer_batch1", dict(netD="n_layer"))])
def test_reuse_fake_for_d_step_matches_jax(case, kw):
    opt = jconfig.Options(**{**REUSE, **kw}).finalize()
    popt = port_options(opt)
    n = 1 if case.endswith("batch1") else 2
    data = synthetic_train_data(popt, 0, n)
    _, v = jax_d(opt, np.zeros((2 * n, 64, 64, opt.d_input_nc()), np.float32))
    model = MichiGANModel(popt, "cpu")
    model.init_weights(0)
    model.netD.load_state_dict(convert.state_dicts_from_flax({"netD": v}, popt)["netD"],
                               strict=True)
    trainer = TrainStep(model)
    batch = batch_from_numpy(data, "cpu")
    _, fake, orient = trainer.g_step(batch, 2)
    ran = []
    model.generate_fake = lambda *a, **k: ran.append(1)  # the D step must not run netG
    d = trainer.d_step(batch, 2, orient, None, fake)
    assert not ran
    jm = JModel(opt)
    jbatch = {k: jnp.asarray(a) for k, a in data.items()}

    def run(v, fake, orient):
        return jm.discriminator_loss({"netD": v}, jbatch, None, fake_image=fake,
                                     orient=orient)[1]

    args = (v, nhwc(fake), nhwc(orient))
    want = to_np(jax_compiled(run, *args)(*args))
    for k in ("D_Fake", "D_real"):
        np.testing.assert_allclose(d[k].item(), want[k], **LOSS_TOL, err_msg=(case, k))


# ---------------------------------------------------------------------------
# (e) --add_zeros
# ---------------------------------------------------------------------------

def test_add_zeros_host_prep_matches_jax():
    flags = ["--netG", "spadeb", "--use_encoder", "--noise_background", "--use_ig",
             "--add_zeros", "--add_th", "32", "--crop_size", "128", "--load_size", "128",
             "--data_dir", DATA_DIR, "--gpu_ids", "-1"]
    want = jax_data(jconfig.test_options(flags))
    got = port_data(pconfig.test_options(flags))
    plain = port_data(pconfig.test_options([f for f in flags if f != "--add_zeros"]))
    assert got.keys() == want.keys()
    for k, a in want.items():
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert not np.array_equal(got["image_tag"], plain["image_tag"])


# ---------------------------------------------------------------------------
# (f) the weight bridge
# ---------------------------------------------------------------------------

G_BASE = dict(isTrain=False, netG="spadeb", ngf=4, crop_size=64, load_size=64,
              use_encoder=True, noise_background=True, use_ig=True)
ROUND_TRIP = {"norm": dict(Image_encoder_mode="norm"),
              "instance": dict(Image_encoder_mode="instance"),
              "no_encoder": dict(use_encoder=False), "weight_norm_g0": dict(weight_norm_G=True),
              "weight_norm_g1": dict(weight_norm_G=True, weight_norm_g=1),
              "background": dict(noise_background=False)}


def random_tree(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                  shapes)


def generator_shapes(opt):
    s = opt.generator_input_size()
    z = lambda c: jnp.zeros((1, s, s, c))
    return jax.eval_shape(jnets.define_G(opt).init, jax.random.PRNGKey(0), z(2), z(2), z(2),
                          z(3), z(3), z(3))


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", sorted(ROUND_TRIP))
def test_round_trip_through_jax_convert(case):
    """JAX tree -> the port's state_dict (strict load) -> the JAX package's
    convert_generator -> the same tree."""
    opt = jconfig.Options(**{**G_BASE, **ROUND_TRIP[case]}).finalize()
    v = random_tree(generator_shapes(opt))
    sd = convert.state_dicts_from_flax({"netG": v}, opt)["netG"]
    SPADEBGenerator(port_options(opt)).load_state_dict(sd, strict=True)
    kinds = {"norm": "fc.fc.weight", "instance": "fc.layer5.0.weight_orig",
             "no_encoder": "fc.weight", "weight_norm_g0": "head_0.conv_0.weight_g",
             "weight_norm_g1": "head_0.conv_0.weight",
             "background": "backgroud_enc.conv1.conv.weight"}
    assert kinds[case] in sd
    back = flat(convert_generator(sd, opt))
    assert back.keys() == flat(v).keys()
    for k, a in flat(v).items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_bridge_of_keys_jax_convert_does_not_cover():
    """The NonSpadeNorm batch norm's .1.* keys (netG's encoder, netD, netE),
    an n_layer netD's keys and netFE's: a strict load, and each tensor is
    the JAX leaf it stands for."""
    opt = jconfig.Options(**{**G_BASE, "isTrain": True, "Image_encoder_mode": "norm",
                             "norm_E": "spectralbatch", "norm_D": "spectralbatch",
                             "use_vae": True, "netD": "n_layer"}).finalize()
    popt = port_options(opt)
    x = jnp.zeros((2, 64, 64, opt.d_input_nc()))
    fe = jmg.FeatureEncoder(3, 3, 4)
    vs = {"netG": generator_shapes(dataclasses.replace(opt, use_vae=False)),
          "netD": jax.eval_shape(jnets.define_D(opt).init, jax.random.PRNGKey(0), x),
          "netE": jax.eval_shape(jenc.ConvEncoder(opt).init, jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3))),
          "netFE": jax.eval_shape(fe.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                  jnp.zeros((1, 32, 32, 1)))}
    v = {k: random_tree(t, i) for i, (k, t) in enumerate(vs.items())}
    sds = convert.state_dicts_from_flax(v, popt)
    gopt = dataclasses.replace(popt, use_vae=False)
    SPADEBGenerator(gopt).load_state_dict(sds["netG"], strict=True)
    define_D(popt).load_state_dict(sds["netD"], strict=True)
    ConvEncoder(popt).load_state_dict(sds["netE"], strict=True)
    maskgan.FeatureEncoder(3, 3, 4).load_state_dict(sds["netFE"], strict=True)
    t = lambda a: np.asarray(a)
    g, d, e, f = (v[k] for k in ("netG", "netD", "netE", "netFE"))
    checks = {
        ("netG", "fc.layer2.1.weight"): g["params"]["fc"]["layer2"]["norm_scale"],
        ("netG", "fc.layer2.1.bias"): g["params"]["fc"]["layer2"]["norm_bias"],
        ("netG", "fc.layer2.1.running_var"): g["batch_stats"]["fc"]["layer2"]["norm"][
            "running_var"],
        ("netD", "model1.0.1.weight"): d["params"]["model1"]["norm_scale"],
        ("netD", "model2.0.1.running_mean"): d["batch_stats"]["model2"]["norm"]["running_mean"],
        ("netD", "model0.0.weight"): t(d["params"]["model0_conv"]["kernel"]).transpose(3, 2, 0, 1),
        ("netE", "layer3.1.bias"): e["params"]["layer3"]["norm_bias"],
        ("netFE", "up1.weight"): t(f["params"]["up1"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1),
        ("netFE", "head.bias"): f["params"]["head"]["bias"],
    }
    for (net, key), a in checks.items():
        np.testing.assert_array_equal(sds[net][key].numpy(), t(a), err_msg=key)


# ---------------------------------------------------------------------------
# the combined options through the port's step, checkpoint and infer
# ---------------------------------------------------------------------------

# no --use_ig: the inpainter runs at 256^2 whatever the crop, ~10 s a call
# in one thread here, and none of these options reaches it
SMALL = ("--netG spadeb --gpu_ids -1 --crop_size 64 --load_size 64 --ngf 8 --ndf 8 "
         "--batchSize 2 --init_type none").split()
COMBINED = {
    "A": "--use_encoder --noise_background --Image_encoder_mode norm --norm_E spectralbatch "
         "--norm_D spectralbatch --weight_norm_G --reuse_fake_for_d",
    "B": "--use_encoder --Image_encoder_mode instance --use_instance_feat --no_instance False "
         "--netD n_layer --no_ganFeat_loss",
    "E": "--use_encoder --noise_background --use_vae --norm_E spectralbatch "
         "--norm_D spectralsync_batch --orient_random_disturb --add_zeros",
}


@pytest.mark.parametrize("name", sorted(COMBINED))
def test_combined_options_step_checkpoint_and_infer(tmp_path, name):
    flags = SMALL + COMBINED[name].split() + ["--checkpoints_dir", str(tmp_path), "--name", name]
    opt = pconfig.train_options(flags)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    trainer = TrainStep(model)
    data = synthetic_train_data(opt, 0, 2)
    assert ("instance" in data) == (not opt.no_instance)  # two ids
    frozen = {n: {k: t.clone() for k, t in net.state_dict().items() if "running" in k}
              for n, net in model.nets().items() if n in ("netD", "netE")}
    assert any(frozen.values()) == (name != "B")
    fe = {k: t.clone() for k, t in model.netFE.state_dict().items()} if model.netFE else {}
    batch = batch_from_numpy(data, "cpu")
    g, fake, orient = trainer.g_step(batch, 2)
    d = trainer.d_step(batch, 2, orient, None, fake)
    assert all(np.isfinite(v.item()) for v in {**g, **d}.values())
    for net, state in frozen.items():  # never written, as in JAX
        assert all(torch.equal(model.nets()[net].state_dict()[k], t)
                   for k, t in state.items()), net
    for k, t in fe.items():  # netFE takes no gradient: Adam leaves it
        assert torch.equal(model.netFE.state_dict()[k], t), k
    save_checkpoint(opt, "latest", trainer)
    if opt.use_instance_feat:
        assert (tmp_path / name / "latest_net_FE.pth").exists()
    other = MichiGANModel(opt, "cpu")  # unseeded: the checkpoint writes its nets
    restored = TrainStep(other)
    assert load_checkpoint(opt, "latest", restored)
    for n in CHECKPOINTED.values():
        if n in model.nets():
            for k, t in model.nets()[n].state_dict().items():
                assert torch.equal(other.nets()[n].state_dict()[k], t), (n, k)
    iopt = pconfig.test_options(flags)
    infer = MichiGANModel(iopt, "cpu")
    infer.load_state_dicts({n: model.nets()[n].state_dict() for n in infer.nets()})
    out, _ = infer.infer(batch_from_numpy(synthetic_inference_data(iopt, 0, 1), "cpu"))
    assert out.shape == (1, 3, 64, 64) and torch.isfinite(out).all()


def test_weight_norm_remat_step_equals_the_step_without_it():
    """--weight_norm_G under --remat: a weight-normed conv holds no buffer,
    so the recompute reads what the forward read; one G+D step with every
    block rematerialised equals the step without, bit for bit."""
    flags = SMALL + ["--use_encoder", "--noise_background", "--weight_norm_G"]

    def step(extra):
        opt = pconfig.train_options(flags + extra)
        model = MichiGANModel(opt, "cpu")
        model.init_weights(0)
        trainer = TrainStep(model)
        batch = batch_from_numpy(synthetic_train_data(opt, 0, 2), "cpu")
        g, fake, orient = trainer.g_step(batch, 2)
        d = trainer.d_step(batch, 2, orient, None, fake)
        return ({k: v.item() for k, v in {**g, **d}.items()},
                {f"{n}.{k}": t.clone() for n, net in model.nets().items()
                 for k, t in net.state_dict().items()})

    plain_losses, plain = step([])
    losses, state = step(["--remat"])
    assert losses == plain_losses
    assert state.keys() == plain.keys()
    assert not [k for k in plain if not torch.equal(state[k], plain[k])]


def test_every_option_constructs_and_fused_step_is_refused():
    base = pconfig.train_options(SMALL + ["--use_encoder", "--noise_background"])
    options = [dict(use_instance_feat=True), dict(add_zeros=True), dict(no_instance=False),
               dict(reuse_fake_for_d=True), dict(orient_random_disturb=True),
               dict(Image_encoder_mode="norm"), dict(Image_encoder_mode="instance"),
               dict(use_encoder=False), dict(noise_background=False),
               dict(weight_norm_G=True), dict(weight_norm_G=True, weight_norm_g=1),
               dict(netD="n_layer"), dict(norm_E="spectralbatch", use_vae=True)] + \
        [dict(norm_D=n) for n in ("spectralbatch", "spectralsync_batch", "spectralnone",
                                  "instance", "batch", "none")]
    for kw in options:
        for o in (base, dataclasses.replace(base, isTrain=False)):
            MichiGANModel(dataclasses.replace(o, **kw), "cpu")
    with pytest.raises(NotImplementedError, match="fused_step"):
        check_supported(dataclasses.replace(base, fused_step=True))


def test_flag_matrix_instance_feat_row_trains_checkpoints_and_restores(tmp_path):
    """tests/test_torch_most.py's flag-matrix rows in the same form for the
    row instance_feat (--use_instance_feat): one epoch of the bundled sample
    through the trainer CLI, its checkpoint with _net_FE.pth, then the
    inference CLI restoring netG and netFE from it."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    ck = str(tmp_path / "checkpoints")
    run = lambda module, *flags: subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, module, *ROW_COMMON, "--use_instance_feat",
         "--checkpoints_dir", ck, *flags], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    train = run("michigan_tpu_torch.train", "--ndf", "8", "--batchSize", "1", "--niter", "1",
                "--nThreads", "1", "--print_freq", "1", "--random_expand_mask",
                "--label_dir", os.path.join(DATA_DIR, "val_labels"),
                "--image_dir", os.path.join(DATA_DIR, "val_images"),
                "--orient_dir", os.path.join(DATA_DIR, "val_dense_orients"))
    assert train.returncode == 0, train.stdout + train.stderr
    assert train.stdout.count("(epoch: 1, iters: 1") == 1 and train.stdout.strip().endswith("ok")
    files = sorted(os.listdir(os.path.join(ck, "row")))
    for f in ("1_net_G.pth", "1_net_D.pth", "1_net_FE.pth", "latest_net_FE.pth",
              "latest_optim.pth"):
        assert f in files, (f, files)
    infer = run("michigan_tpu_torch.inference", "--which_epoch", "latest",
                "--data_dir", DATA_DIR, "--inference_ref_name", "67172",
                "--inference_tag_name", "67172", "--inference_orient_name", "67172")
    assert infer.returncode == 0, infer.stdout + infer.stderr
    for net, x in (("netG", "G"), ("netFE", "FE")):
        assert f"loaded {net} from {os.path.join(ck, 'row', f'latest_net_{x}.pth')}" in \
            infer.stdout
    assert (tmp_path / "inference_samples" / "fake_image.jpg").exists()
