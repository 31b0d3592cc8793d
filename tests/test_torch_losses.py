"""The training slice's modules and losses against the JAX package's.

Weights come from each Flax module's init through the port's weight bridge;
inputs are seeded numpy in NHWC, transposed to NCHW at the port's boundary.
Tolerance: rtol 1e-4, atol 1e-5 (float32 sums in another order), unless a
test says otherwise.

The orientation loss's gradient is held against `jax.grad` under
MICHIGAN_FILTERBANK=direct (fp32 autodiff through the bank conv) within 1e-4
of the gradient's largest magnitude, and against the default s2d path, whose
backward runs in bf16, within 2e-2.  Both run on textured planes: there the
clamped responses have no exact ties, where the two frameworks' max
gradients would split differently (JAX shares a tie's gradient, torch gives
it to the returned index).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu import losses as JL
from michigan_tpu.config import Options
from michigan_tpu.models.architecture import SPADEResnetBlock as JBlock
from michigan_tpu.models.discriminator import MultiscaleDiscriminator as JD
from michigan_tpu.models.vgg import VGG19 as JVGG
from michigan_tpu.ops import color as jcolor
from michigan_tpu.ops import masks as jmasks
from michigan_tpu.ops import norms as jnorms
from michigan_tpu.ops import resize as jresize
from michigan_tpu.ops.pallas.conv_lowch import conv3x3_same_lowch as pallas_lowch
from michigan_tpu_torch import convert
from michigan_tpu_torch.losses import color, feat, gan, orient, perceptual
from michigan_tpu_torch.models.architecture import SPADEResnetBlock
from michigan_tpu_torch.models.discriminator import MultiscaleDiscriminator
from michigan_tpu_torch.models.layers import frozen_buffers
from michigan_tpu_torch.models.vgg import VGG19
from michigan_tpu_torch.ops import cuda as kernels
from michigan_tpu_torch.ops import filters, masks, norms, resize
from michigan_tpu_torch.ops import color as tcolor
from michigan_tpu_torch.ops.cuda import lowch as L
from michigan_tpu_torch.ops.cuda import orient as O

TOL = dict(rtol=1e-4, atol=1e-5)
REPO_AB_COUNT = "data_assets/ab_count.npy"


def train_opt(**kw):
    d = dict(isTrain=True, crop_size=32, load_size=32, ngf=8, ndf=8, use_ig=True)
    d.update(kw)
    return Options(**d).finalize()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **(tol or TOL))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_discriminator_forward_and_weight_gradients_match_jax(rng):
    opt = train_opt()
    x = rng.standard_normal((4, 32, 32, opt.d_input_nc())).astype(np.float32)
    jd = JD(opt)
    v = to_np(jax.jit(lambda k, x: jd.init(k, x, train=False))(jax.random.PRNGKey(1), x))
    j_out = jax.jit(lambda v, x: jd.apply(v, x, train=True))(v, x)
    cot = [[rng.standard_normal(np.shape(t)).astype(np.float32) for t in s] for s in j_out]

    def j_loss(p):
        out = jd.apply({**v, "params": p}, x, train=True)
        return sum((o * c).sum() for s, cs in zip(out, cot) for o, c in zip(s, cs))

    j_grad = convert.module_state_dict({"params": to_np(jax.jit(jax.grad(j_loss))(v["params"]))},
                                       convert.D_RENAMES)
    d = MultiscaleDiscriminator(opt).train()
    d.load_state_dict(convert.state_dicts_from_flax({"netD": v}, opt)["netD"], strict=True)
    out = d(nchw(x))
    sum((o * nchw(c)).sum() for s, cs in zip(out, cot) for o, c in zip(s, cs)).backward()
    for s, js in zip(out, j_out):
        for o, j in zip(s, js):
            close(nhwc(o), j)
    for k, p in d.named_parameters():
        want = j_grad[k.replace("weight_orig", "weight")].numpy()
        assert np.abs(p.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max(), k
    # netD's train-mode forward never writes its spectral u / v, as in JAX
    before = {k: t.clone() for k, t in d.state_dict().items()}
    d(nchw(x))
    for k, t in d.state_dict().items():
        assert torch.equal(t, before[k]), k


@pytest.mark.parametrize("grad", [True, False])  # no grad: features_2 takes the lowch route
def test_vgg19_matches_jax(rng, grad):
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jv = JVGG()
    v = to_np(jax.jit(jv.init)(jax.random.PRNGKey(2), x))
    net = VGG19()
    net.load_state_dict(convert.state_dicts_from_flax({"vgg": v}, train_opt())["vgg"],
                        strict=True)
    with torch.set_grad_enabled(grad):
        got = net(nchw(x))
    want = jax.jit(jv.apply)(v, x)
    assert len(got) == 5
    for a, b in zip(got, want):
        close(nhwc(a), b)


@pytest.mark.parametrize("net", ["netD", "vgg"])
def test_round_trip_discriminator_and_vgg19(rng, net):
    """netD's tree (spectral u / v included) and VGG19's (shapes from tracing
    their inits, values random) survive JAX -> port state_dict -> the JAX
    package's own converter exactly."""
    from michigan_tpu.training.convert import convert_discriminator, convert_vgg19

    opt = train_opt()
    if net == "netD":
        shapes = jax.eval_shape(lambda k, x: JD(opt).init(k, x, train=False),
                                jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, opt.d_input_nc())))
        port = MultiscaleDiscriminator(opt)
    else:
        shapes = jax.eval_shape(JVGG().init, jax.random.PRNGKey(6), jnp.zeros((1, 32, 32, 3)))
        port = VGG19()
    v = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    sd = convert.state_dicts_from_flax({net: v}, opt)[net]
    port.load_state_dict(sd, strict=True)
    if net == "netD":
        back = convert_discriminator(sd, opt)
    else:  # convert_vgg19 takes torchvision's `features` state_dict
        back = convert_vgg19({k.removeprefix("features."): t for k, t in sd.items()})
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("fin,fout", [(16, 8), (8, 8)])
def test_spade_block_train_mode_matches_jax(rng, fin, fout):
    """Train-mode SPADE: batch statistics, running statistics and spectral
    u / v written as JAX's mutable apply writes them; under
    frozen_buffers the same output and nothing written."""
    opt = train_opt()
    x = rng.standard_normal((2, 8, 8, fin)).astype(np.float32)
    seg = rng.uniform(size=(2, 16, 16, opt.spade_label_nc())).astype(np.float32)
    jm = JBlock(fin, fout, opt)
    v = to_np(jax.jit(jm.init)(jax.random.PRNGKey(3), x, seg))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    want, upd = jax.jit(lambda v: jm.apply(v, x, seg, train=True,
                                           mutable=["batch_stats", "spectral"]))(v)
    want_state = convert.module_state_dict(to_np({**v, **upd}))
    net = SPADEResnetBlock(fin, fout, opt)
    net.load_state_dict(convert.module_state_dict(v), strict=True)
    net.train()
    before = {k: t.clone() for k, t in net.state_dict().items()}
    with frozen_buffers(net):
        frozen = nhwc(net(nchw(x), nchw(seg)))
    for k, t in net.state_dict().items():
        assert torch.equal(t, before[k]), k
    got = nhwc(net(nchw(x), nchw(seg)))
    close(got, want)
    close(frozen, want)
    for k, t in net.state_dict().items():
        if k.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
            close(t.numpy(), want_state[k].numpy(), rtol=0, atol=1e-5)


def test_batch_norm_train_matches_jax(rng):
    x = (rng.standard_normal((3, 5, 6, 4)) * 3 + 1).astype(np.float32)
    rm, rv = rng.standard_normal(4).astype(np.float32), rng.uniform(1, 2, 4).astype(np.float32)
    y, m, v = norms.batch_norm_train(nchw(x), torch.from_numpy(rm), torch.from_numpy(rv))
    jy, jm, jv = jnorms.batch_norm_train(jnp.asarray(x), jnp.asarray(rm), jnp.asarray(rv))
    close(nhwc(y), jy)
    close(m.numpy(), jm)
    close(v.numpy(), jv)


def test_pools_and_edges_match_jax(rng):
    x = rng.standard_normal((2, 17, 20, 3)).astype(np.float32)
    close(nhwc(resize.avg_pool_3x3s2(nchw(x))), jresize.avg_pool_3x3s2(jnp.asarray(x)))
    close(nhwc(resize.max_pool_same(nchw(x), 2, 2, 0)),
          jresize.max_pool_same(jnp.asarray(x), 2, 2, 0))
    m = (rng.uniform(size=(2, 40, 40, 1)) > 0.6).astype(np.float32)
    close(nhwc(masks.wide_edges(nchw(m))), jmasks.wide_edges(jnp.asarray(m)))


def test_rgb_to_lab_matches_jax(rng):
    rgb = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    rgb[0, 0, :3] = 0.0  # the linear branch of f() near black
    close(nhwc(tcolor.rgb_to_lab(nchw(rgb))), jcolor.rgb_to_lab(jnp.asarray(rgb)),
          rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def d_outputs(rng, n=2, sizes=((9, 9), (5, 5)), chans=(4, 6, 1)):
    return [[rng.standard_normal((n,) + hw + (c,)).astype(np.float32) for c in chans]
            for hw in sizes]


def port_preds(preds):
    return [[nchw(t) for t in s] for s in preds]


@pytest.mark.parametrize("kw", [dict(), dict(wide_edge=3.0), dict(remove_background=True),
                                dict(gan_mode="ls"), dict(gan_mode="original"),
                                dict(gan_mode="w")])
def test_gan_losses_match_jax(rng, kw):
    opt = train_opt(**kw)
    preds = d_outputs(rng)
    label = (rng.uniform(size=(2, 32, 32, 1)) > 0.5).astype(np.float32)
    for real, for_d in ((True, False), (True, True), (False, True)):
        got = gan.multiscale_gan_loss(port_preds(preds), real, for_d, opt, nchw(label))
        want = JL.multiscale_gan_loss([[jnp.asarray(t) for t in s] for s in preds], real, for_d,
                                      opt, jnp.asarray(label))
        close(float(got), float(want))


@pytest.mark.parametrize("remove_background", [False, True])
def test_feat_loss_matches_jax(rng, remove_background):
    opt = train_opt(remove_background=remove_background)
    fake, real = d_outputs(rng), d_outputs(rng)
    label = (rng.uniform(size=(2, 32, 32, 1)) > 0.5).astype(np.float32)
    got = feat.gan_feat_loss(port_preds(fake), port_preds(real), opt, nchw(label))
    want = JL.gan_feat_loss(fake, real, opt, jnp.asarray(label))
    close(float(got), float(want))


@pytest.mark.parametrize("remove_background", [False, True])
def test_vgg_style_content_losses_match_jax(rng, remove_background):
    opt = train_opt(remove_background=remove_background)
    shapes = [(2, 32 // f, 32 // f, c) for f, c in ((1, 8), (2, 16), (4, 16), (8, 32), (16, 32))]
    fs = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    lab_s, lab_c = ((rng.uniform(size=(2, 32, 32, 1)) > 0.4).astype(np.float32)
                    for _ in range(2))
    pt = [[nchw(t) for t in f] for f in fs]
    close(float(perceptual.vgg_loss_from_features(pt[0], pt[1], opt, nchw(lab_c))),
          float(JL.vgg_loss_from_features(fs[0], fs[1], opt, jnp.asarray(lab_c))))
    got = perceptual.style_content_loss_from_features(*pt, opt, nchw(lab_s), nchw(lab_c))
    want = JL.style_content_loss_from_features(*fs, opt, jnp.asarray(lab_s), jnp.asarray(lab_c))
    for a, b in zip(got, want):
        close(float(a), float(b))


@pytest.mark.parametrize("balance", [False, True])
def test_lab_and_background_losses_match_jax(rng, balance):
    opt = train_opt(balance_Lab=balance)
    fake, real = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(2, 16, 16, 1)) > 0.5).astype(np.float32)
    ab = np.load(REPO_AB_COUNT).astype(np.float32) if balance else None
    got = color.lab_color_loss(nchw(fake), nchw(real), opt, nchw(mask),
                               None if ab is None else torch.from_numpy(ab))
    want = JL.lab_color_loss(jnp.asarray(fake), jnp.asarray(real), opt, jnp.asarray(mask),
                             None if ab is None else jnp.asarray(ab))
    close(float(got), float(want))
    onehot = np.concatenate([1 - mask, mask], axis=-1)
    close(float(color.rgb_background_l1_loss(nchw(fake), nchw(onehot), nchw(real))),
          float(JL.rgb_background_l1_loss(jnp.asarray(fake), jnp.asarray(onehot),
                                          jnp.asarray(real))))


def strands(rng, n, s, amp):
    """(n, s, s, 3) images in [-1, 1]: oriented strands plus noise, so the
    filter bank's responses have no exact ties.  `amp` scales the texture
    around black: small values keep the Gabor max response near 1, where
    its tanh squash has a gradient."""
    ax = np.arange(s, dtype=np.float32) / s
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    wave = np.sin(2 * math.pi * 6 * (xx * np.cos(3 * yy) + yy * np.sin(3 * xx)))
    img = 0.5 + 0.4 * wave[None, ..., None] + 0.1 * rng.uniform(size=(n, s, s, 3))
    return (-1.0 + amp * img).astype(np.float32)


def orient_case(rng, mode):
    opt = train_opt(orient_filter=mode)
    fake = strands(rng, 2, 32, 0.02 if mode == "gabor" else 2.0)
    hair = np.zeros((2, 32, 32, 1), np.float32)
    hair[:, 4:28, 6:30] = 1.0
    onehot = np.concatenate([1 - hair, hair], axis=-1)
    label = rng.uniform(-1, 1, (2, 32, 32, 2)).astype(np.float32) * hair
    return opt, fake, onehot, label


def port_orient_loss_and_grad(opt, fake, onehot, label):
    x = nchw(fake).requires_grad_()
    l1, conf = orient.orient_loss(x, nchw(label), nchw(onehot), opt)
    (l1 * 10 + conf).backward()
    return l1.item(), conf.item(), nhwc(x.grad)


def jax_orient_loss_and_grad(opt, fake, onehot, label):
    def f(x):
        l1, conf = JL.orient_loss(x, jnp.asarray(label), jnp.asarray(onehot), opt)
        return l1 * 10 + conf, (l1, conf)

    g, (l1, conf) = jax.grad(f, has_aux=True)(jnp.asarray(fake))
    return float(l1), float(conf), np.asarray(g)


@pytest.mark.parametrize("mode", ["gabor", "dog"])
def test_orient_loss_and_gradient_match_jax(rng, monkeypatch, mode):
    """Against fp32 autodiff (MICHIGAN_FILTERBANK=direct): within 1e-4 of the
    gradient's largest magnitude; against the default s2d path (bf16
    backward): within 2e-2."""
    case = orient_case(rng, mode)
    l1, conf, grad = port_orient_loss_and_grad(*case)
    assert np.abs(grad).max() > 0
    monkeypatch.setenv("MICHIGAN_FILTERBANK", "direct")
    j_l1, j_conf, j_grad = jax_orient_loss_and_grad(*case)
    close(l1, j_l1)
    close(conf, j_conf)
    scale = np.abs(j_grad).max()
    assert np.abs(grad - j_grad).max() <= 1e-4 * scale
    monkeypatch.setenv("MICHIGAN_FILTERBANK", "s2d")
    _, _, s2d_grad = jax_orient_loss_and_grad(*case)
    assert np.abs(grad - s2d_grad).max() <= 2e-2 * scale


@pytest.mark.parametrize("mode", ["gabor", "dog"])
def test_orientation_backward_plain_is_autograd_of_the_plain_forward(rng, mode):
    """The backward's plain version (the transposed bank conv of the
    cotangent at each argmax) equals autograd through conv, clamp and max,
    on a textured plane; the CPU run counts no launch."""
    gray = torch.from_numpy(strands(rng, 2, 40, 1.0)[..., :1] * 100 + 127).permute(0, 3, 1, 2)
    gray = gray.contiguous()
    bank = filters.bank(mode, gray.device)
    dconf = torch.from_numpy(rng.standard_normal((2, 40, 40)).astype(np.float32))
    g = gray.clone().requires_grad_()
    _, conf = O.filterbank_orientation_plain(g, bank)
    (want,) = torch.autograd.grad(conf, g, dconf)
    kernels.reset_launch_counts()
    g2 = gray.clone().requires_grad_()
    idx, conf2 = O.OrientationResponse.apply(g2, bank)
    conf2.backward(dconf)
    torch.testing.assert_close(g2.grad, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
    assert not idx.requires_grad
    assert kernels.launch_counts()["filterbank_orientation_backward"] == 0


@pytest.mark.parametrize("shape,co", [((2, 16, 16, 8), 8), ((1, 16, 20, 64), 64)])
def test_conv3x3_same_lowch_plain_matches_pallas(rng, shape, co):
    """The plain version against the Pallas kernel in interpret mode (as
    tests/test_pallas_kernels.py runs it), both strategies."""
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], co)) / math.sqrt(9 * shape[-1])).astype(np.float32)
    got = nhwc(L.conv3x3_same_lowch(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy())))
    for im2col in (True, False):
        want = np.asarray(pallas_lowch(jnp.asarray(x), jnp.asarray(w), tile_rows=4,
                                       im2col=im2col))
        close(got, want, rtol=1e-4, atol=1e-4)
