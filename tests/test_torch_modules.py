"""The port's modules against the JAX package's on the same weights.

JAX variables come from each Flax module's own init; `state_dicts_from_flax`
/ `module_state_dict` carry them into the port, which loads them strictly.
Inputs are made in NHWC with numpy and transposed to NCHW at the port's
boundary.  Tolerances follow the existing oracles: blocks and layers 1e-4,
the inpainter 1e-3 (max abs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu.config import Options
from michigan_tpu.models import layers as jl
from michigan_tpu.models.architecture import SPADEResnetBlock as JBlock
from michigan_tpu.models.encoders import BackgroundEncode2 as JBack
from michigan_tpu.models.encoders import ImageEncoder3 as JEnc
from michigan_tpu.models.inpaint import InpaintGenerator as JIG
from michigan_tpu.models.inpaint import SInpaintGenerator as JSIG
from michigan_tpu.training.convert import convert_generator, convert_inpaint
from michigan_tpu_torch import convert
from michigan_tpu_torch.models import layers as tl
from michigan_tpu_torch.models.architecture import SPADEResnetBlock
from michigan_tpu_torch.models.encoders import BackgroundEncode2, ImageEncoder3
from michigan_tpu_torch.models.inpaint import InpaintGenerator, SInpaintGenerator
from michigan_tpu_torch.model import MichiGANModel

BLOCK_TOL = 1e-4
IG_TOL = 1e-3


def opt_small(**kw):
    base = dict(
        isTrain=False, netG="spadeb", ngf=4, crop_size=64, load_size=64,
        use_encoder=True, use_ig=True, noise_background=True, expand_mask_be=True,
        expand_th=5, add_feat_zeros=True, init_type="none",
    )
    base.update(kw)
    return Options(**base).finalize()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_from(variables, net, renames=convert.G_RENAMES, transposed=frozenset()):
    net.load_state_dict(convert.module_state_dict(to_np(variables), renames, transposed),
                        strict=True)
    return net.eval()


def jit_init(module):
    return jax.jit(module.init)


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_spectral_conv_dilated(rng):
    x = rng.standard_normal((1, 12, 12, 6)).astype(np.float32)
    jm = jl.TorchConv(5, 3, padding=2, dilation=2, spectral=True)
    v = jit_init(jm)(jax.random.PRNGKey(0), jnp.asarray(x))
    net = port_from(v, tl.SpectralConv2d(6, 5, 3, padding=2, dilation=2))
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    assert max_err(got, jax.jit(jm.apply)(v, jnp.asarray(x))) <= BLOCK_TOL


def test_spectral_conv_transpose(rng):
    x = rng.standard_normal((1, 6, 6, 8)).astype(np.float32)
    jm = jl.TorchConvTranspose(5, 4, 2, padding=1, spectral=True)
    v = jit_init(jm)(jax.random.PRNGKey(1), jnp.asarray(x))
    net = port_from(v, tl.SpectralConvTranspose2d(8, 5, 4, 2, 1), transposed={()})
    with torch.no_grad():
        got = nhwc(net(nchw(x)))
    assert got.shape == (1, 12, 12, 5)
    assert max_err(got, jax.jit(jm.apply)(v, jnp.asarray(x))) <= BLOCK_TOL


def test_partial_conv(rng):
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    m = (rng.uniform(size=(1, 16, 16, 1)) > 0.4).astype(np.float32)
    jm = jl.PartialConv(7, 3, 2, 1)
    v = jit_init(jm)(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(m))
    v = {"params": {"kernel": v["params"]["kernel"],
                    "bias": rng.standard_normal(7).astype(np.float32)}}
    net = port_from(v, tl.PartialConv(3, 7, 3, 2, 1))
    with torch.no_grad():
        out, mask = net(nchw(x), nchw(m))
    j_out, j_mask = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(m))
    assert max_err(nhwc(out), j_out) <= BLOCK_TOL
    np.testing.assert_array_equal(nhwc(mask), np.asarray(j_mask))


@pytest.mark.parametrize("fin,fout", [(16, 8), (8, 8)])
def test_spade_resnet_block(rng, fin, fout):
    """Eval-mode SPADE block with random running stats (the port's
    spade_modulate against JAX's batch_norm_eval composition)."""
    opt = opt_small()
    x = rng.standard_normal((1, 8, 8, fin)).astype(np.float32)
    seg = rng.uniform(size=(1, 16, 16, opt.spade_label_nc())).astype(np.float32)
    jm = JBlock(fin, fout, opt)
    v = to_np(jit_init(jm)(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(seg)))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    net = port_from(v, SPADEResnetBlock(fin, fout, opt))
    with torch.no_grad():
        got = nhwc(net(nchw(x), nchw(seg)))
    assert max_err(got, jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(seg))) <= BLOCK_TOL


def test_image_encoder3(rng):
    opt = opt_small()
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    ref = (rng.uniform(size=(1, 64, 64, 1)) > 0.5).astype(np.float32)
    tag = (rng.uniform(size=(1, 64, 64, 1)) > 0.5).astype(np.float32)
    jm = JEnc(opt, 1, 1)
    args = [jnp.asarray(a) for a in (x, ref, tag)]
    v = jit_init(jm)(jax.random.PRNGKey(4), *args)
    net = port_from(v, ImageEncoder3(opt, 1, 1))
    with torch.no_grad():
        got = nhwc(net(nchw(x), nchw(ref), nchw(tag)))
    assert got.shape == (1, 1, 1, 64)
    assert max_err(got, jax.jit(jm.apply)(v, *args)) <= BLOCK_TOL


def test_background_encode2(rng):
    opt = opt_small()
    s = opt.generator_input_size()
    image = rng.uniform(-1, 1, (1, s, s, 3)).astype(np.float32)
    hair = np.zeros((1, s, s, 1), np.float32)
    hair[:, 40:80, 40:90] = 1
    mask = np.concatenate([1 - hair, hair], -1)
    noise = rng.uniform(size=(1, s, s, 3)).astype(np.float32)
    jm = JBack(opt)
    args = [jnp.asarray(a) for a in (image, mask, noise)]
    v = jit_init(jm)(jax.random.PRNGKey(5), *args)
    net = port_from(v, BackgroundEncode2(opt))
    with torch.no_grad():
        feats, masks = net(nchw(image), nchw(mask), nchw(noise))
    j_feats, j_masks = jax.jit(jm.apply)(v, *args)
    for a, b in zip(feats, j_feats):
        assert max_err(nhwc(a), b) <= BLOCK_TOL
    for a, b in zip(masks, j_masks):
        np.testing.assert_array_equal(nhwc(a), np.asarray(b))


@pytest.fixture(scope="module")
def ig_pair():
    opt = opt_small()
    jm = JIG(opt=opt)
    v = to_np(jit_init(jm)(jax.random.PRNGKey(6), jnp.zeros((1, 32, 32, 4))))
    return opt, jm, v


def test_inpaint_generator(ig_pair, rng):
    opt, jm, v = ig_pair
    x = rng.uniform(size=(1, 32, 32, 4)).astype(np.float32)
    net = InpaintGenerator()
    net.load_state_dict(convert.state_dicts_from_flax({"netIG": v}, opt)["netIG"], strict=True)
    with torch.no_grad():
        got = nhwc(net.eval()(nchw(x)))
    assert max_err(got, jax.jit(jm.apply)(v, jnp.asarray(x))) <= IG_TOL


@pytest.mark.parametrize("epilogue", [False, True])
def test_sinpaint_generator(rng, epilogue):
    """SIG with two resblocks on a 32^2 input (as tests/test_pallas_kernels.py
    :141), with and without --use_pallas_epilogue on both sides: JAX runs its
    Pallas conv3x3_in_act in interpret mode, the port the kernel's plain
    version."""
    opt = opt_small(use_stroke=True, use_pallas_epilogue=epilogue)
    jm = JSIG(opt=opt, blocks=2)
    x = rng.uniform(size=(1, 32, 32, 5)).astype(np.float32)
    v = to_np(jit_init(jm)(jax.random.PRNGKey(9), jnp.asarray(x)))
    net = SInpaintGenerator(blocks=2, epilogue=epilogue)
    net.load_state_dict(convert.state_dicts_from_flax({"netSIG": v}, opt)["netSIG"], strict=True)
    with torch.no_grad():
        got = nhwc(net.eval()(nchw(x)))
    assert max_err(got, jax.jit(jm.apply)(v, jnp.asarray(x))) <= IG_TOL


def assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_round_trip_inpaint(ig_pair):
    """JAX tree -> port state_dict -> the JAX package's own converter gives
    the original tree back exactly."""
    opt, _, v = ig_pair
    sd = convert.state_dicts_from_flax({"netIG": v}, opt)["netIG"]
    InpaintGenerator().load_state_dict(sd, strict=True)
    assert_trees_equal(convert_inpaint(sd), v)


def test_round_trip_sinpaint(rng):
    """netSIG's full tree (12 blocks, shapes from tracing its init, values
    random) survives JAX -> port -> convert_inpaint exactly."""
    opt = opt_small(use_stroke=True)
    shapes = jax.eval_shape(JSIG(opt=opt).init, jax.random.PRNGKey(10),
                            jnp.zeros((1, 32, 32, 5)))
    v = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    sd = convert.state_dicts_from_flax({"netSIG": v}, opt)["netSIG"]
    MichiGANModel(opt, "cpu").netSIG.load_state_dict(sd, strict=True)
    assert_trees_equal(convert_inpaint(sd), v)


def test_round_trip_generator(rng):
    """The generator's tree (shapes from tracing its init, values random)
    survives JAX -> port -> convert_generator exactly."""
    from michigan_tpu.models.generator import SPADEBGenerator as JGen

    opt = opt_small()
    s = opt.generator_input_size()
    z = lambda c: jnp.zeros((1, s, s, c))
    shapes = jax.eval_shape(JGen(opt).init, jax.random.PRNGKey(7), z(2), z(2), z(2), z(3),
                            z(3), z(3))
    v = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    sd = convert.state_dicts_from_flax({"netG": v}, opt)["netG"]
    MichiGANModel(opt, "cpu").netG.load_state_dict(sd, strict=True)
    assert_trees_equal(convert_generator(sd, opt), v)


@pytest.mark.parametrize("norm_type", ["syncbatch", "instance"])
def test_param_free_norm(rng, norm_type):
    from michigan_tpu.models.normalization import ParamFreeNorm as JNorm
    from michigan_tpu_torch.models.normalization import ParamFreeNorm

    x = (rng.standard_normal((2, 6, 5, 8)) * 2 + 1).astype(np.float32)
    jm = JNorm(norm_type, 8)
    v = to_np(jit_init(jm)(jax.random.PRNGKey(8), jnp.asarray(x)))
    if norm_type != "instance":
        v["batch_stats"] = {
            "running_mean": rng.standard_normal(8).astype(np.float32),
            "running_var": rng.uniform(0.5, 2.0, 8).astype(np.float32),
        }
    net = ParamFreeNorm(norm_type, 8)
    net.load_state_dict(convert.module_state_dict({"params": {}, **v}), strict=True)
    with torch.no_grad():
        got = nhwc(net.eval()(nchw(x)))
    assert max_err(got, jax.jit(jm.apply)(v, jnp.asarray(x))) <= BLOCK_TOL


@pytest.mark.parametrize("train", [False, True])
def test_expanded_back_mask(train):
    """Eval: the add_feat_zeros-aware expansion; train: the random expansion
    at its expected width (two extra 3x3 dilations)."""
    from michigan_tpu.models.encoders import _expanded_back_mask as j_mask
    from michigan_tpu_torch.models.encoders import _expanded_back_mask

    opt = opt_small(isTrain=train, random_expand_mask=train)
    s = opt.generator_input_size()
    hair = np.zeros((1, s, s, 1), np.float32)
    hair[:, 50:70, 40:90] = 1
    mask = np.concatenate([1 - hair, hair], -1)
    got = nhwc(_expanded_back_mask(opt, nchw(mask)))
    np.testing.assert_array_equal(got, np.asarray(j_mask(opt, jnp.asarray(mask))))
    assert got.sum() < (1 - hair).sum()


def test_spade_gamma_beta_conv_follows_weight_changes(rng):
    """SPADE keeps mlp_gamma/mlp_beta concatenated between forwards without
    autograd; a load, an in-place write or a grad-enabled forward must see
    the current weights.  Reference: the two convs run separately (NCHW)."""
    from michigan_tpu_torch.models.normalization import SPADE
    from michigan_tpu_torch.ops.norms import batch_norm_eval

    m = SPADE("spadesyncbatch3x3", 6, 3, nhidden=8).eval()
    x = torch.from_numpy(rng.standard_normal((2, 6, 8, 8)).astype(np.float32))
    seg = torch.from_numpy(rng.uniform(size=(2, 3, 8, 8)).astype(np.float32))

    def reference():
        with torch.no_grad():
            actv = m.mlp_shared(seg)
            pfn = m.param_free_norm
            return (batch_norm_eval(x, pfn.running_mean, pfn.running_var, pfn.eps)
                    * (1 + m.mlp_gamma(actv)) + m.mlp_beta(actv))

    with torch.no_grad():
        torch.testing.assert_close(m(x, seg), reference(), atol=1e-5, rtol=1e-5)
        sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
              if k.startswith("mlp_") else v for k, v in m.state_dict().items()}
        m.load_state_dict(sd, strict=True)
        torch.testing.assert_close(m(x, seg), reference(), atol=1e-5, rtol=1e-5)
        m.mlp_beta.bias.add_(1.0)
        torch.testing.assert_close(m(x, seg), reference(), atol=1e-5, rtol=1e-5)
    m(x, seg).sum().backward()
    assert m.mlp_gamma.weight.grad is not None and m.mlp_beta.bias.grad is not None


# ---------------------------------------------------------------------------
# the float32 conv route off cuDNN (layers.NativeConv) and where it applies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("func,bias,rest", [
    (torch.nn.functional.conv2d, True, (1, 1, 1, 1)),
    (torch.nn.functional.conv2d, False, (2, 1, 2, 1)),
    (torch.nn.functional.conv_transpose2d, True, (2, 1)),
])
def test_native_conv_matches_the_conv_and_its_gradients(func, bias, rest):
    """NativeConv computes the conv and its three gradients exactly as the
    conv does (in float64 here, where only the summation order could
    differ)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 6, 9, 9), generator=g, dtype=torch.float64, requires_grad=True)
    shape = (6, 5, 3, 3) if func is torch.nn.functional.conv_transpose2d else (5, 6, 3, 3)
    w = torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(5, generator=g, dtype=torch.float64, requires_grad=True) if bias else None
    ins = [t for t in (x, w, b) if t is not None]
    want = func(x, w, b, *rest)
    cot = torch.randn(want.shape, generator=g, dtype=torch.float64)
    got = tl.NativeConv.apply(func, x, w, b, *rest)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for a, e in zip(torch.autograd.grad(got, ins, cot), torch.autograd.grad(want, ins, cot)):
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12)


def test_generator_pins_its_high_channel_blocks_off_cudnn(monkeypatch):
    """In train mode the generator runs its CUDNN_OFF blocks, and only those,
    inside layers.cudnn_off, and in eval mode none; layers.conv takes
    NativeConv there only for a float32 card tensor, so the CPU and bf16
    keep the plain conv."""
    from michigan_tpu_torch.models.generator import CUDNN_OFF, SPADEBGenerator

    opt = opt_small()
    net = SPADEBGenerator(opt)
    seen = {}
    for name, m in net.named_modules():
        if name:
            m.register_forward_pre_hook(
                lambda *_, b=name.split(".")[0]: seen.setdefault(b, set()).add(tl._CUDNN_OFF))
    s = opt.generator_input_size()
    g = torch.Generator().manual_seed(0)
    seg = torch.zeros((1, 2, s, s))
    seg[:, 1, s // 4:3 * s // 4, s // 4:3 * s // 4] = 1
    seg[:, 0] = 1 - seg[:, 1]
    args = (seg, seg, torch.rand((1, 2, s, s), generator=g), torch.rand((1, 3, s, s), generator=g),
            torch.rand((1, 3, s, s), generator=g), torch.rand((1, 3, s, s), generator=g))
    for train in (True, False):
        seen.clear()
        with torch.no_grad():
            net.train(train)(*args)
        assert set(CUDNN_OFF) < set(seen), seen
        assert seen == {b: {train and b in CUDNN_OFF} for b in seen}, (train, seen)
    calls = []
    monkeypatch.setattr(tl.NativeConv, "apply", lambda *a: calls.append(a) or "native")
    x = torch.zeros((1, 2, 4, 4))
    w = torch.zeros((3, 2, 3, 3))
    cuda_like = type("CudaLike", (), {"is_cuda": True, "dtype": torch.float32})()
    with tl.cudnn_off():
        assert tl.conv(torch.nn.functional.conv2d, x, w, None, 1, 1).shape == (1, 3, 4, 4)
        assert tl.conv(None, cuda_like, None, None) == "native"
        cuda_like.dtype = torch.bfloat16
        with pytest.raises(TypeError):  # bf16: the plain conv (here not callable)
            tl.conv(None, cuda_like, None, None)
    cuda_like.dtype = torch.float32
    with pytest.raises(TypeError):  # outside cudnn_off: the plain conv
        tl.conv(None, cuda_like, None, None)
    assert len(calls) == 1
