"""The port's bf16 compute policy (--dtype bfloat16) on the serving paths,
against the JAX package's, on the CPU.

- kernels: the plain versions of conv3x3_in_act, fused_instance_norm and
  spade_modulate in bfloat16 against the JAX package's Pallas functions in
  bfloat16 (interpret mode, as tests/test_pallas_kernels.py runs them), at
  aligned shapes so that the Pallas path is the one taken: atol 1e-2, rtol
  1.6e-2 (about two bf16 ulps: both round the output once, from float32
  sums taken in another order);
- the flagship slice and the stroke slice (crop 128, ngf 8) through both
  packages' ``MichiGANModel.infer`` on the same weights, JAX with
  --use_pallas (and --use_pallas_epilogue for the stroke slice), so that
  both compute the same function.  Gate: port-bf16 vs JAX-bf16 max abs at
  most 2x JAX-bf16 vs JAX-fp32; and the port's bf16 output differs from its
  fp32 one (a policy that silently ran float32 would fail).  Measured on
  the CPU: flagship port-bf16 vs JAX-bf16 0.0270 against
  JAX-bf16 vs JAX-fp32 0.0274, port bf16 vs fp32 0.0309; stroke 0.0277
  against 0.0340, port bf16 vs fp32 0.0233 (each test prints its own);
- the frozen towers' rounding (IG, SIG and, in training, VGG19) equals
  ``compact_frozen_variables`` leaf by leaf, and the weight bridge carries
  those compacted leaves into the port exactly;
- float32 is unchanged: with the code this policy replaced patched back in
  (the layers' forwards, SPADE's gamma / beta conv, the model's casts and
  frozen-tower rounding, the plain conv3x3_in_act), float32 outputs are
  bit-identical;
- --batch_inference, the CLIs without jax and the refusals: in
  tests/test_torch_bf16_clis.py, a file of its own so that it runs in
  another worker.  (tests/test_torch_bf16_training.py holds the bf16 step
  to JAX's.)
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu import config
from michigan_tpu.data.single import demo_inference_data as jax_demo_data
from michigan_tpu.data.single import single_inference_data as jax_data
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.ops.pallas import epilogue as pallas_epilogue
from michigan_tpu.ops.pallas import spade as pallas
from michigan_tpu.training.convert import convert_generator, convert_inpaint, convert_vgg19
from michigan_tpu_torch import model as port_model
from michigan_tpu_torch.convert import state_dicts_from_flax
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.models import layers, normalization
from michigan_tpu_torch.ops.cuda import epilogue as E
from michigan_tpu_torch.ops.cuda import spade as K
from michigan_tpu_torch.ops.cuda.spade import _act
from michigan_tpu_torch.ops.norms import instance_norm, spectral_sigma
from tests.test_torch_stroke import edit_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "datasets", "FFHQ_single")
DEMO_DIR = os.path.join(REPO, "datasets", "FFHQ_demo")
FLAGS = ("--netG spadeb --use_encoder --noise_background --use_ig --expand_mask_be "
         "--expand_th 5 --add_feat_zeros --inference_ref_name 67172 "
         "--inference_tag_name 67172 --inference_orient_name 67172").split()
SMALL = ["--crop_size", "128", "--load_size", "128", "--ngf", "8", "--init_type", "none",
         "--gpu_ids", "-1"]
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)
SLICE_RATIO = 2.0
TRAIN_SMALL = ["--netG", "spadeb", "--use_encoder", "--use_ig", "--noise_background",
               "--crop_size", "64", "--load_size", "64", "--ngf", "8", "--ndf", "8",
               "--gpu_ids", "-1"]


def flagship_opt(*argv):
    return config.test_options(FLAGS + SMALL + ["--data_dir", DATA_DIR] + list(argv))


def stroke_opt(*argv):
    return config.demo_options(SMALL + ["--demo_data_dir", DEMO_DIR] + list(argv))


def as_bf16(opt):
    return dataclasses.replace(opt, dtype="bfloat16")


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def bf16_np(rng, shape, scale=1.0):
    """float32 values that bfloat16 holds exactly, so both packages start
    from the same numbers."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.bfloat16().float().numpy()


# ---------------------------------------------------------------------------
# kernels: plain versions in bf16 against the Pallas functions in bf16
# ---------------------------------------------------------------------------

# (dilation, act, residual, (n, c, co, h, w)): C = Co = 128 at 16^2, batch
# 2, the resident, lane-aligned Pallas path (epilogue.py:114-122); W = 13,
# not a multiple of 8 (the CUDA kernel's narrower halo copies), at both
# dilations on that path; odd C = 7 and Co = 9 at W = 11 and 13, which the
# Pallas kernel refuses (epilogue.py:129-132)
IN_ACT_CASES = [
    pytest.param(2, "relu", False, (2, 128, 128, 16, 16), id="2-relu-False"),
    pytest.param(1, None, True, (2, 128, 128, 16, 16), id="1-None-True"),
    pytest.param(1, "lrelu", False, (2, 128, 128, 16, 16), id="1-lrelu-False"),
    pytest.param(2, "lrelu", True, (1, 128, 128, 9, 13), id="2-lrelu-True-w13"),
    pytest.param(1, "relu", True, (1, 128, 128, 9, 13), id="1-relu-True-w13"),
    pytest.param(2, None, True, (2, 7, 9, 10, 11), id="2-None-True-c7-w11"),
    pytest.param(1, "relu", False, (1, 7, 9, 8, 13), id="1-relu-False-c7-w13"),
]


@pytest.mark.parametrize("d,act,with_res,shape", IN_ACT_CASES)
def test_conv3x3_in_act_plain_bf16_matches_pallas(rng, d, act, with_res, shape):
    """The plain version in bf16 against the Pallas kernel in bf16
    (interpret mode): bf16 x_pad and residual, float32 w and b, within
    BF16_TOL.  Where the kernel refuses the shape, its _xla_reference in
    float32 on the same bf16 operands (w rounded to bf16), rounded to bf16
    once: the kernel's arithmetic (the bf16 call of _xla_reference would
    round the conv, the bias add, the norm and the act each)."""
    n, c, co, h, wd = shape
    x = bf16_np(rng, (n, h + 2 * d, wd + 2 * d, c))
    w = (rng.standard_normal((3, 3, c, co)) * 0.05).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    res = bf16_np(rng, (n, h, wd, co)) if with_res else None
    if c % 128 == 0 and co % 128 == 0:
        ref = pallas_epilogue.conv3x3_in_act(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), dilation=d, act=act,
            residual=None if res is None else jnp.asarray(res, jnp.bfloat16))
    else:
        w16 = jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)
        ref = pallas_epilogue._xla_reference(
            jnp.asarray(x), w16, jnp.asarray(b), d, act, 1e-5,
            None if res is None else jnp.asarray(res)).astype(jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    got = E.conv3x3_in_act(nchw(x, torch.bfloat16),
                           torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
                           torch.from_numpy(b), dilation=d, act=act,
                           residual=None if res is None else nchw(res, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(ref, np.float32), **BF16_TOL)


def test_conv3x3_in_act_plain_bf16_rounds_once():
    """The bf16 plain version normalises the float32 conv sum, not a bf16
    rounding of it (the TPU kernel's semantics, not _xla_reference's)."""
    rng = np.random.default_rng(1)
    x = nchw(bf16_np(rng, (1, 10, 10, 16)), torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((16, 16, 3, 3)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    got = E.conv3x3_in_act(x, w, b, act="relu")
    want = _act(instance_norm(F.conv2d(x.float(), w.bfloat16().float(), b)), "relu")
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("modulated,act", [(False, "lrelu"), (False, None), (True, "relu")])
def test_instance_norm_plain_bf16_matches_pallas(rng, modulated, act):
    shape = (2, 8, 8, 128)  # resident, one 128-channel block per sample
    x = bf16_np(rng, shape, 3.0)
    g, b = (bf16_np(rng, shape) if modulated else None for _ in range(2))
    j = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)
    ref = pallas.fused_instance_norm(j(x), j(g), j(b), act=act)
    t = lambda a: None if a is None else nchw(a, torch.bfloat16)
    got = K.fused_instance_norm(t(x), t(g), t(b), act=act)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(ref, np.float32), **BF16_TOL)


def test_spade_modulate_plain_bf16_matches_pallas(rng):
    shape = (2, 16, 16, 128)  # 512-row tiles, C = 128
    x, g, b = (bf16_np(rng, shape) for _ in range(3))
    mean = rng.standard_normal(128).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, 128).astype(np.float32)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = pallas.spade_modulate(j(x), jnp.asarray(mean), jnp.asarray(inv), j(g), j(b))
    bf = lambda a: nchw(a, torch.bfloat16)
    got = K.spade_modulate(bf(x), torch.from_numpy(mean), torch.from_numpy(inv), bf(g), bf(b))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(ref, np.float32), **BF16_TOL)


# ---------------------------------------------------------------------------
# the slices against the JAX package, bf16
# ---------------------------------------------------------------------------

def port_weights(opt):
    """Seeded float32 port weights and the JAX variables carried from them
    by the JAX package's own converters."""
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    sd = {k: net.state_dict() for k, net in model.nets().items()}
    variables = {"netG": convert_generator(sd["netG"], opt), "netIG": convert_inpaint(sd["netIG"])}
    if opt.use_stroke:
        variables["netSIG"] = convert_inpaint(sd["netSIG"])
    return sd, variables


def run_slice(opt, sd, variables, data, mode):
    """{'port' / 'jax'} x {'float32' / 'bfloat16'} fakes, NHWC numpy; JAX
    with --use_pallas (and the epilogue flag as given)."""
    out = {}
    batch = {k: jnp.asarray(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    for dt in ("float32", "bfloat16"):
        o = dataclasses.replace(opt, dtype=dt, use_pallas=True)
        jm = JModel(o)
        fake, _ = jax.jit(lambda v, b: jm.infer(v, b, inpaint_mode=mode))(
            jm.compact_frozen_variables(variables), batch)
        out["jax", dt] = np.asarray(fake)
        pm = MichiGANModel(o, "cpu")
        pm.load_state_dicts(sd)
        fake, _ = pm.infer(batch_from_numpy(data, "cpu"), mode)
        assert fake.dtype == torch.float32
        out["port", dt] = nhwc(fake)
    return out


def assert_slice_gate(out, label):
    diff = lambda a, b: float(np.max(np.abs(out[a] - out[b])))
    port_jax = diff(("port", "bfloat16"), ("jax", "bfloat16"))
    jax_policy = diff(("jax", "bfloat16"), ("jax", "float32"))
    port_policy = diff(("port", "bfloat16"), ("port", "float32"))
    print(f"{label}: port-bf16 vs JAX-bf16 {port_jax:.4f}, JAX-bf16 vs JAX-fp32 "
          f"{jax_policy:.4f}, port bf16 vs fp32 {port_policy:.4f}")
    assert all(np.isfinite(v).all() for v in out.values())
    assert diff(("port", "float32"), ("jax", "float32")) <= 2e-3
    assert port_jax <= SLICE_RATIO * jax_policy
    assert port_policy > 1e-3


def test_flagship_slice_bf16_matches_jax():
    opt = flagship_opt()
    sd, variables = port_weights(opt)
    assert_slice_gate(run_slice(opt, sd, variables, jax_data(opt), "ref"), "flagship")


def test_stroke_slice_bf16_matches_jax():
    """The two-stage branch (IG prefill, then SIG), the epilogue in both."""
    opt = stroke_opt("--use_pallas_epilogue")
    sd, variables = port_weights(opt)
    data = jax_demo_data(opt, **edit_args(prefill=True), noise=None)
    assert_slice_gate(run_slice(opt, sd, variables, data, "stroke"), "stroke")


# ---------------------------------------------------------------------------
# frozen-tower rounding and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_frozen_tower_rounding_equals_compact_frozen_variables(train):
    """The stroke configuration (IG, SIG), and the training one (IG,
    VGG19; netD keeps float32 like netG)."""
    opt = config.train_options(TRAIN_SMALL) if train else stroke_opt()
    sd, variables = port_weights(opt)
    frozen = ("netIG", "vgg") if train else ("netIG", "netSIG")
    if train:
        variables["vgg"] = convert_vgg19({k.removeprefix("features."): v
                                          for k, v in sd["vgg"].items()})
    compact = JModel(as_bf16(opt)).compact_frozen_variables(variables)
    bridged = state_dicts_from_flax(compact, opt)
    model = MichiGANModel(as_bf16(opt), "cpu")
    model.load_state_dicts(sd)
    # the trained nets keep float32; every floating leaf of the frozen towers
    # is bfloat16, equal to the JAX package's rounding, and the bridge from
    # the compacted variables loads into the port exactly
    for net in ("netG", "netD") if train else ("netG",):
        assert all(v.dtype == torch.float32 for v in model.nets()[net].state_dict().values()
                   if v.is_floating_point())
    for name in frozen:
        state = model.nets()[name].state_dict()
        assert state.keys() == bridged[name].keys()
        for k, v in state.items():
            assert v.dtype == torch.bfloat16, (name, k)
            assert torch.equal(v.float(), bridged[name][k]), (name, k)
        again = MichiGANModel(as_bf16(opt), "cpu")
        again.load_state_dicts({**sd, name: bridged[name]})
        for k, v in again.nets()[name].state_dict().items():
            assert torch.equal(v, state[k]), (name, k)


def test_spectral_sigma_is_float32_from_bf16_storage():
    conv = layers.SpectralConv2d(8, 8, 3)
    layers.init_weights(conv, torch.Generator().manual_seed(0), "none")
    conv.eval().to(torch.bfloat16)
    w_mat = conv.weight_orig.float().reshape(8, -1)
    sigma = spectral_sigma(w_mat, conv.weight_u.float(), conv.weight_v.float())
    got = conv.weight()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, conv.weight_orig.float() / sigma, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# float32 unchanged
# ---------------------------------------------------------------------------

def _old_spectral_weight(self):
    return self.weight_orig / spectral_sigma(self.w_mat(), self.weight_u, self.weight_v)


def _old_partial_forward(self, x, mask):
    k = self.kernel_size[0]
    ones = torch.ones(1, 1, k, k, dtype=torch.float32, device=x.device)
    update_mask = F.conv2d(mask.float(), ones, None, self.stride, self.padding)
    mask_ratio = float(k * k) / (update_mask + 1e-8)
    update_mask = update_mask.clamp(0.0, 1.0)
    mask_ratio = mask_ratio * update_mask
    raw = F.conv2d(x * mask.to(x.dtype), self.weight, None, self.stride, self.padding)
    mask_ratio = mask_ratio.to(raw.dtype)
    return (raw * mask_ratio + self.bias.view(1, -1, 1, 1)) * update_mask.to(raw.dtype), \
        update_mask


def _old_spade_forward(self, x, segmap):
    seg = normalization.resize_nearest(segmap, x.shape[2:]).to(x.dtype)
    actv = self.mlp_shared(seg)
    weight = torch.cat([self.mlp_gamma.weight, self.mlp_beta.weight])
    bias = torch.cat([self.mlp_gamma.bias, self.mlp_beta.bias])
    gamma, beta = F.conv2d(actv, weight, bias, padding=self.pw).chunk(2, dim=1)
    pfn = self.param_free_norm
    return K.spade_modulate(x, pfn.running_mean, torch.rsqrt(pfn.running_var + pfn.eps),
                            gamma, beta)


def _old_run_ig(self, net, inp):
    size = self.opt.crop_size
    if size != 256 or inp.shape[2] != 256:
        inp = port_model.resize_nearest(inp, (256, 256))
    out = net(inp)
    return port_model.resize_nearest(out, (size, size)) if out.shape[2] != size else out


def _old_padded_gen_inputs(self, pre, orient):
    gin = {k: pre[k] for k in port_model.GEN_KEYS if k != "orient"}
    gin["orient"] = orient
    return {k: self._zeros_pad(v) for k, v in gin.items()} if self.opt.add_feat_zeros else gin


def _old_in_act_plain(x_pad, w, b, dilation=1, act=None, eps=1e-5, residual=None):
    y = _act(instance_norm(F.conv2d(x_pad, w, b, dilation=dilation), eps), act)
    return y if residual is None else residual + y


def float32_outputs():
    out = {}
    opt = flagship_opt()
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    out["flagship"] = model.infer(batch_from_numpy(jax_data(opt), "cpu"))[0]
    opt = stroke_opt("--use_pallas_epilogue")
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    data = jax_demo_data(opt, **edit_args(prefill=True), noise=None)
    out["stroke"] = model.infer(batch_from_numpy(data, "cpu"), "stroke")[0]
    return out


def test_float32_outputs_bit_identical_to_the_code_before_the_policy(monkeypatch):
    new = float32_outputs()
    conv_forward = nn.Conv2d.forward
    monkeypatch.setattr(layers.SpectralConv2d, "weight", _old_spectral_weight)
    monkeypatch.setattr(layers.SpectralConv2d, "forward", lambda self, x: F.conv2d(
        x, self.weight(), self.bias, self.stride, self.padding, self.dilation))
    monkeypatch.setattr(layers.SpectralConvTranspose2d, "forward", lambda self, x:
                        F.conv_transpose2d(x, self.weight(), self.bias, self.stride,
                                           self.padding))
    monkeypatch.setattr(layers.Conv2d, "forward", conv_forward)
    monkeypatch.setattr(layers.PartialConv, "forward", _old_partial_forward)
    monkeypatch.setattr(normalization.SPADE, "forward", _old_spade_forward)
    monkeypatch.setattr(MichiGANModel, "_run_ig", _old_run_ig)
    monkeypatch.setattr(MichiGANModel, "_padded_gen_inputs", _old_padded_gen_inputs)
    monkeypatch.setattr(MichiGANModel, "compact_frozen_nets", lambda self: None)
    monkeypatch.setattr(E, "conv3x3_in_act_plain", _old_in_act_plain)
    old = float32_outputs()
    for k in new:
        assert new[k].dtype == torch.float32
        assert torch.equal(new[k], old[k]), k
