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
- --batch_inference: 3 names at --batchSize 2 write the images the JAX
  CLI's batch_inference writes for the same weights (float32), within 2
  uint8 levels after JPEG decoding; a missing list raises;
- the CLIs run the bf16 path with jax unimportable, the trainer included
  (two steps, a save, a resume, and the saved generator feeding
  inference); --dtype bfloat16 with --isTrain builds a training model,
  while other dtypes and the unported training flags are refused.
  (tests/test_torch_bf16_training.py holds the bf16 step to JAX's.)
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

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


# ---------------------------------------------------------------------------
# --batch_inference
# ---------------------------------------------------------------------------

NAMES = ("s0", "s1", "s2")


def three_sample_dir(root):
    """A val set of 3 names made from sample 67172: as it is, mirrored, and
    shifted, so that each batch slot renders a different image."""
    src = {k: Image.open(os.path.join(DATA_DIR, f"val_{k}", f"67172{ext}"))
           for k, ext in (("images", ".jpg"), ("labels", ".png"),
                          ("dense_orients", "_orient_dense.png"))}
    edits = (lambda a: a, lambda a: a[:, ::-1], lambda a: np.roll(a, 24, axis=1))
    for name, edit in zip(NAMES, edits):
        for k, img in src.items():
            d = os.path.join(root, f"val_{k}")
            os.makedirs(d, exist_ok=True)
            suffix = {"images": ".jpg", "labels": ".png", "dense_orients": "_orient_dense.png"}[k]
            Image.fromarray(np.ascontiguousarray(edit(np.array(img)))).save(
                os.path.join(d, name + suffix))
    path = os.path.join(root, "names.txt")
    with open(path, "w") as f:
        f.write("\n".join(NAMES) + "\n")
    return path


def test_batch_inference_writes_the_jax_cli_images(tmp_path):
    import inference as jax_cli
    from michigan_tpu_torch.inference import batch_inference

    names = three_sample_dir(str(tmp_path / "data"))
    opt = dataclasses.replace(
        flagship_opt(), data_dir=str(tmp_path / "data"), val_list_dir=names, batchSize=2,
        how_many=3)
    sd, variables = port_weights(opt)
    model = MichiGANModel(opt, "cpu")
    model.load_state_dicts(sd)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    written = batch_inference(dataclasses.replace(opt, results_dir=str(port_dir)), model)
    assert [os.path.basename(p) for p in written] == [n + ".jpg" for n in NAMES]
    jax_cli.batch_inference(dataclasses.replace(opt, results_dir=str(jax_dir)), JModel(opt),
                            variables, jax.random.PRNGKey(opt.seed))
    imgs = []
    for name in NAMES:
        ours = np.asarray(Image.open(port_dir / f"{name}.jpg"), np.int16)
        theirs = np.asarray(Image.open(jax_dir / f"{name}.jpg"), np.int16)
        assert ours.shape == theirs.shape == (128, 128, 3)
        assert np.abs(ours - theirs).max() <= 2, name
        imgs.append(ours)
    assert all(np.abs(imgs[0] - im).max() > 10 for im in imgs[1:])  # three different renders

    with pytest.raises(FileNotFoundError, match="val_list_dir"):
        batch_inference(dataclasses.replace(opt, val_list_dir=str(tmp_path / "none.txt")),
                        model)


# ---------------------------------------------------------------------------
# the CLIs without jax; the refusal with --isTrain
# ---------------------------------------------------------------------------

BLOCK_JAX = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "michigan_tpu"):
    sys.modules[name] = None
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
runpy.run_module(module, run_name="__main__")
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "michigan_tpu" or m.startswith("michigan_tpu.")))
assert not leaked, leaked
print("ok")
"""


def run_without_jax(tmp_path, module, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", BLOCK_JAX, module, *args], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
    return proc.stdout


def test_clis_run_bf16_without_jax(tmp_path):
    names = three_sample_dir(str(tmp_path / "data"))
    out = run_without_jax(tmp_path, "michigan_tpu_torch.inference", *FLAGS, *SMALL,
                          "--dtype", "bfloat16", "--batch_inference", "--batchSize", "2",
                          "--data_dir", str(tmp_path / "data"), "--val_list_dir", names,
                          "--results_dir", str(tmp_path / "results"),
                          "--checkpoints_dir", str(tmp_path / "checkpoints"))
    assert "rendered 3/3" in out
    for name in NAMES:
        img = Image.open(tmp_path / "results" / f"{name}.jpg")
        assert img.size == (128, 128) and img.mode == "RGB"
    edit = tmp_path / "edit.jpg"
    out = run_without_jax(tmp_path, "michigan_tpu_torch.demo", "--stroke", "--out", str(edit),
                          "--dtype", "bfloat16", "--use_pallas_epilogue",
                          "--checkpoints_dir", str(tmp_path / "checkpoints"), *SMALL,
                          "--demo_data_dir", DEMO_DIR)
    assert "inference time" in out
    assert Image.open(edit).size == (128, 128)


def test_bf16_is_refused_with_is_train():
    """(Since the bf16 training step was ported:) --dtype bfloat16 with
    --isTrain builds a training model; another dtype is still refused in
    training and inference, and so are bf16 with an unported flag and bf16
    with the float32-only VAE, blender and unpaired configs."""
    opt = config.train_options(["--dtype", "bfloat16"] + TRAIN_SMALL)
    model = MichiGANModel(opt, "cpu")
    assert model.compute_dtype == torch.bfloat16 and model.netD is not None
    assert model.vgg is not None and model.netG.training
    port_model.check_supported(as_bf16(flagship_opt()))  # inference takes it
    for o in (flagship_opt(), opt):
        with pytest.raises(NotImplementedError, match="float16"):
            port_model.check_supported(dataclasses.replace(o, dtype="float16"))
    with pytest.raises(NotImplementedError, match="use_instance_feat"):
        MichiGANModel(dataclasses.replace(opt, use_instance_feat=True), "cpu")
    # the VAE, blender and unpaired configs are float32 only
    for flag in ("use_vae", "use_blender", "unpairTrain"):
        with pytest.raises(NotImplementedError, match=f"--{flag} with --dtype bfloat16"):
            MichiGANModel(dataclasses.replace(opt, **{flag: True}), "cpu")


def test_trainer_cli_trains_bf16_saves_resumes_and_feeds_inference(tmp_path):
    """python -m michigan_tpu_torch.train --dtype bfloat16 with jax
    unimportable: two epochs of the one sample, a resume from 'latest' for
    a third; the checkpoints hold float32 netG and netD, and the saved
    generator restores into a bf16 inference model, which renders."""
    from tests.test_torch_training import TRAIN_FLAGS

    ck = str(tmp_path / "checkpoints")
    first = run_without_jax(tmp_path, "michigan_tpu_torch.train", *TRAIN_FLAGS, "--dtype",
                            "bfloat16", "--checkpoints_dir", ck, "--niter", "2",
                            "--debug_nans")
    assert first.count("(epoch: ") == 2
    saved = {w: torch.load(tmp_path / "checkpoints" / "t" / f"latest_net_{w}.pth",
                           weights_only=True) for w in ("G", "D")}
    assert all(v.dtype == torch.float32 for sd in saved.values() for v in sd.values()
               if v.is_floating_point())
    second = run_without_jax(tmp_path, "michigan_tpu_torch.train", *TRAIN_FLAGS, "--dtype",
                             "bfloat16", "--checkpoints_dir", ck, "--niter", "3",
                             "--continue_train")
    assert "resumed checkpoint 'latest'" in second and "(epoch: 3, iters: 1" in second

    from michigan_tpu_torch.inference import load_released

    inf = config.test_options(["--netG", "spadeb", "--use_encoder", "--noise_background",
                               "--use_ig", "--ngf", "8", "--crop_size", "64", "--load_size",
                               "64", "--checkpoints_dir", ck, "--name", "t", "--which_epoch",
                               "latest", "--dtype", "bfloat16"])
    model = MichiGANModel(inf, "cpu")
    model.init_weights(0)
    assert load_released(model, inf)
    latest = torch.load(tmp_path / "checkpoints" / "t" / "latest_net_G.pth", weights_only=True)
    for k, v in model.netG.state_dict().items():
        assert torch.equal(v, latest[k]), k
    from tests.test_torch_training import tiny_batch

    fake, _ = model.infer(batch_from_numpy(tiny_batch(inf), "cpu"))
    assert fake.shape == (1, 3, 64, 64) and fake.dtype == torch.float32
    assert torch.isfinite(fake).all() and fake.std() > 1e-3
