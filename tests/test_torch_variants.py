"""The generator's options against the JAX package's, on the CPU: the
appearance encoders --Image_encoder_mode norm and instance (each also with
--norm_E spectralbatch), the seed without --use_encoder, BackgroundEncode
(no --noise_background) at --num_upsampling_layers more and most,
--orient_random_disturb, --weight_norm_G (--weight_norm_g 0 and 1) and an
instance map (--no_instance False), each one parametrised case.

Each case draws seeded values for the JAX generator's variable tree (its
shapes traced by ``jax.eval_shape``, which compiles nothing; every
parameter kind drawn, the running statistics too), carries them into the
port with ``convert.state_dicts_from_flax`` (strictly) and compares it
with one compiled JAX function a case, at crop 128 (a 4x4 latent; at crop
64 the first batch norms' statistics over a 2x2 latent at batch 2 put the
JAX package's own float32 output 1.7e-3 from float64): the eval forward and
the train-mode forward (max abs within GEN_TOL), the buffers the latter
writes (BUF_REL of their largest magnitude) and the parameters' gradients
for one seeded cotangent (JAX: ``apply`` with mutable collections under
``jax.vjp``), per block by their relative L2 error (GRAD_REL), the rules
of tests/test_torch_most.py.  Its other rule, the port's float32 gradient
against its float64 one (GRAD_REL64), is not applied: at these sizes a few
leaky-ReLU branches flip between the two, and that error went from 4e-6 to
1.7e-2 in one case with the CPU's convolution route alone.

Also: the mask helpers of the new paths against the JAX package's, and the
flagship's and the paired step's seeded weights (``init_weights(0)``) bit
for bit as they were before these options (their SHA-256 at crop 64, ngf 8).
"""

import dataclasses
import functools
import hashlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu import config as jconfig
from michigan_tpu.models.generator import SPADEBGenerator as JGen
from michigan_tpu.ops import masks as jmasks
from michigan_tpu_torch import convert
from michigan_tpu_torch import config as pconfig
from michigan_tpu_torch.config import Options
from michigan_tpu_torch.model import MichiGANModel
from michigan_tpu_torch.models.generator import SPADEBGenerator
from michigan_tpu_torch.ops import masks
from test_torch_most import (
    BUF_REL,
    GEN_TOL,
    GRAD_REL,
    block_errors,
    generator_inputs,
    nchw,
    nhwc,
    seeded_variables,
    to_np,
)

BASE = dict(isTrain=True, netG="spadeb", ngf=8, crop_size=128, load_size=128, use_encoder=True,
            use_ig=True, noise_background=True, init_type="none")
CASES = {
    "norm": dict(Image_encoder_mode="norm"),
    "norm_spectralbatch": dict(Image_encoder_mode="norm", norm_E="spectralbatch"),
    "instance": dict(Image_encoder_mode="instance"),
    "instance_spectralbatch": dict(Image_encoder_mode="instance", norm_E="spectralbatch"),
    "no_encoder": dict(use_encoder=False),
    "background_more": dict(noise_background=False, num_upsampling_layers="more"),
    "background_most": dict(noise_background=False, num_upsampling_layers="most"),
    "orient_random_disturb": dict(orient_random_disturb=True),
    "weight_norm_g0": dict(weight_norm_G=True),
    "weight_norm_g1": dict(weight_norm_G=True, weight_norm_g=1),
    "instance_map": dict(no_instance=False),
}
# SHA-256 of every net's state_dict after init_weights(0) at crop 64, ngf 8
# (ndf 8), as the code before these options drew them
SEEDED = {
    "flagship": "e1e3286a155f4cb7b28345941be226e7471422d4f62475372fefda363a3fd5bf",
    "paired_step": "9d666e8da4bf1ff272d32e1d90c14b5bd925b9e6afa6cf68de3f2fd26991e79b",
}
FLAGSHIP = ("--netG spadeb --use_encoder --noise_background --use_ig --expand_mask_be "
            "--expand_th 5 --add_feat_zeros --gpu_ids -1 --crop_size 64 --load_size 64 "
            "--ngf 8").split()
PAIRED = ("--netG spadeb --use_encoder --use_ig --noise_background --random_expand_mask "
          "--gpu_ids -1 --crop_size 64 --load_size 64 --ngf 8 --ndf 8 --batchSize 2").split()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_compiled(fn, *args):
    """jax.jit(fn) compiled for `args` at XLA's backend optimisation level
    0: a third of the default's compile time for these small programs."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def port_options(jopt) -> Options:
    """The port's Options with the JAX Options' values."""
    return Options(**{f.name: getattr(jopt, f.name) for f in dataclasses.fields(Options)
                      if hasattr(jopt, f.name)}).finalize()


def seeded_all(shapes, seed):
    """``seeded_variables``, then weight norm's g, the norm layers' affine
    scale and bias and the running statistics drawn too.  The convs' biases
    stay 0: an offset before a batch norm over the few values of a small
    latent costs the JAX package's one-pass batch variance (E[x^2] -
    mean^2) its digits."""
    v = seeded_variables(shapes, seed)
    rng = np.random.default_rng(seed + 100)
    draws = {"wn_g": lambda s: rng.uniform(0.3, 0.9, s),
             "norm_scale": lambda s: rng.uniform(0.5, 1.5, s),
             "norm_bias": lambda s: rng.uniform(-0.2, 0.2, s),
             "running_mean": lambda s: rng.normal(0.0, 0.1, s),
             "running_var": lambda s: rng.uniform(0.5, 1.5, s)}

    def draw(path, a):
        f = draws.get(path[-1].key)
        return a if f is None else f(a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, v)


def case_inputs(opt, seed):
    """generator_inputs at batch 2; under --no_instance False the tag's
    one-hot gets the edges of a seeded two-id instance map (a vertical cut
    at a seeded column), as preprocess appends them."""
    seg_ref, seg_tag, *rest = generator_inputs(opt, 2, seed)
    if not opt.no_instance:
        s = seg_tag.shape[1]
        cut = np.random.default_rng(seed + 7).integers(s // 4, 3 * s // 4, 2)
        inst = (np.arange(s)[None, None, :, None] >= cut[:, None, None, None])
        inst = np.broadcast_to(inst, (2, s, s, 1)).astype(np.float32)
        edges = np.asarray(jmasks.instance_edges(jnp.asarray(inst)))
        seg_tag = np.concatenate([seg_tag, edges], -1)
    return [seg_ref, seg_tag, *rest]


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_option_matches_jax(case):
    opt = jconfig.Options(**{**BASE, **CASES[case]}).finalize()
    popt = port_options(opt)
    ins = case_inputs(opt, 0)
    gen = JGen(opt)
    shapes = jax.eval_shape(functools.partial(gen.init, train=False), jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in ins))
    v = seeded_all(shapes, 0)
    s = opt.generator_input_size()
    cot = np.random.default_rng(1).standard_normal((2, s, s, 3)).astype(np.float32)

    def run(v, cot):
        y_eval = gen.apply(v, *ins, train=False)

        def f(p):
            return gen.apply({**v, "params": p}, *ins, train=True,
                             mutable=["batch_stats", "spectral"])

        y, vjp, written = jax.vjp(f, v["params"], has_aux=True)
        return y_eval, y, written, vjp(cot)[0]

    y_eval, y, written, grads = to_np(jax_compiled(run, v, cot)(v, cot))
    sd = convert.state_dicts_from_flax({"netG": v}, popt)["netG"]
    net = SPADEBGenerator(popt)
    net.load_state_dict(sd, strict=True)
    t_ins = [nchw(a) for a in ins]

    # eval: the running statistics, the stored spectral u / v
    with torch.no_grad():
        got_eval = net.eval()(*t_ins)
    assert got_eval.std() > 1e-2
    assert np.max(np.abs(nhwc(got_eval) - y_eval)) <= GEN_TOL, case

    # train mode: the output, the buffers it wrote, the gradients
    got = net.train()(*t_ins)
    got.backward(nchw(cot))
    assert np.max(np.abs(nhwc(got) - y)) <= GEN_TOL, case
    want = convert.module_state_dict(
        {"params": v["params"], **{c: written.get(c, v[c]) for c in ("batch_stats", "spectral")
                                   if c in v}})
    bufs = {k: b for k, b in net.state_dict().items() if not k.endswith("num_batches_tracked")
            and k in dict(net.named_buffers())}
    assert bufs.keys() <= want.keys()
    for k, b in bufs.items():
        w = want[k].numpy()
        assert np.max(np.abs(b.numpy() - w)) <= BUF_REL * np.abs(w).max(), (case, k)
    params = dict(net.named_parameters())
    jgrads = {k: g for k, g in convert.module_state_dict(
        {"params": grads, "spectral": v.get("spectral", {})}).items() if k in params}
    assert jgrads.keys() == params.keys()
    errs = block_errors({k: t.grad for k, t in params.items()}, jgrads)
    assert "fc" in errs and max(errs.values()) <= GRAD_REL, (case, errs)


def test_option_modules_are_the_ones_asked_for():
    """Each case builds the modules its option names (so a case cannot pass
    on the flagship's modules)."""
    kinds = {}
    for case, kw in CASES.items():
        net = SPADEBGenerator(port_options(jconfig.Options(**{**BASE, **kw}).finalize()))
        kinds[case] = (type(net.fc).__name__, type(net.backgroud_enc).__name__,
                       type(net.head_0.conv_0).__name__, hasattr(net.head_0.norm_0,
                                                                 "param_free_norm"))
    assert kinds["norm"][0] == "ImageEncoder" and kinds["instance"][0] == "ImageEncoder2"
    assert kinds["no_encoder"][0] == "Conv2d"
    assert kinds["background_most"][1] == kinds["background_more"][1] == "BackgroundEncode"
    assert kinds["norm"][1] == "BackgroundEncode2"
    assert kinds["weight_norm_g0"][2:] == ("WeightNormConv2d", False)
    assert kinds["weight_norm_g1"][2:] == ("UnitNormConv2d", False)
    assert kinds["norm"][2:] == ("SpectralConv2d", True)
    net = SPADEBGenerator(port_options(jconfig.Options(
        **{**BASE, **CASES["norm_spectralbatch"]}).finalize()))
    assert type(net.fc.layer1[1]).__name__ == "AffineBatchNorm"


@pytest.mark.parametrize("k", [3, 5, 7])
def test_mask_helpers_match_jax(k):
    rng = np.random.default_rng(k)
    yy, xx = np.mgrid[0:40, 0:40] / 40
    hair = (((yy - 0.5) / 0.3) ** 2 + ((xx - 0.45) / 0.35) ** 2 < 1)[None, ..., None]
    hair = np.concatenate([hair, np.roll(hair, 5, axis=2)]).astype(np.float32)
    want = np.asarray(jmasks.wide_edges_outer(jnp.asarray(hair), k))
    np.testing.assert_array_equal(nhwc(masks.wide_edges_outer(nchw(hair), k)), want)
    inst = rng.integers(0, 3, (2, 17, 23, 1)).astype(np.float32)
    np.testing.assert_array_equal(nhwc(masks.instance_edges(nchw(inst))),
                                  np.asarray(jmasks.instance_edges(jnp.asarray(inst))))


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_weights_unchanged(name):
    opt = pconfig.test_options(FLAGSHIP) if name == "flagship" else pconfig.train_options(PAIRED)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    h = hashlib.sha256()
    for net_name, net in model.nets().items():
        for k, t in net.state_dict().items():
            h.update(f"{net_name}.{k}".encode())
            h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == SEEDED[name]
