"""The 1024^2 configuration's pieces (--num_upsampling_layers most) and
--remat activation checkpointing, on the CPU.

- the `most` generator in train mode (crop 128, no --add_feat_zeros: a 1x1
  latent; ngf 8) against the JAX package's on the same seeded weights,
  bridged by ``convert.state_dicts_from_flax``: the output, the written
  batch-norm running statistics and spectral u / v, and the parameters'
  gradients for one seeded cotangent (JAX: ``apply`` with mutable
  collections under ``jax.vjp``);
- `most` through ``infer`` at crop 256 with --add_feat_zeros --add_th 128
  (planes 3^2 ... 384^2, the pad-crop back to 256) against the JAX
  package's ``infer`` (tests/test_torch_inference.py's tolerance);
- --remat --remat_blocks up_1,up_2,up_3,up_4 (port only): one G+D step at
  crop 128 `most` equals the step without it bit for bit (losses,
  parameters, running statistics, spectral u / v), each batch norm's
  num_batches_tracked advances by one, and a block name that is not valid
  raises; and the same on two gloo ranks;
- the weight bridge round-trips a `most` netG exactly;
- the --crop_size / --add_th combinations the JAX package cannot run under
  `most` are refused, and 1024 + 128 runs;
- the flag-matrix rows stroke, remove_background and no_ig through the
  trainer CLI (jax unimportable), its checkpoint and an inference restore.
"""

import copy
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_parallel_ranks as R
from michigan_tpu import config as jconfig
from michigan_tpu.data.single import single_inference_data as jax_data
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.models.generator import SPADEBGenerator as JGen
from michigan_tpu.training.convert import convert_generator
from michigan_tpu_torch import convert
from michigan_tpu_torch.config import Options, train_options
from michigan_tpu_torch.data.synthetic import synthetic_train_data
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.models.generator import SPADEBGenerator
from michigan_tpu_torch.parallel import dist as DP
from michigan_tpu_torch.training.train_step import TrainStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "datasets", "FFHQ_single")
# the train-mode `most` generator against JAX: at a 1x1 latent the first
# batch norms take their statistics over the batch's two values, which
# amplifies float32 rounding; JAX's float32 step (its one-pass batch
# variance) lies ~3% (relative L2, per block) from the port's float64 step,
# the port's float32 step 2e-5 (measured on this test's inputs)
OUT_TOL = 5e-4      # the tanh output, max abs (its largest magnitude ~0.15)
BUF_REL = 1e-3      # running statistics and spectral u / v, max abs over the largest
GRAD_REL = 5e-2     # the gradients of each block's parameters, relative L2
GRAD_REL64 = 1e-3   # the same of the port's float32 step against its float64 step
GEN_TOL = 2e-3     # infer's output, max abs (tests/test_torch_inference.py)
REMAT = ["--remat", "--remat_blocks", "up_1,up_2,up_3,up_4"]
JOIN_TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here in one thread (as the other port files do):
    beside the other workers of a parallel run a pool of a thread a core
    waits on cores the others hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_variables(shapes, seed, transposed=frozenset()):
    """Seeded values for an abstract variable tree (``jax.eval_shape`` of a
    Flax init, which compiles nothing), as --init_type none draws them:
    kernels U(-b, b) with b = 1/sqrt(fan_in), biases and running means 0,
    running variances 1; and each spectral conv's u and v from 10 power
    iterations on its kernel, as a trained checkpoint holds them (JAX's W:
    O x I*kh*kw, a transposed conv's kernel, its module path in
    `transposed`, flipped first)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "kernel":
            b = 1.0 / np.sqrt(np.prod(a.shape[:-1]))
            return rng.uniform(-b, b, a.shape).astype(np.float32)
        if leaf in ("u", "v"):
            return rng.standard_normal(a.shape).astype(np.float32)
        return np.full(a.shape, 1.0 if leaf == "running_var" else 0.0, np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)

    def fix(mods, params, prefix=()):
        for k, sub in mods.items():
            if "u" in sub:
                kernel = params[k]["kernel"]
                if prefix + (k,) in transposed:
                    kernel = kernel[::-1, ::-1]
                w = kernel.transpose(3, 2, 0, 1).reshape(kernel.shape[3], -1).astype(np.float64)
                u = sub["u"] / np.linalg.norm(sub["u"])
                for _ in range(10):
                    vv = w.T @ u
                    vv /= np.linalg.norm(vv)
                    u = w @ vv
                    u /= np.linalg.norm(u)
                sub["u"], sub["v"] = u.astype(np.float32), vv.astype(np.float32)
            else:
                fix(sub, params[k], prefix + (k,))

    for net in ([v] if "params" in v else v.values()):
        fix(net.get("spectral", {}), net["params"])
    return v


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def generator_inputs(opt, n, seed):
    """The generator's six NHWC inputs: hair ellipses of different sizes, a
    two-channel orientation inside them, images and noise.  Each sample's
    images lie around a mean of their own, so that the samples' latents
    differ: at a 1x1 latent the first batch norm's statistics are over the
    batch alone, and near-equal samples make its gradient ill-conditioned."""
    rng = np.random.default_rng(seed)
    s = opt.generator_input_size()
    yy, xx = np.mgrid[0:s, 0:s] / s
    hair = np.stack([(((yy - 0.4) / (0.2 + 0.05 * i)) ** 2 + ((xx - 0.5) / 0.3) ** 2 < 1)
                     for i in range(n)])[..., None].astype(np.float32)
    seg = np.concatenate([1 - hair, hair], -1)
    t = rng.uniform(0, np.pi, (n, s, s, 1))
    orient = (np.concatenate([np.sin(2 * t), np.cos(2 * t)], -1) * hair).astype(np.float32)
    means = np.linspace(-0.5, 0.5, n).reshape(n, 1, 1, 1)
    img = lambda: (rng.uniform(-0.5, 0.5, (n, s, s, 3)) + means).astype(np.float32)
    return seg, seg, orient, img(), img(), rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the `most` generator in train mode against JAX's apply + vjp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_mode_pair():
    opt = jconfig.Options(
        isTrain=True, netG="spadeb", ngf=8, crop_size=128, load_size=128, use_encoder=True,
        use_ig=True, noise_background=True, random_expand_mask=True,
        num_upsampling_layers="most", init_type="none").finalize()
    ins = [jnp.asarray(a) for a in generator_inputs(opt, 2, 0)]
    gen = JGen(opt)
    v = to_np(jax.jit(functools.partial(gen.init, train=False))(jax.random.PRNGKey(3), *ins))
    cot = np.random.default_rng(1).standard_normal((2, 128, 128, 3)).astype(np.float32)

    @jax.jit
    def step(params, cot):
        def f(p):
            return gen.apply({**v, "params": p}, *ins, train=True,
                             mutable=["batch_stats", "spectral"])
        y, vjp, written = jax.vjp(f, params, has_aux=True)
        return y, written, vjp(cot)[0]

    y, written, grads = to_np(step(v["params"], jnp.asarray(cot)))
    net = SPADEBGenerator(opt).train()
    net.load_state_dict(convert.state_dicts_from_flax({"netG": v}, opt)["netG"], strict=True)
    got = net(*(nchw(a) for a in ins))
    got.backward(nchw(cot))
    return dict(opt=opt, v=v, y=y, written=written, grads=grads, net=net, got=got, cot=cot)


def block_errors(got: dict, want: dict) -> dict:
    """{block: relative L2 error of the gradients of its parameters}."""
    sums = {}
    for k, w in want.items():
        d, n = sums.setdefault(k.split(".")[0], [0.0, 0.0])
        sums[k.split(".")[0]] = [d + float(((got[k].double() - w.double()) ** 2).sum()),
                                 n + float((w.double() ** 2).sum())]
    return {b: (d / n) ** 0.5 for b, (d, n) in sums.items()}


def test_most_generator_train_step_matches_jax(train_mode_pair):
    p = train_mode_pair
    net = p["net"]
    assert p["got"].shape == (2, 3, 128, 128) and p["got"].std() > 1e-2
    assert np.max(np.abs(nhwc(p["got"]) - p["y"])) <= OUT_TOL
    # the buffers the forward wrote, under the reference's names
    want = convert.module_state_dict({"params": p["v"]["params"], **p["written"]})
    bufs = dict(net.named_buffers())
    names = [k for k in want if k.endswith(("running_mean", "running_var", "weight_u",
                                            "weight_v"))]
    assert any(k.startswith("up_4.") for k in names) and len(names) == 84
    for k in names:
        w = want[k].numpy()
        assert np.max(np.abs(bufs[k].numpy() - w)) <= BUF_REL * np.abs(w).max(), k
    # the gradients, named as the parameters they belong to, block by block
    params = dict(net.named_parameters())
    grads = {k: g for k, g in convert.module_state_dict(
        {"params": p["grads"], "spectral": p["v"]["spectral"]}).items() if k in params}
    assert grads.keys() == params.keys()
    errs = block_errors({k: t.grad for k, t in params.items()}, grads)
    assert "up_4" in errs and max(errs.values()) <= GRAD_REL, errs
    # the port's own rounding: its float32 step against its float64 step
    net64 = copy.deepcopy(net).double()
    net64.load_state_dict(convert.state_dicts_from_flax({"netG": p["v"]}, p["opt"])["netG"])
    net64.zero_grad(set_to_none=True)
    net64(*(nchw(a).double() for a in generator_inputs(p["opt"], 2, 0))).backward(
        nchw(p["cot"]).double())
    errs64 = block_errors({k: t.grad for k, t in params.items()},
                          {k: t.grad for k, t in net64.named_parameters()})
    assert max(errs64.values()) <= GRAD_REL64, errs64


# ---------------------------------------------------------------------------
# `most` through infer, and the sizes the JAX package cannot run
# ---------------------------------------------------------------------------

MOST_INFER = ("--netG spadeb --use_encoder --noise_background --use_ig --expand_mask_be "
              "--expand_th 5 --add_feat_zeros --inference_ref_name 67172 "
              "--inference_tag_name 67172 --inference_orient_name 67172 "
              "--num_upsampling_layers most --add_th 128 --crop_size 256 --load_size 256 "
              "--ngf 8 --init_type none --gpu_ids -1").split() + ["--data_dir", DATA_DIR]


def test_most_infer_matches_jax():
    """Seeded variables in JAX's tree (the shapes of its init, traced
    without compiling), carried into the port, on the real 67172 sample at
    crop 256 + add_th 128."""
    opt = jconfig.test_options(MOST_INFER)
    assert opt.latent_size() == (3, 3)
    data = jax_data(opt)
    batch = {k: jnp.asarray(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    jm = JModel(opt)
    variables = seeded_variables(jax.eval_shape(jm.init_variables, jax.random.PRNGKey(0), batch),
                                 0, {("decoder_0",), ("decoder_3",)})
    j_fake, j_orient_rgb = jax.jit(jm.infer)(variables, batch)

    model = MichiGANModel(opt, "cpu")
    model.load_state_dicts(convert.state_dicts_from_flax(variables, opt))
    fake, orient_rgb = model.infer(batch_from_numpy(data, "cpu"))
    fake = nhwc(fake)
    assert fake.shape == (1, 384, 384, 3) and fake.std() > 1e-2
    assert np.max(np.abs(fake - np.asarray(j_fake))) <= GEN_TOL
    np.testing.assert_allclose(nhwc(orient_rgb), np.asarray(j_orient_rgb), atol=1e-3)


def most_opt(crop, add_th, **kw):
    return jconfig.Options(
        isTrain=False, netG="spadeb", ngf=4, crop_size=crop, load_size=crop, use_encoder=True,
        use_ig=True, noise_background=True, expand_mask_be=True, expand_th=5,
        add_feat_zeros=True, add_th=add_th, num_upsampling_layers="most", **kw).finalize()


def jax_generator_shape(opt):
    """The JAX generator's output shape at `opt`, traced abstractly (no
    compute): its init then its apply."""
    s = opt.generator_input_size()
    z = lambda c: jax.ShapeDtypeStruct((1, s, s, c), jnp.float32)
    args = (z(2), z(2), z(2), z(3), z(3), z(3))
    gen = JGen(opt)
    v = jax.eval_shape(gen.init, jax.random.PRNGKey(0), *args)
    return jax.eval_shape(gen.apply, v, *args).shape


def port_generator_shape(opt):
    """The port's generator output shape at `opt`, on the meta device (train
    mode, no gradient: shapes only, no memory)."""
    s = opt.generator_input_size()
    with torch.device("meta"), torch.no_grad():
        net = SPADEBGenerator(opt).train()
        z = lambda c: torch.zeros((1, c, s, s))
        return tuple(net(z(2), z(2), z(2), z(3), z(3), z(3)).shape)


@pytest.mark.parametrize("crop,add_th", [(256, 64), (1024, 64), (1024, 100)])
def test_most_refuses_the_sizes_jax_cannot_run(crop, add_th):
    opt = most_opt(crop, add_th)
    with pytest.raises(Exception):  # a shape mismatch deep in the trace
        jax_generator_shape(opt)
    with pytest.raises(ValueError, match=r"--crop_size \+ --add_th.*multiple of 128"):
        SPADEBGenerator(opt)
    with pytest.raises(ValueError, match="--add_th"):
        MichiGANModel(opt, "cpu")


def test_most_runs_1024_plus_128_in_both():
    opt = most_opt(1024, 128)
    assert opt.latent_size() == (9, 9)
    assert jax_generator_shape(opt) == (1, 1152, 1152, 3)
    assert port_generator_shape(opt) == (1, 3, 1152, 1152)


def test_round_trip_most_generator():
    """A `most` netG's tree (shapes from tracing its init, values random)
    survives JAX -> port -> convert_generator exactly, and loads through
    load_reference_state as a released file (DataParallel prefix, the
    never-applied layer4) would."""
    opt = most_opt(64, 64)
    s = opt.generator_input_size()
    z = lambda c: jnp.zeros((1, s, s, c))
    shapes = jax.eval_shape(JGen(opt).init, jax.random.PRNGKey(7), z(2), z(2), z(2), z(3),
                            z(3), z(3))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    sd = convert.state_dicts_from_flax({"netG": v}, opt)["netG"]
    for k in ("up_4.conv_s.weight_orig", "up_4.norm_s.mlp_gamma.weight",
              "backgroud_enc.conv0.conv.weight", "backgroud_enc.layer0.conv.weight"):
        assert k in sd, k
    assert not any(k.startswith("backgroud_enc.conv1.") for k in sd)
    net = MichiGANModel(opt, "cpu").netG
    net.load_state_dict(sd, strict=True)
    back = convert_generator(sd, opt)
    flat = lambda t: {jax.tree_util.keystr(p): a for p, a in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(back).keys() == flat(v).keys()
    for k, a in flat(v).items():
        np.testing.assert_array_equal(np.asarray(flat(back)[k]), a, err_msg=k)
    released = {"module." + k: t.clone() for k, t in sd.items()}
    released["module.backgroud_enc.layer4.conv.weight"] = torch.zeros(1)
    other = MichiGANModel(opt, "cpu").netG
    convert.load_reference_state(other, released)
    for k, t in other.state_dict().items():
        assert torch.equal(t, sd[k]), k


# ---------------------------------------------------------------------------
# --remat: the step equals the step without it
# ---------------------------------------------------------------------------

def remat_step(extra):
    """One G+D step at crop 128 `most` (ngf 8, batch 2) from seed 0; the
    losses and every net's state_dict after it."""
    flags = ("--netG spadeb --use_encoder --use_ig --noise_background --random_expand_mask "
             "--num_upsampling_layers most --init_type none --gpu_ids -1 --crop_size 128 "
             "--load_size 128 --ngf 8 --ndf 8 --batchSize 2").split()
    opt = train_options(flags + list(extra))
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    trainer = TrainStep(model)
    batch = batch_from_numpy(synthetic_train_data(opt, 0, 2), "cpu")
    g, _fake, orient = trainer.g_step(batch, 2)
    d = trainer.d_step(batch, 2, orient)
    state = {f"{n}.{k}": v.clone() for n, net in model.nets().items()
             for k, v in net.state_dict().items()}
    return {k: v.item() for k, v in {**g, **d}.items()}, state


def test_remat_step_equals_the_step_without_it():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain_losses, plain = remat_step(())
        losses, state = remat_step(REMAT)
    finally:
        torch.set_num_threads(threads)
    assert losses == plain_losses
    assert state.keys() == plain.keys()
    differ = [k for k in plain if not torch.equal(state[k], plain[k])]
    assert not differ, differ[:10]
    tracked = {k: int(v) for k, v in state.items() if k.endswith("num_batches_tracked")}
    assert any(k.startswith("netG.up_4.") for k in tracked)
    assert set(tracked.values()) == {1}  # one write per norm, not one more in the recompute


@pytest.mark.parametrize("ups,blocks", [("most", "up_1,up_5"), ("more", "up_4"),
                                        ("most", "conv_img")])
def test_remat_blocks_must_name_spade_blocks(ups, blocks):
    opt = Options(isTrain=True, netG="spadeb", ngf=4, crop_size=128, load_size=128,
                  use_encoder=True, use_ig=True, noise_background=True,
                  num_upsampling_layers=ups, remat=True, remat_blocks=blocks).finalize()
    with pytest.raises(ValueError, match=r"--remat_blocks: unknown block.*valid: .*'up_3'"):
        SPADEBGenerator(opt)


def test_remat_on_two_ranks_equals_the_step_without_it(tmp_path):
    """Two gloo ranks (tests/test_torch_parallel_ranks.py's harness): the
    sync batch norms' all-reduce runs again in each recompute, in the same
    order on both ranks; each rank's remat step equals its step without."""
    DP.launch(R.remat_and_plain_step, (str(tmp_path),), 2, timeout=JOIN_TIMEOUT)
    flat = lambda r: {**{f"{net}.{k}": v for net, p in r["params"].items() for k, v in p.items()},
                      **{f"netG buffer {k}": v for k, v in r["buffers"].items()}}
    for rank in range(2):
        res = torch.load(tmp_path / f"remat{rank}.pt")
        assert res["remat"]["losses"] == res["plain"]["losses"], rank
        got, want = flat(res["remat"]), flat(res["plain"])
        assert got.keys() == want.keys()
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        assert not differ, (rank, differ[:10])


# ---------------------------------------------------------------------------
# the flag-matrix rows stroke, remove_background and no_ig
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
ROW_COMMON = ["--gpu_ids", "-1", "--name", "row", "--netG", "spadeb", "--use_encoder",
              "--noise_background", "--ngf", "8", "--crop_size", "64", "--load_size", "64"]
ROWS = {"stroke": ["--use_ig", "--use_stroke"], "remove_background":
        ["--use_ig", "--remove_background"], "no_ig": []}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_flag_matrix_row_trains_checkpoints_and_restores(tmp_path, row):
    """One epoch of the bundled sample through the trainer CLI, its
    checkpoint, then the inference CLI restoring netG from it; with
    --use_stroke the trainer and the inference build netSIG (frozen; it is
    no trained net, so the checkpoint holds G and D, as the reference's)."""
    # one thread a process, as the port's tests run beside the other workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    ck = str(tmp_path / "checkpoints")
    run = lambda module, *flags: subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, module, *ROW_COMMON, *ROWS[row], "--checkpoints_dir",
         ck, *flags], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    train = run("michigan_tpu_torch.train", "--ndf", "8", "--batchSize", "1", "--niter", "1",
                "--nThreads", "1", "--print_freq", "1", "--random_expand_mask",
                "--label_dir", os.path.join(DATA_DIR, "val_labels"),
                "--image_dir", os.path.join(DATA_DIR, "val_images"),
                "--orient_dir", os.path.join(DATA_DIR, "val_dense_orients"))
    assert train.returncode == 0, train.stdout + train.stderr
    assert train.stdout.count("(epoch: 1, iters: 1") == 1 and train.stdout.strip().endswith("ok")
    files = sorted(os.listdir(os.path.join(ck, "row")))
    for f in ("1_net_G.pth", "1_net_D.pth", "latest_net_G.pth", "latest_optim.pth"):
        assert f in files, (f, files)
    infer = run("michigan_tpu_torch.inference", "--which_epoch", "latest",
                "--data_dir", DATA_DIR, "--inference_ref_name", "67172",
                "--inference_tag_name", "67172", "--inference_orient_name", "67172")
    assert infer.returncode == 0, infer.stdout + infer.stderr
    assert f"loaded netG from {os.path.join(ck, 'row', 'latest_net_G.pth')}" in infer.stdout
    out = "inpaint_fake_image.jpg" if ROWS[row] else "fake_image.jpg"
    assert (tmp_path / "inference_samples" / out).exists()

    from michigan_tpu_torch.inference import load_released, parse_options

    opt = parse_options([*ROW_COMMON, *ROWS[row], "--checkpoints_dir", ck,
                         "--which_epoch", "latest"])
    model = MichiGANModel(opt, "cpu")
    model.init_weights(opt.seed)
    assert load_released(model, opt)
    trained = train_options([*ROW_COMMON, *ROWS[row], "--ndf", "8"])
    held = MichiGANModel(trained, "cpu")
    held.init_weights(trained.seed)
    assert (model.netSIG is not None) == ("--use_stroke" in ROWS[row])
    for name in ("netIG", "netSIG"):  # the frozen nets the trainer held
        if getattr(model, name) is not None:
            for k, t in getattr(held, name).state_dict().items():
                assert torch.equal(getattr(model, name).state_dict()[k], t), (name, k)
