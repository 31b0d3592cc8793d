"""Spatial sharding of inference (michigan_tpu_torch/parallel/spatial.py) on
CPU ranks over gloo, against the port's unsharded ``infer`` and the JAX
package's.

- ``halo_rows`` on the convolutions of the path, and each band layer (zero
  and reflect padding, stride 1 and 2, k 1/3/4/7, dilation 1 and 2, the
  spectral and partial convs, the instance norm and masked mean, nearest
  resizes to a band and to a whole plane, the expanded background mask with
  the crop's edges inside the bands, the gather) against the whole layer's
  rows of the band, at P = 4 and P = 2 in one launch: within LAYER_TOL
  (bfloat16: one bf16 rounding, LAYER_TOL_BF16);
- ``make_spatial_infer`` at the two topologies of
  tests/test_spatial_sharding.py at torch's default init (outputs O(1)):
  the `normal` flagship at crop 64 + 64, ngf 8, P = 2; `most` at
  crop 256 + --add_th 128, ngf 4, P = 4 (a 384 frame, planes 3^2 ...
  384^2), fp32 and bf16; batch 1 (the layer cases run batch 2); against
  the port's ``infer`` (PORT_TOL; bf16 PORT_TOL_BF16) and against the JAX
  package's ``infer`` on the same weights (the port's, carried into JAX by
  its own converters): JAX_TOL, tests/test_torch_most.py's limit;
- a control, the same run with zeros in place of the neighbours' halo
  rows, fails both gates;
- every option outside the ported path raises, and so do misaligned
  frames;
- (slow) the JAX package's own ``make_spatial_infer`` on a ('space',) mesh
  of 4 of the 8 virtual CPU devices against the port's 4 ranks.

Every rank runs one torch thread with subnormals flushed (the seeded
inpainter's attention softmax underflows, and the CPU crawls on them).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import test_torch_spatial_ranks as R
from michigan_tpu import config
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.parallel.spatial import make_spatial_infer as jax_spatial_infer
from michigan_tpu.training.convert import convert_generator, convert_inpaint
from michigan_tpu_torch.data.synthetic import synthetic_inference_data
from michigan_tpu_torch.inference import parse_options
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.parallel import dist as DP
from michigan_tpu_torch.parallel.spatial import (
    SPACE_AXIS,
    Space,
    check_spatial,
    halo_rows,
    make_spatial_infer,
    plane_plan,
)

FLAGS = ("--netG spadeb --use_encoder --noise_background --use_ig --expand_mask_be "
         "--expand_th 5 --add_feat_zeros --gpu_ids -1").split()
# name: (flags, ranks, batch, dtypes)
TOPOLOGIES = {
    "normal_p2": (["--crop_size", "64", "--load_size", "64", "--ngf", "8",
                   "--num_upsampling_layers", "normal", "--init_type", "none"], 2, 1,
                  ("float32",)),
    "most_p4": (["--crop_size", "256", "--load_size", "256", "--ngf", "4", "--add_th", "128",
                 "--num_upsampling_layers", "most", "--init_type", "none"], 4, 1,
                ("float32", "bfloat16")),
}
LAYER_TOL = 1e-6       # a band layer against the whole layer's rows, float32
LAYER_TOL_BF16 = 1e-2  # bfloat16: one rounding of an O(1) value (2^-7 relative)
PORT_TOL = 1e-5        # the bands against the port's infer, float32: sums reordered
PORT_TOL_BF16 = 1e-2   # bfloat16 (the JAX package's own `most` spatial limit)
JAX_TOL = 2e-3         # against the JAX package's infer (tests/test_torch_most.py)
JOIN_TIMEOUT = 120
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def one_thread_subnormals_flushed():
    """The port's CPU work here in one thread, subnormals flushed (as
    tests/test_torch_qt_ui.py)."""
    n = torch.get_num_threads()
    flushed = torch.tensor([1e-39]).mul(1.0).item() == 0.0
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(flushed)
    torch.set_num_threads(n)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# halo_rows and the band layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,padding,dilation,want", [
    (3, 1, 1, 1, (1, 1)), (4, 2, 1, 1, (1, 1)), (3, 2, 1, 1, (1, 0)), (7, 1, 3, 1, (3, 3)),
    (3, 1, 2, 2, (2, 2)), (1, 1, 0, 1, (0, 0)), (5, 1, 2, 1, (2, 2))])
def test_halo_rows(k, stride, padding, dilation, want):
    assert halo_rows(k, stride, padding, dilation, 8) == want


def test_halo_rows_refuses_a_band_off_the_stride():
    with pytest.raises(ValueError, match="not aligned with stride 2"):
        halo_rows(3, 2, 1, 1, 3)


@pytest.fixture(scope="module")
def layer_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("layers")
    DP.launch(R.band_layers, (str(out),), 4, timeout=JOIN_TIMEOUT)
    return [torch.load(out / f"layers{r}.pt") for r in range(4)]


@pytest.mark.parametrize("ranks", [4, 2])
@pytest.mark.parametrize("case", R.LAYER_CASES)
def test_band_layer_matches_the_whole_layer(layer_results, case, ranks):
    tol = LAYER_TOL_BF16 if case.endswith("bf16") else LAYER_TOL
    for r, res in enumerate(layer_results):
        got = res[(case, ranks)]
        assert got["shape_ok"] and got["err"] <= tol, (r, got)


# ---------------------------------------------------------------------------
# make_spatial_infer against the port's infer and the JAX package's
# ---------------------------------------------------------------------------

def run_topology(name, out):
    flags, ranks, n, dtypes = TOPOLOGIES[name]
    flags = FLAGS + flags
    opt = parse_options(flags)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(SEED)
    states = {k: net.state_dict() for k, net in model.nets().items()}
    data = synthetic_inference_data(opt, SEED, n)
    batch = batch_from_numpy(data, "cpu")
    torch.save(states, out / "states.pt")
    torch.save(batch, out / "batch.pt")
    res = {"opt": opt, "ranks": ranks, "port": {}}
    for dtype in dtypes:
        m = MichiGANModel(parse_options(flags + ["--dtype", dtype]), "cpu")
        m.load_state_dicts(states)
        res["port"][dtype] = m.infer(batch)
    DP.launch(R.spatial_infer, (str(out), flags, dtypes, True), ranks, timeout=JOIN_TIMEOUT)
    res["spatial"] = torch.load(out / "spatial.pt")
    # the JAX package's infer on the same weights, at XLA's optimisation level 0
    jopt = config.test_options(flags)
    variables = {"netG": convert_generator(states["netG"], jopt),
                 "netIG": convert_inpaint(states["netIG"])}
    jbatch = {k: jnp.asarray(v) for k, v in data.items() if v.ndim == 4}
    infer = jax.jit(JModel(jopt).infer).lower(variables, jbatch).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    res["jax"] = [np.asarray(a) for a in infer(variables, jbatch)]
    res["jax_inputs"] = (jopt, variables, jbatch)
    return res


@pytest.fixture(scope="module")
def topologies(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_topology(name, tmp_path_factory.mktemp(name))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_spatial_infer_matches_the_unsharded_port(topologies, name):
    res = topologies(name)
    opt = res["opt"]
    frame, crop = opt.generator_input_size(), opt.crop_size
    for dtype, (fake, orient_rgb) in res["port"].items():
        got, got_orient = res["spatial"][dtype]
        assert got.shape == fake.shape == (fake.shape[0], 3, frame, frame)
        assert got_orient.shape == orient_rgb.shape == (fake.shape[0], 3, crop, crop)
        assert fake.std() > 1e-2
        tol = PORT_TOL if dtype == "float32" else PORT_TOL_BF16
        assert (got - fake).abs().max().item() <= tol, dtype
        assert (got_orient - orient_rgb).abs().max().item() <= tol, dtype


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_spatial_infer_matches_jax(topologies, name):
    res = topologies(name)
    j_fake, j_orient = res["jax"]
    got, got_orient = res["spatial"]["float32"]
    assert np.max(np.abs(nhwc(got) - j_fake)) <= JAX_TOL
    np.testing.assert_allclose(nhwc(got_orient), j_orient, atol=1e-3)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_zero_halo_control_fails_both_gates(topologies, name):
    res = topologies(name)
    got = res["spatial"]["control"][0]
    assert (got - res["port"]["float32"][0]).abs().max().item() > max(PORT_TOL, JAX_TOL)
    assert np.max(np.abs(nhwc(got) - res["jax"][0])) > JAX_TOL


def test_plane_plan_names_the_whole_planes():
    most = parse_options(FLAGS + TOPOLOGIES["most_p4"][0])
    plan = plane_plan(most, 4)
    assert plan[3] == plan[6] == "whole" and plan[12] == "band of 3 rows"
    assert plan[384] == "band of 96 rows" and len(plan) == 8
    flag = parse_options(FLAGS + ["--num_upsampling_layers", "most", "--crop_size", "1024",
                                  "--load_size", "1024", "--add_th", "128"])
    assert [h for h, v in plane_plan(flag, 4).items() if v == "whole"] == [9, 18]
    assert [h for h, v in plane_plan(flag, 2).items() if v == "whole"] == [9]


# ---------------------------------------------------------------------------
# what the path refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("added,dropped,what", [
    (["--use_vae"], (), "--use_vae"),
    (["--use_blender"], ("--add_feat_zeros",), "--use_blender"),
    (["--Image_encoder_mode", "norm"], (), "--Image_encoder_mode norm"),
    (["--Image_encoder_mode", "instance"], (), "--Image_encoder_mode instance"),
    ([], ("--use_encoder",), "no --use_encoder"),
    (["--use_stroke", "--inpaint_mode", "stroke"], (), "--inpaint_mode stroke"),
    (["--orient_random_disturb"], (), "--orient_random_disturb"),
    (["--no_instance", "False"], (), "--no_instance False"),
    (["--weight_norm_G"], (), "--weight_norm_G"),
    ([], ("--add_feat_zeros",), "no --add_feat_zeros"),
    ([], ("--use_ig",), "no --use_ig"),
    ([], ("--noise_background",), "no --noise_background"),
    ([], ("--expand_mask_be",), "no --expand_mask_be"),
    (["--norm_G", "spectralspadeinstance3x3"], (), "--norm_G spectralspadeinstance3x3"),
])
def test_options_outside_the_path_raise(added, dropped, what):
    opt = parse_options([f for f in FLAGS if f not in dropped] + added +
                        ["--crop_size", "64", "--load_size", "64", "--ngf", "4"])
    model = MichiGANModel(opt, "cpu")
    with pytest.raises(NotImplementedError, match=what):
        make_spatial_infer(model, Space(None, 0, 2, torch.device("cpu")))


def test_training_options_raise():
    from michigan_tpu_torch.train import parse_options as train_options

    opt = train_options(FLAGS + ["--crop_size", "64", "--load_size", "64"])
    with pytest.raises(NotImplementedError, match="--isTrain"):
        check_spatial(opt, 2)


@pytest.mark.parametrize("crop,add_th,ranks,what", [
    (96, 64, 2, r"frame \(--crop_size 96 \+ --add_th 64 = 160\) / 2 to be a multiple of 32"),
    (64, 64, 3, r"= 128\) / 3 to be a multiple of 32 .*; it is 42.6667"),
    (64, 64, 8, r"/ 8 to be a multiple of 32 .*; it is 16"),
    (256, 128, 3, r"3 to divide the inpainter's 256 rows"),
])
def test_misaligned_frames_raise(crop, add_th, ranks, what):
    opt = parse_options(FLAGS + ["--crop_size", str(crop), "--load_size", str(crop),
                                 "--add_th", str(add_th)])
    with pytest.raises(ValueError, match=what):
        check_spatial(opt, ranks)


# ---------------------------------------------------------------------------
# the JAX package's own spatial sharding
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_matches_jax_make_spatial_infer_on_four_devices(topologies):
    assert jax.device_count() >= 8
    res = topologies("most_p4")
    jopt, variables, jbatch = res["jax_inputs"]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), (SPACE_AXIS,))
    with mesh:
        j_fake, j_orient = jax_spatial_infer(JModel(jopt), mesh)(variables, jbatch)
    got, got_orient = res["spatial"]["float32"]
    assert np.max(np.abs(nhwc(got) - np.asarray(j_fake))) <= JAX_TOL
    np.testing.assert_allclose(nhwc(got_orient), np.asarray(j_orient), atol=1e-3)
