"""The port's evaluation (michigan_tpu_torch.evaluate, models/inception.py)
against the JAX package's (evaluate.py, michigan_tpu/models/inception.py).

- InceptionV3 pool3 on the JAX package's random params carried over by
  ``convert.inception_state_dict``: the JAX package's
  ``inception_features`` at 2 x 75^2 and 1 x 299^2, within 1e-4 of the
  features' largest magnitude (float32 sums of ~94 convolutions in
  another order);
- VGG19's relu4_1, mean-pooled (the FID variant), on bridged weights: the
  JAX VGG19's, within the same tolerance;
- an ``inception_v3.npz`` written by the JAX package's
  ``save_inception_npz`` loads into the port's loader (pretrained=True)
  and gives the same features;
- ``frechet_distance`` and ``psnr`` equal evaluate.py's on the same arrays
  (rtol 1e-10: the same numpy / scipy arithmetic), and FID refuses fewer
  than 2 images a side;
- the CLI runs ``fid`` on two small PNG directories with --gpu_ids -1 where
  jax and the JAX package cannot be imported, and tags the RANDOM
  backbone.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import evaluate as jax_evaluate
from michigan_tpu.models import inception as JI
from michigan_tpu.models.vgg import VGG19 as JVGG19
from michigan_tpu_torch import evaluate
from michigan_tpu_torch.convert import VGG_RENAMES, inception_state_dict, module_state_dict
from michigan_tpu_torch.models.inception import INCEPTION_SPEC, InceptionV3, load_inception_params
from michigan_tpu_torch.models.vgg import VGG19

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    params = JI.init_inception_params(jax.random.PRNGKey(3))
    # non-trivial batch norms, so that the bridge's leaves are told apart
    rng = np.random.default_rng(0)
    for p in params.values():
        o = p["bn_scale"].shape[0]
        p["bn_scale"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
        p["bn_bias"] = rng.normal(0, 0.1, o).astype(np.float32)
        p["bn_mean"] = rng.normal(0, 0.1, o).astype(np.float32)
        p["bn_var"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, params)


def assert_features_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_REL * np.abs(want).max())


@pytest.mark.parametrize("n, size", [(2, 75), (1, 299)])
def test_inception_matches_jax(jax_params, n, size):
    x = np.random.default_rng(size).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JI.inception_features)(jax_params, jnp.asarray(x)))
    net = InceptionV3()
    net.load_state_dict(inception_state_dict(jax_params), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (n, JI.FEATURE_DIM) and want.std() > 0
    assert_features_close(got, want)


def test_vgg_relu4_1_features_match_jax():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    jvgg = JVGG19()
    variables = jax.jit(jvgg.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jvgg.apply(variables, jnp.asarray(x))[-2].mean(axis=(1, 2)))
    vgg = VGG19()
    vgg.load_state_dict(module_state_dict(jax.tree_util.tree_map(np.asarray, variables),
                                          VGG_RENAMES), strict=True)
    with torch.no_grad():
        got = evaluate._VGGRelu41(vgg).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 512)
    assert_features_close(got, want)


def test_jax_npz_loads_into_the_port(jax_params, tmp_path, monkeypatch):
    path = str(tmp_path / "inception_v3.npz")
    JI.save_inception_npz(jax_params, path)
    monkeypatch.setenv("MICHIGAN_INCEPTION", path)
    net = InceptionV3()
    assert load_inception_params(net, torch.Generator().manual_seed(0), str(tmp_path / "none"))
    want = inception_state_dict(jax_params)
    got = net.state_dict()
    assert set(got) == set(want) and len(INCEPTION_SPEC) * 6 == len(got)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_random_fallback_is_tagged(tmp_path, monkeypatch):
    monkeypatch.delenv("MICHIGAN_INCEPTION", raising=False)
    monkeypatch.chdir(tmp_path)
    net = InceptionV3()
    with pytest.warns(UserWarning, match="RANDOM Inception backbone"):
        assert not load_inception_params(net, torch.Generator().manual_seed(0),
                                         str(tmp_path / "checkpoints"))
    x = np.random.default_rng(2).uniform(-1, 1, (3, 75, 75, 3)).astype(np.float32)
    feats = evaluate.extract_features(x, "inception", batch=2,
                                      checkpoints_dir=str(tmp_path / "checkpoints"))
    assert feats.shape == (3, 2048) and np.isfinite(feats).all() and feats.std() > 0
    assert evaluate.extract_features.last_pretrained is False


def test_frechet_distance_and_psnr_match_evaluate_py():
    rng = np.random.default_rng(0)
    f1 = rng.normal(0, 1, (12, 16))
    f2 = rng.normal(0.3, 1.2, (9, 16))
    assert evaluate.frechet_distance(f1, f2) == pytest.approx(
        jax_evaluate.frechet_distance(f1, f2), rel=1e-10)
    assert evaluate.frechet_distance(f1, f1) == pytest.approx(0, abs=1e-6)
    a = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    assert evaluate.psnr(a, b) == pytest.approx(jax_evaluate.psnr(a, b), rel=1e-10)
    assert evaluate.psnr(a, a) == float("inf")
    for one in ((f1[:1], f2), (f1, f2[:1])):
        with pytest.raises(ValueError, match=">=2 images"):
            evaluate.frechet_distance(*one)


BLOCK_JAX = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "michigan_tpu"):
    sys.modules[name] = None
sys.argv = ["evaluate"] + sys.argv[1:]
runpy.run_module("michigan_tpu_torch.evaluate", run_name="__main__")
"""


def test_cli_fid_without_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for d in ("real", "fake"):
        os.makedirs(tmp_path / d)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                tmp_path / d / f"{i}.png")
    env = {k: v for k, v in os.environ.items() if k not in ("MICHIGAN_INCEPTION",)}
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, "fid", "--real_dir", str(tmp_path / "real"),
         "--fake_dir", str(tmp_path / "fake"), "--extractor", "inception", "--gpu_ids", "-1"],
        cwd=tmp_path, env=dict(env, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("FID (InceptionV3-pool3, RANDOM backbone") and "over 3/3 images" in line
    assert float(line.split(": ")[1].split()[0]) > 0
