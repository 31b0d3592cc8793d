"""The port's flagship inference slice against the JAX package's.

- the slice at a small config (crop 128, ngf 8, the flagship flags) through
  ``michigan_tpu.model.MichiGANModel.infer`` and the port's ``infer`` on the
  same prepared batch and weights: generator output within 2e-3 max abs;
- the port's host prep equals ``michigan_tpu.data.single_inference_data``;
- with jax unimportable, the port's CLI runs the small slice on the CPU;
- (slow) the 67172 golden of tests/test_inference_golden.py, with the JAX
  package's own initialised weights carried into the port: PSNR > 40 dB.

Batches are NHWC numpy (the JAX layout); the port's ``batch_from_numpy``
moves them to NCHW and its outputs are transposed back for comparison.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu import config
from michigan_tpu.data.single import single_inference_data as jax_data
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.training.convert import convert_generator, convert_inpaint
from michigan_tpu_torch.data.single import single_inference_data
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "datasets", "FFHQ_single")
FLAGS = ("--netG spadeb --use_encoder --noise_background --use_ig --expand_mask_be "
         "--expand_th 5 --add_feat_zeros --inference_ref_name 67172 "
         "--inference_tag_name 67172 --inference_orient_name 67172").split()
SMALL = ["--crop_size", "128", "--load_size", "128", "--ngf", "8", "--init_type", "none",
         "--data_dir", DATA_DIR, "--gpu_ids", "-1"]
GEN_TOL = 2e-3


def small_opt():
    return config.test_options(FLAGS + SMALL)


def test_host_prep_equals_jax_package():
    opt = small_opt()
    ours, theirs = single_inference_data(opt), jax_data(opt)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


def test_slice_matches_jax_infer():
    """Seeded port weights, carried into JAX by the JAX package's own
    converters, on the real 67172 batch."""
    opt = small_opt()
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    sd = {k: net.state_dict() for k, net in model.nets().items()}
    variables = {"netG": convert_generator(sd["netG"], opt),
                 "netIG": convert_inpaint(sd["netIG"])}
    data = jax_data(opt)

    fake, orient_rgb = model.infer(batch_from_numpy(data, "cpu"))
    batch = {k: jnp.asarray(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    j_fake, j_orient_rgb = jax.jit(lambda v, b: JModel(opt).infer(v, b))(variables, batch)

    fake = fake.permute(0, 2, 3, 1).numpy()
    assert fake.shape == (1, 192, 192, 3)
    assert fake.std() > 1e-2  # not a constant image
    assert np.max(np.abs(fake - np.asarray(j_fake))) <= GEN_TOL
    np.testing.assert_allclose(orient_rgb.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_orient_rgb), atol=1e-3)


BLOCK_JAX = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "michigan_tpu"):
    sys.modules[name] = None
sys.argv = ["inference"] + sys.argv[1:]
runpy.run_module("michigan_tpu_torch.inference", run_name="__main__")
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "michigan_tpu" or m.startswith("michigan_tpu.")))
assert not leaked, leaked
print("ok")
"""


def test_cli_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, *FLAGS, *SMALL,
         "--checkpoints_dir", str(tmp_path / "checkpoints")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
    from PIL import Image

    img = Image.open(tmp_path / "inference_samples" / "inpaint_fake_image.jpg")
    assert img.size == (128, 128) and img.mode == "RGB"


def test_cli_rejects_cuda_without_a_card(tmp_path, monkeypatch):
    from michigan_tpu_torch.inference import device_from_gpu_ids

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_from_gpu_ids("-1") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_from_gpu_ids("0")


@pytest.mark.slow
def test_golden_with_jax_initialised_weights():
    from tests.test_inference_golden import FIXTURE, golden_opt, psnr
    from michigan_tpu_torch.convert import state_dicts_from_flax
    from michigan_tpu_torch.utils.imaging import tensor2im

    opt = golden_opt()
    data = jax_data(opt)
    batch = {k: jnp.asarray(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    variables = JModel(opt).init_variables(jax.random.PRNGKey(opt.seed), batch)

    model = MichiGANModel(opt, "cpu")
    model.load_state_dicts(state_dicts_from_flax(variables, opt))
    fake, _ = model.infer(batch_from_numpy(data, "cpu"))
    r = opt.add_th // 2
    img = tensor2im(fake.permute(0, 2, 3, 1).numpy()[0, r : r + opt.crop_size,
                                                     r : r + opt.crop_size])
    gold = np.load(FIXTURE)["image"]
    assert psnr(img, gold) > 40.0


def test_synthetic_sample_has_the_loader_contract():
    """The numpy-only sample the card smoke test feeds has the keys, shapes
    and dtypes of single_inference_data."""
    from michigan_tpu_torch.data.synthetic import synthetic_inference_data

    opt = small_opt()
    real, fake = single_inference_data(opt), synthetic_inference_data(opt, 0)
    arrays = {k for k, v in real.items() if isinstance(v, np.ndarray)}
    assert arrays == set(fake)
    for k in arrays:
        assert (fake[k].shape, fake[k].dtype) == (real[k].shape, real[k].dtype), k


def test_released_checkpoints_load(tmp_path):
    """Released-style .pth files: DataParallel prefixes, the never-applied
    background layer4, resblock convs saved without a bias."""
    from michigan_tpu_torch.inference import load_released

    opt = dataclasses.replace(small_opt(), checkpoints_dir=str(tmp_path), name="M",
                              which_epoch="50")
    src = MichiGANModel(opt, "cpu")
    src.init_weights(3)
    g = {"module." + k: v for k, v in src.netG.state_dict().items()}
    g["module.backgroud_enc.layer4.conv.weight"] = torch.zeros(1)
    ig = {k: v for k, v in src.netIG.state_dict().items()
          if not (k.startswith("middle.0.conv_block") and k.endswith(".bias"))}
    os.makedirs(tmp_path / "M")
    torch.save(g, tmp_path / "M" / "50_net_G.pth")
    torch.save({"generator": ig}, tmp_path / "M" / opt.ig_model_name)

    dst = MichiGANModel(opt, "cpu")
    dst.init_weights(4)
    assert load_released(dst, opt)
    for name, net in src.nets().items():
        got = dst.nets()[name].state_dict()
        for k, v in net.state_dict().items():
            want = torch.zeros_like(v) if k.startswith("middle.0.conv_block") and \
                k.endswith(".bias") and name == "netIG" else v
            torch.testing.assert_close(got[k], want, rtol=0, atol=0, msg=k)

    g["module.not_a_layer.weight"] = torch.zeros(1)
    torch.save(g, tmp_path / "M" / "50_net_G.pth")
    with pytest.raises(KeyError, match="not_a_layer"):
        load_released(dst, opt)
