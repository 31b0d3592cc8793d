"""The port's stroke-edit path and dense-orientation tool against the JAX
package's.

- the stroke slice at a small config (the demo flags at crop 128, ngf 8)
  through ``michigan_tpu.model.MichiGANModel.infer(..., inpaint_mode=
  "stroke")`` and the port's, on the same weights and the same prepared
  demo batch, for both outcomes of the two-stage branch: generator output
  within GEN_TOL 2e-3 max abs, inpainted orientation within 1e-3;
- the demo host prep, the stroke -> orientation conversion, the dense
  orientation golden of sample 67172 and ``compute_orientation_map``;
- the plain Gaussian against cv2.GaussianBlur;
- with jax unimportable, ``python -m michigan_tpu_torch.demo --stroke`` and
  ``python -m michigan_tpu_torch.cal_orientation`` run on the CPU.

Inputs are NHWC numpy (the JAX layout); the port's ``batch_from_numpy``
moves them to NCHW.
"""

import dataclasses
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from michigan_tpu import config
from michigan_tpu.data.single import demo_inference_data as jax_demo_data
from michigan_tpu.demo import engine as jax_engine
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.ops.filters import dense_orientation as jax_dense_orientation
from michigan_tpu.training.convert import convert_generator, convert_inpaint
from michigan_tpu_torch.cal_orientation import compute_orientation_map, gaussian_blur
from michigan_tpu_torch.data.single import demo_inference_data
from michigan_tpu_torch.demo import engine
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.ops.filters import dense_orientation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_DIR = os.path.join(REPO, "datasets", "FFHQ_demo")
SMALL = ["--crop_size", "128", "--load_size", "128", "--ngf", "8", "--init_type", "none",
         "--demo_data_dir", DEMO_DIR, "--gpu_ids", "-1"]
GEN_TOL = 2e-3
ORIENT_TOL = 1e-3
IDENT, REF = "67172", "59144"


def small_opt(*argv):
    return config.demo_options(SMALL + list(argv))


def demo_sample(name):
    img = Image.open(os.path.join(DEMO_DIR, "images", name + ".jpg")).convert("RGB")
    label = np.array(Image.open(os.path.join(DEMO_DIR, "labels", name + ".png")))
    orient = np.array(Image.open(os.path.join(DEMO_DIR, "orients", name + "_orient_dense.png")))
    return img, label, orient


def edit_args(prefill):
    """demo_inference_data's arguments for a stroke edit of 67172 with the
    appearance of 59144.  With `prefill` the orientation map leaves the hole
    uncovered (the demo's own edit: the two-stage branch runs); without, it
    covers the hair (SIG alone)."""
    tag_img, label, orient = demo_sample(IDENT)
    ref_img, _, _ = demo_sample(REF)
    stroke = engine.draw_stroke(label)
    hole = jax_engine.dilate_hole(stroke, 50) * label
    return dict(
        ref_label_path=os.path.join(DEMO_DIR, "labels", REF + ".png"), tag_label=label,
        mask_orient=label * (1 - hole) if prefill else label, ref_orient=orient,
        ref_image=ref_img, tag_image=tag_img,
        orient_stroke=jax_engine.stroke_to_orient(stroke), mask_stroke=stroke,
        mask_hole=hole,
    )


def test_demo_host_prep_equals_jax_package():
    opt = small_opt()
    args = edit_args(prefill=True)
    ours, theirs = demo_inference_data(opt, **args), jax_demo_data(opt, **args)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        if isinstance(v, np.ndarray):
            assert ours[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


@pytest.fixture(scope="module")
def stroke_pair():
    """Seeded port weights (netG, netIG, netSIG), carried into JAX by its
    own converters, and the JAX stroke-mode infer, compiled once."""
    opt = small_opt()
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    sd = {k: net.state_dict() for k, net in model.nets().items()}
    variables = {"netG": convert_generator(sd["netG"], opt),
                 "netIG": convert_inpaint(sd["netIG"]),
                 "netSIG": convert_inpaint(sd["netSIG"])}
    j_infer = jax.jit(lambda v, b: JModel(opt).infer(v, b, inpaint_mode="stroke"))
    return opt, sd, variables, j_infer


# the epilogue computes the same function as the unfused stack
# (tests/test_pallas_kernels.py:141), so the port runs one branch with each
@pytest.mark.parametrize("prefill,epilogue", [(True, True), (False, False)])
def test_stroke_slice_matches_jax_infer(stroke_pair, prefill, epilogue):
    opt, sd, variables, j_infer = stroke_pair
    model = MichiGANModel(dataclasses.replace(opt, use_pallas_epilogue=epilogue), "cpu")
    model.load_state_dicts(sd)
    data = jax_demo_data(opt, **edit_args(prefill), noise=None)
    assert (np.max(data["label_tag"] - data["orient_rgb_mask"]) != 0) == prefill

    fake, orient_rgb = model.infer(batch_from_numpy(data, "cpu"), inpaint_mode="stroke")
    batch = {k: jnp.asarray(v) for k, v in data.items() if isinstance(v, np.ndarray)}
    j_fake, j_orient_rgb = j_infer(variables, batch)

    fake = fake.permute(0, 2, 3, 1).numpy()
    assert fake.shape == (1, 192, 192, 3) and fake.std() > 1e-2
    assert np.max(np.abs(fake - np.asarray(j_fake))) <= GEN_TOL
    np.testing.assert_allclose(orient_rgb.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_orient_rgb), atol=ORIENT_TOL)


def test_infer_takes_the_mode_and_leaves_the_options(stroke_pair):
    opt, sd, _, _ = stroke_pair
    model = MichiGANModel(opt, "cpu")
    model.load_state_dicts(sd)
    batch = batch_from_numpy(jax_demo_data(opt, **edit_args(True)), "cpu")
    assert opt.inpaint_mode == "ref"
    _, ref_rgb = model.infer(batch)
    _, stroke_rgb = model.infer(batch, inpaint_mode="stroke")
    assert opt.inpaint_mode == "ref"
    assert not torch.equal(ref_rgb, stroke_rgb)
    no_sig = MichiGANModel(dataclasses.replace(opt, use_stroke=False), "cpu")
    with pytest.raises(ValueError, match="use_stroke"):
        no_sig.infer(batch, inpaint_mode="stroke")


def test_render_edit_encodes_on_the_device(stroke_pair):
    """The crop and uint8 encode of render_edit equal tensor2im on the host."""
    from michigan_tpu_torch.utils.imaging import tensor2im

    opt, sd, _, _ = stroke_pair
    model = MichiGANModel(opt, "cpu")
    model.load_state_dicts(sd)
    batch = batch_from_numpy(jax_demo_data(opt, **edit_args(False)), "cpu")
    out = engine.render_edit(model, batch, "stroke")
    fake, orient_rgb = model.infer(batch, "stroke")
    r = opt.add_th // 2
    want = tensor2im(fake.permute(0, 2, 3, 1).numpy()[0, r : r + 128, r : r + 128])
    assert out.shape == (2, 128, 128, 3) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out[0].numpy(), want)
    np.testing.assert_array_equal(
        out[1].numpy(), (orient_rgb.permute(0, 2, 3, 1).numpy()[0] * 255).astype(np.uint8))


def test_released_sig_checkpoint_loads(stroke_pair, tmp_path):
    """SInpaintingModel_gen.pth ['generator'] loads into netSIG with
    --use_stroke."""
    from michigan_tpu_torch.inference import load_released

    opt, sd, _, _ = stroke_pair
    opt = dataclasses.replace(opt, checkpoints_dir=str(tmp_path), name="M")
    os.makedirs(tmp_path / "M")
    torch.save({"generator": {"module." + k: v for k, v in sd["netSIG"].items()}},
               tmp_path / "M" / opt.sig_model_name)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(1)
    assert not load_released(model, opt)  # no generator file
    for k, v in model.netSIG.state_dict().items():
        torch.testing.assert_close(v, sd["netSIG"][k], rtol=0, atol=0, msg=k)


def test_stroke_to_orient_matches_jax():
    _, label, _ = demo_sample(IDENT)
    stroke = engine.draw_stroke(label)
    got = engine.stroke_to_orient(torch.from_numpy(stroke)).numpy()
    np.testing.assert_allclose(got, jax_engine.stroke_to_orient(stroke), atol=1e-3)


def test_orient_stroke_plane_matches_host_prep():
    """The device-side orient_stroke plane equals demo_inference_data's when
    the stroke is at crop size."""
    opt = small_opt("--crop_size", "512", "--load_size", "512")
    args = edit_args(prefill=True)
    data = demo_inference_data(opt, **args)
    batch = batch_from_numpy(data, "cpu")
    got = engine.orient_stroke_plane(batch["mask_stroke"], batch["label_tag"])
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), data["orient_stroke"])


def test_dense_orientation_golden():
    """tests/test_orientation_regression.py's fixture and limits."""
    img = np.asarray(Image.open(os.path.join(REPO, "datasets/FFHQ_single/val_images/67172.jpg"))
                     .convert("RGB"), np.float32) / 255.0
    crop = img[128:192, 224:288]
    fake = ((crop * 2 - 1) + 1) / 2 * 255
    gray = 0.299 * fake[..., 0] + 0.587 * fake[..., 1] + 0.144 * fake[..., 2]
    idx, conf = dense_orientation(torch.from_numpy(gray[None, ..., None]), mode="dog")
    assert idx.shape == conf.shape == (1, 64, 64, 1)
    gold = np.load(os.path.join(REPO, "tests/fixtures_orientation_67172.npz"))
    idx, conf = idx.numpy()[0, ..., 0], conf.numpy()[0, ..., 0]
    assert (idx.astype(np.uint8) != gold["idx"]).mean() < 0.01
    np.testing.assert_allclose(conf, gold["conf"], rtol=1e-3, atol=1e-2)
    j_idx, j_conf = jax_dense_orientation(jnp.asarray(gray[None, ..., None]), mode="dog")
    assert (idx != np.asarray(j_idx)[0, ..., 0]).mean() < 0.01
    np.testing.assert_allclose(conf, np.asarray(j_conf)[0, ..., 0], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", [(100, 120), (512, 512)])
def test_gaussian_blur_matches_cv2(shape):
    """cv2.GaussianBlur(x, (0, 0), 4) on float32; tolerance 1e-5 of the
    input's scale (float32 sums in another order)."""
    x = (np.random.default_rng(0).standard_normal(shape) * 50).astype(np.float32)
    got = gaussian_blur(torch.from_numpy(x), 4).numpy()
    np.testing.assert_allclose(got, cv2.GaussianBlur(x, (0, 0), 4), rtol=0, atol=5e-4)


def test_compute_orientation_map_matches_jax():
    import cal_orientation as jax_cal

    img = np.asarray(Image.open(os.path.join(REPO, "datasets/FFHQ_single/val_images/67172.jpg"))
                     .convert("RGB"), np.float32) / 255.0
    mask = np.array(Image.open(os.path.join(REPO, "datasets/FFHQ_single/val_labels/67172.png")))
    mask = (mask > 130) * 1 if mask.max() > 1 else mask
    got = compute_orientation_map(torch.from_numpy(img),
                                  torch.from_numpy(mask.astype(np.float32))).numpy()
    want = jax_cal.compute_orientation_map(img, mask.astype(np.float64))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got != want).mean() <= 0.01


def test_synthetic_stroke_sample_has_the_demo_contract():
    """The numpy-only stroke edit the card smoke test feeds has the keys,
    shapes and dtypes of demo_inference_data (less orient_stroke, made on
    the device) and takes the two-stage branch."""
    from michigan_tpu_torch.data.synthetic import synthetic_stroke_data

    opt = small_opt()
    real = demo_inference_data(opt, **edit_args(prefill=True))
    fake = synthetic_stroke_data(opt, 0)
    arrays = {k for k, v in real.items() if isinstance(v, np.ndarray)} - {"orient_stroke"}
    assert arrays == set(fake)
    for k in arrays:
        assert (fake[k].shape, fake[k].dtype) == (real[k].shape, real[k].dtype), k
    assert fake["mask_stroke"].sum() > 0
    assert np.all(fake["mask_stroke"] <= fake["hole"])
    assert np.max(fake["label_tag"] - fake["orient_rgb_mask"]) != 0


def test_select_tag_image_recon_semantics():
    """Reconstructed-tag selection (reference demo.py:330-333)."""
    tag = Image.new("RGB", (8, 8), (10, 10, 10))
    recon = Image.new("RGB", (8, 8), (200, 200, 200))
    mask = np.zeros((8, 8), np.uint8)
    mask[2:6, 2:6] = 1
    shrunk, grown = mask.copy(), mask.copy()
    shrunk[2:4] = 0
    grown[6:8, 2:6] = 1
    assert np.asarray(engine.select_tag_image(tag, recon, mask, shrunk))[0, 0, 0] == 200
    assert np.asarray(engine.select_tag_image(tag, recon, mask, grown))[0, 0, 0] == 10
    assert np.asarray(engine.select_tag_image(tag, recon, mask, shrunk, True))[0, 0, 0] == 10
    assert np.asarray(engine.select_tag_image(tag, None, mask, shrunk))[0, 0, 0] == 10


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


def test_demo_cli_runs_without_jax(tmp_path):
    out = tmp_path / "edit.jpg"
    stdout = run_without_jax(tmp_path, "michigan_tpu_torch.demo", "--stroke", "--out", str(out),
                             "--checkpoints_dir", str(tmp_path / "checkpoints"), *SMALL)
    assert "inference time" in stdout
    img = Image.open(out)
    assert img.size == (128, 128) and img.mode == "RGB"


def test_cal_orientation_cli_runs_without_jax(tmp_path):
    run_without_jax(
        tmp_path, "michigan_tpu_torch.cal_orientation",
        "--image_path", os.path.join(REPO, "datasets/FFHQ_single/val_images/67172.jpg"),
        "--hairmask_path", os.path.join(REPO, "datasets/FFHQ_single/val_labels/67172.png"),
        "--orientation_root", str(tmp_path / "orient"), "--gpu_ids", "-1")
    img = Image.open(tmp_path / "orient" / "67172.png")
    assert img.size == (512, 512) and img.mode == "L"
