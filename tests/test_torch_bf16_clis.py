"""The bf16 compute policy's CLIs and batch inference (split from
tests/test_torch_bf16.py, whose helpers it uses, so that the two files run
in two workers):

- --batch_inference: 3 names at --batchSize 2 write the images the JAX
  CLI's batch_inference writes for the same weights (float32), within 2
  uint8 levels after JPEG decoding; a missing list raises;
- the CLIs run the bf16 path with jax unimportable, the trainer included
  (two steps, a save, a resume, and the saved generator feeding
  inference); --dtype bfloat16 with --isTrain builds a training model,
  while other dtypes and the unported training flags are refused.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import jax
import torch

from michigan_tpu import config
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu_torch import model as port_model
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from tests.test_torch_bf16 import (
    DATA_DIR,
    DEMO_DIR,
    FLAGS,
    REPO,
    SMALL,
    TRAIN_SMALL,
    as_bf16,
    flagship_opt,
    port_weights,
)

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
    training and inference, and so is bf16 with an unported flag.  (Since
    the VAE, blender and unpaired configs were ported under bf16, they
    build with it too; since --use_instance_feat was ported, the flag
    refused is --fused_step.)"""
    opt = config.train_options(["--dtype", "bfloat16"] + TRAIN_SMALL)
    model = MichiGANModel(opt, "cpu")
    assert model.compute_dtype == torch.bfloat16 and model.netD is not None
    assert model.vgg is not None and model.netG.training
    port_model.check_supported(as_bf16(flagship_opt()))  # inference takes it
    for o in (flagship_opt(), opt):
        with pytest.raises(NotImplementedError, match="float16"):
            port_model.check_supported(dataclasses.replace(o, dtype="float16"))
    with pytest.raises(NotImplementedError, match="fused_step"):
        MichiGANModel(dataclasses.replace(opt, fused_step=True), "cpu")
    # the VAE, blender and unpaired configs build under bf16
    for flag in ("use_vae", "use_blender", "unpairTrain"):
        m = MichiGANModel(dataclasses.replace(opt, **{flag: True}), "cpu")
        assert m.compute_dtype == torch.bfloat16
        assert getattr(m, {"use_vae": "netE", "use_blender": "netB",
                           "unpairTrain": "netD2"}[flag]) is not None


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
