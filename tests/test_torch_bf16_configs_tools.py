"""Inference, serving, diagnostics, the visualizer and the trainer CLI of the
VAE, blender and unpaired configs under --dtype bfloat16, on the CPU
(tests/test_torch_bf16_configs.py's companions, a file of their own so that
they run in another worker):

- bf16 ``infer`` of vae, blender and only_blend against the JAX package's
  bf16 ``infer`` from the same float32 numpy weights at torch's default
  init (outputs that are not flat), at most CAL x the distance of JAX's
  bf16 image from the port's float32 one (which tests/test_torch_vae_blender.py
  holds to JAX's float32 infer); the bf16 blender through the serving
  session and the exported program, against eager infer bit for bit;
- ``training/diagnostics.diagnostics`` against the JAX package's
  ``make_diag_fn`` on the same weights after a step of the unpaired config
  (netG, netD, netD2), within rtol 1e-5;
- ``utils/visualizer.Visualizer`` against the JAX package's on the same
  losses and images: loss_log.txt, scalars.jsonl, the gallery's PNGs and
  index.html the same, tensor2label equal to JAX's; --tf_log writes
  TensorBoard events, and raises naming the flag without tensorboard;
- the trainer CLI with jax unimportable: --unpairTrain --same_netD_model
  --use_vae --use_blender --dtype bfloat16 --stats_freq 1 for two epochs,
  a resume for a third, then the bf16 inference CLI on its checkpoints.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.training.convert import (
    convert_discriminator,
    convert_generator,
    convert_vae_encoder,
)
from michigan_tpu.training.diagnostics import make_diag_fn
from michigan_tpu.utils import imaging as j_imaging
from michigan_tpu.utils.visualizer import Visualizer as JVisualizer
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.serving import InferenceSession
from michigan_tpu_torch.serving.export import export_inference, load_exported
from michigan_tpu_torch.training.diagnostics import diagnostics
from michigan_tpu_torch.training.state import init_netd2_from_netd
from michigan_tpu_torch.training.train_step import TrainStep
from michigan_tpu_torch.utils import imaging
from michigan_tpu_torch.utils.visualizer import Visualizer
from tests.test_torch_bf16_configs import (  # noqa: F401  (fixture)
    CAL,
    blob_batch,
    config_opt,
    flax_blender,
    one_torch_thread,
    snapshot,
)
from tests.test_torch_training import EXTRA, REPO, tiny_opt
from tests.test_torch_unpair import CLI_FLAGS, run_cli

INFER = {"vae": dict(use_vae=True), "blender": dict(use_blender=True),
         "only_blend": dict(use_blender=True, only_blend=True)}


def infer_opt(kw, **more):
    return config_opt(kw, isTrain=False, use_ig=False, init_type="none", **more)


def seeded_model(opt, seed=0):
    m = MichiGANModel(opt, "cpu")
    m.init_weights(seed)
    return m


@pytest.mark.parametrize("name", list(INFER))
def test_bf16_inference_matches_jax_infer(name):
    opt32, opt16 = infer_opt(INFER[name]), infer_opt(INFER[name], dtype="bfloat16")
    sd = snapshot(seeded_model(opt32))
    batch = blob_batch(opt16, seed=3, paired=False)
    rng = jax.random.PRNGKey(0)
    eps = torch.from_numpy(np.asarray(jax.random.normal(rng, (opt16.batchSize, 256))))
    jm = JModel(opt16)
    want, _ = jax.jit(lambda v, b: jm.infer(v, b, rng=rng))(
        jax_variables_infer(sd, opt16), {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(want, np.float32)
    got = {}
    for label, opt in (("bfloat16", opt16), ("float32", opt32)):
        m = MichiGANModel(opt, "cpu")
        m.load_state_dicts(sd)
        out, _ = m.infer(batch_from_numpy(batch, "cpu"), eps=eps)
        got[label] = out.permute(0, 2, 3, 1).numpy()
    assert got["bfloat16"].shape == want.shape and np.isfinite(got["bfloat16"]).all()
    gap = np.abs(got["bfloat16"] - want).max()
    policy = np.abs(want - got["float32"]).max()
    print(f"{name}: port-bf16 vs JAX-bf16 {gap:.3e}, JAX-bf16 vs fp32 {policy:.3e}; image std "
          f"{want.std():.3f}")
    assert want.std() > 0.05 and policy > 0
    assert gap <= CAL * policy


def jax_variables_infer(sd, opt):
    """jax_variables of the nets an inference model holds."""
    out = {"netG": convert_generator(sd["netG"], opt)}
    if "netE" in sd:
        out["netE"] = convert_vae_encoder(sd["netE"], opt)
    if "netB" in sd:
        out["netB"] = flax_blender(sd["netB"])
    return out


def test_bf16_blender_serves_through_the_session_and_the_exported_program(tmp_path):
    """The session (each bucket eager on the CPU) and the exported program
    take the bf16 blender config as its eager infer does, bit for bit."""
    opt = infer_opt(INFER["blender"], dtype="bfloat16")
    model = seeded_model(opt)
    batch = blob_batch(opt, seed=3, paired=False)
    want, _ = model.infer(batch_from_numpy(batch, "cpu"))
    got, _ = InferenceSession(model, (64, 64), (1, 2)).infer(batch)
    assert np.array_equal(got, want.permute(0, 2, 3, 1).numpy())
    path = str(tmp_path / "blend16.pt2")
    tb = batch_from_numpy(batch, "cpu")
    export_inference(model, tb, path)
    out, _ = load_exported(path)({k: net.state_dict() for k, net in model.nets().items()}, tb)
    assert torch.equal(out, want)


def test_diagnostics_match_make_diag_fn():
    """After a G+D step of the unpaired config (netG's running statistics
    and u / v written), the port's diagnostics and the JAX package's, from
    the same weights: the same names and values within rtol 1e-5; the
    spectral u / v are read, not written."""
    opt = config_opt(dict(unpairTrain=True, curr_step=2, same_netD_model=True))
    m = MichiGANModel(opt, "cpu")
    m.init_weights(0)
    init_netd2_from_netd(m)
    tr = TrainStep(m)
    b = batch_from_numpy(blob_batch(opt, paired=False), "cpu")
    _, _, orient = tr.g_step(b, EXTRA)
    tr.d_step(b, EXTRA, orient)
    before = snapshot(m)
    got = diagnostics(m)
    assert all(torch.equal(v, before[n][k]) for n, sd in snapshot(m).items()
               for k, v in sd.items())
    variables = {"netG": convert_generator(before["netG"], opt),
                 **{k: convert_discriminator(before[k], opt) for k in ("netD", "netD2")}}
    want = {k: float(v) for k, v in make_diag_fn()(variables).items()}
    print(got)
    assert set(got) == set(want)
    for net in ("netG", "netD", "netD2"):
        assert f"pnorm_{net}" in got and f"sn_sigma_max_{net}" in got
    assert "bn_var_max_netG" in got and "bn_mean_absmax_netG" in got
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k


def visuals_of(rng, n_label):
    lab = rng.integers(0, n_label, (64, 64, 1)).astype(np.float32)
    return {"input_label": lab, "input_tag": lab[::-1].copy(),
            "synthesized_image": rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
            "image_tag": rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)}


def test_visualizer_writes_what_the_jax_visualizer_writes(tmp_path, rng):
    opt = tiny_opt(name="v")
    visuals = visuals_of(rng, opt.label_nc + 2)
    losses = {"GAN": np.float32(0.25), "KLD": np.float32(1.5)}
    stats = {"pnorm_netG": 3.0, "sn_sigma_max_netD": 1.25}
    dirs = {}
    for label, cls in (("port", Visualizer), ("jax", JVisualizer)):
        o = tiny_opt(name="v", checkpoints_dir=str(tmp_path / label))
        vis = cls(o)
        vis.print_current_errors(2, 6, losses, 0.5)
        vis.plot_current_errors(losses, 6)
        vis.plot_current_errors(stats, 6)
        vis.display_current_results(visuals, 1, 6)
        vis.display_current_results(visuals, 2, 12)
        dirs[label] = tmp_path / label / "v"
    read = lambda p: p.read_bytes()
    log = {k: (d / "loss_log.txt").read_text().splitlines()[1:] for k, d in dirs.items()}
    assert log["port"] == log["jax"] and log["port"][0].startswith("(epoch: 2, iters: 6,")
    assert read(dirs["port"] / "scalars.jsonl") == read(dirs["jax"] / "scalars.jsonl")
    assert json.loads((dirs["port"] / "scalars.jsonl").read_text().splitlines()[1]) == \
        {"step": 6, **stats}
    images = sorted(os.listdir(dirs["jax"] / "web" / "images"))
    assert images == sorted(os.listdir(dirs["port"] / "web" / "images")) and len(images) == 8
    for f in images + ["../index.html"]:
        assert read(dirs["port"] / "web" / "images" / f) == read(dirs["jax"] / "web" / "images" / f)
    for k, v in visuals.items():
        if v.shape[-1] == 1:
            for lab in (v, v[None]):
                np.testing.assert_array_equal(imaging.tensor2label(lab, opt.label_nc + 2),
                                              j_imaging.tensor2label(lab, opt.label_nc + 2))
        else:
            np.testing.assert_array_equal(imaging.tensor2im(v), j_imaging.tensor2im(v))


def test_tf_log_writes_events_and_names_the_flag_without_tensorboard(tmp_path, monkeypatch):
    opt = tiny_opt(name="tb", checkpoints_dir=str(tmp_path), tf_log=True)
    vis = Visualizer(opt)
    vis.plot_current_errors({"GAN": 0.5}, 1)
    assert any(f.startswith("events.") for f in os.listdir(tmp_path / "tb" / "logs"))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="--tf_log"):
        Visualizer(tiny_opt(name="tb2", checkpoints_dir=str(tmp_path), tf_log=True))


def test_trainer_cli_bf16_unpair_vae_blender_stats_trains_resumes_and_renders(tmp_path):
    """Two epochs (a stage-2 step, then a stage-1 step each), the
    diagnostics every step and the gallery at --display_freq into
    scalars.jsonl and web/; a resume for a third epoch; the bf16 inference
    CLI restores netG, netE and netB from the float32 checkpoints."""
    ck = tmp_path / "checkpoints"
    flags = [*CLI_FLAGS, "--dtype", "bfloat16", "--stats_freq", "1", "--display_freq", "3",
             "--checkpoints_dir", str(ck)]
    first = run_cli(tmp_path, "michigan_tpu_torch.train", *flags, "--niter", "2")
    steps = [line for line in first.splitlines() if line.startswith("(epoch: ")]
    assert len(steps) == 4 and first.strip().endswith("ok")
    assert "hairAvgLab" in steps[0] and "VGG" in steps[1]
    records = [json.loads(line) for line in (ck / "u" / "scalars.jsonl").read_text().splitlines()]
    diag = [r for r in records if "pnorm_netG" in r]
    assert len(diag) == 4
    assert {"sn_sigma_mean_netD2", "sn_sigma_max_netD", "bn_var_max_netG",
            "bn_mean_absmax_netG"} <= set(diag[0])
    assert all(np.isfinite(v) for r in diag for v in r.values())
    assert (ck / "u" / "web" / "index.html").exists()
    for x in ("G", "D", "E", "B", "D2"):
        sd = torch.load(ck / "u" / f"latest_net_{x}.pth", weights_only=True)
        assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point()), x
    second = run_cli(tmp_path, "michigan_tpu_torch.train", *flags, "--niter", "3",
                     "--continue_train")
    assert "resumed checkpoint 'latest'" in second
    assert second.count("(epoch: 3,") == 2 and "(epoch: 1," not in second

    data = os.path.join(REPO, "datasets", "FFHQ_single")
    out = run_cli(tmp_path, "michigan_tpu_torch.inference", "--gpu_ids", "-1", "--netG",
                  "spadeb", "--use_encoder", "--noise_background", "--use_ig", "--use_vae",
                  "--use_blender", "--ngf", "8", "--crop_size", "64", "--load_size", "64",
                  "--dtype", "bfloat16", "--data_dir", data, "--checkpoints_dir", str(ck),
                  "--name", "u", "--which_epoch", "latest")
    for net in ("netG", "netE", "netB"):
        assert f"loaded {net} from" in out, net
    from PIL import Image

    img = Image.open(tmp_path / "inference_samples" / "inpaint_fake_image.jpg")
    assert img.size == (64, 64)
