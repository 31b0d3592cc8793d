"""Single-image and batched inference CLI of the port (counterpart of
inference.py).

    python -m michigan_tpu_torch.inference --name MichiGAN --gpu_ids 0 \
        --inference_ref_name 67172 --inference_tag_name 67172 \
        --inference_orient_name 67172 --netG spadeb --use_encoder \
        --noise_background --use_ig --expand_mask_be --expand_th 5 \
        --add_feat_zeros --data_dir ./datasets/FFHQ_single --which_epoch 50 \
        [--dtype bfloat16] [--batch_inference --val_list_dir names.txt]

Same flags as the JAX CLI (the port's config.test_options).  The device
comes from --gpu_ids: -1 is the CPU, N is cuda:N (an error when CUDA is
absent).  --dtype bfloat16 runs the bf16 compute policy (model.py).  The
released .pth files under checkpoints/<name>/ are loaded when present;
otherwise the nets get seeded weights by --init_type from --seed.  With
--use_vae the generator's seed is z from netE (<which_epoch>_net_E.pth), its
noise drawn from a generator seeded by --seed; with --use_blender the image
written is netB's blend (<which_epoch>_net_B.pth) of the fake, or of the ref
image under --only_blend, into the tag image.  Writes
./inference_samples/inpaint_fake_image.jpg (fake_image.jpg without
--use_ig); with --batch_inference, --results_dir/<name>.jpg for the first
--how_many names of --val_list_dir, rendered in batches of --batchSize.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

import torch


def device_from_gpu_ids(gpu_ids: str) -> torch.device:
    ids = [int(s) for s in str(gpu_ids).split(",") if s.strip()]
    if not ids or ids[0] < 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids {gpu_ids} asks for CUDA, which is not available "
            "(use --gpu_ids -1 for the CPU)"
        )
    return torch.device(f"cuda:{ids[0]}")


def load_released(model, opt) -> bool:
    """Load checkpoints/<name>/<which_epoch>_net_G.pth (and _net_E.pth under
    --use_vae, _net_B.pth under --use_blender, _net_FE.pth under
    --use_instance_feat), the IG's
    InpaintingModel_gen.pth ['generator'] (--use_ig) and the SIG's
    SInpaintingModel_gen.pth ['generator'] (--use_stroke) when present; True
    if netG came from a file."""
    from michigan_tpu_torch.convert import load_reference_state

    base = os.path.join(opt.checkpoints_dir, opt.name)
    paths = {f"net{x}": (os.path.join(base, f"{opt.which_epoch}_net_{x}.pth"), None)
             for x, on in (("G", True), ("E", opt.use_vae), ("B", opt.use_blender),
                           ("FE", opt.use_instance_feat)) if on}
    if opt.use_ig:
        paths["netIG"] = (os.path.join(base, opt.ig_model_name), "generator")
    if opt.use_stroke:
        paths["netSIG"] = (os.path.join(base, opt.sig_model_name), "generator")
    loaded = {}
    for name, (path, key) in paths.items():
        if os.path.exists(path):
            state = torch.load(path, map_location="cpu", weights_only=True)
            if key is not None and key in state:
                state = state[key]
            load_reference_state(model.nets()[name], state)
            loaded[name] = path
            print(f"loaded {name} from {path}")
    model.to_device()
    return "netG" in loaded


def _batch_flag(argv=None):
    """(whether --batch_inference is given, the other flags)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--batch_inference", action="store_true")
    pre_args, rest = pre.parse_known_args(argv)
    return pre_args.batch_inference, rest


def parse_options(argv=None):
    """The CLI's flags (sys.argv[1:] when `argv` is None) -> Options, by
    config.test_options; --batch_inference is main's."""
    from michigan_tpu_torch.config import test_options

    return test_options(_batch_flag(argv)[1])


def batch_inference(opt, model) -> list:
    """Render the first --how_many names of --val_list_dir in batches of
    --batchSize into --results_dir/<name>.jpg, as the JAX CLI does: one
    seeded noise pyramid for every sample, each name's prep by
    single_inference_data, the add_feat_zeros frame cropped.  A short last
    batch runs at its own size (nothing is compiled per shape).  Returns the
    paths written."""
    from michigan_tpu_torch.data.noise import generate_noise
    from michigan_tpu_torch.data.single import single_inference_data
    from michigan_tpu_torch.model import batch_from_numpy
    from michigan_tpu_torch.utils.imaging import save_image, tensor2im

    if not os.path.isfile(opt.val_list_dir):
        raise FileNotFoundError(f"--val_list_dir {opt.val_list_dir}: no such list of names "
                                "(one image name per line)")
    with open(opt.val_list_dir) as f:
        names = [line.strip() for line in f if line.strip()][: opt.how_many]
    os.makedirs(opt.results_dir, exist_ok=True)
    noise = generate_noise(opt.crop_size, opt.crop_size, np.random.default_rng(opt.seed))[None]
    r = opt.add_th // 2 if opt.add_feat_zeros else 0
    written = []
    for i in range(0, len(names), opt.batchSize):
        chunk = names[i : i + opt.batchSize]
        samples = [single_inference_data(dataclasses.replace(
            opt, inference_ref_name=name, inference_tag_name=name,
            inference_orient_name=name), noise=noise) for name in chunk]
        batch = {k: np.concatenate([s[k] for s in samples]) for k, v in samples[0].items()
                 if isinstance(v, np.ndarray) and v.ndim == 4}
        out, _ = model.infer(batch_from_numpy(batch, model.device))
        out = out.permute(0, 2, 3, 1).cpu().numpy()
        for j, name in enumerate(chunk):
            img = out[j, r : r + opt.crop_size, r : r + opt.crop_size] if r else out[j]
            path = os.path.join(opt.results_dir, name + ".jpg")
            save_image(tensor2im(img), path)
            written.append(path)
        print(f"rendered {min(i + opt.batchSize, len(names))}/{len(names)}")
    return written


def main(argv=None):
    from michigan_tpu_torch.data.single import single_inference_data
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.utils.imaging import save_image, tensor2im

    batched, rest = _batch_flag(argv)
    opt = parse_options(rest)
    device = device_from_gpu_ids(opt.gpu_ids)
    if device.type == "cuda":
        # cuDNN's fp32 convolutions default to TF32; keep full fp32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = MichiGANModel(opt, device)
    model.init_weights(opt.seed)
    if not load_released(model, opt):
        print(f"no released generator under {opt.checkpoints_dir}/{opt.name}: "
              f"seeded random weights (--init_type {opt.init_type}, --seed {opt.seed})")
    if batched:
        batch_inference(opt, model)
        return

    data = single_inference_data(opt)
    generated, _ = model.infer(batch_from_numpy(data, device))
    generated = generated.permute(0, 2, 3, 1).cpu().numpy()
    print(f"process image... {data['path']}")

    if opt.add_feat_zeros:
        r = opt.add_th // 2
        generated = generated[:, r : r + opt.crop_size, r : r + opt.crop_size, :]
    if opt.remove_background:
        mask = data["label_tag"]
        generated = generated * mask + data["image_tag"] * (1 - mask)

    os.makedirs("./inference_samples", exist_ok=True)
    name = "inpaint_fake_image.jpg" if opt.use_ig else "fake_image.jpg"
    save_image(tensor2im(generated[0]), os.path.join("./inference_samples", name))
    print(f"saved ./inference_samples/{name}")


if __name__ == "__main__":
    main()
