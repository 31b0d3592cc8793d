"""Single-image inference CLI of the port (counterpart of inference.py).

    python -m michigan_tpu_torch.inference --name MichiGAN --gpu_ids 0 \
        --inference_ref_name 67172 --inference_tag_name 67172 \
        --inference_orient_name 67172 --netG spadeb --use_encoder \
        --noise_background --use_ig --expand_mask_be --expand_th 5 \
        --add_feat_zeros --data_dir ./datasets/FFHQ_single --which_epoch 50

Same flags as the JAX CLI (the port's config.test_options).  The device
comes from --gpu_ids: -1 is the CPU, N is cuda:N (an error when CUDA is
absent).  The released .pth files under checkpoints/<name>/ are loaded when
present; otherwise the nets get seeded weights by --init_type from --seed.
Writes ./inference_samples/inpaint_fake_image.jpg (fake_image.jpg without
--use_ig).
"""

from __future__ import annotations

import argparse
import os

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
    """Load checkpoints/<name>/<which_epoch>_net_G.pth, the IG's
    InpaintingModel_gen.pth ['generator'] (--use_ig) and the SIG's
    SInpaintingModel_gen.pth ['generator'] (--use_stroke) when present; True
    if netG came from a file."""
    from michigan_tpu_torch.convert import load_reference_state

    base = os.path.join(opt.checkpoints_dir, opt.name)
    paths = {"netG": (os.path.join(base, f"{opt.which_epoch}_net_G.pth"), None)}
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


def parse_options(argv=None):
    """The CLI's flags (sys.argv[1:] when `argv` is None) -> Options, by
    config.test_options; --batch_inference is not ported."""
    from michigan_tpu_torch.config import test_options

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--batch_inference", action="store_true")
    pre_args, rest = pre.parse_known_args(argv)
    if pre_args.batch_inference:
        raise NotImplementedError("--batch_inference is not ported yet")
    return test_options(rest)


def main(argv=None):
    from michigan_tpu_torch.data.single import single_inference_data
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.utils.imaging import save_image, tensor2im

    opt = parse_options(argv)
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
