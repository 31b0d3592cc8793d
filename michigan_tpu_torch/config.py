"""Typed configuration of the port: its own copy of the JAX package's
``michigan_tpu/config.py``, so that the port imports nothing of that package.

The reference drives everything off a dynamically-assembled argparse namespace
(`options/base_options.py:16-242`, `train_options.py`, `test_options.py`,
`demo_options.py` of tzt101/MichiGAN).  The exact public flag names are kept
so the reference CLI commands keep working, backed by one explicit dataclass
instead of reflection-injected parsers.  The fields, their defaults and the
three parsers equal the JAX package's (``tests/test_torch_config.py`` holds
them field by field); flags that only the JAX package reads (mesh, relay,
XLA and Pallas options) parse here too and are ignored, except those the
port's CLIs refuse by name.

Derived values (`semantic_nc`, latent grid size) are computed in
``finalize()`` which mirrors `base_options.py:212-242`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Options:
    # ---- experiment specifics (base_options.py:22-32) ----
    name: str = "MichiGAN"
    gpu_ids: str = "0"                   # -1: the CPU; N: cuda:N; N,M,...: a process each
    checkpoints_dir: str = "./checkpoints"
    model: str = "pix2pix"
    norm_G: str = "spectralspadesyncbatch3x3"  # resolved default for netG=spadeb
    norm_D: str = "spectralinstance"
    norm_E: str = "spectralinstance"
    phase: str = "train"
    weight_norm_G: bool = False
    weight_norm_g: int = 0

    # ---- input/output sizes (base_options.py:34-45) ----
    batchSize: int = 32
    preprocess_mode: str = "scale_width_and_crop"
    load_size: int = 512
    crop_size: int = 512
    aspect_ratio: float = 1.0
    label_nc: int = 2
    contain_dontcare_label: bool = False
    output_nc: int = 3
    orient_nc: int = 2
    add_noise_to_image: bool = False
    use_original_image: bool = False

    # ---- inputs (base_options.py:48-62) ----
    data_dir: str = "./datasets/FFHQ_single"
    dataroot: str = "./datasets/cityscapes/"
    dataset_mode: str = "custom"
    serial_batches: bool = False
    no_flip: bool = False
    nThreads: int = 8
    max_dataset_size: int = sys.maxsize
    load_from_opt_file: bool = False
    # the loader's <dir>/files.list (data/dataset.py list_images)
    cache_filelist_write: bool = False
    cache_filelist_read: bool = False
    # the loader's RAM cache of decoded (and, where --preprocess_mode
    # scales, pre-scaled) source images, in MB; 0 disables it
    # (data/dataset.py _DecodeCache).  Sized to the working set, epochs
    # after the first decode nothing.  ~1 MB per 568² RGB image
    decode_cache_mb: int = 0
    color_jitter: bool = False
    orient_random_disturb: bool = False
    hair_random_disturb: bool = False
    display_winsize: int = 512

    # ---- generator (base_options.py:67-86) ----
    netG: str = "spadeb"
    ngf: int = 64
    init_type: str = "xavier"
    init_variance: float = 0.02
    z_dim: int = 256
    netIG: str = "inpaint"
    use_ig: bool = False
    ig_model_name: str = "InpaintingModel_gen.pth"
    norm_model: str = "instance"
    fix_netG: bool = False
    num_upsampling_layers: str = "more"   # normal | more | most
    ms_step: int = 0
    batch_sizes: str = "32,32,32,16,8"
    alpha_value: float = -1.0
    show_feat_maps: bool = False

    # ---- feature encoder (base_options.py:88-96) ----
    use_instance_feat: bool = False
    feat_num: int = 3
    feat_input_nc: int = 3
    use_encoder: bool = False
    Image_encoder_mode: str = "partialconv"  # norm | instance | partialconv
    norm_ref_encode: str = "instance"
    ref_global_pool: bool = False

    # ---- blender (base_options.py:99-101) ----
    use_blender: bool = False
    netB: str = "blend2"
    only_blend: bool = False

    # ---- instance / vae (base_options.py:104-106) ----
    no_instance: bool = True
    nef: int = 16
    use_vae: bool = False

    # ---- background (base_options.py:109-115) ----
    noise_background: bool = False
    random_expand_mask: bool = False
    random_expand_th: float = 0.05
    bf_direct_add: bool = False
    random_noise_background: bool = False
    no_orientation: bool = False

    # ---- stroke inpainting (base_options.py:118-123) ----
    use_stroke: bool = False
    inpaint_mode: str = "ref"            # ref | stroke
    netSIG: str = "sinpaint"
    sig_model_name: str = "SInpaintingModel_gen.pth"

    # ---- zero padding / clipping (base_options.py:126-131) ----
    add_zeros: bool = False
    add_feat_zeros: bool = False
    add_th: int = 64
    clip_th: float = 300.0
    use_clip: bool = False

    # ---- train options (train_options.py) ----
    isTrain: bool = True
    display_freq: int = 100
    print_freq: int = 100
    save_latest_freq: int = 5000
    save_epoch_freq: int = 1
    # images-cadence for the on-device diagnostics stream (param norms,
    # spectral sigma, BN running-stat extremes -> scalars.jsonl); 0 = off
    stats_freq: int = 0
    no_html: bool = False
    debug: bool = False
    tf_log: bool = False
    continue_train: bool = False
    which_epoch: str = "latest"
    niter: int = 50
    niter_decay: int = 0
    optimizer: str = "adam"
    beta1: float = 0.5
    beta2: float = 0.999
    lr: float = 0.0002
    D_steps_per_G: int = 1
    G_steps_per_D: int = 1
    smooth: bool = False
    epoch_each_step: int = 10
    unpairTrain: bool = False
    curr_step: int = 1
    same_netD_model: bool = False
    lambda_hairavglab: float = 1.0
    ndf: int = 64
    lambda_feat: float = 1.0
    lambda_vgg: float = 1.0
    lambda_orient: float = 10.0
    lambda_confidence: float = 100.0
    lambda_content: float = 1.0
    lambda_style: float = 1.0
    lambda_background: float = 1.0
    lambda_rgb: float = 1.0
    lambda_lab: float = 1.0
    no_gan_loss: bool = False
    no_ganFeat_loss: bool = False
    no_vgg_loss: bool = False
    no_background_loss: bool = False
    no_rgb_loss: bool = False
    no_lab_loss: bool = False
    gan_mode: str = "hinge"
    netD: str = "multiscale"
    no_TTUR: bool = False
    lambda_kld: float = 0.05
    no_orient_loss: bool = False
    no_confidence_loss: bool = False
    no_content_loss: bool = False
    no_style_loss: bool = False
    remove_background: bool = False
    orient_filter: str = "gabor"         # gabor | dog
    wide_edge: float = 1.0
    no_discriminator: bool = False
    balance_Lab: bool = False
    weight_dir: str = "./data/ab_count.npy"
    Lab_weight_th: float = 10.0

    # ---- discriminator sub-arch (discriminator.py:16-28,70) ----
    netD_subarch: str = "n_layer"
    num_D: int = 2
    n_layers_D: int = 4

    # ---- test options (test_options.py) ----
    results_dir: str = "./results/"
    how_many: int = 5000
    source_dir: str = ""
    source_file: str = "comparison"
    four_image_show: bool = False
    which_settings: str = "spadeb512"
    which_random: str = "orient"
    input_relation: str = "ref=tag!=ori"
    val_list_dir: str = "data/val_image_list.txt"
    inference_ref_name: str = "67172"
    inference_tag_name: str = "67172"
    inference_orient_name: str = "67172"
    subset: str = "val"
    expand_tag_mask: bool = False
    expand_th: int = 11
    expand_mask_be: bool = False

    # ---- demo options (demo_options.py) ----
    demo_data_dir: str = "./datasets/FFHQ_demo/"

    # ---- dataset dirs (custom_dataset.py) ----
    label_dir: str = ""
    image_dir: str = ""
    orient_dir: str = ""
    instance_dir: str = ""
    clear: bool = False
    no_pairing_check: bool = False

    # ---- the JAX package's extensions (no reference analog) ----
    # Same names and defaults as michigan_tpu/config.py.  The port reads
    # dtype (float32, or bfloat16: the bf16 compute policy, for inference
    # and training), orient_bank_fp32 (the orientation loss's bank in
    # float32 under bfloat16), seed, use_pallas_epilogue (the resblocks'
    # fused conv3x3_in_act kernel),
    # reuse_orient_for_d, reuse_fake_for_d (the D step on the G step's fake,
    # not with --use_blender), max_steps, debug_nans and profile_dir (the
    # trainer's finite-loss check and one profiled step), mesh_shape (data:-1
    # or data:N replicas, space:N ranks in row bands; the data x space grid
    # and any other axis raise) and bf16_grad_allreduce (the
    # data-parallel gradient mean in bfloat16), remat and remat_blocks
    # (activation checkpointing of netG's SPADE blocks and the VGG tower),
    # accepts multihost (torchrun's environment spans hosts), and refuses
    # fused_step (check_supported in model.py); the rest configure the JAX
    # package's jit, relay and device-side input pipeline (device_prefetch,
    # compact_transfer, device_noise, device_orient_rgb, donate_buffers,
    # rss_restart_gb, ...) and are parsed and ignored here.  The host
    # pipeline's decode_cache_mb and cache_filelist_* (above) are read.
    dtype: str = "float32"
    mesh_shape: str = "data:-1"
    seed: int = 0
    debug_nans: bool = False
    profile_dir: str = ""
    bench_iters: int = 20
    use_pallas: bool = False
    use_pallas_epilogue: bool = False
    orient_bank_fp32: bool = False
    donate_buffers: bool = True
    remat: bool = False
    remat_blocks: str = "all"
    multihost: bool = False
    reuse_fake_for_d: bool = False
    reuse_orient_for_d: bool = True
    bf16_grad_allreduce: bool = False
    fused_step: bool = False
    device_prefetch: int = 1
    compact_transfer: bool = True
    device_noise: bool = False
    device_orient_rgb: bool = False
    rss_restart_gb: float = 0.0
    max_steps: int = 0

    # ---- derived (finalize) ----
    semantic_nc: int = 2
    num_gpus: int = 1

    def finalize(self) -> "Options":
        """Derived values; mirrors reference base_options.py:212-242."""
        self.semantic_nc = (
            self.label_nc
            + (1 if self.contain_dontcare_label else 0)
            + (0 if self.no_instance else 1)
        )
        ids = [int(s) for s in str(self.gpu_ids).split(",") if s not in ("", "-1")]
        self.num_gpus = max(len(ids), 1)
        return self

    # latent grid size; mirrors generator.py:79-96
    def latent_size(self) -> tuple:
        ups = {"normal": 5, "more": 6, "most": 7}[self.num_upsampling_layers]
        if self.add_feat_zeros:
            sw = (self.crop_size + self.add_th) // (2 ** ups)
        else:
            sw = self.crop_size // (2 ** ups)
        sh = round(sw / self.aspect_ratio)
        return sw, sh

    def generator_input_size(self) -> int:
        return self.crop_size + (self.add_th if self.add_feat_zeros else 0)

    def spade_label_nc(self) -> int:
        """Channels of the SPADE conditioning map the generator builds: the
        one-hot tag labels (with the don't-care class and, under
        --no_instance False, the instance edges) and the
        orientation.  The JAX package's convs take their input channels
        from this map; no path of it concatenates netFE's features."""
        return (self.label_nc + (1 if self.contain_dontcare_label else 0)
                + (0 if self.no_instance else 1)
                + (self.orient_nc if not self.no_orientation else 0))

    def d_input_nc(self) -> int:
        """Discriminator input channels (discriminator.py:102-108)."""
        nc = self.label_nc + self.output_nc + self.orient_nc
        if self.contain_dontcare_label:
            nc += 1
        if not self.no_instance:
            nc += 1
        return nc

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)

    @classmethod
    def load(cls, path: str) -> "Options":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known}).finalize()


_BOOL_TRUE_DEFAULTS = {"no_instance"}  # flags whose reference default is True


def _add_flags(parser: argparse.ArgumentParser, defaults: Options) -> None:
    """Register every Options field as a CLI flag with reference semantics:
    bools are `action=store_true` switches, everything else typed values."""
    for f in dataclasses.fields(Options):
        if f.name in ("isTrain", "semantic_nc", "num_gpus"):
            continue
        default = getattr(defaults, f.name)
        flag = "--" + f.name
        if isinstance(default, bool):
            if default:
                parser.add_argument(flag, type=lambda s: s.lower() not in ("0", "false"),
                                    nargs="?", const=True, default=default)
            else:
                parser.add_argument(flag, action="store_true", default=False)
        else:
            parser.add_argument(flag, type=type(default), default=default)


def _parse(defaults: Options, argv: Optional[List[str]] = None) -> Options:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False
    )
    _add_flags(parser, defaults)
    ns, _unknown = parser.parse_known_args(argv)
    opt = dataclasses.replace(defaults, **{k: v for k, v in vars(ns).items()})
    opt = opt.finalize()
    if opt.load_from_opt_file:
        # reference base_options.py:199-210: saved experiment options become
        # the defaults, then CLI flags re-apply on top
        path = os.path.join(opt.checkpoints_dir, opt.name, "opt.json")
        loaded = Options.load(path)
        loaded.isTrain = defaults.isTrain
        # re-apply only flags explicitly present on the command line
        explicit = _explicit_flags(argv)
        for k, v in vars(ns).items():
            if k in explicit:
                setattr(loaded, k, v)
        return loaded.finalize()
    return opt


def _explicit_flags(argv: Optional[List[str]]) -> set:
    args = argv if argv is not None else sys.argv[1:]
    out = set()
    for a in args:
        if a.startswith("--"):
            out.add(a[2:].split("=")[0])
    return out


def train_options(argv: Optional[List[str]] = None) -> Options:
    """Reference `TrainOptions().parse()` equivalent."""
    defaults = Options(isTrain=True)
    return _parse(defaults, argv)


def test_options(argv: Optional[List[str]] = None) -> Options:
    """Reference `TestOptions().parse()` equivalent (test_options.py:16-21)."""
    defaults = Options(
        isTrain=False, phase="test", serial_batches=True, no_flip=True,
        batchSize=1, which_epoch="50",
    )
    return _parse(defaults, argv)


def demo_options(argv: Optional[List[str]] = None) -> Options:
    """Reference `DemoOptions().parse()` equivalent (demo_options.py:12-31)."""
    defaults = Options(
        isTrain=False, phase="test", serial_batches=True, no_flip=True,
        batchSize=1, netG="spadeb", use_encoder=True, use_ig=True,
        use_stroke=True, noise_background=True, load_size=512, crop_size=512,
        name="MichiGAN", expand_mask_be=True, which_epoch="50",
        add_feat_zeros=True, expand_th=5,
    )
    return _parse(defaults, argv)

