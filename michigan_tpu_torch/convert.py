"""Weight bridge into the port's state_dicts (the inverse of
michigan_tpu/training/convert.py).

``state_dicts_from_flax(variables, opt)`` turns the JAX package's variable
trees for netG, netIG, netSIG, netD, netD2, netE, netB, netFE and VGG19
(params / spectral / batch_stats, numpy or jax arrays) into state_dicts with
the reference checkpoints' key names (torchvision's for VGG19; netFE has
no known reference keys and takes the port's module paths), which the
port's nets load with ``load_state_dict(strict=True)``:

  kernel (HWIO)                   -> weight (OIHW)
  kernel (in, out) of a Linear    -> weight (out, in)
  kernel of a transposed conv     -> weight (I, O, kh, kw), the equivalent
                                     conv's spatial pre-flip undone
  kernel + spectral u / v         -> weight_orig, weight_u, weight_v
  kernel + wn_g (weight norm)     -> weight_v, weight_g (O, 1, 1, 1)
  batch_stats running_mean / var  -> running_mean, running_var
                                     (+ num_batches_tracked = 0)
  norm_scale / norm_bias of a     -> <layer>.1.weight / .1.bias, the
  NonSpadeNorm's batch norm          BatchNorm2d(affine) beside its
                                     running statistics (.0.1 in netD)

``load_reference_state`` loads a released ``.pth`` state_dict, and
``inception_state_dict`` turns the JAX package's InceptionV3 params
({name: {kernel, bn_scale, bn_bias, bn_mean, bn_var}}, as its
``inception_v3.npz`` holds them) into torchvision's state_dict.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# IG / SIG module names -> reference nn.Sequential paths
IG_RENAMES = (
    (r"^encoder_(\d+)$", r"encoder.\1"),
    (r"^middle_(\d+)$", r"middle.\1"),
    (r"^decoder_(\d+)$", r"decoder.\1"),
    (r"^conv1$", "conv_block.1"),
    (r"^conv2$", "conv_block.5"),
)
# a rule whose pattern holds a "/" matches the module's whole path and
# names the module itself: the appearance encoders' norm layers
# fc/layer<i>/{conv,norm} -> fc.layer<i>.{0,1} (the background encoder's
# layer<i>/conv keeps its name)
G_RENAMES = ((r"^mlp_shared_0$", "mlp_shared.0"), (r"^fc/layer\d+/conv$", "0"),
             (r"^fc/layer\d+/norm$", "1"))
# netD: model0_conv -> model0.0, model<n>/conv -> model<n>.0.0 and
# model<n>/norm -> model<n>.0.1 (the norm layer's Sequential),
# model<last>_conv -> model<last>.0
D_RENAMES = ((r"^model(\d+)_conv$", r"model\1.0"), (r"^conv$", "0.0"), (r"^norm$", "0.1"))
VGG_RENAMES = ((r"^features_(\d+)$", r"features.\1"),)
# netE: layer<i>/conv -> layer<i>.0, as convert_vae_encoder names them;
# layer<i>/norm -> layer<i>.1
E_RENAMES = ((r"^conv$", "0"), (r"^norm$", "1"))
B_RENAMES = ((r"^model_middle_(\d+)$", r"model_middle.\1"),)
IG_TRANSPOSED = frozenset({("decoder_0",), ("decoder_3",)})
B_TRANSPOSED = frozenset({("model5_conv",), ("model6_conv",), ("model7_conv",)})
FE_TRANSPOSED = frozenset({(f"up{i}",) for i in range(4)})


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_prefix(path: Tuple[str, ...], renames) -> str:
    parts = []
    for k, p in enumerate(path):
        for pat, rep in renames:
            whole = "/" in pat
            if re.match(pat, "/".join(path[:k + 1]) if whole else p):
                p = rep if whole else re.sub(pat, rep, p)
                break
        parts.append(p)
    return "".join(p + "." for p in parts)


def module_state_dict(variables: Mapping, renames=G_RENAMES,
                      transposed=frozenset()) -> Dict[str, torch.Tensor]:
    """One Flax module's variables -> its torch state_dict.  `renames` maps
    Flax module names to torch paths; `transposed` holds the module paths
    of transposed convs (the empty path for a transposed conv at the root)."""
    spectral = {path: a for path, a in _leaves(variables.get("spectral", {}))}
    params = dict(_leaves(variables["params"]))
    sd: Dict[str, torch.Tensor] = {}
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    for path, a in params.items():
        mod, leaf = path[:-1], path[-1]
        pre = _torch_prefix(mod, renames)
        if leaf == "bias":
            sd[pre + "bias"] = t(a)
        elif leaf in ("norm_scale", "norm_bias"):
            norm = _torch_prefix(mod + ("norm",), renames)
            sd[norm + ("weight" if leaf == "norm_scale" else "bias")] = t(a)
        elif leaf == "wn_g":
            sd[pre + "weight_g"] = t(a).view(-1, 1, 1, 1)
        elif leaf == "kernel" and a.ndim == 2:  # a Linear's (in, out)
            sd[pre + "weight"] = t(a.T)
        elif leaf == "kernel":
            if mod in transposed:  # K[h,w,i,o] = W[i,o,k-1-h,k-1-w]
                w = np.transpose(a[::-1, ::-1], (2, 3, 0, 1))
            else:  # HWIO -> OIHW
                w = np.transpose(a, (3, 2, 0, 1))
            if mod + ("u",) in spectral:
                sd[pre + "weight_orig"] = t(w)
                sd[pre + "weight_u"] = t(spectral[mod + ("u",)])
                sd[pre + "weight_v"] = t(spectral[mod + ("v",)])
            elif mod + ("wn_g",) in params:
                sd[pre + "weight_v"] = t(w)
            else:
                sd[pre + "weight"] = t(w)
        else:
            raise KeyError(f"no torch counterpart for param {'/'.join(path)}")
    for path, a in _leaves(variables.get("batch_stats", {})):
        pre = _torch_prefix(path[:-1], renames)
        sd[pre + path[-1]] = t(a)
        sd[pre + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def state_dicts_from_flax(variables: Mapping, opt) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'netG': tree, 'netIG': tree, ...} -> {'netG': state_dict, ...};
    netIG with --use_ig, netSIG with --use_stroke (the same network and key
    names as netIG, with 5 input channels), netD, netD2, netE, netB, netFE
    and vgg when present."""
    out = {}
    if "netG" in variables:
        out["netG"] = module_state_dict(variables["netG"], G_RENAMES)
    if opt.use_ig and "netIG" in variables:
        out["netIG"] = module_state_dict(variables["netIG"], IG_RENAMES, IG_TRANSPOSED)
    if opt.use_stroke and "netSIG" in variables:
        out["netSIG"] = module_state_dict(variables["netSIG"], IG_RENAMES, IG_TRANSPOSED)
    for name in ("netD", "netD2"):
        if name in variables:
            out[name] = module_state_dict(variables[name], D_RENAMES)
    if "netE" in variables:
        out["netE"] = module_state_dict(variables["netE"], E_RENAMES)
    if "netB" in variables:
        out["netB"] = module_state_dict(variables["netB"], B_RENAMES, B_TRANSPOSED)
    if "netFE" in variables:
        out["netFE"] = module_state_dict(variables["netFE"], (), FE_TRANSPOSED)
    if "vgg" in variables:
        out["vgg"] = module_state_dict(variables["vgg"], VGG_RENAMES)
    return out


# keys of the released checkpoints that the port never runs
# (BackgroundEncode2.layer4 is built but never applied, encoder.py:284)
_UNUSED_PREFIXES = ("backgroud_enc.layer4.",)


def load_reference_state(net: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Load a released state_dict: strip DataParallel's 'module.', drop the
    keys the port never runs, and give convs the reference built without a
    bias (bias=not use_spectral_norm) a zero bias, as the JAX package's init
    does; any other missing or unexpected key raises."""
    state = {re.sub(r"^module\.", "", k): v for k, v in state.items()}
    state = {k: v for k, v in state.items() if not k.startswith(_UNUSED_PREFIXES)}
    own = net.state_dict()
    unexpected = sorted(set(state) - set(own))
    missing = sorted(set(own) - set(state))
    bad = [k for k in missing if not k.endswith((".bias", ".num_batches_tracked"))]
    if unexpected or bad:
        raise KeyError(f"checkpoint mismatch: unexpected {unexpected}, missing {bad}")
    for k in missing:
        state[k] = torch.zeros_like(own[k])
    net.load_state_dict(state, strict=True)


def inception_state_dict(params: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3 params -> the state_dict of
    ``models.inception.InceptionV3`` (torchvision's key names): HWIO kernels
    to OIHW conv weights, bn_scale / bn_bias / bn_mean / bn_var to the batch
    norm's weight, bias and running statistics."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        sd[f"{name}.conv.weight"] = t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        for leaf, key in (("bn_scale", "weight"), ("bn_bias", "bias"),
                          ("bn_mean", "running_mean"), ("bn_var", "running_var")):
            sd[f"{name}.bn.{key}"] = t(p[leaf])
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
