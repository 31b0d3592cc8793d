"""Portable inference programs via ``torch.export`` (port of
michigan_tpu/serving/export.py).

``export_inference`` traces ``MichiGANModel.infer`` in ref mode into an
``ExportedProgram`` whose weights are call arguments, not constants: one
artifact serves every checkpoint of the same architecture, as the JAX
package's StableHLO artifact takes its variables.  Each spectral conv enters
as its frozen W / sigma (``ops.norms.spectral_weight``, the expression the
serving session freezes and an eval forward recomputes), which
``load_exported``'s callable computes from the state_dicts once per call
before the program runs.  The program records the port's CUDA kernels as
``torch.ops.michigan_tpu_torch.*`` calls, so loading it needs torch and
their registration (``michigan_tpu_torch.ops.cuda``), not the model code.

Shapes, dtypes and the device are those of the example batch (serve other
batch sizes with one artifact per bucket, or with the in-process session).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import torch

from michigan_tpu_torch.ops.norms import spectral_weight

# the artifact's record of which state_dict entries are spectral convs:
# {net: {module prefix: transposed}}
SPECTRAL_FILE = "spectral_convs.json"
_SPECTRAL_KEYS = ("weight_orig", "weight_u", "weight_v")


class _Infer(torch.nn.Module):
    """The nets under one root, so that one name space ("netG.head_0...")
    reaches every tensor ``infer`` reads."""

    def __init__(self, model):
        super().__init__()
        self.nets = torch.nn.ModuleDict(model.nets())
        self._model = (model,)  # not a submodule

    def forward(self, batch):
        return self._model[0].infer(batch, inpaint_mode="ref")


class _Program(torch.nn.Module):
    """forward(weights, batch): ``infer`` with every tensor it reads taken
    from `weights` ({"nets.<net>.<name>": tensor}); it owns no parameters."""

    def __init__(self, model):
        super().__init__()
        self._infer = (_Infer(model),)

    def forward(self, weights: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        return torch.func.functional_call(self._infer[0], weights, (batch,))


def program_weights(state_dicts: Mapping[str, Mapping[str, torch.Tensor]], spectral,
                    device) -> Dict[str, torch.Tensor]:
    """The program's weights from per-net state_dicts: each spectral conv's
    weight_orig, weight_u and weight_v become its frozen weight_frozen."""
    out = {}
    for net, sd in state_dicts.items():
        convs = spectral.get(net, {})
        for key, t in sd.items():
            prefix, _, leaf = key.rpartition(".")
            prefix = prefix + "." if prefix else ""
            if leaf in _SPECTRAL_KEYS and prefix in convs:
                if leaf == "weight_orig":
                    out[f"nets.{net}.{prefix}weight_frozen"] = spectral_weight(
                        t.to(device), sd[prefix + "weight_u"].to(device),
                        sd[prefix + "weight_v"].to(device), convs[prefix])
            else:
                out[f"nets.{net}.{key}"] = t.to(device)
    return dict(sorted(out.items()))  # the exported input spec's order


def spectral_convs(model) -> Dict[str, Dict[str, bool]]:
    """{net: {module prefix: transposed}} of the model's spectral convs."""
    from michigan_tpu_torch.models.layers import SpectralConv2d

    return {net: {(name + "." if name else ""): m.transposed
                  for name, m in module.named_modules() if isinstance(m, SpectralConv2d)}
            for net, module in model.nets().items()}


def export_inference(model, example_batch: Mapping[str, torch.Tensor], path: str):
    """Export ``model.infer(batch, "ref")`` at the example batch's shapes
    (NCHW tensors on the model's device, as ``infer`` takes them) to `path`,
    written atomically.  Returns the ``ExportedProgram``."""
    if model.opt.use_vae:
        raise NotImplementedError("export of --use_vae: its eps is drawn on the host")
    spectral = spectral_convs(model)
    with torch.no_grad():
        weights = program_weights({k: net.state_dict() for k, net in model.nets().items()},
                                  spectral, model.device)
        batch = dict(example_batch)
        exported = torch.export.export(_Program(model), (weights, batch))
    tmp = path + ".tmp.pt2"  # torch.export.save expects the .pt2 suffix
    torch.export.save(exported, tmp, extra_files={SPECTRAL_FILE: json.dumps(spectral)})
    os.replace(tmp, path)
    return exported


def load_exported(path: str):
    """Load an ``export_inference`` artifact.  Returns ``fn(state_dicts,
    batch) -> (image, orient_rgb)``: `state_dicts` {net: state_dict} of the
    exported architecture (moved to the batch's device), `batch` NCHW
    tensors of the exported shapes."""
    import michigan_tpu_torch.ops.cuda  # noqa: F401  (registers the kernels' ops)

    extra = {SPECTRAL_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    spectral = json.loads(extra[SPECTRAL_FILE])
    program = exported.module()

    def fn(state_dicts, batch):
        device = next(iter(batch.values())).device
        with torch.no_grad():
            return program(program_weights(state_dicts, spectral, device), dict(batch))

    return fn
