"""Training diagnostics for long runs (port of
michigan_tpu/training/diagnostics.py).

``diagnostics(model)`` returns, for each of netG, netD and netD2 that the
model holds, a few scalars of its state, computed on its device under
no_grad and brought to the host in one transfer:

- ``pnorm_<net>``: the L2 norm of all its parameters, in float32;
- ``sn_sigma_mean_<net>``, ``sn_sigma_max_<net>``: sigma over its spectral
  convs, from one power iteration of the stored u with torch's (O,
  I*kh*kw) flatten (v = norm(W^T u), u = norm(W v), sigma = u . W v).  The
  stored u and v lag one optimizer step behind W, so u . W v from them
  can even be negative; the iteration reads them and never writes them;
- ``bn_mean_absmax_<net>``, ``bn_var_max_<net>``: the largest |running
  mean| and running variance over its batch norms.

The trainer logs them every --stats_freq samples.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import SpectralConv2d

NETS = ("netG", "netD", "netD2")


@torch.no_grad()
def diagnostics(model, nets=NETS) -> Dict[str, float]:
    names, values = [], []
    for name in nets:
        net = getattr(model, name, None)
        if net is None:
            continue
        params = list(net.parameters())
        if params:
            names.append(f"pnorm_{name}")
            values.append(torch.sqrt(sum(p.float().square().sum() for p in params)))
        sigmas = []
        for m in net.modules():
            if isinstance(m, SpectralConv2d):
                w = m.w_mat().float()
                v = F.normalize(torch.mv(w.t(), m.weight_u.float()), dim=0, eps=1e-12)
                u = F.normalize(torch.mv(w, v), dim=0, eps=1e-12)
                sigmas.append(torch.dot(u, torch.mv(w, v)))
        if sigmas:
            sig = torch.stack(sigmas)
            names += [f"sn_sigma_mean_{name}", f"sn_sigma_max_{name}"]
            values += [sig.mean(), sig.max()]
        buffers = dict(net.named_buffers())
        for key, stat, fn in (("running_mean", "bn_mean_absmax", lambda t: t.abs().max()),
                              ("running_var", "bn_var_max", lambda t: t.max())):
            stats = [b.float().flatten() for k, b in buffers.items() if k.endswith(key)]
            if stats:
                names.append(f"{stat}_{name}")
                values.append(fn(torch.cat(stats)))
    if not values:
        return {}
    return dict(zip(names, torch.stack(values).cpu().tolist()))
