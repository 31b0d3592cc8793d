"""VGG perceptual loss and the AdaIN-style style / content losses (port of
michigan_tpu/losses/perceptual.py, reference loss.py:178-207, 623-712), on
feature lists the caller computes once and shares; each reduction over
pixels goes through `red` (losses/reduce.py: the whole plane, or a band's
share of it)."""

from __future__ import annotations

import torch

from michigan_tpu_torch.losses.reduce import WHOLE
from michigan_tpu_torch.ops.resize import resize_nearest
from michigan_tpu_torch.ops.stats import masked_mean_std

VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_loss_from_features(fx, fy, opt, label: torch.Tensor = None, red=WHOLE
                           ) -> torch.Tensor:
    """Weighted L1 over the 5 slices; fy is detached."""
    total = 0.0
    for w, a, b in zip(VGG_WEIGHTS, fx, fy):
        a, b = a.float(), b.detach().float()
        if opt.remove_background:
            lab = resize_nearest(label.detach(), a.shape[2:])
            term = (a * lab - b * lab).abs().sum() / (lab.sum() * a.shape[1] + 1e-5)
        else:
            term = red.mean((a - b).abs())
        total = total + w * term
    return total


def style_content_loss_from_features(f_fake, f_style, f_content, opt, style_label=None,
                                     content_label=None, red=WHOLE):
    """(content, style): content is the MSE on relu5_1 against f_content,
    style the MSE of per-channel means and stds over all 5 slices against
    f_style; masked by the hair with --remove_background.  f_style and
    f_content must carry no gradient.  The style term is computed from
    whole-plane statistics (``red.mean_std``), alike on every rank."""
    if opt.remove_background:
        cl, sl = content_label.detach(), style_label.detach()
        a, b = f_fake[-1].float(), f_content[-1].float()
        lab = resize_nearest(cl, a.shape[2:])
        loss_c = ((a * lab - b * lab) ** 2).sum() / (lab.sum() * a.shape[1] + 1e-5)
        loss_s = 0.0
        for fs, ff in zip(f_style, f_fake):
            sm, ss = masked_mean_std(fs, resize_nearest(sl, fs.shape[2:]))
            fm, fstd = masked_mean_std(ff, resize_nearest(cl, ff.shape[2:]))
            loss_s = loss_s + ((sm - fm) ** 2).mean() + ((ss - fstd) ** 2).mean()
        return loss_c, loss_s
    loss_c = red.mean((f_fake[-1].float() - f_content[-1].float()) ** 2)
    stats = red.mean_std(list(f_style) + list(f_fake))
    k = len(f_style)
    loss_s = 0.0
    for (sm, ss), (fm, fstd) in zip(stats[:k], stats[k:]):
        loss_s = loss_s + ((sm - fm) ** 2).mean() + ((ss - fstd) ** 2).mean()
    return loss_c, red.whole(loss_s)
