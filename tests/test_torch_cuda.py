"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither jax nor the repository's test fixtures, so it runs where only torch
is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the fused norms float32 atol 1e-4, rtol 1e-5, bfloat16 atol
1e-2, rtol 1.6e-2 (about two bf16 ulps); conv3x3_in_act atol 1e-4, rtol
1e-4 (float32 sums of C*9 products in another order); the filter bank's
response rtol 1e-4, atol 1e-3, its argmax off on at most 0.1% of pixels and
then by one orientation (near-ties under another summation order);
conv3x3_same_lowch and filterbank_orientation_backward within 1e-4 of the
plain result's largest magnitude (float32 sums in another order); the 3xTF32
kernels against float64 at most 2x the error of their plain version in
float32, and the filter bank's argmax off float64's on at most 1e-4 of the
pixels more than the plain version's.
"""

import math

import pytest
import torch

from michigan_tpu_torch.ops import cuda as kernels
from michigan_tpu_torch.ops import filters
from michigan_tpu_torch.ops.cuda import epilogue as E
from michigan_tpu_torch.ops.cuda import lowch as L
from michigan_tpu_torch.ops.cuda import orient as O
from michigan_tpu_torch.ops.cuda import spade as K

pytestmark = pytest.mark.cuda

ACTS = [None, "relu", "lrelu"]
TOLS = {torch.float32: dict(atol=1e-4, rtol=1e-5),
        torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the plain versions' convolutions
    return torch.device("cuda")


def rand(gen, shape, device, dtype):
    return torch.randn(shape, generator=gen).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(9, 9), (16, 16), (5, 7)])  # scalar and four-wide paths
def test_kernels_match_plain(cuda_device, dtype, hw):
    gen = torch.Generator().manual_seed(0)
    shape = (2, 64) + hw
    x, g, b = (rand(gen, shape, cuda_device, dtype) for _ in range(3))
    mean = torch.randn(64, generator=gen).to(cuda_device)
    inv = torch.rand(64, generator=gen).add(0.5).to(cuda_device)
    kernels.reset_launch_counts()
    got = K.spade_modulate(x, mean, inv, g, b)
    torch.testing.assert_close(got.float(), K.spade_modulate_plain(x, mean, inv, g, b).float(),
                               **TOLS[dtype])
    for act in ACTS:
        for gb in ((None, None), (g, b)):
            got = K.fused_instance_norm(x, *gb, act=act)
            want = K.fused_instance_norm_plain(x, *gb, act=act)
            torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"spade_modulate": 1, "fused_instance_norm": 6,
                                       "conv3x3_in_act": 0, "filterbank_orientation": 0,
                                       "filterbank_orientation_backward": 0,
                                       "conv3x3_same_lowch": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(9, 9), (16, 16)])  # scalar and four-wide paths
def test_spade_modulate_reads_conv_halves_in_place(cuda_device, dtype, hw):
    """gamma and beta as SPADE passes them: the channel halves of one
    (N, 2C, H, W) conv output, whose samples lie 2C*H*W elements apart."""
    gen = torch.Generator().manual_seed(2)
    x = rand(gen, (3, 64) + hw, cuda_device, dtype)
    g, b = rand(gen, (3, 128) + hw, cuda_device, dtype).chunk(2, dim=1)
    mean = torch.randn(64, generator=gen).to(cuda_device)
    inv = torch.rand(64, generator=gen).add(0.5).to(cuda_device)
    got = K.spade_modulate(x, mean, inv, g, b)
    want = K.spade_modulate_plain(x, mean, inv, g.contiguous(), b.contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])


def test_instance_norm_is_stable_far_from_zero(cuda_device):
    """A large mean with a small spread: E[x^2] - mean^2 would cancel."""
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn((1, 8, 256, 256), generator=gen) * 1e-2 + 1e3).to(cuda_device)
    got = K.fused_instance_norm(x)
    want = K.fused_instance_norm_plain(x.double()).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros((1, 4, 8, 8), device=cuda_device)
    stats = torch.zeros(4, device=cuda_device)
    with pytest.raises(TypeError):
        K.fused_instance_norm(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_instance_norm(x.transpose(2, 3))
    with pytest.raises(ValueError, match="shape"):
        K.spade_modulate(x, stats, stats, x, x[:, :2].contiguous())
    with pytest.raises(ValueError, match="float32"):
        K.spade_modulate(x, stats.double(), stats, x, x)
    x2 = torch.zeros((2, 4, 8, 8), device=cuda_device)
    with pytest.raises(ValueError, match="within each sample"):
        K.spade_modulate(x2, stats, stats, x2.transpose(2, 3), x2)
    with pytest.raises(ValueError, match="sample strides"):
        K.spade_modulate(x2, stats, stats, torch.zeros((2, 8, 8, 8), device=cuda_device)[:, :4], x2)


# (n, c, co, h, w, dilation, act, residual): the path's shape, batch 2, a
# channel count that is not a multiple of the 64-channel tile, a plane whose
# size is not a multiple of 4 (no float4 stores) nor of the 4 x 32 patch;
# then input channels that are not a multiple of the 8-channel chunk (20;
# 3 and 7 also not of 4: the 4-byte weight copies), output channels 40 and
# 72 around the 64-channel block, W % 4 != 0 at dilation 2, more samples
EPILOGUE_CASES = [(1, 256, 256, 64, 64, 2, "relu", False), (1, 256, 256, 64, 64, 1, None, True),
                  (2, 128, 128, 16, 16, 1, "lrelu", True), (1, 20, 70, 9, 7, 2, "relu", True),
                  (1, 3, 5, 5, 5, 1, None, False), (2, 20, 40, 13, 30, 2, "lrelu", False),
                  (1, 64, 72, 37, 53, 1, "relu", True), (3, 7, 64, 4, 32, 2, None, True)]


@pytest.mark.parametrize("n,c,co,h,w,d,act,res", EPILOGUE_CASES)
def test_conv3x3_in_act_matches_plain(cuda_device, n, c, co, h, w, d, act, res):
    gen = torch.Generator().manual_seed(3)
    x = rand(gen, (n, c, h + 2 * d, w + 2 * d), cuda_device, torch.float32)
    wt = rand(gen, (co, c, 3, 3), cuda_device, torch.float32) * 0.05
    b = rand(gen, (co,), cuda_device, torch.float32)
    r = rand(gen, (n, co, h, w), cuda_device, torch.float32) if res else None
    kernels.reset_launch_counts()
    got = E.conv3x3_in_act(x, wt, b, dilation=d, act=act, residual=r)
    want = E.conv3x3_in_act_plain(x, wt, b, dilation=d, act=act, residual=r)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert kernels.launch_counts()["conv3x3_in_act"] == 1


# whole and ragged tiles, a plane smaller than one tile, and more tiles than
# one wave of the kernel's persistent blocks
@pytest.mark.parametrize("mode", ["gabor", "dog"])
@pytest.mark.parametrize("n,h,w", [(1, 512, 512), (2, 37, 53), (1, 8, 8), (300, 16, 16)])
def test_filterbank_matches_plain(cuda_device, mode, n, h, w):
    gen = torch.Generator().manual_seed(4)
    gray = (torch.rand((n, 1, h, w), generator=gen) * 255).to(cuda_device)
    bank = filters.bank(mode, cuda_device)
    idx, conf = O.filterbank_orientation(gray, bank)
    p_idx, p_conf = O.filterbank_orientation_plain(gray, bank)
    torch.cuda.synchronize()
    torch.testing.assert_close(conf, p_conf, rtol=1e-4, atol=1e-3)
    off = (idx - p_idx) % 32
    assert (off != 0).float().mean().item() <= 1e-3
    assert bool(((off == 0) | (off == 1) | (off == 31)).all())


@pytest.mark.parametrize("mode", ["gabor", "dog"])
def test_filterbank_is_as_accurate_as_cudnn_fp32(cuda_device, mode):
    """(2, 1, 512^2) strand planes: the kernel's 3xTF32 products against a
    float64 bank conv, beside the plain version in float32 (cuDNN, TF32
    off): at most 2x its largest response error, and at most 1e-4 of the
    pixels more whose argmax differs from float64's."""
    gray = strand_gray(torch.Generator().manual_seed(9), 2, 512, 512, cuda_device)
    bank = filters.bank(mode, cuda_device)
    res = torch.nn.functional.conv2d(gray.double(), bank.double().permute(3, 2, 0, 1), padding=8)
    conf64, idx64 = res.clamp_min(0.0).max(dim=1)
    (idx, conf), (p_idx, p_conf) = (O.filterbank_orientation(gray, bank),
                                    O.filterbank_orientation_plain(gray, bank))
    kernel, plain = ((c.double() - conf64).abs().max().item() for c in (conf, p_conf))
    assert kernel <= 2 * plain, (kernel, plain)
    k_mis, p_mis = ((i != idx64).float().mean().item() for i in (idx, p_idx))
    assert k_mis <= p_mis + 1e-4, (k_mis, p_mis)


def test_filterbank_ties_take_the_first_index(cuda_device):
    """An all-zero plane clamps every response to 0: idx 0, conf 0."""
    idx, conf = O.filterbank_orientation(torch.zeros((1, 1, 40, 40), device=cuda_device),
                                         filters.bank("dog", cuda_device))
    torch.cuda.synchronize()
    assert idx.dtype == torch.int32 and not idx.any() and not conf.any()


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    bank = filters.bank("dog", cuda_device)
    gray = torch.zeros((1, 1, 8, 8), device=cuda_device)
    with pytest.raises(TypeError):
        O.filterbank_orientation(gray.double(), bank)
    with pytest.raises(ValueError, match="N, 1, H, W"):
        O.filterbank_orientation(torch.zeros((1, 2, 8, 8), device=cuda_device), bank)
    with pytest.raises(ValueError, match="bank must be"):
        O.filterbank_orientation(gray, bank[:, :, :, :16])
    with pytest.raises(ValueError, match="contiguous"):
        O.filterbank_orientation(torch.zeros((1, 1, 8, 8), device=cuda_device).transpose(2, 3)
                                 [:, :, :, :4], bank)
    x = torch.zeros((1, 4, 10, 10), device=cuda_device)
    w = torch.zeros((4, 4, 3, 3), device=cuda_device)
    with pytest.raises(TypeError):
        E.conv3x3_in_act(x.double(), w.double(), None)
    with pytest.raises(ValueError, match="shape"):
        E.conv3x3_in_act(x, torch.zeros((4, 4, 5, 5), device=cuda_device), None)
    with pytest.raises(ValueError, match="shape"):
        E.conv3x3_in_act(x, w, torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        E.conv3x3_in_act(x.transpose(2, 3), w, None)
    with pytest.raises(ValueError, match="residual"):
        E.conv3x3_in_act(x, w, None, residual=torch.zeros((1, 4, 10, 10), device=cuda_device))
    with pytest.raises(ValueError, match="no output"):
        E.conv3x3_in_act(x, w, None, dilation=5)
    with pytest.raises(ValueError, match="dilation up to"):
        E.conv3x3_in_act(torch.zeros((1, 4, 20, 20), device=cuda_device), w, None, dilation=5)
    with pytest.raises(ValueError, match="w is on cpu"):
        E.conv3x3_in_act(x, w.cpu(), None)


def assert_rel(got, want, rel=1e-4):
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


# ragged patches; Co over one block; C = 20 (not a multiple of the 8-channel
# chunk), Co 40, H and W % 4 != 0; Co 72 over two blocks, three samples;
# C = 7 (4-byte weight copies), one whole patch
@pytest.mark.parametrize("n,c,co,h,w", [(2, 64, 64, 37, 53), (1, 64, 64, 64, 64),
                                        (1, 3, 70, 10, 11), (1, 20, 40, 33, 30),
                                        (3, 12, 72, 9, 66), (2, 7, 64, 4, 32)])
def test_conv3x3_same_lowch_matches_plain(cuda_device, n, c, co, h, w):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((n, c, h, w), generator=gen).relu().to(cuda_device)
    wt = (torch.randn((co, c, 3, 3), generator=gen) * math.sqrt(2 / (9 * c))).to(cuda_device)
    kernels.reset_launch_counts()
    got = L.conv3x3_same_lowch(x, wt)
    torch.cuda.synchronize()
    assert_rel(got, L.conv3x3_same_lowch_plain(x, wt))
    assert kernels.launch_counts()["conv3x3_same_lowch"] == 1


def rel_err(got, want64):
    """Largest error against a float64 result, in units of its largest magnitude."""
    return ((got.double() - want64).abs().max() / want64.abs().max()).item()


def test_conv3x3_same_lowch_is_as_accurate_as_cudnn_fp32(cuda_device):
    """Batch 2 of VGG19's features_2 shape: the kernel's 3xTF32 products
    against a float64 convolution, beside F.conv2d in float32 (TF32 off)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((2, 64, 512, 512), generator=gen, device=cuda_device).relu_()
    wt = torch.randn((64, 64, 3, 3), generator=gen, device=cuda_device) * math.sqrt(2 / 576)
    want = L.conv3x3_same_lowch_plain(x.double(), wt.double())
    kernel, cudnn = rel_err(L.conv3x3_same_lowch(x, wt), want), rel_err(
        L.conv3x3_same_lowch_plain(x, wt), want)
    assert kernel <= 2 * cudnn, (kernel, cudnn)


def test_conv3x3_in_act_is_as_accurate_as_cudnn_fp32(cuda_device):
    """Batch 2 of the inpainters' resblock shape, both dilations: the fused
    kernel against the float64 composition, beside the plain version (F.conv2d
    and the torch norm) in float32."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    for d, act, res in ((2, "relu", False), (1, None, True)):
        x = torch.randn((2, 256, 64 + 2 * d, 64 + 2 * d), generator=gen, device=cuda_device)
        wt = torch.randn((256, 256, 3, 3), generator=gen, device=cuda_device) * 0.02
        b = torch.randn(256, generator=gen, device=cuda_device)
        r = torch.randn((2, 256, 64, 64), generator=gen, device=cuda_device) if res else None
        want = E.conv3x3_in_act_plain(x.double(), wt.double(), b.double(), d, act,
                                      residual=None if r is None else r.double())
        kernel = rel_err(E.conv3x3_in_act(x, wt, b, d, act, residual=r), want)
        cudnn = rel_err(E.conv3x3_in_act_plain(x, wt, b, d, act, residual=r), want)
        assert kernel <= 2 * cudnn, (d, kernel, cudnn)


def strand_gray(gen, n, h, w, device):
    """Textured planes in [0, 255]: no exact ties among the clamped responses."""
    yy = torch.arange(h, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, dtype=torch.float32)[None, :] / w
    tex = 127 + 80 * torch.sin(2 * math.pi * 20 * (xx * 0.7 + yy * 0.4 + 0.3 * xx * yy))
    return (tex + 40 * torch.rand((n, 1, h, w), generator=gen)).to(device)


@pytest.mark.parametrize("mode", ["gabor", "dog"])
@pytest.mark.parametrize("n,h,w", [(2, 37, 53), (1, 128, 128)])  # ragged and whole tiles
def test_filterbank_backward_matches_plain_and_autograd(cuda_device, mode, n, h, w):
    gen = torch.Generator().manual_seed(6)
    gray = strand_gray(gen, n, h, w, cuda_device)
    bank = filters.bank(mode, cuda_device)
    dconf = torch.randn((n, h, w), generator=gen).to(cuda_device)
    kernels.reset_launch_counts()
    g = gray.clone().requires_grad_()
    idx, conf = O.OrientationResponse.apply(g, bank)
    conf.backward(dconf)
    want = O.filterbank_orientation_backward_plain(dconf, idx, conf, bank)
    g2 = gray.clone().requires_grad_()
    (auto,) = torch.autograd.grad(O.filterbank_orientation_plain(g2, bank)[1], g2, dconf)
    torch.cuda.synchronize()
    assert_rel(g.grad, want)
    assert_rel(auto, want)
    assert kernels.launch_counts()["filterbank_orientation"] == 1
    assert kernels.launch_counts()["filterbank_orientation_backward"] == 1


def test_training_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros((1, 4, 8, 8), device=cuda_device)
    w = torch.zeros((4, 4, 3, 3), device=cuda_device)
    with pytest.raises(TypeError):
        L.conv3x3_same_lowch(x.double(), w.double())
    with pytest.raises(ValueError, match="must be"):
        L.conv3x3_same_lowch(x, torch.zeros((4, 3, 3, 3), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        L.conv3x3_same_lowch(x.transpose(2, 3), w)
    with pytest.raises(ValueError, match="w is on cpu"):
        L.conv3x3_same_lowch(x, w.cpu())
    bank = filters.bank("dog", cuda_device)
    d = torch.zeros((1, 8, 8), device=cuda_device)
    idx = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="idx"):
        O.filterbank_orientation_backward(d, idx.long(), d, bank)
    with pytest.raises(ValueError, match="conf is"):
        O.filterbank_orientation_backward(d, idx, torch.zeros((1, 8, 9), device=cuda_device),
                                          bank)
    with pytest.raises(ValueError, match="bank must be"):
        O.filterbank_orientation_backward(d, idx, d, bank[:, :, :, :16])


@pytest.mark.parametrize("mode", ["gabor", "dog"])
def test_filterbank_backward_on_a_masked_gradient(cuda_device, mode):
    """dconf inside an ellipse only, as the training loss passes it back
    (it multiplies by the hair): the ellipse's edge cuts through the
    kernel's tiles and warp blocks, and the blocks it does not reach are
    skipped.  Against the plain version and autograd."""
    gen = torch.Generator().manual_seed(10)
    n, h, w = 2, 200, 300
    gray = strand_gray(gen, n, h, w, cuda_device)
    bank = filters.bank(mode, cuda_device)
    yy = torch.arange(h, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, dtype=torch.float32)[None, :] / w
    ellipse = (((yy - 0.45) / 0.3) ** 2 + ((xx - 0.4) / 0.25) ** 2 < 1).float()
    dconf = (torch.randn((n, h, w), generator=gen) * ellipse).to(cuda_device)
    g = gray.clone().requires_grad_()
    idx, conf = O.OrientationResponse.apply(g, bank)
    conf.backward(dconf)
    want = O.filterbank_orientation_backward_plain(dconf, idx, conf, bank)
    # autograd through the plain forward takes the plain forward's argmax,
    # which may differ from the kernel's at a near-tie
    g2 = gray.clone().requires_grad_()
    p_idx, p_conf = O.filterbank_orientation_plain(g2, bank)
    (auto,) = torch.autograd.grad(p_conf, g2, dconf)
    torch.cuda.synchronize()
    assert_rel(g.grad, want)
    assert_rel(auto, O.filterbank_orientation_backward_plain(dconf, p_idx, p_conf.detach(), bank))
    assert not g.grad[:, :, :, -20:].any()  # more than 8 pixels right of the ellipse
