"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither jax nor the repository's test fixtures, so it runs where only torch
is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the fused norms float32 atol 1e-4, rtol 1e-5, bfloat16 atol
1e-2, rtol 1.6e-2 (about two bf16 ulps); conv3x3_in_act atol 1e-4, rtol
1e-4 (float32 sums of C*9 products in another order), in bfloat16 atol
1e-2, rtol 1.6e-2 (the one rounding of the output); the filter bank's
response rtol 1e-4, atol 1e-3, its argmax off on at most 0.1% of pixels and
then by one orientation (near-ties under another summation order);
conv3x3_same_lowch and filterbank_orientation_backward within 1e-4 of the
plain result's largest magnitude (float32 sums in another order); the 3xTF32
kernels against float64 at most 2x the error of their plain version in
float32, and the filter bank's argmax off float64's on at most 1e-4 of the
pixels more than the plain version's.  The bf16 forms: conv3x3_same_lowch
atol 1e-2, rtol 1.6e-2 (the one rounding of the output) and against
float64 at most 2x F.conv2d in bfloat16; the bank's bf16-operand form's
conf within one bf16 ulp (rtol 1e-2, atol 1e-3: a float32 sum in another
order may round to the neighbouring bf16 value), its argmax off on at most
1% of the pixels and there only where the plain version's two responses
lie within that tolerance; against float64 sums of the bf16 operands its
conf error within 1% of the plain version's (both round to bf16) and its
argmax off float64's on at most 1e-4 of the pixels more.  fused_instance_norm
in bf16 (one read, planes split across clusters) atol 1e-2, rtol 1.6e-2 at
every shape of the bf16 paths, ragged and large planes (all on planes with a
trend along H*W, whose slices differ), and far from zero.
"""

import math

import pytest
import torch

from michigan_tpu_torch.ops import cuda as kernels
from michigan_tpu_torch.ops import filters
from michigan_tpu_torch.ops.cuda import build
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


def trended(shape, gen, device):
    """bf16 planes whose slices differ: randn plus a trend along H*W (4
    linspace(-1, 1)), chip_smoke.py's norm input.  Each slice of a plane
    split across a cluster has its own mean, so a merge that drops, doubles
    or mis-weights a slice, or leaves out the spread of the slices' means,
    fails the comparison; on i.i.d. planes the slices agree and it would not
    (tools/norm_variants.py plants such merges)."""
    h, w = shape[-2:]
    trend = 4 * torch.linspace(-1, 1, h * w, device=device).view(h, w)
    return (torch.randn(shape, generator=gen, device=device) + trend).bfloat16()


# fused_instance_norm's shapes on the bf16 paths (C, H=W, act): the
# inpainter's norms, run by the flagship and the edit at batch 1 and by the
# training step at batch 8
IN_BF16_SHAPES = [(64, 256, "lrelu"), (128, 128, "lrelu"), (256, 64, "lrelu"),
                  (256, 64, "relu"), (256, 64, None), (128, 128, "relu"), (64, 256, "relu")]


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("c,h,act", IN_BF16_SHAPES)
def test_instance_norm_bf16_matches_plain_at_the_path_shapes(cuda_device, c, h, act, batch):
    """The one-read bf16 form, with and without gamma and beta, on planes
    whose slices differ."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = trended((batch, c, h, h), gen, cuda_device)
    g, b = (torch.randn((batch, c, h, h), generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    for gb in ((None, None), (g, b)):
        got = K.fused_instance_norm(x, *gb, act=act)
        want = K.fused_instance_norm_plain(x, *gb, act=act)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOLS[torch.bfloat16])


# (n, c, h, w): H*W % 8 != 0 and % 4 != 0 (the scalar path), in one block,
# split across a cluster and above a cluster's 65,536 elements (the
# two-pass form); small planes split because the call has few blocks
@pytest.mark.parametrize("n,c,h,w", [(1, 64, 37, 53), (2, 3, 255, 257), (1, 2, 300, 301),
                                     (1, 8, 128, 128), (2, 5, 24, 40)])
def test_instance_norm_bf16_on_ragged_and_large_planes(cuda_device, n, c, h, w):
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    x = trended((n, c, h, w), gen, cuda_device)
    g, b = (torch.randn((n, c, h, w), generator=gen, device=cuda_device).bfloat16()
            for _ in range(2))
    for act in ACTS:
        for gb in ((None, None), (g, b)):
            got = K.fused_instance_norm(x, *gb, act=act)
            want = K.fused_instance_norm_plain(x, *gb, act=act)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **TOLS[torch.bfloat16])


def test_instance_norm_bf16_is_stable_far_from_zero(cuda_device):
    """A large mean with a spread of a few bf16 ulps (4 at 1000): E[x^2] -
    mean^2 would cancel.  In one block, and split across a cluster."""
    gen = torch.Generator().manual_seed(1)
    for shape in ((1, 256, 64, 64), (1, 8, 256, 256)):
        x = (torch.randn(shape, generator=gen) * 16 + 1e3).to(cuda_device, torch.bfloat16)
        got = K.fused_instance_norm(x)
        want = K.fused_instance_norm_plain(x.double()).bfloat16()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **TOLS[torch.bfloat16])


def test_instance_norm_bf16_splits_planes_by_shape(cuda_device):
    """The form is the shape's: the inpainter's (1, 64, 256^2) splits each
    plane across a cluster of 8 blocks, (1, 128, 128^2) of 2, (1, 256, 64^2)
    keeps one block a plane, at batch 8 too; a plane above 8 x 8,192
    elements takes the two-pass form.  The split form at (1, 64, 256^2)
    matches its plain version."""
    z = lambda *shape: torch.zeros(shape, device=cuda_device, dtype=torch.bfloat16)
    assert K.instance_norm_bf16_split(z(1, 64, 256, 256)) == 8
    assert K.instance_norm_bf16_split(z(8, 64, 256, 256)) == 8
    assert K.instance_norm_bf16_split(z(1, 128, 128, 128)) == 2
    assert K.instance_norm_bf16_split(z(1, 256, 64, 64)) == 1
    assert K.instance_norm_bf16_split(z(8, 256, 64, 64)) == 1
    assert K.instance_norm_bf16_split(z(1, 1, 300, 300)) == 0
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    x = trended((1, 64, 256, 256), gen, cuda_device)
    kernels.reset_launch_counts()
    got = K.fused_instance_norm(x, act="lrelu")
    torch.cuda.synchronize()
    assert kernels.launch_counts(by_dtype=True)["fused_instance_norm"] == {"bfloat16": 1}
    torch.testing.assert_close(got.float(), K.fused_instance_norm_plain(x, act="lrelu").float(),
                               **TOLS[torch.bfloat16])


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
# the bf16 form's own edges beside those: planes of more than 16 tiles of 4
# x 64 (the pre-norm form; batch 2, and 3 with a 2-tile remainder),
# dilation 4, one tile per plane at the edit's channel count, and more
# planes than the card holds blocks for (one block walks each plane)
EPILOGUE_BF16_CASES = EPILOGUE_CASES + [
    (2, 16, 24, 80, 80, 1, "relu", True), (3, 20, 36, 70, 130, 2, "lrelu", False),
    (1, 32, 32, 16, 16, 4, None, False), (2, 24, 40, 30, 66, 4, "relu", True),
    (1, 256, 256, 4, 64, 1, None, True), (140, 8, 64, 8, 72, 1, "relu", True)]



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


# the bf16 form on the same cases and its own (odd C, W % 8 != 0, a partial
# 32-channel block); the weight and bias as the model hands them: float32
# (the spectral weight of netG's policy) or bfloat16 (the frozen
# inpainters' stored ones); one launch counted per call (the device's own
# count: test_bf16_convs_launch_one_device_kernel_per_call)
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,co,h,w,d,act,res", EPILOGUE_BF16_CASES)
def test_conv3x3_in_act_bf16_matches_plain(cuda_device, n, c, co, h, w, d, act, res,
                                           param_dtype):
    gen = torch.Generator().manual_seed(5)
    x = rand(gen, (n, c, h + 2 * d, w + 2 * d), cuda_device, torch.bfloat16)
    wt = (torch.randn((co, c, 3, 3), generator=gen) * 0.05).to(cuda_device, param_dtype)
    b = rand(gen, (co,), cuda_device, param_dtype)
    r = rand(gen, (n, co, h, w), cuda_device, torch.bfloat16) if res else None
    kernels.reset_launch_counts()
    got = E.conv3x3_in_act(x, wt, b, dilation=d, act=act, residual=r)
    want = E.conv3x3_in_act_plain(x, wt, b, dilation=d, act=act, residual=r)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **TOLS[torch.bfloat16])
    assert kernels.launch_counts(by_dtype=True)["conv3x3_in_act"] == {"bfloat16": 1}


def test_conv3x3_in_act_raises_on_mixed_dtypes(cuda_device):
    x = torch.zeros((1, 8, 10, 10), device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros((8, 8, 3, 3), device=cuda_device)
    with pytest.raises(TypeError, match="residual"):
        E.conv3x3_in_act(x, w, None, residual=torch.zeros((1, 8, 8, 8), device=cuda_device))
    with pytest.raises(TypeError, match="w is torch.bfloat16"):
        E.conv3x3_in_act(x.float(), w.bfloat16(), None)
    with pytest.raises(TypeError, match="x_pad"):
        E.conv3x3_in_act(x.half(), w, None)


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


LOWCH_BF16_CASES = [(2, 64, 64, 37, 53), (1, 64, 64, 64, 64), (1, 3, 70, 10, 11),
                    (1, 20, 40, 33, 30), (3, 12, 72, 9, 66), (2, 7, 64, 4, 32),
                    (1, 64, 64, 8, 64), (1, 160, 64, 20, 70), (4, 64, 64, 128, 136)]


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,co,h,w", LOWCH_BF16_CASES)
def test_conv3x3_same_lowch_bf16_matches_plain(cuda_device, n, c, co, h, w, w_dtype):
    """The bf16 form on the fp32 list's shapes (odd C, odd W and W % 8 !=
    0, Co over one block) and its own: fewer tiles than SMs (the persistent
    grid), C = 160 (too many channels for resident weights: streamed), more
    tiles than SMs with a ragged last column of tiles.  One device kernel per
    call."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((n, c, h, w), generator=gen).relu().to(cuda_device, torch.bfloat16)
    wt = (torch.randn((co, c, 3, 3), generator=gen) * math.sqrt(2 / (9 * c))).to(
        cuda_device, w_dtype)
    kernels.reset_launch_counts()
    got = L.conv3x3_same_lowch(x, wt)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (n, co, h, w)
    torch.testing.assert_close(got, L.conv3x3_same_lowch_plain(x, wt), **TOLS[torch.bfloat16])
    assert kernels.launch_counts(by_dtype=True)["conv3x3_same_lowch"] == {"bfloat16": 1}


def test_bf16_convs_launch_one_device_kernel_per_call(cuda_device):
    """Every bf16 case above, one call each under torch.profiler in a
    process of its own (tools/kernel_launches.py): conv3x3_same_lowch one
    device kernel per call, conv3x3_in_act its layout pass and its
    convolution, and no other kernel (no pair pass, no norm pass)."""
    from michigan_tpu_torch.tools import kernel_launches

    cases = [["in_act", list(c)] for c in EPILOGUE_BF16_CASES] + \
        [["lowch", list(c)] for c in LOWCH_BF16_CASES]
    launches = kernel_launches.run(cases)
    short = {k.split("::", 1)[-1].split("(")[0]: n for k, n in launches.items()}
    assert short == {"in_act_layout_kernel": len(EPILOGUE_BF16_CASES),
                     "conv3x3_in_act_bf16_kernel": len(EPILOGUE_BF16_CASES),
                     "conv3x3_same_bf16_kernel": len(LOWCH_BF16_CASES)}, launches


def test_conv3x3_same_lowch_bf16_takes_the_tensor_map_at_the_path_shape(cuda_device):
    """features_2's (16, 64, 512^2) in bf16 qualifies for the tensor map by
    shape, and a map the driver refused would raise, so a call that returns
    and matches its plain version took the map; a W % 8 != 0 x and an x off
    16 bytes go row by row."""
    lib = build.load("conv_lowch")
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn((16, 64, 512, 512), generator=gen, device=cuda_device).relu_().bfloat16()
    wt = (torch.randn((64, 64, 3, 3), generator=gen, device=cuda_device)
          * math.sqrt(2 / 576)).bfloat16()
    assert lib.conv3x3_same_bf16_uses_map(x.data_ptr(), 512) == 1
    assert lib.conv3x3_same_bf16_uses_map(x.data_ptr(), 53) == 0
    assert lib.conv3x3_same_bf16_uses_map(x.data_ptr() + 2, 512) == 0
    got = L.conv3x3_same_lowch(x, wt)
    torch.testing.assert_close(got, L.conv3x3_same_lowch_plain(x, wt), **TOLS[torch.bfloat16])


@pytest.mark.parametrize("n,c,co,h,w", [(1, 3, 70, 10, 11), (2, 7, 64, 9, 64)])
def test_conv3x3_same_lowch_bf16_on_an_x_off_16_bytes(cuda_device, n, c, co, h, w):
    """x a view that starts 2 bytes past a 16-byte boundary and ends off
    one: its first and last rows' widened copies would leave x's own bytes,
    so they go by plain loads; the result is unchanged."""
    gen = torch.Generator().manual_seed(12)
    base = torch.randn((n * c * h * w + 1,), generator=gen).relu().to(cuda_device,
                                                                       torch.bfloat16)
    x = base[1:].view(n, c, h, w)
    assert x.data_ptr() % 16 == 2
    wt = (torch.randn((co, c, 3, 3), generator=gen) * math.sqrt(2 / (9 * c))).to(cuda_device)
    got = L.conv3x3_same_lowch(x, wt)
    torch.testing.assert_close(got, L.conv3x3_same_lowch_plain(x, wt), **TOLS[torch.bfloat16])


def test_conv3x3_same_lowch_bf16_is_as_accurate_as_cudnn_bf16(cuda_device):
    """Batch 2 of features_2's shape in bf16: the kernel and F.conv2d in
    bf16 against a float64 conv of the same bf16 values."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((2, 64, 512, 512), generator=gen, device=cuda_device).relu_().bfloat16()
    wt = (torch.randn((64, 64, 3, 3), generator=gen, device=cuda_device)
          * math.sqrt(2 / 576)).bfloat16()
    want = L.conv3x3_same_lowch_plain(x.double(), wt.double())
    kernel = rel_err(L.conv3x3_same_lowch(x, wt), want)
    cudnn = rel_err(torch.nn.functional.conv2d(x, wt, padding=1), want)
    assert kernel <= 2 * cudnn, (kernel, cudnn)


def test_conv3x3_in_act_bf16_is_as_accurate_as_cudnn_bf16(cuda_device):
    """Batch 2 of the resblock shape, both dilations, in bf16: the kernel's
    one wgmma chain over all 2304 products, and cuDNN's bf16 conv + the
    torch norm, against the float64 composition of the same bf16 values."""
    F = torch.nn.functional
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    for d, act, res in ((2, "relu", False), (1, None, True)):
        x = torch.randn((2, 256, 64 + 2 * d, 64 + 2 * d), generator=gen,
                        device=cuda_device).bfloat16()
        wt = torch.randn((256, 256, 3, 3), generator=gen, device=cuda_device) * 0.02
        b = torch.randn(256, generator=gen, device=cuda_device)
        r = torch.randn((2, 256, 64, 64), generator=gen, device=cuda_device).bfloat16() \
            if res else None
        want = E.conv3x3_in_act_plain(x.double(), wt.bfloat16().double(), b.double(), d, act,
                                      residual=None if r is None else r.double())
        kernel = rel_err(E.conv3x3_in_act(x, wt, b, d, act, residual=r), want)
        y = K._act(K.instance_norm(F.conv2d(x, wt.bfloat16(), b.bfloat16(), dilation=d)), act)
        cudnn = rel_err(y if r is None else r + y, want)
        assert kernel <= 2 * cudnn, (d, kernel, cudnn)


@pytest.mark.parametrize("mode", ["gabor", "dog"])
@pytest.mark.parametrize("n,h,w", [(1, 512, 512), (2, 37, 53), (300, 16, 16)])
def test_filterbank_bf16_operands_matches_plain(cuda_device, mode, n, h, w):
    gray = strand_gray(torch.Generator().manual_seed(4), n, h, w, cuda_device)
    bank = filters.bank(mode, cuda_device)
    kernels.reset_launch_counts()
    idx, conf = O.filterbank_orientation(gray, bank, bf16_operands=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts(by_dtype=True)["filterbank_orientation"] == {"bfloat16": 1}
    p_idx, p_conf = O.filterbank_orientation_plain(gray, bank, bf16_operands=True)
    assert torch.equal(conf.bfloat16().float(), conf)  # bf16 values
    torch.testing.assert_close(conf, p_conf, rtol=1e-2, atol=1e-3)
    differ = idx != p_idx
    assert differ.float().mean().item() <= 1e-2
    if differ.any():
        g16, b16 = gray.bfloat16().double(), bank.bfloat16().double()
        res = torch.nn.functional.conv2d(g16, b16.permute(3, 2, 0, 1), padding=8)
        res = res.bfloat16().double().clamp_min(0.0)
        n_, y_, x_ = differ.nonzero(as_tuple=True)
        a, b = (res[n_, i[differ].long(), y_, x_] for i in (idx, p_idx))
        assert bool(((a - b).abs() <= 1e-3 + 1e-2 * b.abs()).all())


def test_filterbank_bf16_operands_zero_plane_and_bf16_ties(cuda_device):
    """An all-zero plane gives idx 0 and conf 0.  A bank whose orientations
    7 and 20 differ in float32 but are equal in bf16 (7 on the bf16 grid, 20
    is 7 times 1 + 2^-12, under half a bf16 ulp away), and larger than the
    others: the responses tie in bf16, and the first index, 7, wins wherever
    either is the largest."""
    bank = filters.bank("gabor", cuda_device)
    idx, conf = O.filterbank_orientation(torch.zeros((1, 1, 40, 70), device=cuda_device), bank,
                                         bf16_operands=True)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int32 and not idx.any() and not conf.any()
    bank = bank.clone()
    bank[..., 7] = (bank[..., 7] * 4).bfloat16().float()
    bank[..., 20] = bank[..., 7] * (1 + 2 ** -12)
    assert torch.equal(bank[..., 20].bfloat16(), bank[..., 7].bfloat16())
    assert not torch.equal(bank[..., 20], bank[..., 7])
    gray = strand_gray(torch.Generator().manual_seed(16), 2, 100, 130, cuda_device)
    idx, conf = O.filterbank_orientation(gray, bank, bf16_operands=True)
    p_idx, _ = O.filterbank_orientation_plain(gray, bank, bf16_operands=True)
    torch.cuda.synchronize()
    assert (idx == 7).any() and not (idx == 20).any() and not (p_idx == 20).any()


@pytest.mark.parametrize("mode", ["gabor", "dog"])
def test_filterbank_bf16_operands_is_as_accurate_as_before(cuda_device, mode):
    """(2, 1, 512^2) strand planes against float64 sums of the bf16
    operands: the one float32 chain's conf error within 1% of the plain
    version's (exact products, float32 sums, the responses rounded to bf16:
    the arithmetic of the form this kernel replaced, whose error equalled
    the plain version's), and its argmax off float64's (the float64 sums
    rounded to bf16, first index) on at most 1e-4 of the pixels more."""
    F = torch.nn.functional
    gray = strand_gray(torch.Generator().manual_seed(9), 2, 512, 512, cuda_device)
    bank = filters.bank(mode, cuda_device)
    res = F.conv2d(gray.bfloat16().double(), bank.bfloat16().double().permute(3, 2, 0, 1),
                   padding=8)
    idx64 = res.bfloat16().double().clamp_min(0.0).argmax(dim=1)
    exact = res.clamp_min(0.0).amax(dim=1)
    (idx, conf), (p_idx, p_conf) = (O.filterbank_orientation(gray, bank, bf16_operands=True),
                                    O.filterbank_orientation_plain(gray, bank, bf16_operands=True))
    kernel, plain = ((c.double() - exact).abs().max().item() for c in (conf, p_conf))
    assert kernel <= 1.01 * plain, (kernel, plain)
    k_mis, p_mis = ((i != idx64).float().mean().item() for i in (idx, p_idx))
    assert k_mis <= p_mis + 1e-4, (k_mis, p_mis)


def test_filterbank_bf16_operands_one_kernel_on_bf16_tensor_cores(cuda_device):
    """One device kernel per call at the training step's (8, 1, 512^2)
    (torch.profiler, in a process of its own), and its SASS issues bf16
    tensor-core products (HMMA.16816 bf16 or HGMMA) and no TF32 mma."""
    from michigan_tpu_torch.tools import kernel_launches

    launches = kernel_launches.run([["bank16", [8, 512, 512]]])
    short = {kernel_launches.short_name(k): n for k, n in launches.items()}
    assert short == {"filterbank_bf16_kernel": 1}, launches
    ops = kernel_launches.sass_mma(build.build("filterbank"), "filterbank_bf16_kernel")
    assert any(k.startswith(("HMMA.16816.F32.BF16", "HGMMA")) for k in ops), ops
    assert not any("TF32" in k for k in ops), ops


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
    with pytest.raises(TypeError):  # a bf16 weight takes a bf16 x
        L.conv3x3_same_lowch(x, w.bfloat16())
    with pytest.raises(TypeError):
        L.conv3x3_same_lowch(x.bfloat16(), w.half())
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


def test_native_conv_route_matches_float64_on_the_card(cuda_device):
    """layers.NativeConv (cuDNN off) at a generator block's shape, forward
    and both gradients, against float64: within float32 rounding of the
    sums, and no further from float64 than cuDNN's float32 conv."""
    from michigan_tpu_torch.models.layers import NativeConv

    F = torch.nn.functional
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn((2, 1024, 16, 16), generator=gen, device=cuda_device)
    w = torch.randn((1024, 1024, 3, 3), generator=gen, device=cuda_device) * 0.01
    b = torch.randn(1024, generator=gen, device=cuda_device)
    g = torch.randn((2, 1024, 16, 16), generator=gen, device=cuda_device)

    def run(fn, dtype):
        ins = [t.to(dtype).requires_grad_() for t in (x, w, b)]
        y = fn(*ins)
        return (y, *torch.autograd.grad(y, ins, g.to(dtype)))

    want = run(lambda *t: F.conv2d(*t, 1, 1), torch.float64)
    native = run(lambda *t: NativeConv.apply(F.conv2d, *t, 1, 1), torch.float32)
    cudnn = run(lambda *t: F.conv2d(*t, 1, 1), torch.float32)
    for got, ref, base in zip(native, want, cudnn):
        assert rel_err(got, ref) <= max(2 * rel_err(base, ref), 1e-6), (
            rel_err(got, ref), rel_err(base, ref))
