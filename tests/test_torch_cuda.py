"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither jax nor the repository's test fixtures, so it runs where only torch
is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 atol 1e-4, rtol 1e-5; bfloat16 atol 1e-2, rtol 1.6e-2
(about two bf16 ulps).
"""

import pytest
import torch

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
    K.reset_launch_counts()
    got = K.spade_modulate(x, mean, inv, g, b)
    torch.testing.assert_close(got.float(), K.spade_modulate_plain(x, mean, inv, g, b).float(),
                               **TOLS[dtype])
    for act in ACTS:
        for gb in ((None, None), (g, b)):
            got = K.fused_instance_norm(x, *gb, act=act)
            want = K.fused_instance_norm_plain(x, *gb, act=act)
            torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])
    torch.cuda.synchronize()
    assert K.launch_counts() == {"spade_modulate": 1, "fused_instance_norm": 6}


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
