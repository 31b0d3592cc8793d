"""The port's kernels: plain versions against the JAX package's composition
and its Pallas functions (interpret mode on the CPU).

Inputs are made in NHWC with numpy; the port takes NCHW, so each test
transposes at the boundary.  Tolerances (float32, sums taken in another
order): the fused norms rtol 1e-5, atol 1e-5; conv3x3_in_act rtol 1e-4,
atol 1e-4 and the filter bank's response rtol 1e-4, atol 1e-3 with argmax
flips on < 0.1% of pixels, as the JAX package's own Pallas tests hold them
(tests/test_pallas_kernels.py).  The kernels themselves are held to these
plain versions on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu.ops import filters as jax_filters
from michigan_tpu.ops.norms import instance_norm as jax_instance_norm
from michigan_tpu.ops.pallas import epilogue as pallas_epilogue
from michigan_tpu.ops.pallas import spade as pallas
from michigan_tpu.ops.pallas.filterbank import filterbank_orientation as pallas_filterbank
from michigan_tpu_torch.ops import filters
from michigan_tpu_torch.ops import cuda as kernels
from michigan_tpu_torch.ops.cuda import epilogue as E
from michigan_tpu_torch.ops.cuda import lowch as L
from michigan_tpu_torch.ops.cuda import orient as O
from michigan_tpu_torch.ops.cuda import spade as K

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = [None, "relu", "lrelu"]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def jax_act(y, act):
    if act == "relu":
        return jax.nn.relu(y)
    if act == "lrelu":
        return jax.nn.leaky_relu(y, 0.2)
    return y


def in_inputs(rng, shape, modulated):
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    if not modulated:
        return x, None, None
    g = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return x, g, b


def port_in(x, g, b, act):
    t = lambda a: None if a is None else nchw(a)
    return nhwc(K.fused_instance_norm(t(x), t(g), t(b), act=act))


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_instance_norm_plain_matches_jax_composition(rng, act, modulated):
    x, g, b = in_inputs(rng, (2, 9, 7, 12), modulated)
    ref = jax_instance_norm(jnp.asarray(x))
    if modulated:
        ref = ref * (1.0 + g) + b
    np.testing.assert_allclose(port_in(x, g, b, act), np.asarray(jax_act(ref, act)), **TOL)


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_instance_norm_plain_matches_pallas(rng, act, modulated):
    # resident form; grid n * C/128 = 2 steps in interpret mode
    x, g, b = in_inputs(rng, (2, 8, 8, 32), modulated)
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = pallas.fused_instance_norm(j(x), j(g), j(b), act=act)
    np.testing.assert_allclose(port_in(x, g, b, act), np.asarray(ref), **TOL)


@pytest.mark.parametrize("modulated", [False, True])
def test_instance_norm_plain_matches_pallas_streaming(rng, modulated):
    # the two-pass streaming form of large planes, with a ragged last tile
    x, g, b = in_inputs(rng, (1, 20, 20, 70), modulated)
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = pallas._streaming_instance_norm(j(x), j(g), j(b), 1e-5, th=96, act="lrelu")
    np.testing.assert_allclose(port_in(x, g, b, "lrelu"), np.asarray(ref), **TOL)


def mod_inputs(rng, shape):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, c).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return x, mean, inv, g, b


def port_mod(x, mean, inv, g, b):
    return nhwc(K.spade_modulate(nchw(x), torch.from_numpy(mean), torch.from_numpy(inv),
                                 nchw(g), nchw(b)))


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (1, 9, 9, 24)])
def test_spade_modulate_plain_matches_jax_composition(rng, shape):
    x, mean, inv, g, b = mod_inputs(rng, shape)
    # the eval-mode SPADE composition of michigan_tpu/models/normalization.py
    ref = (jnp.asarray(x) - mean) * inv * (1.0 + g) + b
    np.testing.assert_allclose(port_mod(x, mean, inv, g, b), np.asarray(ref), **TOL)


def test_spade_modulate_plain_matches_pallas(rng):
    x, mean, inv, g, b = mod_inputs(rng, (2, 16, 16, 128))  # 512-row tiles, C=128
    ref = pallas.spade_modulate(*(jnp.asarray(a) for a in (x, mean, inv, g, b)))
    np.testing.assert_allclose(port_mod(x, mean, inv, g, b), np.asarray(ref), **TOL)


EPILOGUE_CASES = [(2, "relu", False), (1, None, True), (1, "lrelu", False)]


def epilogue_inputs(rng, d, with_res):
    """tests/test_pallas_kernels.py's cases: batch 2, C = Co = 128, 16^2."""
    x = rng.standard_normal((2, 16 + 2 * d, 16 + 2 * d, 128)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 128, 128)) * 0.05).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    res = rng.standard_normal((2, 16, 16, 128)).astype(np.float32) if with_res else None
    return x, w, b, res


def port_epilogue(x, w, b, res, d, act):
    w_oihw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    return nhwc(E.conv3x3_in_act(nchw(x), w_oihw, torch.from_numpy(b), dilation=d, act=act,
                                 residual=None if res is None else nchw(res)))


@pytest.mark.parametrize("d,act,with_res", EPILOGUE_CASES)
def test_conv3x3_in_act_plain_matches_jax_composition(rng, d, act, with_res):
    x, w, b, res = epilogue_inputs(rng, d, with_res)
    ref = pallas_epilogue._xla_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), d, act,
                                         1e-5, None if res is None else jnp.asarray(res))
    np.testing.assert_allclose(port_epilogue(x, w, b, res, d, act), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,act,with_res", EPILOGUE_CASES)
def test_conv3x3_in_act_plain_matches_pallas(rng, d, act, with_res):
    x, w, b, res = epilogue_inputs(rng, d, with_res)
    ref = pallas_epilogue.conv3x3_in_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         dilation=d, act=act,
                                         residual=None if res is None else jnp.asarray(res))
    np.testing.assert_allclose(port_epilogue(x, w, b, res, d, act), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def assert_orientation_close(idx, conf, j_idx, j_conf):
    np.testing.assert_allclose(conf.numpy(), np.asarray(j_conf), rtol=1e-4, atol=1e-3)
    assert (idx.numpy() != np.asarray(j_idx)).mean() < 1e-3


@pytest.mark.parametrize("mode", ["gabor", "dog"])
def test_orientation_response_matches_jax(rng, mode):
    gray = (rng.standard_normal((1, 40, 48, 1)) * 10).astype(np.float32)
    idx, conf = filters.orientation_response(torch.from_numpy(gray), mode)
    assert idx.dtype == torch.int32 and idx.shape == conf.shape == (1, 40, 48)
    assert_orientation_close(idx, conf, *jax_filters.orientation_response(jnp.asarray(gray), mode))


@pytest.mark.parametrize("mode", ["gabor", "dog"])
def test_filterbank_plain_matches_pallas(rng, mode):
    gray = (rng.standard_normal((1, 40, 48, 1)) * 10).astype(np.float32)
    idx, conf = O.filterbank_orientation(nchw(gray), filters.bank(mode, torch.device("cpu")))
    assert_orientation_close(idx, conf, *pallas_filterbank(jnp.asarray(gray), mode, tile_h=16))


def test_banks_equal_the_jax_package():
    np.testing.assert_array_equal(filters._gabor_bank_np(), jax_filters._gabor_bank_np())
    np.testing.assert_array_equal(filters._dog_bank_np(), jax_filters._dog_bank_np())


def test_filterbank_ties_take_the_first_index():
    """An all-zero plane: every clamped response is 0, so idx is 0."""
    idx, conf = filters.orientation_response(torch.zeros(2, 20, 24, 1), "dog")
    assert not idx.any() and not conf.any()


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    kernels.reset_launch_counts()
    x, mean, inv, g, b = mod_inputs(rng, (1, 4, 4, 8))
    port_mod(x, mean, inv, g, b)
    port_in(x, g, b, "relu")
    xp, w, bias, res = epilogue_inputs(rng, 1, True)
    port_epilogue(xp, w, bias, res, 1, None)
    filters.orientation_response(torch.zeros(1, 20, 24, 1), "gabor")
    gray = torch.rand(1, 1, 20, 24, requires_grad=True)
    _, conf = O.OrientationResponse.apply(gray, filters.bank("gabor", gray.device))
    conf.sum().backward()
    L.conv3x3_same_lowch(torch.zeros(1, 4, 6, 6), torch.zeros(4, 4, 3, 3))
    assert kernels.launch_counts() == {"spade_modulate": 0, "fused_instance_norm": 0,
                                       "conv3x3_in_act": 0, "filterbank_orientation": 0,
                                       "filterbank_orientation_backward": 0,
                                       "conv3x3_same_lowch": 0}


def test_wrappers_raise_on_devices_without_a_kernel():
    x = torch.empty(1, 2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.fused_instance_norm(x)
    with pytest.raises(ValueError, match="no kernel"):
        K.spade_modulate(x, torch.empty(2, device="meta"), torch.empty(2, device="meta"), x, x)
    with pytest.raises(ValueError, match="no kernel"):
        E.conv3x3_in_act(x, torch.empty(2, 2, 3, 3, device="meta"), None)
    with pytest.raises(ValueError, match="no kernel"):
        O.filterbank_orientation(x[:, :1], torch.empty(O.BANK_SHAPE, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        O.filterbank_orientation_backward(x[:, 0], x[:, 0].int(), x[:, 0],
                                          torch.empty(O.BANK_SHAPE, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        L.conv3x3_same_lowch(x, torch.empty(2, 2, 3, 3, device="meta"))
    with pytest.raises(ValueError, match="activation"):
        K.fused_instance_norm(torch.zeros(1, 1, 2, 2), act="gelu")
    with pytest.raises(ValueError, match="activation"):
        E.conv3x3_in_act(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3), None, act="gelu")


@pytest.mark.parametrize("variant", ["cvt.rna split", "small rounded", "one chain",
                                     "4-byte halo copies", "in_act one group",
                                     "lowch two groups"])
def test_tile_variants_still_apply_to_the_sources(tmp_path, variant):
    """tools/tile_variants.py measures the tile's design choices as edits of
    the built sources: each edit must still find its text exactly once."""
    from michigan_tpu_torch.ops.cuda import build
    from michigan_tpu_torch.tools import tile_variants

    edits = tile_variants.VARIANTS[variant]
    tile_variants.patched_sources(edits, tmp_path, build.CSRC_DIR)
    for name, old, new in edits:
        text = (tmp_path / name).read_text()
        assert new in text and old not in text


def test_tile_variants_reads_registers_and_spills_from_ptxas():
    from michigan_tpu_torch.tools import tile_variants

    stderr = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z4normPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4normPf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 112 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z4convPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4convPf\n"
        "    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative stack size\n")
    assert tile_variants.ptxas_report(stderr) == [
        "_Z4normPf: Used 32 registers, used 1 barriers, 112 bytes smem; 0 bytes stack frame, "
        "0 bytes spill stores, 0 bytes spill loads",
        "_Z4convPf: Used 128 registers, used 1 barriers, 16 bytes cumulative stack size; 16 "
        "bytes stack frame, 12 bytes spill stores, 20 bytes spill loads"]
