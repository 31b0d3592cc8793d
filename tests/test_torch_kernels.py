"""The port's fused-norm kernels: plain versions against the JAX package's
composition and its Pallas functions (interpret mode on the CPU).

Inputs are made in NHWC with numpy; the port takes NCHW, so each test
transposes at the boundary.  Tolerance rtol 1e-5, atol 1e-5 (float32, sums
taken in another order).  The kernels themselves are held to these plain
versions on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu.ops.norms import instance_norm as jax_instance_norm
from michigan_tpu.ops.pallas import spade as pallas
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


def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    K.reset_launch_counts()
    x, mean, inv, g, b = mod_inputs(rng, (1, 4, 4, 8))
    port_mod(x, mean, inv, g, b)
    port_in(x, g, b, "relu")
    assert K.launch_counts() == {"spade_modulate": 0, "fused_instance_norm": 0}


def test_wrappers_raise_on_devices_without_a_kernel():
    x = torch.empty(1, 2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.fused_instance_norm(x)
    with pytest.raises(ValueError, match="no kernel"):
        K.spade_modulate(x, torch.empty(2, device="meta"), torch.empty(2, device="meta"), x, x)
    with pytest.raises(ValueError, match="activation"):
        K.fused_instance_norm(torch.zeros(1, 1, 2, 2), act="gelu")
