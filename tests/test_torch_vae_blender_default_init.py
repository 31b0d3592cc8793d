"""The blender config's G step at torch's default init against the JAX
package's: tests/test_torch_vae_blender.py's ``blender_default_init`` case,
in a file of its own (its own jitted JAX init and G step) so that it runs
in another worker than the VAE and blender steps at their own init.

From JAX's initial variables on tests/test_torch_vae_blender.py's seeded
paired batch: netG and netB after the G step by the scale-aware rule, or,
where its count fails, by the float64 witness on the port's branches
(at most F64_CAL x JAX's gradient error against the float64 step, at most
MAX_FLIPS choices apart from float64's, each within MAX_FLIP_ULPS); the
half-batch control must fail the witness.  Also the float64 G step
itself (tools/float64_step.py g_step64), moved here from that file.
"""

import jax
import numpy as np
import pytest
import torch

from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.training.train_step import TrainStep
from tests.test_torch_training import EXTRA, tiny_batch, tiny_opt
from tests.test_torch_vae_blender import (  # noqa: F401  (fixture)
    CONFIGS,
    check_g_step_updates,
    check_half_batch_control,
    jax_g_step,
    one_torch_thread,
    port_g_step,
    witness_of,
)

G_CASES = {"blender_default_init": dict(use_blender=True, init_type="none")}
WITNESSED = ("blender_default_init",)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's init and G step of the case, on the batch (and with the eps)
    of tests/test_torch_vae_blender.py's jax_runs."""
    rng = jax.random.PRNGKey(0)
    both = tiny_opt(**{**CONFIGS["vae"], **CONFIGS["blender"]})
    batch = tiny_batch(both)
    out = {"batch": batch, "eps": np.asarray(jax.random.normal(rng, (both.batchSize, 256)))}
    for name, kw in G_CASES.items():
        out[name] = jax_g_step(tiny_opt(**kw), batch, rng)
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    return {name: port_g_step(jax_runs, name)[0] for name in G_CASES}


@pytest.fixture(scope="module")
def witness_runs(jax_runs, port_runs):
    return witness_of(jax_runs, port_runs, WITNESSED)


@pytest.mark.parametrize("name", list(G_CASES))
def test_g_step_updates_netg_and_own_net_as_jax(request, jax_runs, port_runs, name):
    check_g_step_updates(request, jax_runs, port_runs, name, WITNESSED)


@pytest.mark.parametrize("name", WITNESSED)
def test_half_batch_control_fails_the_float64_witness(witness_runs, name):
    check_half_batch_control(witness_runs, name)


def test_float64_witness_step_computes_the_g_step_in_float64():
    """tools/float64_step.py's g_step64 (chip_smoke.py's phase 16 witness):
    the blender config's G step on the CPU in float64 from float32 state
    dicts; every gradient and parameter comes back float64, torch's casts
    and default dtype are restored after it, its losses are the float32
    step's (rtol 1e-5), and adam_grads reads the float32 step's gradients
    back from Adam as autograd left them.
    At crop 128: at 64^2 the float32 step's own losses differ from
    float64's by up to 1e-3 (GAN, CONFIDENCE), at 128^2 by 1.2e-6."""
    from michigan_tpu_torch.tools import float64_step

    opt = tiny_opt(use_blender=True, crop_size=128, load_size=128)
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    init = {k: {n: t.detach().clone() for n, t in net.state_dict().items()}
            for k, net in model.nets().items()}
    batch = batch_from_numpy(tiny_batch(opt), "cpu")
    nets = ("netG", "netB")
    losses, grads, exact = float64_step.g_step64(opt, init, batch, None, nets, EXTRA)
    assert torch.ones(1).dtype == torch.float32
    assert torch.ones(1).double().float().dtype == torch.float32
    assert set(exact) == set(grads) == set(nets)
    assert all(p.dtype == torch.float64 for d in (grads, exact) for net in d.values()
               for p in net.values())
    trainer = TrainStep(model)
    seen = {}
    adam_step = trainer.optimizers["G"].step

    def step_keeping_grads(*a, **kw):
        seen.update({(k, n): p.grad.clone() for k in nets
                     for n, p in model.nets()[k].named_parameters()})
        return adam_step(*a, **kw)

    trainer.optimizers["G"].step = step_keeping_grads
    want, _, _ = trainer.g_step(batch, EXTRA)
    got = float64_step.adam_grads(trainer, nets)
    assert all(torch.equal(got[k][n], seen[k, n].double()) for k, n in seen)
    assert 0 < float64_step.rel_err(got["netG"], grads["netG"]) < 1e-2
    assert list(losses) == list(want)
    for k, v in want.items():
        assert losses[k] == pytest.approx(v.item(), rel=1e-5, abs=1e-7), k
    moved = {k: any(not torch.equal(p.float(), init[k][n]) for n, p in exact[k].items())
             for k in exact}
    assert all(moved.values())
