"""The blender configs under the bf16 compute policy against the JAX
package's, on the CPU: tests/test_torch_bf16_configs.py's steps, gates and
controls, in a file of their own so that they run in another worker.

- blender: --use_blender --hair_random_disturb on blob hair labels, whose
  edge band netB's input replaces by noise;
- only_blend: --use_blender --only_blend (netB blends the ref image, netG
  runs nowhere).

Both at the config's own init (xavier, gain 0.02).  At torch's default
init the blender's bf16 G step is not gated against JAX's: there the
orientation loss's Gabor confidence term takes its gradient from the few
hair pixels whose largest clamped bank response lies just above 0, where
tanh' is 1, and bf16 operands move which pixels those are; a handful of
them sets the whole G-step gradient (measured in the port; JAX's bf16
gradient lies as far from float64's at another seed, not broken down by
term).  Run as a script, the file measures it per seed
(``default_init_readings``; ~2.5 minutes a seed; --seeds, --repeats):

    env JAX_PLATFORMS=cpu python -m tests.test_torch_bf16_configs_blender

The card's bf16 blender step at default init is held against the CPU's in
chip_smoke.py's phase 19.
"""

import argparse
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from michigan_tpu.training.state import TrainState
from michigan_tpu.training.train_step import make_train_steps
from michigan_tpu_torch.convert import state_dicts_from_flax
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.ops.masks import wide_edges
from michigan_tpu_torch.tools import float64_step
from michigan_tpu_torch.training.train_step import TrainStep
from tests.test_torch_bf16_configs import (  # noqa: F401  (fixtures)
    assert_losses_within_gate,
    assert_nets_within_gate,
    blob_batch,
    config_opt,
    config_run,
    floats,
    jax_variables,
    one_torch_thread,
    runs,
    snapshot,
)
from tests.test_torch_bf16_training import loss_gate
from tests.test_torch_training import EXTRA
from tests.test_torch_vae_blender import adam_mu

CONFIGS = {"blender": dict(use_blender=True, hair_random_disturb=True),
           "only_blend": dict(use_blender=True, only_blend=True)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_step_matches_jax(config_run, name):
    assert_losses_within_gate(config_run)
    assert_nets_within_gate(config_run)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_loss_gate_fails_half_the_batch(config_run, name):
    rows, past = loss_gate(config_run["half"]["g"], config_run["jax"]["g"],
                           config_run["float32"]["g"])
    print("half the batch, port-bf16 vs JAX-bf16 / JAX-bf16 vs fp32: "
          + ", ".join(f"{k} {v}" for k, v in rows.items()))
    assert past, rows


def test_hair_random_disturb_bands_the_blob_edge_in_bf16():
    """On the blob labels the band of --hair_random_disturb covers the
    hair's edge and not every pixel, in bf16 as in float32, and moves the
    bf16 blend."""
    opt = config_opt(CONFIGS["blender"], dtype="bfloat16")
    batch = batch_from_numpy(blob_batch(opt), "cpu")
    model = MichiGANModel(opt, "cpu")
    model.init_weights(0)
    hair = batch["label_tag"]
    for dtype in (torch.float32, torch.bfloat16):
        band = wide_edges(hair.to(dtype), th=5.0 / hair.shape[2])
        assert band.dtype == dtype and 0.02 < band.float().mean() < 0.5
        assert torch.equal(band.float(), wide_edges(hair, th=5.0 / hair.shape[2]))
    pre = model.preprocess(batch)
    with torch.no_grad():
        args = [pre[k].to(torch.bfloat16) for k in ("image_ref", "image_tag", "input_tag",
                                                    "noise")]
        with_band = model.netB(*args)
        model.netB.hair_random_disturb = False
        without = model.netB(*args)
    assert with_band.dtype == torch.bfloat16
    assert (with_band.float() - without.float()).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# the blender's bf16 G step at torch's default init (not gated: measured)
# ---------------------------------------------------------------------------

def default_init_readings(seed):
    """The blender config's bf16 G step at torch's default init on the blob
    batch of `seed` (the weights the port's seeded init 0): the per-loss
    gate of the port's bf16 step and of its half-batch control against
    JAX's bf16 step (calibrated on JAX-bf16 vs the port's float32 step), and
    each G-side net's gradient error, relative to the witness's norm, of
    JAX's bf16 step, the port's and the control against three witnesses:
    the port's G step in float64 as it runs ('f64'), JAX's float32 G step
    ('jax32') and the float64 step on the port's bf16 step's branches
    ('f64_port_branches', float64_step.branch_masks: its ReLUs, max pools
    and |.|; not the filter bank's clamp and argmax); and per loss term, the
    norm of its gradient at netB's output in the port's bf16 and float32
    steps."""
    kw = {**CONFIGS["blender"], "init_type": "none"}
    opt32, opt16 = config_opt(kw), config_opt(kw, dtype="bfloat16")
    init = MichiGANModel(opt32, "cpu")
    init.init_weights(0)
    sd = snapshot(init)
    nets = ("netG", "netB")
    batch = blob_batch(opt16, seed)
    rng, extra = jax.random.PRNGKey(0), jnp.asarray(EXTRA, jnp.int32)
    jax_steps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MICHIGAN_FILTERBANK", raising=False)  # the s2d bank: fwd_bf16
        for name, opt in (("jax16", opt16), ("jax32", opt32)):
            model, g_step, _ = make_train_steps(opt)
            v0 = model.compact_frozen_variables(jax_variables(sd, opt))
            state1, losses, _, _ = g_step(TrainState.create(opt, v0), batch, rng, extra)
            mu = adam_mu(state1.opt_g_state)
            v0 = jax.tree_util.tree_map(np.asarray, v0)
            grads = state_dicts_from_flax({k: {**v0[k], "params": mu[k]} for k in nets}, opt)
            jax_steps[name] = dict(losses=floats(losses), grads=grads)
    tbatch = batch_from_numpy(batch, "cpu")

    def port_step(opt, b, record=False):
        m = MichiGANModel(opt, "cpu")
        m.load_state_dicts(sd)
        tr = TrainStep(m)
        with float64_step.branch_masks() if record else contextlib.nullcontext() as branches:
            losses, _, _ = tr.g_step(b, EXTRA)
        return floats(losses), float64_step.adam_grads(tr, nets), branches

    port16, g16, branches16 = port_step(opt16, tbatch, record=True)
    port32, _, _ = port_step(opt32, tbatch)
    half16, g_half, _ = port_step(opt16, {k: v[:1] for k, v in tbatch.items()})
    _, f64, _ = float64_step.g_step64(opt32, sd, tbatch, None, nets, EXTRA)
    _, f64_own, _ = float64_step.g_step64(opt16, sd, tbatch, None, nets, EXTRA,
                                          branches=branches16)
    witnesses = {"f64": f64, "jax32": jax_steps["jax32"]["grads"], "f64_port_branches": f64_own}
    steps = {"jax16": jax_steps["jax16"]["grads"], "port16": g16, "half16": g_half}
    names = {k: list(f64[k]) for k in nets}  # the parameters (JAX's state also has u / v)
    errors = {w: {who: {k: float64_step.rel_err({n: got[k][n] for n in names[k]},
                                                {n: want[k][n].double() for n in names[k]})
                        for k in nets} for who, got in steps.items()}
              for w, want in witnesses.items()}
    jax16 = jax_steps["jax16"]["losses"]
    return {"losses": {who: loss_gate(got, jax16, port32)[1]
                       for who, got in (("port16", port16), ("half16", half16))},
            "errors": errors,
            "blend_grads": {name: blend_term_grads(opt, sd, tbatch)
                            for name, opt in (("port16", opt16), ("port32", opt32))}}


def blend_term_grads(opt, sd, batch):
    """{loss term: the norm of its gradient at netB's output} of the G
    step's losses, from the float32 state dicts `sd`."""
    m = MichiGANModel(opt, "cpu")
    m.load_state_dicts(sd)
    m.netD.requires_grad_(False)
    seen, blend_forward = {}, m.netB.forward

    def forward(*a, **k):
        seen["blend"] = blend_forward(*a, **k)
        return seen["blend"]

    m.netB.forward = forward
    _, losses, _, _ = m.generator_loss(batch, EXTRA)
    return {k: torch.autograd.grad(v, seen["blend"], retain_graph=True)[0].float().norm().item()
            for k, v in losses.items()}


def main(argv=None):
    """Prints default_init_readings of each seed, `--repeats` times."""
    ap = argparse.ArgumentParser(description=default_init_readings.__doc__)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for r in range(args.repeats):
        for seed in map(int, args.seeds.split(",")):
            out = default_init_readings(seed)
            print(f"run {r + 1}, seed {seed}: losses past the gate {out['losses']}")
            for w, errs in out["errors"].items():
                print(f"run {r + 1}, seed {seed}, gradient error against {w}: "
                      + "; ".join(f"{who} " + ", ".join(f"{k} {v:.4g}" for k, v in e.items())
                                  for who, e in errs.items()), flush=True)
            grads = out["blend_grads"]
            print(f"run {r + 1}, seed {seed}, each loss term's gradient at the blend, bf16 / "
                  f"float32: " + ", ".join(f"{k} {v:.4g} / {grads['port32'][k]:.4g}"
                                           for k, v in grads["port16"].items()), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
