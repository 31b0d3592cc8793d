"""The port's serving front end (michigan_tpu_torch.serving) against the JAX
package's (michigan_tpu.serving), on the CPU at crop 64, ngf 8, the
flagship's flags.

- ``InferenceSession`` with buckets (1, 2) at request sizes 1 and 3 (a
  chunk of 2, then one of 1) gives the JAX package's ``InferenceSession``
  output on the JAX package's initial weights carried over by
  ``state_dicts_from_flax``: the image within 2e-3 max abs and the
  inpainted orientation within 1e-3, tests/test_torch_inference.py's
  tolerances (two frameworks' float32 sums in another order);
- padding repeats the last sample (the padded request gives eager
  ``infer``'s images bit for bit, a VAE model's too: the session draws eps
  as an eager call of the padded chunk does), and the JAX session's
  ValueErrors are raised;
- ``--inpaint_mode stroke`` is refused, naming the host sync;
- a reloaded checkpoint changes what tells a CUDA session to capture
  again (tests/test_torch_cuda.py serves one on the card);
- the frozen spectral weight equals the recomputed one bit for bit;
- ``export_inference`` -> ``load_exported`` in a process where jax, the JAX
  package and ``michigan_tpu_torch.models`` stay unimported gives eager
  ``infer``'s outputs bit for bit, for the exported checkpoint and for a
  second one passed as state_dicts;
- the kernels' custom ops: their fake implementations give the plain
  versions' shapes and dtypes on CUDA fake tensors, and an eager call on
  CPU tensors takes the plain version.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from michigan_tpu import config
from michigan_tpu.model import MichiGANModel as JModel
from michigan_tpu.serving import InferenceSession as JSession
from michigan_tpu_torch.convert import state_dicts_from_flax
from michigan_tpu_torch.data.synthetic import synthetic_inference_data
from michigan_tpu_torch.inference import parse_options
from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
from michigan_tpu_torch.models.layers import SpectralConv2d, frozen_spectral_weights
from michigan_tpu_torch.ops.cuda import epilogue as E
from michigan_tpu_torch.ops.cuda import spade as K
from michigan_tpu_torch.serving import InferenceSession, export_inference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("--netG spadeb --use_encoder --noise_background --use_ig --expand_mask_be "
         "--expand_th 5 --add_feat_zeros --init_type none --crop_size 64 --load_size 64 "
         "--ngf 8").split()
GEN_TOL, ORIENT_TOL = 2e-3, 1e-3  # tests/test_torch_inference.py's
KEYS = tuple(InferenceSession.BATCH_CHANNELS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_opt(*extra):
    return parse_options(FLAGS + ["--gpu_ids", "-1", *extra])


def request(n, seed=1):
    data = synthetic_inference_data(port_opt(), seed, batch=n)
    return {k: data[k] for k in KEYS}


def seeded_model(seed, *extra):
    model = MichiGANModel(port_opt(*extra), "cpu")
    model.init_weights(seed)
    return model


def eager_nhwc(model, batch):
    image, orient = model.infer(batch_from_numpy(batch, "cpu"))
    return image.permute(0, 2, 3, 1).numpy(), \
        None if orient is None else orient.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def jax_side():
    jopt = config.test_options(FLAGS)
    variables = jax.jit(JModel(jopt).init_variables)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in request(1).items()})
    session = JSession(JModel(jopt), variables, (64, 64), buckets=(1, 2))
    session.precompile()
    return jopt, jax.tree_util.tree_map(np.asarray, variables), session


@pytest.mark.parametrize("n", [1, 3])
def test_session_matches_jax_session(jax_side, n):
    jopt, variables, jsession = jax_side
    model = MichiGANModel(port_opt(), "cpu")
    model.load_state_dicts(state_dicts_from_flax(variables, jopt))
    session = InferenceSession(model, (64, 64), buckets=(1, 2))
    session.precompile()
    batch = request(n)
    image, orient = session.infer(batch)
    want_image, want_orient = jsession.infer(batch)
    assert image.shape == want_image.shape and image.shape[0] == n
    assert image.std() > 1e-2 and np.isfinite(image).all()
    assert np.abs(image - np.asarray(want_image)).max() <= GEN_TOL
    np.testing.assert_allclose(orient, np.asarray(want_orient), rtol=0, atol=ORIENT_TOL)


def test_padding_repeats_the_last_sample():
    """A request of 3 at bucket 4: the chunk's 4th sample is its 3rd, and
    the 3 images are eager infer's of the padded chunk, bit for bit."""
    model = seeded_model(0)
    session = InferenceSession(model, (64, 64), buckets=(4,))
    chunks = []
    fill = session._fill
    session._fill = lambda chunk, part: fill(chunk, part) or chunks.append(chunk)
    batch = request(3)
    image, orient = session.infer(batch)
    (chunk,) = chunks
    assert all(np.array_equal(chunk[k][3], chunk[k][2]) and np.array_equal(chunk[k][:3],
                                                                            batch[k])
               for k in KEYS)
    want_image, want_orient = eager_nhwc(model, chunk)
    np.testing.assert_array_equal(image, want_image[:3])
    np.testing.assert_array_equal(orient, want_orient[:3])


def test_vae_session_draws_eps_as_eager_infer():
    """Under --use_vae, each chunk's eps is one draw of the bucket's size
    from the model's eps_gen, as an eager infer of the padded chunk draws
    it: two models of one seed give the same images."""
    extra = ("--use_vae",)
    session = InferenceSession(seeded_model(0, *extra), (64, 64), buckets=(2,))
    eager = seeded_model(0, *extra)
    batch = request(3)
    image, _ = session.infer(batch)
    padded = {k: np.concatenate([v, v[-1:]]) for k, v in batch.items()}
    first, _ = eager_nhwc(eager, {k: v[:2] for k, v in padded.items()})
    second, _ = eager_nhwc(eager, {k: v[2:] for k, v in padded.items()})
    np.testing.assert_array_equal(image, np.concatenate([first, second[:1]]))


def test_session_sees_a_reloaded_checkpoint():
    """What tells a CUDA session its graphs are stale (they read the nets'
    tensors in place, and the frozen W / sigma and SPADE's gamma / beta
    computed from them at capture): the storage and versions of every
    parameter and buffer change with load_state_dicts, and not with infer.
    The CPU session serves the reloaded checkpoint as eager infer does."""
    model, other = seeded_model(0), seeded_model(1)
    session = InferenceSession(model, (64, 64), buckets=(1, 2))
    assert len(session._tensors) == sum(
        len(list(net.parameters())) + len(list(net.buffers())) for net in model.nets().values())
    key = session._weights_key()
    batch = request(1)
    session.infer(batch)
    assert session._weights_key() == key
    model.load_state_dicts({k: net.state_dict() for k, net in other.nets().items()})
    assert session._weights_key() != key
    image, orient = session.infer(batch)
    want_image, want_orient = eager_nhwc(other, batch)
    np.testing.assert_array_equal(image, want_image)
    np.testing.assert_array_equal(orient, want_orient)


def test_session_errors():
    model = seeded_model(0)
    with pytest.raises(ValueError, match="buckets must be positive"):
        InferenceSession(model, (64, 64), buckets=(0, 2))
    session = InferenceSession(model, (64, 64), buckets=(1, 2))
    batch = request(2)
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        session.infer({**batch, "noise": batch["noise"][:1]})
    with pytest.raises(ValueError, match="lacks"):
        session.infer({k: v for k, v in batch.items() if k != "hole"})
    with pytest.raises(ValueError, match="expected"):
        session.infer({**batch, "hole": batch["hole"][:, :32]})


def test_stroke_mode_is_refused():
    model = MichiGANModel(port_opt("--use_stroke", "--inpaint_mode", "stroke"), "cpu")
    with pytest.raises(ValueError, match=r"stroke.*model\.py:255"):
        InferenceSession(model, (64, 64))


def test_frozen_spectral_weight_equals_the_recomputed_one():
    model = seeded_model(0)
    convs = [m for net in model.nets().values() for m in net.modules()
             if isinstance(m, SpectralConv2d)]
    assert len(convs) > 10
    want = [m.weight() for m in convs]
    keys = {k: list(net.state_dict()) for k, net in model.nets().items()}
    with frozen_spectral_weights(*model.nets().values()) as frozen:
        assert all(torch.equal(f, w) and m.weight() is f
                   for f, w, m in zip(frozen, want, convs))
    assert all(m.weight_frozen is None and torch.equal(m.weight(), w)
               for m, w in zip(convs, want))
    assert keys == {k: list(net.state_dict()) for k, net in model.nets().items()}


LOAD_EXPORTED = """
import sys
for name in ("jax", "jaxlib", "flax", "michigan_tpu"):
    sys.modules[name] = None
import torch
from michigan_tpu_torch.serving import load_exported
torch.set_num_threads(1)  # the sums of the eager calls it is held to
fn = load_exported(sys.argv[1])
got = {}
for name in ("first", "second"):
    state_dicts, batch = torch.load(sys.argv[2] + "/" + name + ".pt")
    got[name] = fn(state_dicts, batch)
leaked = sorted(m for m in sys.modules if m == "michigan_tpu_torch.models"
                or m.startswith(("michigan_tpu_torch.models.", "michigan_tpu_torch.model")))
assert not leaked, leaked
torch.save(got, sys.argv[2] + "/got.pt")
print("ok")
"""


def test_exported_program_serves_any_checkpoint(tmp_path):
    """The program exported from one checkpoint, loaded where only torch
    and the kernels' ops are imported, gives eager infer's outputs for that
    checkpoint and, from its state_dicts, for another."""
    models = {"first": seeded_model(0), "second": seeded_model(1)}
    batch = batch_from_numpy(request(1), "cpu")
    path = str(tmp_path / "infer.pt2")
    exported = export_inference(models["first"], batch, path)
    assert not os.path.exists(path + ".tmp.pt2")
    ops = [str(n.target) for n in exported.graph.nodes if "michigan_tpu_torch" in str(n.target)]
    assert sum("spade_modulate" in o for o in ops) == 18
    assert sum("fused_instance_norm" in o for o in ops) == 29
    want = {}
    for name, model in models.items():
        torch.save(({k: net.state_dict() for k, net in model.nets().items()}, batch),
                   tmp_path / f"{name}.pt")
        want[name] = model.infer(batch)
    proc = subprocess.run([sys.executable, "-c", LOAD_EXPORTED, path, str(tmp_path)],
                          cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), \
        proc.stdout + proc.stderr
    got = torch.load(tmp_path / "got.pt")
    for name in models:
        for g, w in zip(got[name], want[name]):
            assert torch.equal(g, w), name
    assert not torch.equal(want["first"][0], want["second"][0])


FAKE_CASES = {
    "spade_modulate": lambda t, d: (
        t((2, 8, 5, 5), d), t((8,), torch.float32), t((8,), torch.float32),
        t((2, 8, 5, 5), d), t((2, 8, 5, 5), d)),
    "fused_instance_norm": lambda t, d: (t((2, 8, 5, 5), d), t((2, 8, 5, 5), d),
                                         t((2, 8, 5, 5), d), 1e-5, "lrelu"),
    "conv3x3_in_act": lambda t, d: (t((2, 6, 11, 9), d), t((4, 6, 3, 3), torch.float32),
                                    t((4,), torch.float32), 2, "relu", 1e-5,
                                    t((2, 4, 7, 5), d)),
}
PLAIN = {"spade_modulate": K.spade_modulate_plain,
         "fused_instance_norm": K.fused_instance_norm_plain,
         "conv3x3_in_act": E.conv3x3_in_act_plain}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FAKE_CASES))
def test_custom_ops_fake_impls_give_the_plain_shapes(name, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def real(shape, d):
        return torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(d)

    want = PLAIN[name](*FAKE_CASES[name](real, dtype))
    op = getattr(torch.ops.michigan_tpu_torch, name)
    with FakeTensorMode():
        got = op(*FAKE_CASES[name](lambda s, d: torch.empty(s, dtype=d, device="cuda"), dtype))
    assert (got.shape, got.dtype, got.device.type) == (want.shape, want.dtype, "cuda")
    # an eager call on CPU tensors is the plain version (with autograd)
    wrapper = {"spade_modulate": K.spade_modulate, "fused_instance_norm": K.fused_instance_norm,
               "conv3x3_in_act": E.conv3x3_in_act}[name]
    assert torch.equal(wrapper(*FAKE_CASES[name](real, dtype)), want)
