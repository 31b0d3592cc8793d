"""Data-parallel training of the port (michigan_tpu_torch/parallel) on the
CPU: gloo, two ranks spawned from the test (rank bodies in
tests/test_torch_parallel_ranks.py), each with one torch thread, a
process-group timeout and a join timeout of at most 120 s.

(a) batch_norm_train with a group, float32 and the bf16 Function: forward,
    dx and running statistics of 2 ranks x half the batch against the JAX
    package's batch_norm_train with axis_name under shard_map over 2 of
    conftest's virtual CPU devices (float32 rtol 1e-5; bf16 the bf16
    kernels' atol 1e-2, rtol 1.6e-2);
(b) one paired G+D step on 2 ranks at tests/test_data_parallel.py's tiny
    config (crop 64, ngf 8, no IG; the DoG bank, whose confidence is live
    at this crop) on synthetic hair ellipses, against the
    port's one-process step at the global batch on the same objective
    (tools/replica_objective.py: ORIENT and CONFIDENCE are the means of each
    replica's values, as in the JAX package) within rtol 1e-5 per loss,
    the D step from the one-process netG after its G step, parameters by
    the scale-aware rule of tests/test_training.py, the two ranks bit for
    bit equal; (b') the same step with the norms' group removed (each
    replica's own batch statistics) fails that rule;
(c) --bf16_grad_allreduce: the ranks' mean is the JAX package's
    _grad_pmean rounding applied on the host to the two ranks' gradients,
    and differs from the float32 mean;
(d) BatchLoader(shard=(r, 2)) against the JAX package's
    create_dataloader(shard=(r, 2)), sample for sample, and the shards
    concatenated against the unsharded stream;
(e) the trainer CLI under torchrun with two CPU ranks: two steps, one
    writer, a resume on both ranks, and the inference CLI on the
    checkpoint;
(f) (slow tier) the 2-rank step against the JAX package's
    make_train_steps(opt, mesh=make_mesh("data:2")).
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import test_torch_parallel_ranks as R
from michigan_tpu.parallel.mesh import make_mesh
from michigan_tpu_torch.parallel import dist as DP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 120
LOSS_RTOL = 1e-5
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)


def scale_aware(got: dict, want: dict, max_lr: float):
    """tests/test_training.py:212-247's rule: (passes, max diff, elements
    beyond float noise, elements); every element within 2.5 max_lr, at most
    0.1% of them (or 8) beyond 1e-4 relative + 1e-5."""
    worst, n_bad, n_tot = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        worst = max(worst, d.max().item())
        n_bad += int((d > 1e-4 * w.double().abs() + 1e-5).sum())
        n_tot += d.numel()
    return worst <= 2.5 * max_lr and n_bad <= max(1e-3 * n_tot, 8), worst, n_bad, n_tot


def step_rule(got, want, opt):
    """(b)'s rule: (passes, failing parts)."""
    bad = [k for k, v in want["losses"].items()
           if abs(got["losses"][k] - v) > LOSS_RTOL * abs(v) + 1e-7]
    for net, lr in (("netG", opt.lr / 2), ("netD", 2 * opt.lr)):
        if not scale_aware(got["params"][net], want["params"][net], lr)[0]:
            bad.append(net)
    if not scale_aware(got["buffers"], {k: v for k, v in want["buffers"].items()
                                        if v.is_floating_point()}, opt.lr / 2)[0]:
        bad.append("netG buffers")
    return not bad, bad


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(a)-(c)'s two ranks, their inputs, and the one-process references."""
    out = str(tmp_path_factory.mktemp("ranks"))
    rng = np.random.default_rng(0)
    bn = {"x": rng.normal(0.5, 2.0, (4, 5, 6, 3)).astype(np.float32),
          "w": rng.normal(0.0, 1.0, (4, 5, 6, 3)).astype(np.float32)}
    np.savez(os.path.join(out, "bn.npz"), **bn)
    opt = R.tiny_opt()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = R.tiny_batch(opt)
        ref = R.one_step(opt, data, world=2)
        global_batch = R.one_step(opt, data, post_g=ref["post_g"])
    finally:
        torch.set_num_threads(threads)
    torch.save(ref["post_g"], os.path.join(out, "post_g.pt"))
    DP.launch(R.norms_and_step, (out,), 2, timeout=JOIN_TIMEOUT)
    got = [torch.load(os.path.join(out, f"ranks{r}.pt")) for r in range(2)]
    return dict(bn=bn, got=got, opt=opt, ref=ref, global_batch=global_batch)


def jax_bn(x, w, dtype):
    """JAX's batch_norm_train with axis_name 'data' over 2 devices: (y, dx,
    running mean, running var), NHWC."""
    from michigan_tpu.ops.norms import batch_norm_train

    mesh = make_mesh("data:2", jax.devices()[:2])
    c = x.shape[-1]

    def body(xs, ws):
        rm, rv = jnp.zeros(c), jnp.ones(c)
        f = lambda xx: batch_norm_train(xx, rm, rv, axis_name="data")
        (y, m, v), vjp = jax.vjp(f, xs)
        dx = vjp((ws, jnp.zeros_like(m), jnp.zeros_like(v)))[0]
        return y, dx, m, v

    run = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                    out_specs=(P("data"), P("data"), P(), P()), check_rep=False)
    return [np.asarray(jnp.asarray(t, jnp.float32))
            for t in jax.jit(run)(jnp.asarray(x, dtype), jnp.asarray(w, dtype))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_batch_norm_matches_jax_psum(ranks, dtype):
    y, dx, rm, rv = jax_bn(ranks["bn"]["x"], ranks["bn"]["w"], getattr(jnp, dtype))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else BF16_TOL
    key = str(getattr(torch, dtype))
    nchw = lambda t: t.permute(0, 2, 3, 1).numpy()
    got = [r[key] for r in ranks["got"]]
    np.testing.assert_allclose(np.concatenate([nchw(g["y"]) for g in got]), y, **tol)
    np.testing.assert_allclose(np.concatenate([nchw(g["dx"]) for g in got]), dx, **tol)
    for g in got:  # the running statistics are the global batch's on every rank
        np.testing.assert_allclose(g["rm"].numpy(), rm, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["rv"].numpy(), rv, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[0]["rm"], got[1]["rm"]) and torch.equal(got[0]["rv"], got[1]["rv"])


def test_two_rank_step_matches_one_process(ranks):
    ok, bad = step_rule(ranks["got"][0]["step"], ranks["ref"], ranks["opt"])
    assert ok, f"the 2-rank step differs from the one-process step in {bad}"


@pytest.mark.parametrize("part", ["params", "buffers"])
def test_ranks_stay_bit_identical(ranks, part):
    a, b = (r["step"][part] for r in ranks["got"])
    flat = a if part == "buffers" else {f"{n}.{k}": v for n in a for k, v in a[n].items()}
    other = b if part == "buffers" else {f"{n}.{k}": v for n in b for k, v in b[n].items()}
    assert flat.keys() == other.keys()
    assert all(torch.equal(flat[k], other[k]) for k in flat)
    assert ranks["got"][0]["step"]["losses"] == ranks["got"][1]["step"]["losses"]


def test_orientation_terms_are_the_mean_of_the_replicas_values(ranks):
    """The JAX package's semantics: each replica's ORIENT and CONFIDENCE
    (under the DoG bank, taken over the replica's own hair and confidence
    maximum) averaged; on these slices they are not the global batch's
    values, which the other terms are."""
    got = ranks["got"][0]["step"]["losses"]
    ref, glob = ranks["ref"]["losses"], ranks["global_batch"]["losses"]
    for k in ("ORIENT", "CONFIDENCE"):
        assert abs(got[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), k
        assert abs(glob[k] - ref[k]) > 1e-3 * abs(ref[k]), k
    for k in ("GAN", "VGG", "style", "lab"):
        assert abs(glob[k] - ref[k]) <= LOSS_RTOL * abs(ref[k]), k


def test_local_statistics_control_fails_the_rule(ranks):
    ok, bad = step_rule(ranks["got"][0]["control"], ranks["ref"], ranks["opt"])
    assert not ok
    assert "netG buffers" in bad


def test_bf16_grad_allreduce_follows_jax_rounding(ranks):
    """_grad_pmean under --bf16_grad_allreduce: grads cast to bfloat16,
    pmean in bfloat16, cast back to float32."""
    local = [jnp.asarray(r["grads"]["local"].numpy()) for r in ranks["got"]]
    want = np.asarray(((local[0].astype(jnp.bfloat16) + local[1].astype(jnp.bfloat16))
                       / 2).astype(jnp.float32))
    for r in ranks["got"]:
        np.testing.assert_array_equal(r["grads"]["mean"].numpy(), want)
    fp32 = (ranks["got"][0]["grads"]["local"] + ranks["got"][1]["grads"]["local"]) / 2
    assert not torch.equal(fp32, ranks["got"][0]["grads"]["mean"])
    # one bf16 rounding of the sum: within bf16's precision of the float32 mean as a whole
    assert (ranks["got"][0]["grads"]["mean"] - fp32).norm() <= 1e-2 * fp32.norm()


def test_launch_terminates_a_hung_rank_and_reports_a_failed_one():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="still running"):
        DP.launch(time.sleep, (600,), 2, timeout=3)
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="exited with code"):
        DP.launch(os._exit, (3,), 2, timeout=JOIN_TIMEOUT)


def test_mesh_shape_backends_and_missing_gpus_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="spatial"):
        DP.data_axis_size("data:2,model:2")
    assert DP.data_axis_size("data:-1") == -1 and DP.data_axis_size("data:4") == 4
    assert DP.backend_for(torch.device("cpu")) == "gloo"
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs NCCL"):
        DP.backend_for(torch.device("cuda:0"))
    from michigan_tpu_torch.train import main

    with pytest.raises(RuntimeError, match="asks for GPU 1"):
        main(["--gpu_ids", "0,1", "--name", "never"])


@pytest.fixture
def tiny_dataset(tmp_path):
    """tests/test_multihost_data.py's eight 32^2 samples."""
    from PIL import Image

    base = tmp_path / "ds"
    rng = np.random.default_rng(0)
    for sub in ("train_labels", "train_images", "train_dense_orients"):
        (base / sub).mkdir(parents=True)
    for i in range(8):
        name = f"{i:05d}"
        Image.fromarray((rng.integers(0, 2, (32, 32))).astype(np.uint8), "L").save(
            base / "train_labels" / f"{name}.png")
        Image.fromarray(rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)).save(
            base / "train_images" / f"{name}.jpg")
        Image.fromarray(rng.integers(0, 255, (32, 32)).astype(np.uint8), "L").save(
            base / "train_dense_orients" / f"{name}.png")
    return str(base)


def test_loader_shards_match_jax_and_the_unsharded_stream(tiny_dataset):
    """The JAX loader (its native noise pyramid, which the port's loader
    draws too) ships uint8 planes and no ref planes in the paired stage:
    decoded, each sample equals the port's."""
    from michigan_tpu import config as jax_config
    from michigan_tpu.data import dataset as jax_dataset
    from michigan_tpu_torch.config import Options
    from michigan_tpu_torch.data.dataset import BatchLoader, CustomDataset

    kw = dict(isTrain=True, crop_size=32, load_size=32, batchSize=4, use_ig=True, nThreads=1,
              data_dir=tiny_dataset, preprocess_mode="resize_and_crop")
    port_opt, jax_opt = Options(**kw).finalize(), jax_config.Options(**kw).finalize()
    whole = list(BatchLoader(CustomDataset(port_opt), port_opt))
    shards = [list(BatchLoader(CustomDataset(port_opt), port_opt, (r, 2))) for r in range(2)]
    assert len(whole) == 2 and all(len(s) == 2 for s in shards)
    for r, shard in enumerate(shards):
        theirs = list(jax_dataset.create_dataloader(jax_opt, shard=(r, 2)))
        for mine, want in zip(shard, theirs):
            for k, v in mine.items():
                w = want[{"label_ref": "label_tag", "image_ref": "image_tag"}.get(k, k)]
                w = w / 127.5 - 1.0 if k.startswith("image") else w.astype(np.float32)
                np.testing.assert_allclose(v, w, rtol=0, atol=1e-5, err_msg=f"rank {r} {k}")
    for g, a, b in zip(whole, *shards):
        for k in g:
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), g[k])
    with pytest.raises(ValueError, match="must divide"):
        BatchLoader(CustomDataset(port_opt), port_opt, (0, 3))


BLOCK_JAX = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "michigan_tpu"):
    sys.modules[name] = None
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("michigan_tpu_torch.train", run_name="__main__")
print("ok")
"""


def run_bounded(cmd, cwd, timeout=JOIN_TIMEOUT):
    """Run `cmd` in a session of its own; on the timeout kill the whole
    session (torchrun and its ranks) and fail."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{cmd[:4]} ran past {timeout} s")
    assert proc.returncode == 0, out
    return out


def test_trainer_cli_under_torchrun_two_cpu_ranks(tmp_path):
    demo = os.path.join(REPO, "datasets", "FFHQ_demo")
    script = tmp_path / "train_blocked.py"
    script.write_text(BLOCK_JAX)
    ck = str(tmp_path / "ck")
    flags = ["--gpu_ids", "-1", "--name", "dp", "--netG", "spadeb", "--use_encoder",
             "--use_ig", "--noise_background", "--random_expand_mask", "--ngf", "8", "--ndf",
             "8", "--crop_size", "64", "--load_size", "64", "--batchSize", "2", "--nThreads",
             "1", "--print_freq", "2", "--checkpoints_dir", ck,
             "--label_dir", os.path.join(demo, "labels"),
             "--image_dir", os.path.join(demo, "images"),
             "--orient_dir", os.path.join(demo, "orients")]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", str(script)]
    first = run_bounded(torchrun + flags + ["--niter", "2"], tmp_path)
    assert "data parallel: 2 replicas, global batch 2, 1 a replica" in first
    assert first.count("(epoch: ") == 2 and first.count("Training was successfully") == 1
    assert first.count("ok") == 2  # both ranks ran to the end without jax
    run_dir = tmp_path / "ck" / "dp"
    for f in ("2_net_G.pth", "latest_net_D.pth", "latest_optim.pth", "iter.txt", "opt.json"):
        assert (run_dir / f).exists(), f
    log = (run_dir / "loss_log.txt").read_text().splitlines()
    # rank 0 alone: the visualizer's one header and the two printed steps
    assert len(log) == 3 and sum(line.startswith("(epoch: ") for line in log) == 2
    second = run_bounded(torchrun + flags + ["--niter", "3", "--continue_train"], tmp_path)
    assert second.count("resumed checkpoint 'latest'") == 1
    assert "(epoch: 3, iters: 2" in second and "(epoch: 1," not in second
    assert (run_dir / "3_net_G.pth").exists()
    run_bounded([sys.executable, "-m", "michigan_tpu_torch.inference", "--gpu_ids", "-1",
                 "--checkpoints_dir", ck, "--name", "dp", "--which_epoch", "latest",
                 "--netG", "spadeb", "--use_encoder", "--noise_background", "--use_ig",
                 "--ngf", "8", "--crop_size", "64", "--load_size", "64",
                 "--data_dir", os.path.join(REPO, "datasets", "FFHQ_single")], tmp_path)
    assert (tmp_path / "inference_samples" / "inpaint_fake_image.jpg").exists()


@pytest.mark.slow
def test_two_rank_step_matches_jax_data_mesh(tmp_path):
    """The JAX package's sharded G step then D step over make_mesh("data:2")
    against the port's two ranks, from JAX's initial variables (jitting the
    JAX step takes minutes: slow tier).  Losses rtol 1e-4 (CONFIDENCE too:
    both average the replicas' ratios), parameters by the scale-aware rule."""
    from michigan_tpu.config import Options as JaxOptions
    from michigan_tpu.training.state import TrainState
    from michigan_tpu.training.train_step import make_train_steps
    from michigan_tpu_torch.convert import state_dicts_from_flax

    kw = dict(isTrain=True, crop_size=64, load_size=64, ngf=8, ndf=8, batchSize=R.GLOBAL_BATCH,
              use_encoder=True, use_ig=False, noise_background=True,
              num_upsampling_layers="normal", donate_buffers=False, orient_filter="dog")
    jopt = JaxOptions(**kw).finalize()
    popt = R.tiny_opt()
    data = R.tiny_batch(popt)
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    extra = jnp.asarray(1, jnp.int32)
    rng = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MICHIGAN_FILTERBANK", "direct")
        model, g_step, d_step = make_train_steps(jopt, mesh=make_mesh("data:2",
                                                                      jax.devices()[:2]))
        variables = model.init_variables(rng, batch)
        state = TrainState.create(jopt, variables)
        state, g_losses, _fake, orient = g_step(state, batch, rng, extra)
        state, d_losses = d_step(state, batch, rng, extra, orient=orient)
    init = state_dicts_from_flax(jax.tree_util.tree_map(np.asarray, variables), jopt)
    after = state_dicts_from_flax(jax.tree_util.tree_map(np.asarray, state.variables), jopt)
    torch.save(init, tmp_path / "init.pt")
    DP.launch(R.step_from_states, (str(tmp_path),), 2, timeout=JOIN_TIMEOUT)
    got = torch.load(tmp_path / "from_states0.pt")
    want = {**{k: float(v) for k, v in g_losses.items()},
            **{k: float(v) for k, v in d_losses.items()}}
    for k, v in want.items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    for net, lr in (("netG", popt.lr / 2), ("netD", 2 * popt.lr)):
        names = set(got["params"][net])
        ok, worst, n_bad, n_tot = scale_aware(
            got["params"][net], {k: v for k, v in after[net].items() if k in names}, lr)
        assert ok, (net, worst, n_bad, n_tot)


