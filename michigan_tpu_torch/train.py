"""Training CLI of the port (counterpart of train.py, reference train.py).

    python -m michigan_tpu_torch.train --name MichiGAN --gpu_ids 0 \
        --netG spadeb --use_encoder --use_ig --noise_background \
        --expand_mask_be --expand_th 5 --random_expand_mask \
        --num_upsampling_layers more --batchSize 8 --data_dir <dir>

Same flags as the JAX CLI (the port's config.train_options), with the VAE
(--use_vae), the blender (--use_blender, --hair_random_disturb) and the
unpaired two-stage schedule (--unpairTrain [--same_netD_model]: each epoch
a pass of the unpaired stage, training netD2, then one of the paired stage,
training netD), under either dtype.  <dir> holds
train_images/, train_labels/ and train_dense_orients/ (or point --image_dir,
--label_dir and --orient_dir at them).  The device comes from --gpu_ids: -1
is the CPU, N is cuda:N; fp32 with TF32 off, or --dtype bfloat16 (the bf16
compute policy: bf16 convolutions on float32 parameters, the frozen IG and
VGG19 stored in bf16; checkpoints hold float32 netG, netD and Adam state
either way, so a run resumes under either dtype; netE, netB and netD2 are
saved beside them as <label>_net_E / _net_B / _net_D2.pth).  netIG comes from
checkpoints/<name>/InpaintingModel_gen.pth when present, VGG19 from
$MICHIGAN_VGG19 or checkpoints/vgg19*.{pth,npz}; otherwise seeded weights.

Data parallelism, one process per GPU (the JAX package's data mesh;
parallel/dist.py): several --gpu_ids (``--gpu_ids 0,1,2,3``) start one
process per id on this host; under torchrun (``torchrun --nproc_per_node N
-m michigan_tpu_torch.train --gpu_ids 0,...,N-1 ...``, also across hosts,
where --multihost is accepted) each rank takes cuda:<gpu_ids[LOCAL_RANK]>,
or the CPU with gloo under --gpu_ids -1.  --batchSize is the global batch:
each rank loads and steps on its batchSize / world slice; netG's sync batch
norms, the gradients (--bf16_grad_allreduce: in bfloat16) and the printed
losses are reduced over the ranks; --mesh_shape takes data:-1 or data:N
for this, and space:N for row bands (below).
Every rank seeds the same weights and host RNG; rank 0 alone prints and
writes opt.json, loss_log.txt, iter.txt and the checkpoints.  With one
process nothing is reduced.

Spatial sharding of training (parallel/spatial.py): --mesh_shape space:N
(or data:1,space:N) makes the N processes one spatial group, which trains
in row bands: every rank loads the same --batchSize samples (the loader's
shard is the data axis alone) and steps on its band of their rows, the
fp32 paired stage with every default loss; gradients and losses are summed
over the group, and rank 0's checkpoints are one process's.  The data x
space grid (data:M,space:N with M > 1) and --dtype bfloat16 in bands raise
NotImplementedError: they are the next slice.

The loop follows the JAX trainer: epochs with the linear LR decay,
--max_steps, the mask dilation width drawn per step from a host RNG seeded
by --seed, losses printed every --print_freq images (and appended to
checkpoints/<name>/loss_log.txt), 'latest' saved every --save_latest_freq
images and at the end of each epoch, each --save_epoch_freq epoch saved
under its number, --continue_train resuming from --which_epoch and iter.txt.
--debug_nans checks every loss of every step for a finite value (a host
sync per step); --profile_dir writes a torch.profiler trace of rank 0's
step at 3 * --batchSize samples there (trace.json, for chrome://tracing or
Perfetto).  Rank 0 logs through utils/visualizer.py as the JAX trainer
does: the printed losses to loss_log.txt and scalars.jsonl (with the
epoch's wall img/s), every --stats_freq samples the diagnostics of
training/diagnostics.py to scalars.jsonl, and every --display_freq samples
the first sample's labels, images and fake to the HTML gallery under
checkpoints/<name>/web/ (--no_html: none; --tf_log: TensorBoard too).
"""

from __future__ import annotations

import contextlib
import math
import os
import random
import sys
import time


def parse_options(argv=None):
    from michigan_tpu_torch.config import train_options

    return train_options(argv)


@contextlib.contextmanager
def profiled_step(profile_dir: str, device):
    """One step under torch.profiler (host and, on a card, device
    activity); its trace goes to <profile_dir>/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def check_finite(losses: dict, step: int) -> None:
    """--debug_nans: raise naming the first non-finite loss and the step
    (samples seen so far), as the JAX trainer's assertion does."""
    for k, v in losses.items():
        val = float(v)
        if not math.isfinite(val):
            raise FloatingPointError(f"non-finite loss {k}={val} at step {step}")


def load_released_ig(model, opt, print_=print) -> None:
    from michigan_tpu_torch.convert import load_reference_state

    path = os.path.join(opt.checkpoints_dir, opt.name, opt.ig_model_name)
    if model.netIG is not None and os.path.exists(path):
        import torch

        state = torch.load(path, map_location="cpu", weights_only=True)
        load_reference_state(model.netIG, state.get("generator", state))
        model.to_device()
        print_(f"loaded netIG from {path}")


def main(argv=None):
    import torch

    from michigan_tpu_torch.parallel import dist as DP

    argv = sys.argv[1:] if argv is None else list(argv)
    opt = parse_options(argv)
    ids = DP.gpu_id_list(opt.gpu_ids)
    if len(ids) > 1 and not DP.in_launched_process():
        # the reference's --gpu_ids 0,1,2,3: one process per id on this host
        DP.check_gpus(ids)
        DP.launch(main, (argv,), len(ids))
        return
    replica = DP.replica_from_env(opt.gpu_ids, opt.mesh_shape)
    try:
        train(opt, replica)
    finally:
        if replica.group is not None:
            torch.distributed.destroy_process_group()


def train(opt, replica) -> None:
    """The training loop on this process's `replica` (parallel/dist.py)."""
    import torch

    from michigan_tpu_torch.data.dataset import BatchLoader, CustomDataset
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.training import checkpoint as CK
    from michigan_tpu_torch.training.state import (
        check_replicas,
        init_netd2_from_netd,
        set_learning_rates,
    )
    from michigan_tpu_torch.training.diagnostics import diagnostics
    from michigan_tpu_torch.training.train_step import TrainStep
    from michigan_tpu_torch.utils.iter_counter import IterationCounter
    from michigan_tpu_torch.utils.visualizer import Visualizer

    from michigan_tpu_torch.parallel import spatial
    from michigan_tpu_torch.parallel.dist import mesh_axes

    main_rank = replica.is_main()
    print_ = print if main_rank else (lambda *a, **k: None)
    print_(" ".join(sys.argv))
    # --mesh_shape space:N: the processes are one spatial group, no replicas
    space = spatial.Space(replica.group, replica.rank, replica.world, replica.device) \
        if mesh_axes(opt.mesh_shape)[1] > 1 else None
    if space is not None:
        print_(f"spatial sharding: {space.world} ranks, each {opt.crop_size // space.world} rows "
               f"of the crop; batch {opt.batchSize} on every rank")
    elif replica.world > 1:
        print_(f"data parallel: {replica.world} replicas, global batch {opt.batchSize}, "
               f"{opt.batchSize // replica.world} a replica")
    device = replica.device
    if device.type == "cuda":
        # cuDNN's fp32 convolutions default to TF32; keep full fp32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if main_rank:
        opt.save(os.path.join(opt.checkpoints_dir, opt.name, "opt.json"))

    shard = (0, 1) if space is not None else (replica.rank, replica.world)
    loader = BatchLoader(CustomDataset(opt), opt, shard)
    if len(loader) == 0:
        raise ValueError(f"the dataset at {opt.data_dir} yields no full batch of {opt.batchSize}")
    # --unpairTrain: every epoch runs the unpaired stage over its own loader
    # first, then the paired stage (reference train.py:42-90)
    loader2 = BatchLoader(CustomDataset(opt, 2), opt, shard) if opt.unpairTrain else None
    model = MichiGANModel(opt, device, None if space is not None else replica.group)
    model.init_weights(opt.seed)
    if opt.unpairTrain and opt.same_netD_model:
        init_netd2_from_netd(model)
    load_released_ig(model, opt, print_)
    trainer = TrainStep(model, space)
    iter_counter = IterationCounter(opt, len(loader) * opt.batchSize, main=main_rank)
    if opt.continue_train and CK.load_checkpoint(opt, opt.which_epoch, trainer):
        print_(f"resumed checkpoint '{opt.which_epoch}'")
    check_replicas(model, trainer.ranks_group)
    visualizer = Visualizer(opt) if main_rank else None
    host_rng = random.Random(opt.seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def save_latest():
        CK.save_checkpoint(opt, "latest", trainer)
        iter_counter.record_current_iter()

    def run_epoch(epoch, data_loader, curr_step) -> bool:
        """One pass of `data_loader` in stage `curr_step`; True at --max_steps."""
        opt.curr_step = curr_step
        iter_counter.record_epoch_start(epoch)
        t0, steps, stop = None, 0, False
        for i, data in enumerate(data_loader):
            if opt.max_steps and iter_counter.total_steps_so_far // opt.batchSize >= opt.max_steps:
                stop = True
                break
            iter_counter.record_one_iteration()
            batch = batch_from_numpy(data, device) if space is None else \
                spatial.shard_batch(batch_from_numpy(data, "cpu"), space)
            # the random mask dilation width (encoder.py:294): 0..4 extra 3x3 steps
            extra = host_rng.randint(0, 4)
            # one draw of the VAE's noise a step, for its G step and D step
            eps = trainer.new_eps(opt.batchSize // (1 if space is not None else replica.world))
            g_losses, d_losses, orient, fake = {}, {}, None, None
            # the step at 3 * batchSize samples, past the first steps' warm-up
            profiling = bool(opt.profile_dir) and main_rank and \
                iter_counter.total_steps_so_far == 3 * opt.batchSize
            with profiled_step(opt.profile_dir, device) if profiling else contextlib.nullcontext():
                if i % opt.D_steps_per_G == 0:
                    g_losses, fake, orient = trainer.g_step(batch, extra, eps)
                if i % opt.G_steps_per_D == 0 and not opt.no_discriminator:
                    d_losses = trainer.d_step(batch, extra, orient, eps, fake)
            if opt.debug_nans:
                check_finite({**g_losses, **d_losses}, iter_counter.total_steps_so_far)
            if t0 is None:
                sync()
                t0 = time.perf_counter()  # the first step's build and warm-up off the clock
            else:
                steps += 1
            step = iter_counter.total_steps_so_far
            if visualizer is not None and iter_counter.needs_printing():
                losses = {k: v.item() for k, v in {**g_losses, **d_losses}.items()}
                visualizer.print_current_errors(epoch, iter_counter.epoch_iter, losses,
                                                iter_counter.time_per_iter)
                visualizer.plot_current_errors(losses, step)
            if visualizer is not None and iter_counter._trigger(opt.stats_freq):
                visualizer.plot_current_errors(diagnostics(model), step)
            if visualizer is not None and iter_counter.needs_displaying() and fake is not None:
                visualizer.display_current_results({
                    "input_ref": data.get("label_ref", data["label_tag"])[0],
                    "input_tag": data["label_tag"][0],
                    "synthesized_image": fake[0].permute(1, 2, 0).float().cpu().numpy(),
                    "image_ref": data.get("image_ref", data["image_tag"])[0],
                    "image_tag": data["image_tag"][0]}, epoch, step)
            if iter_counter.needs_saving():
                print_(f"saving the latest model (epoch {epoch}, "
                       f"total_steps {iter_counter.total_steps_so_far})")
                save_latest()
        if steps:
            sync()
            dt = time.perf_counter() - t0
            rate = steps * opt.batchSize / dt
            print_(f"epoch {epoch} (stage {curr_step}) wall throughput: {rate:.2f} img/s "
                   f"over {steps} steps ({dt / steps:.3f} s/step incl. data)")
            if visualizer is not None:
                visualizer.plot_current_errors({"wall_img_per_s": rate},
                                               iter_counter.total_steps_so_far)
        return stop

    for epoch in iter_counter.training_epochs():
        stop = run_epoch(epoch, loader2, 2) if opt.unpairTrain else False
        if not stop:
            stop = run_epoch(epoch, loader, 1)
        if stop:
            print_(f"stopping at --max_steps {opt.max_steps}")
            save_latest()
            break
        set_learning_rates(trainer.optimizers, opt, epoch + 1)
        iter_counter.record_epoch_end()
        if epoch % opt.save_epoch_freq == 0 or epoch == iter_counter.total_epochs:
            print_(f"saving the model at the end of epoch {epoch}, "
                   f"iters {iter_counter.total_steps_so_far}")
            CK.save_checkpoint(opt, "latest", trainer)
            iter_counter.record_current_iter(epoch + 1, 0)
            CK.save_checkpoint(opt, epoch, trainer)
    print_("Training was successfully finished.")


if __name__ == "__main__":
    main()
