"""Shape-bucketed serving session (port of michigan_tpu/serving/session.py).

A request of any batch size is padded up to the nearest configured batch
bucket, by repeating its last sample (never zeros: degenerate all-zero
masks can produce NaNs), and run at that bucket; a batch above the largest
bucket is split into max-bucket chunks.  NHWC numpy in and out, as the JAX
package's session.

On a CUDA model, ``precompile`` captures one CUDA graph of
``MichiGANModel.infer`` per bucket, which the JAX package's session answers
with one AOT-compiled executable per bucket: the forward's ~50 kernel
launches from Python (PERF.md: the bf16 flagship is host-bound) become one
replay.  Each bucket has static input buffers on the card, filled from
pinned host staging, and static outputs copied back through pinned
staging: each request slice is written straight into the staging, its
padding too, and each output slice straight into the answer.  Warm-up runs
on a side stream before capture.  The buckets share one memory pool;
``infer`` replays one graph at a time and waits for it.  A capture that
fails raises: there is no eager fallback on the card.  While capturing,
each spectral conv reads its W / sigma computed once
(``models.layers.frozen_spectral_weights``), which the session keeps, as
it keeps every tensor outside the graphs' pool that they read.

The graphs read the nets' parameters and buffers in place, and what the
session keeps was computed from them.  So ``infer`` compares each
parameter's and buffer's storage and version counter with those at
capture; after a write (``load_state_dicts`` copies in place) or a new
storage (``.to``, ``.data =``) it captures every bucket again
(``recaptures`` counts this), and serves the weights of the moment, as
eager ``infer`` does.  A parameter replaced by another object is not seen:
build a new session then.

On a CPU model, which only tests ask for, each bucket runs ``model.infer``
eagerly with the same padding and splitting.

This package imports the model code only where it runs a model, so that
``load_exported`` needs no more than torch and the kernels' ops.

What a graph cannot hold:
- the stroke branch (``--inpaint_mode stroke``) decides on the host from a
  device scalar (``michigan_tpu_torch/model.py:255``), so the session
  refuses it;
- under --use_vae the eps of z is drawn on the host (``model.draw_eps``);
  the session draws it from the model's ``eps_gen`` outside the graph, one
  draw of the bucket's size per chunk, as an eager ``infer`` of the padded
  chunk draws it, and feeds it as a static input.

The kernels' launch counters (``ops.cuda.launch_counts``) tick when a graph
is captured, not when it replays: ``captured[bucket]`` holds each graph's
launches by kernel (and its capture's seconds, warm-up included), and
``replays`` counts the replays per bucket.
cuDNN's autotuner (``cudnn.benchmark``) stays off, so capture and eager
calls choose the same convolution algorithms.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


class InferenceSession:
    """Shape-bucketed inference front end of one ``MichiGANModel``.

    session = InferenceSession(model, image_shape=(512, 512))
    session.precompile()                       # captures every bucket (card)
    images, orients = session.infer(batch)     # any batch size, numpy in/out
    """

    #: batch -> trailing-channel layout of each model.infer input
    BATCH_CHANNELS: Dict[str, int] = {
        "label_ref": 1, "label_tag": 1, "image_ref": 3, "image_tag": 3,
        "orient": 1, "hole": 1, "orient_rgb": 3, "noise": 3,
    }

    def __init__(self, model, image_shape: Tuple[int, int],
                 buckets: Sequence[int] = (1, 4, 8)):
        opt = model.opt
        if opt.use_ig and "stroke" in opt.inpaint_mode:
            raise ValueError(
                "--inpaint_mode stroke is not served: its two-stage branch decides on the host "
                "from a device scalar (michigan_tpu_torch/model.py:255), which a CUDA graph "
                "cannot capture; serve --inpaint_mode ref")
        self.model = model
        self.image_shape = tuple(image_shape)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive: {buckets!r}")
        self.replays = {b: 0 for b in self.buckets}
        self.recaptures = 0
        self.captured: Dict[int, dict] = {}
        self._graphs: Dict[int, dict] = {}
        self._pool = None
        self._held = []
        # what the graphs read in place, and its storage and versions at capture
        self._tensors = [t for net in model.nets().values()
                         for t in itertools.chain(net.parameters(), net.buffers())]
        self._weights = None

    # ------------------------------------------------------------------

    def _forward(self, inputs: Dict[str, torch.Tensor], eps=None):
        batch = {k: v.permute(0, 3, 1, 2).contiguous() for k, v in inputs.items()}
        return self.model.infer(batch, eps=eps)

    def precompile(self) -> None:
        """Capture every bucket's graph (CUDA model); nothing on the CPU."""
        from michigan_tpu_torch.models.layers import frozen_spectral_weights

        if self.model.device.type != "cuda":
            return
        self._drop_stale()
        todo = [b for b in self.buckets if b not in self._graphs]
        if not todo:
            return
        nets = self.model.nets().values()
        with frozen_spectral_weights(*nets) as frozen:
            for b in todo:
                self._graphs[b] = self._capture(b)
        # what the graphs read outside their pool: the frozen spectral
        # weights and SPADE's concatenated gamma / beta convs
        self._held.append(frozen)
        self._held.append([m._gamma_beta for net in nets for m in net.modules()
                           if getattr(m, "_gamma_beta", None) is not None])
        self._weights = self._weights_key()

    def _drop_stale(self) -> None:
        """Drop every graph once a parameter or buffer changed since capture."""
        if self._graphs and self._weights_key() != self._weights:
            self._graphs.clear()
            self._held.clear()
            self._pool = None
            self.recaptures += 1

    def _weights_key(self) -> tuple:
        """Storage and version counter of every parameter and buffer the
        graphs read (listed once: walking the nets costs ~0.3 ms)."""
        return tuple((t.data_ptr(), t._version) for t in self._tensors)

    def _capture(self, bucket: int) -> dict:
        from michigan_tpu_torch.ops import cuda as kernels

        t0 = time.perf_counter()
        dev = self.model.device
        h, w = self.image_shape
        shape = lambda c: (bucket, h, w, c)
        staging = {k: torch.empty(shape(c), pin_memory=True)
                   for k, c in self.BATCH_CHANNELS.items()}
        static = {k: torch.zeros(shape(c), device=dev) for k, c in self.BATCH_CHANNELS.items()}
        for k in static:  # a valid sample: labels 0, everything else 0.5
            if not k.startswith("label"):
                static[k].fill_(0.5)
        eps = torch.zeros((bucket, 256), device=dev) if self.model.opt.use_vae else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._forward(static, eps)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            image, orient = self._forward(static, eps)
            image = image.permute(0, 2, 3, 1).contiguous()
            orient = None if orient is None else orient.permute(0, 2, 3, 1).contiguous()
        self._pool = graph.pool()
        self.captured[bucket] = {
            "launches": {k: n - before[k] for k, n in kernels.launch_counts().items()},
            "seconds": time.perf_counter() - t0}
        out = {"image": image, "orient": orient}
        return {"graph": graph, "staging": staging, "static": static, "eps": eps, "out": out,
                "out_host": {k: None if v is None else torch.empty(v.shape, pin_memory=True)
                             for k, v in out.items()}}

    def _fill(self, dest: Dict[str, np.ndarray], part: Dict[str, np.ndarray]) -> None:
        """Write each request slice into its bucket-sized `dest`, and pad
        by repeating the slice's last sample."""
        for k, v in part.items():
            dest[k][:len(v)] = v
            dest[k][len(v):] = v[-1]

    def _dispatch(self, bucket: int, part: Dict[str, np.ndarray]):
        """The bucket's (image, orient_rgb) of the request slice `part`, NHWC
        numpy with the padding; on the card, views of the pinned output
        staging, valid until the next replay."""
        model = self.model
        if model.device.type != "cuda":
            from michigan_tpu_torch.model import batch_from_numpy

            chunk = {k: np.empty((bucket,) + v.shape[1:], np.float32) for k, v in part.items()}
            self._fill(chunk, part)
            image, orient = model.infer(batch_from_numpy(chunk, model.device))
            to_np = lambda t: t.permute(0, 2, 3, 1).cpu().numpy()
            return to_np(image), None if orient is None else to_np(orient)
        if bucket not in self._graphs:
            self.precompile()
        g = self._graphs[bucket]
        self._fill({k: t.numpy() for k, t in g["staging"].items()}, part)
        for k, t in g["staging"].items():
            g["static"][k].copy_(t, non_blocking=True)
        if g["eps"] is not None:
            g["eps"].copy_(model.draw_eps(bucket))
        g["graph"].replay()
        self.replays[bucket] += 1
        for k, v in g["out"].items():
            if v is not None:
                g["out_host"][k].copy_(v, non_blocking=True)
        torch.cuda.current_stream(model.device).synchronize()
        out = g["out_host"]
        return out["image"].numpy(), None if out["orient"] is None else out["orient"].numpy()

    def infer(self, batch: Dict[str, np.ndarray]):
        """Run any-size batch through the buckets.  Pads by repeating the
        last sample and slices the padding back off.  Returns numpy
        (images, orient_rgb), NHWC; orient_rgb is None when the model runs
        without IG inpainting."""
        n = next(iter(batch.values())).shape[0]
        if any(v.shape[0] != n for v in batch.values()):
            raise ValueError("inconsistent batch sizes across inputs")
        missing = sorted(set(self.BATCH_CHANNELS) - set(batch))
        if missing:
            raise ValueError(f"batch lacks {missing}")
        h, w = self.image_shape
        for k, c in self.BATCH_CHANNELS.items():
            if batch[k].shape[1:] != (h, w, c):
                raise ValueError(f"{k} has shape {batch[k].shape}, expected (n, {h}, {w}, {c})")
        if self.model.device.type == "cuda":
            self._drop_stale()
        image = orient = None
        start = 0
        while start < n:
            take = min(n - start, self.buckets[-1])
            bucket = next(b for b in self.buckets if b >= take)
            out, orient_rgb = self._dispatch(
                bucket, {k: batch[k][start:start + take] for k in self.BATCH_CHANNELS})
            if image is None:
                image = np.empty((n,) + out.shape[1:], np.float32)
                orient = None if orient_rgb is None else \
                    np.empty((n,) + orient_rgb.shape[1:], np.float32)
            image[start:start + take] = out[:take]
            if orient is not None:
                orient[start:start + take] = orient_rgb[:take]
            start += take
        return image, orient
