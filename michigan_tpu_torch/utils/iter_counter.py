"""Epoch and iteration bookkeeping with resume (the port's copy of
michigan_tpu/utils/iter_counter.py; reference util/iter_counter.py).
iter.txt holds (epoch, epoch_iter, total_steps); the reference's
two-column form is read too, an --unpairTrain epoch counting two passes
over the data (stage 2, then stage 1).  Counts are of global-batch
images on every data-parallel rank; only the counter made with `main`
(rank 0's) prints and writes iter.txt."""

from __future__ import annotations

import os
import time

import numpy as np


class IterationCounter:
    def __init__(self, opt, dataset_size: int, main: bool = True):
        self.opt, self.main = opt, main
        self.dataset_size = dataset_size
        self.first_epoch = 1
        self.total_epochs = opt.niter + opt.niter_decay
        self.epoch_iter = 0
        self.current_epoch = 1
        self.iter_record_path = os.path.join(opt.checkpoints_dir, opt.name, "iter.txt")
        self.total_steps_so_far = None
        if opt.isTrain and opt.continue_train and os.path.exists(self.iter_record_path):
            rec = np.atleast_1d(np.loadtxt(self.iter_record_path, delimiter=",", dtype=int))
            self.first_epoch, self.epoch_iter = int(rec[0]), int(rec[1])
            if rec.size >= 3:
                self.total_steps_so_far = int(rec[2])
            if main:
                print(f"Resuming from epoch {self.first_epoch} at iteration {self.epoch_iter}")
        if self.total_steps_so_far is None:
            per_epoch = dataset_size * (2 if opt.unpairTrain else 1)
            self.total_steps_so_far = (self.first_epoch - 1) * per_epoch + self.epoch_iter
        self.time_per_iter = 0.0
        self.last_iter_time = self.epoch_start_time = time.time()

    def training_epochs(self):
        return range(self.first_epoch, self.total_epochs + 1)

    def record_epoch_start(self, epoch: int) -> None:
        self.epoch_start_time = self.last_iter_time = time.time()
        self.epoch_iter = 0
        self.current_epoch = epoch

    def record_one_iteration(self) -> None:
        now = time.time()
        self.time_per_iter = (now - self.last_iter_time) / self.opt.batchSize
        self.last_iter_time = now
        self.total_steps_so_far += self.opt.batchSize
        self.epoch_iter += self.opt.batchSize

    def record_epoch_end(self) -> None:
        if self.main:
            print(f"End of epoch {self.current_epoch} / {self.total_epochs} \t"
                  f" Time Taken: {time.time() - self.epoch_start_time:.0f} sec")

    def record_current_iter(self, epoch=None, epoch_iter=None) -> None:
        if not self.main:
            return
        os.makedirs(os.path.dirname(self.iter_record_path), exist_ok=True)
        np.savetxt(self.iter_record_path,
                   (self.current_epoch if epoch is None else epoch,
                    self.epoch_iter if epoch_iter is None else epoch_iter,
                    self.total_steps_so_far), delimiter=",", fmt="%d")

    def _trigger(self, freq: int) -> bool:
        return freq > 0 and (self.total_steps_so_far % freq) < self.opt.batchSize

    def needs_printing(self) -> bool:
        return self._trigger(self.opt.print_freq)

    def needs_displaying(self) -> bool:
        return self._trigger(self.opt.display_freq)

    def needs_saving(self) -> bool:
        return self._trigger(self.opt.save_latest_freq)
