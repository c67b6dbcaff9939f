"""``fit``: ``MouseModel.fit`` over ``MiceDataLoader`` on a trial tree
written from the seed (``trials`` a mouse of ``frames`` frames of
``video``), with the configuration's epoch, CutMix and loader threads.

Set-up trains the first ``setup_steps`` batches of epoch 0 as one epoch
through the same call and feed as the window, the loader's threads
assembling the next batch while the card runs the last; the reference
re-assembles those batches from the tree and follows the same steps. The
window is epoch 1, which the feed ends at the deadline.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import compare, spec, synth
from benchmark.harness.driver import BaseDriver, free_device, nn_cfg
from benchmark.harness.trace import span
from benchmark.harness.weights import make_weights
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train
from benchmark.work import counts


class _Feed:
    """The loader as ``fit`` sees it: it ends the epoch after ``limit``
    batches or at ``deadline`` (host clock), and counts the batches and the
    seconds spent blocked in the loader's ``next()``."""

    def __init__(self, loader, limit: int | None = None, deadline: float | None = None):
        self.loader, self.limit, self.deadline = loader, limit, deadline
        self.batches, self.wait_s = 0, 0.0

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        batches = iter(self.loader)
        try:
            while self.limit is None or self.batches < self.limit:
                if self.deadline is not None and time.perf_counter() >= self.deadline:
                    return
                before = time.perf_counter()
                with span("bench.loader_next"):
                    batch = next(batches, None)
                self.wait_s += time.perf_counter() - before
                if batch is None:
                    return
                self.batches += 1
                yield batch
        finally:
            batches.close()


class Driver(BaseDriver):
    def setup(self) -> None:
        from sensorium_tpu_torch import constants
        from sensorium_tpu_torch.data import mouse_data
        from sensorium_tpu_torch.data.datasets import TrainMiceDataset
        from sensorium_tpu_torch.data.indexes import WindowIndexer
        from sensorium_tpu_torch.data.inputs import get_inputs_processor
        from sensorium_tpu_torch.data.loader import MiceDataLoader
        from sensorium_tpu_torch.data.mixers import CutMix
        from sensorium_tpu_torch.data.responses import get_responses_processor
        from sensorium_tpu_torch.engine.callbacks import Callback
        from sensorium_tpu_torch.engine.model import MouseModel
        from sensorium_tpu_torch.engine.schedule import build_stage_schedule
        from sensorium_tpu_torch.models.registry import get_nn_module

        start = time.perf_counter()
        config, traffic = self.config, self.traffic
        self.tree_dir = Path(tempfile.mkdtemp(prefix="bench-tree-"))
        self.tree = synth.write_tree(self.tree_dir, constants.mice, self.cfg["readout_outputs"], traffic["trials"],
                                     traffic["frames"], traffic["video"], self.seed, self.device)
        start = self.phase("write_tree", start)

        self._saved = (constants.sensorium_dir, os.environ.get("SENSORIUM_FOLD_ASSIGNMENT"))
        constants.sensorium_dir = self.tree_dir
        os.environ["SENSORIUM_FOLD_ASSIGNMENT"] = "trial"  # every trial a train trial of some fold
        mouse_data.get_folds_tiers.cache_clear()
        mice_data = [mouse_data.get_mouse_data(m, list(constants.folds_splits)) for m in constants.mice]
        self.batch_size = config["batch_size"]
        self.epoch_size = config["train_epoch_size"]
        dataset = TrainMiceDataset(mice_data, WindowIndexer(**self.frame_stack),
                                   get_inputs_processor(*self.params["inputs_processor"]),
                                   get_responses_processor(*self.params["responses_processor"]),
                                   mouse_epoch_size=self.epoch_size // len(mice_data),
                                   mixer=CutMix(**config["cutmix"]), seed=self.seed)
        self.loader = MiceDataLoader(dataset, batch_size=self.batch_size, shuffle=True, seed=self.seed,
                                     num_threads=config["num_dataloader_workers"], drop_last=True)

        start = self.phase("datasets", start)
        self.model = MouseModel(self.params, device=self.device)
        self.model.set_ema(config["ema_decay"])
        iters = self.epoch_size // self.batch_size
        stages = dict(zip(config["stages"], config["num_epochs"]))
        # The recipe's lr plan: peak and floor scaled linearly from a batch of 4.
        self.lr_plan = (self.params["optimizer"][1]["lr"], config["min_base_lr"] * self.batch_size / 4,
                        iters * stages.get("warmup", 0), iters * sum(e for s, e in stages.items() if s != "warmup"))
        self.model.build_state(seed=self.seed, learning_rate=build_stage_schedule(*self.lr_plan))
        start = self.phase("build_state", start)
        weights = make_weights(self.cfg, self.seed, self.device)
        with torch.no_grad():
            self.model.state.model.load_state_dict(weights, strict=True)
            self.model.state.ema_model.load_state_dict(weights, strict=True)
        self.teacher = None
        if "distill" in config:
            teacher_config = spec.load_config(config["teacher_config"], self.cell.bench_dir)
            self.teacher_cfg = nn_cfg(spec.argus_params(teacher_config))
            self.teacher = get_nn_module(self.params["nn_module"][0], self.teacher_cfg, device=self.device)
            self.teacher_weights = self.trained_weights(self.teacher_cfg, "teacher")
            with torch.no_grad():
                self.teacher.load_state_dict(self.teacher_weights, strict=True)
            self.model.set_distill(self.teacher, config["distill"]["ratio"])
        start = self.phase("weights", start)

        losses = self.losses = []

        class Losses(Callback):
            def epoch_complete(self, state):
                losses.append(float(state.metrics["train_loss"]))

        self.callbacks = [Losses()]
        # Each step's loss, and the first gradients as the optimizer took
        # them, are read from what ``fit``'s own steps return and leave: the
        # norms are queued on the card behind step 1, and nothing waits for
        # the card inside the epoch.
        step_losses, first = [], {}
        train_step = self.model.train_step

        def recorded(batch, sharded=False):
            loss = train_step(batch, sharded=sharded)
            step_losses.append(loss)
            if not first:
                first.update(self._first_gradients())
            return loss

        self.model.train_step = recorded
        try:
            self.model.fit(_Feed(self.loader, limit=traffic["setup_steps"]), num_epochs=1, start_epoch=0,
                           callbacks=self.callbacks)
        finally:
            del self.model.train_step
        state = self.model.state
        with torch.no_grad():
            names = [n for n, _ in state.model.named_parameters()]
            live = state.model.state_dict()
            self.program = {
                "losses": [float(loss) for loss in step_losses],
                "grad_norms": {n: float(g) for n, g in first.items()},
                "change_norms": {n: float((live[n] - weights[n]).double().norm()) for n in names},
                "ema_change_norms": {n: float((v - weights[n]).double().norm())
                                     for n, v in state.ema_model.state_dict().items()},
            }
        del weights, live
        self.phase("warm_steps", start)

    def _first_gradients(self) -> dict:
        """Each parameter's first gradient's norm as the optimizer took it,
        on the card: Adam's first moment after one step is (1 - beta1) times
        the gradient (0 for a parameter the optimizer has not stepped)."""
        optimizer = self.model.state.optimizer
        beta1 = optimizer.param_groups[0]["betas"][0]
        moments = {n: optimizer.state.get(p, {}).get("exp_avg") for n, p in self.model.state.model.named_parameters()}
        return {n: 0.0 if m is None else (m / (1.0 - beta1)).double().norm() for n, m in moments.items()}

    def window(self, deadline: float) -> dict:
        feed = _Feed(self.loader, deadline=deadline)
        self.model.fit(feed, num_epochs=1, start_epoch=1, callbacks=self.callbacks)
        steps = feed.batches
        return {"steps": steps, "clips": steps * self.batch_size, "attempted": steps * self.batch_size,
                "loader_wait_s": feed.wait_s}

    def failed(self, counts_: dict) -> int:
        """Every clip of the window, if the window's mean loss is not finite."""
        return 0 if np.isfinite(self.losses[-1]) else counts_["attempted"]

    def work(self, counts_: dict, rates: dict | None) -> dict:
        size, (h, w) = self.frame_stack["size"], self.canvas
        teacher = self.teacher_cfg if self.teacher is not None else None
        out = {"flops": counts_["clips"] * counts.train_flops_per_clip(self.cfg, size, h, w, teacher)}
        if rates is not None:
            calls = counts.dw_calls(self.cfg, self.batch_size, size, h, w, True)
            if teacher is not None:
                calls += counts.dw_calls(teacher, self.batch_size, size, h, w, False)
            out["dw_least_s"] = counts_["steps"] * counts.least_seconds(calls, rates)
        return out

    def free(self) -> None:
        self.model = self.teacher = self.loader = self.callbacks = None
        free_device()

    def check(self) -> tuple[dict, dict]:
        self.reference = self.follow()
        return compare.training_numbers(self.program, self.reference)

    def faults(self) -> dict:
        return {"control": compare.training_numbers(self.follow(ref.Precision("fp8")), self.reference)[0],
                "half_batch": compare.training_numbers(self.follow(half_batch=True), self.reference)[0]}

    def follow(self, precision: ref.Precision = ref.FLOAT32, half_batch: bool = False) -> dict:
        """The reference's steps over set-up's batches, from the same weights and masks."""
        ref.set_exact_float32()
        config = self.config
        tree = ref_data.Tree(self.tree)
        mice = len(self.cfg["readout_outputs"])

        def batch(index):
            def make():
                arrays = ref_data.train_batch(tree, index, self.seed, 0, self.batch_size, self.epoch_size, mice,
                                              max(self.cfg["readout_outputs"]), self.frame_stack, self.canvas,
                                              config["cutmix"])
                return tuple(torch.from_numpy(a).to(self.device) for a in arrays)
            return make

        peak, floor, warmup, total = self.lr_plan
        recipe = {"cfg": self.cfg, "weight_decay": self.params["optimizer"][1]["weight_decay"],
                  "ema_decay": config["ema_decay"], "eps": self.params["loss"][1].get("eps", 1e-8),
                  "lr": lambda count: ref_train.cosine_lr(count, peak, floor, warmup, total)}
        teacher = None
        if "distill" in config:
            recipe["distill_ratio"] = config["distill"]["ratio"]
            teacher = (self.teacher_cfg, {n: t.to(self.device) for n, t in self.teacher_weights.items()})
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        weights = make_weights(self.cfg, self.seed, self.device)
        return ref_train.follow_steps(recipe, weights, [batch(i) for i in range(self.traffic["setup_steps"])],
                                      generator, teacher, q=precision, half_batch=half_batch)

    def cleanup(self) -> None:
        from sensorium_tpu_torch import constants
        from sensorium_tpu_torch.data import mouse_data

        if hasattr(self, "_saved"):
            constants.sensorium_dir, assignment = self._saved
            if assignment is None:
                os.environ.pop("SENSORIUM_FOLD_ASSIGNMENT", None)
            else:
                os.environ["SENSORIUM_FOLD_ASSIGNMENT"] = assignment
            mouse_data.get_folds_tiers.cache_clear()
        if hasattr(self, "tree_dir"):
            shutil.rmtree(self.tree_dir, ignore_errors=True)
