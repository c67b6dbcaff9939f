"""``predict``: ``Predictor.predict_trial`` (``Predictor.from_module``,
``chunk_size``, blend ``blend``) on whole trials of ``frames`` frames of
``video``, drawn from ``distinct_trials`` made from the seed; one
closed-loop client, the mice in turn. After the window the reference
re-predicts ``compare_answers`` of its answers drawn from the seed, the
longest among them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, synth
from benchmark.harness.driver import BaseDriver, free_device
from benchmark.harness.synth import sub_seed
from benchmark.harness.trace import span
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref
from benchmark.work import counts


class Driver(BaseDriver):
    def setup(self) -> None:
        from sensorium_tpu_torch.infer.predictor import Predictor
        from sensorium_tpu_torch.models.registry import get_nn_module

        start = time.perf_counter()
        module = get_nn_module(self.params["nn_module"][0], self.cfg, device=self.device)
        start = self.phase("build_module", start)
        self.weights = self.trained_weights(self.cfg, "weights")
        with torch.no_grad():
            module.load_state_dict(self.weights, strict=True)
        self.predictor = Predictor.from_module(module, self.params, blend_weights=self.traffic["blend"],
                                               chunk_size=self.traffic["chunk_size"], device=self.device)
        start = self.phase("weights", start)
        draws = synth.Draws(self.seed, "trials", self.device)
        self.pool = [synth.trial_arrays(draws, self.traffic["video"], self.traffic["frames"])
                     for _ in range(self.traffic["distinct_trials"])]
        mice, frames = len(self.cfg["readout_outputs"]), self.traffic["frames"]
        # (trial, first frame, length, mouse) of each request in turn.
        self.plan = [(i % len(self.pool), 0, frames, i % mice) for i in range(self.traffic["plan_requests"])]
        start = self.phase("inputs", start)
        self.serve(self.plan[0])
        start = self.phase("first_request", start)
        clip = 2 * (self.frame_stack["size"] - 1) * self.frame_stack["step"]  # two chunks' worth of windows
        for mouse in range(1, mice):
            self.serve((0, 0, clip, mouse))
        self.phase("warm_requests", start)
        self.answers: list = []

    def request_arrays(self, request: tuple):
        trial, first, length, _ = request
        video, behavior, pupil = self.pool[trial]
        return video[..., first:first + length], behavior[:, first:first + length], pupil[:, first:first + length]

    def serve(self, request: tuple) -> np.ndarray:
        with span("bench.request"):
            return self.predictor.predict_trial(*self.request_arrays(request), mouse_index=request[3])

    def window(self, deadline: float) -> dict:
        answers, i = [], 0
        while time.perf_counter() < deadline:
            request = self.plan[i % len(self.plan)]
            answers.append((request, self.serve(request)))
            i += 1
        self.answers = answers
        chunks = [n for request, _ in answers for n in counts.chunk_sizes(request[2], self.frame_stack,
                                                                          self.traffic["chunk_size"])]
        return {"requests": len(answers), "attempted": len(answers), "windows": sum(chunks), "chunk_sizes": chunks}

    def failed(self, counts_: dict) -> int:
        return sum(1 for _, answer in self.answers if not np.all(np.isfinite(answer)))

    def work(self, counts_: dict, rates: dict | None) -> dict:
        size, (h, w) = self.frame_stack["size"], self.canvas
        flops = sum(counts.forward_flops(self.cfg, 1, size, h, w, request[3])
                    * counts.windows(request[2], self.frame_stack) for request, _ in self.answers)
        out = {"flops": flops}
        if rates is not None:
            out["dw_least_s"] = sum(counts.least_seconds(counts.dw_calls(self.cfg, n, size, h, w, False), rates)
                                    for n in counts_["chunk_sizes"])
        return out

    def free(self) -> None:
        self.predictor = None
        free_device()

    def sample(self) -> list:
        """The answers compared: a sample drawn from the seed, the longest request among them."""
        k = min(self.traffic["compare_answers"], len(self.answers))
        rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        picks = set(rng.choice(len(self.answers), size=k, replace=False).tolist()) if k else set()
        if self.answers:
            picks.add(max(range(len(self.answers)), key=lambda i: self.answers[i][0][2]))
        return sorted(picks)

    def expected(self, precision: ref.Precision = ref.FLOAT32) -> list:
        """The reference's answers to the sampled requests, in the sample's order."""
        ref.set_exact_float32()
        weights = {n: t.to(self.device) for n, t in self.weights.items()}
        return [ref_data.predict_trial(weights, self.cfg, *self.request_arrays(self.answers[i][0]),
                                       self.answers[i][0][3], self.frame_stack, self.canvas, self.device,
                                       chunk=self.traffic["chunk_size"], q=precision) for i in self.sample()]

    def check(self) -> tuple[dict, dict]:
        self.reference = self.expected()
        gaps = [compare.output_gaps(self.answers[i][1], expected)
                for i, expected in zip(self.sample(), self.reference)]
        return compare.worst_answer(gaps), {"answers_compared": len(gaps), "gaps": gaps}

    def faults(self) -> dict:
        control = self.expected(ref.Precision("fp8"))
        return {"control": compare.worst_answer([compare.output_gaps(c, e) for c, e in zip(control, self.reference)])}
