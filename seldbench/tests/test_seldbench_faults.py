"""A run with its timed path broken underneath comes out not correct: the harness
is driven on the CPU past its look for a card, at the tiny sizes, once for each
fault the cell can have. Serving: an answer altered where it is produced, and
half of a request's clips left out (the other half's answers in their place).
Training: a step that returns the state unchanged, and half of the batch left
out with the mean taken over the rest."""
from __future__ import annotations

import contextlib

import pytest
import torch

from seldbench import calibrate, run
from seldbench.manifest import Manifest


@contextlib.contextmanager
def answer_altered(monkeypatch):
    import salsa_tpu_torch.pipeline as pipeline

    heads = pipeline.heads

    def altered(*args, **kwargs):
        event_prob, doa = heads(*args, **kwargs)
        event_prob = event_prob.clone()
        event_prob[0, 0, 0] += 0.05
        return event_prob, doa

    monkeypatch.setattr(pipeline, "heads", altered)
    yield


@contextlib.contextmanager
def half_the_clips(monkeypatch):
    from salsa_tpu_torch.pipeline import SeldInferencePipeline

    forward = SeldInferencePipeline.forward

    def halved(self, waves):
        n = waves.shape[0]
        ev, doa = forward(self, waves[:max(1, n // 2)])
        reps = -(-n // ev.shape[0])
        return ev.repeat(reps, 1, 1)[:n], doa.repeat(reps, 1, 1)[:n]

    monkeypatch.setattr(SeldInferencePipeline, "forward", halved)
    yield


@contextlib.contextmanager
def state_unchanged(monkeypatch):
    from salsa_tpu_torch.train.state import ScheduledOptimizer

    def counted_only(self):
        self.count += 1

    monkeypatch.setattr(ScheduledOptimizer, "step", counted_only)
    yield


def half_the_batch(monkeypatch):
    return calibrate.half_batch()


@pytest.mark.parametrize("cell,fault", [
    ("salsa_foa.serve", answer_altered),
    ("salsa_foa.serve", half_the_clips),
    ("salsa_lite_mic.serve", answer_altered),
    ("salsa_lite_mic.serve", half_the_clips),
    ("salsa_foa.train", state_unchanged),
    ("salsa_foa.train", half_the_batch),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    with fault(monkeypatch):
        result = run.run_cell(Manifest(tiny_root), cell, 2**32 + 11, 0.1, False,
                              torch.device("cpu"))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", ["salsa_foa.serve", "salsa_lite_mic.serve", "salsa_foa.train"])
def test_a_sound_run_is_correct(tiny_root, cell):
    result = run.run_cell(Manifest(tiny_root), cell, 2**32 + 11, 0.1, False, torch.device("cpu"))
    assert result["correct"] is True, result["checks"]
