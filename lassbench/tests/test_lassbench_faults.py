"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a small size, once for each fault the cell can have (an answer altered
where it is produced, half of the batch left out, a step that leaves its
state unchanged; no cell here spans cards, so none can lose an exchange
between them). The training cell is the one kept in ``pending/``."""
import numpy as np
import pytest
import torch

from lassbench.harness import correct
from lassbench.tests.conftest import cpu_run


def _over(run, name):
    value, limit = run.checks[name]
    return value > limit


@pytest.fixture
def broken_separate(monkeypatch):
    from lass_torch.evaluation import dcase

    sound = dcase.SeparationInference.separate

    def install(kind):
        def separate(self, mixtures, conditions):
            out = sound(self, mixtures, conditions)
            if kind == "altered":  # one clip's answer phase-inverted
                out[0] = -out[0]
            else:  # half of the batch never separated
                out[len(out) // 2:] = 0.0
            return out

        monkeypatch.setattr(dcase.SeparationInference, "separate", separate)

    return install


@pytest.mark.parametrize("workload", ["sep_text_b16", "sep_audio_b16"])
@pytest.mark.parametrize("kind", ["altered", "half"])
def test_separation_faults(workload, kind, broken_separate, tmp_path):
    broken_separate(kind)
    run = cpu_run(workload, tmp_path)
    assert _over(run, "wave_worst_vs_witness")
    assert not correct(run)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_training_faults(kind, monkeypatch, tmp_path):
    from lass_torch.tasks import audiosep

    sound = audiosep.AudioSepTask._update

    def update(self, mixtures, segments, condition):
        if kind == "half":
            n = len(mixtures) // 2
            return sound(self, mixtures[:n], segments[:n], condition[:n])
        if kind == "unchanged":
            step = self.optimizer.step
            self.optimizer.step = lambda *a, **k: None
            try:
                return sound(self, mixtures, segments, condition)
            finally:
                self.optimizer.step = step
        out = sound(self, mixtures, segments, condition)
        out["train_loss"] = out["train_loss"] * 1.2
        return out

    monkeypatch.setattr(audiosep.AudioSepTask, "_update", update)
    run = cpu_run("train_text_b32", tmp_path)
    assert any(_over(run, k) for k in run.checks)
    assert not correct(run)
    if kind == "unchanged":
        assert run.checks["delta_gap"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["sep_text_b16", "sep_audio_b16",
                                      "train_text_b32"])
def test_sound_runs_are_correct(workload, tmp_path):
    """The same small runs with nothing broken come out correct, so it is
    the fault that the check sees."""
    run = cpu_run(workload, tmp_path)
    assert correct(run), run.checks
