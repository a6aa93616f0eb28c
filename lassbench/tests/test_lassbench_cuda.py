"""On the card (skipped without one): each cell's control, in the
program's place, comes out over the cell's limits, and a sound run comes
out within them, at a size a test run holds (four clips of 10 s a batch,
or eight rows a training step)."""
import time

import pytest

from lassbench.harness import Bench, Run, correct

CONTROLS = [("sep_text_b16", "int8"), ("sep_text_b16", "tf32"),
            ("sep_audio_b16", "int8"), ("sep_audio_b16", "tf32"),
            ("train_text_b32", "fp8")]


def _small(workload):
    bench = Bench.load(workload)
    t = bench.traffic
    if t["runner"] == "separate":
        t.update(batch=4, check_batches=2, warmup_batches=1)
    else:
        t.update(batch=8, warmup_steps=4)
    return bench


@pytest.mark.cuda
@pytest.mark.parametrize("workload,mode", CONTROLS)
def test_control_is_not_correct(card, workload, mode):
    bench = _small(workload)
    found = bench.runner().control(bench, 2 ** 31 + 101, card, mode)
    assert any(v > bench.limits[k] for k, v in found.items()), found


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sep_text_b16", "sep_audio_b16",
                                      "train_text_b32"])
def test_sound_run_is_correct(card, workload):
    bench = _small(workload)
    run = Run(bench, 2 ** 31 + 103, 1.0, False)
    run.t_start = time.perf_counter()
    bench.runner().run(run, card)
    assert correct(run), run.checks
