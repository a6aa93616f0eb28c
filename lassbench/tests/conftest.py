"""CPU tests of the benchmark (``python -m pytest lassbench/tests``); the
ones marked ``cuda`` run only where torch sees a card and skip here."""
import time

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips itself when "
        "torch sees no card")


def shrink(bench, clip: float = 0.32):
    """The cell at a size a CPU test holds: short clips, small batches, a
    2-layer text tower and a one-block-a-stage HTSAT of width 16; the
    separator keeps its published widths."""
    c, t = bench.config, bench.traffic
    c["segment_seconds"] = clip
    c["text"]["num_hidden_layers"] = 2
    if "audio" in c:
        c["audio"].update(embed_dim=16, depths=[1, 1, 1, 1],
                          num_heads=[2, 2, 2, 2], clip_seconds=clip)
    if t["runner"] == "separate":
        t.update(batch=2, clip_seconds=clip, pool_clips=6,
                 distinct_batches=2, warmup_batches=1, check_batches=2,
                 query_pool=6)
    else:
        t.update(batch=2, num_workers=1, warmup_steps=4, checked_steps=3)
        t["corpus"].update(num_clips=16, seconds_min=0.6, seconds_max=1.0)
    return bench


def cpu_run(workload: str, tmp_path, seed: int = 123456789012,
            seconds: float = 1.0, trace: bool = False, edit=None):
    """One run of ``workload`` on the CPU at ``shrink``'s size, with the
    harness's look for a card skipped; ``edit(bench)`` may change it."""
    import torch

    from lassbench.harness import Bench, Run

    torch.set_num_threads(4)
    bench = shrink(Bench.load(workload))
    if edit is not None:
        edit(bench)
    run = Run(bench, seed, seconds, trace)
    run.t_start = time.perf_counter()
    run.cache = str(tmp_path / "cache")
    bench.runner().run(run, device="cpu")
    return run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch sees none)")
    return "cuda"
