"""Trainer and input (``train/loop.py``, ``train/prefetch.py``,
``data/datamodule.py``, ``data/datafiles.py``): the trainer's own
``timing['data_wait']`` (the main thread waiting for the prefetcher) over
the window, in %."""


def read(run, name):
    if "data_wait" not in run.timing or not run.window_s:
        return None
    return 100.0 * run.timing["data_wait"] / run.window_s
