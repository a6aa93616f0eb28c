"""Train step (``tasks/audiosep.py``, ``nn/layers.py`` BatchNorm,
``losses.py``, ``train/optim.py``): device ms per step of the train-mode
batch-norm kernel family (cuDNN's forward and backward batch norm) in the
window."""


def read(run, name):
    tr = run.trace
    if tr is None or tr.window is None or not run.units or \
            run.bench.traffic.get("runner") != "train":
        return None
    return 1e3 * tr.family_s("batch norm (train)") / run.units
