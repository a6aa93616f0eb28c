"""Helpers shared by the port's variant tests (tests/test_torch_variants.py,
tests/test_torch_variant_steps.py): converting a port state dict to the
JAX layout, random BatchNorms, lass_tpu's STFT bank as numpy."""
import jax.numpy as jnp
import numpy as np
import torch

from lass_tpu.dsp.stft import multi_resolution_spectrogram_phase as jax_bank
from lass_torch.models.resunet_multistft import MultiSTFTResUNet30
from lass_torch.nn.layers import BatchNorm

REL = 1e-4
WINS = (256, 512, 2048)
BATCH = 2


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def jax_variables(sd):
    """The port's state dict -> lass_tpu {'params', 'batch_stats'}: the
    module names are the flax names; conv kernels (O, I, kh, kw) ->
    (kh, kw, I, O) (transposed convs (I, O, kh, kw) -> (kh, kw, O, I)),
    Linear weights transposed, BatchNorm weight/bias/running stats ->
    scale/bias/mean/var."""
    params, stats = {}, {}
    bns = {k[:-len(".running_mean")] for k in sd
           if k.endswith(".running_mean")}
    for key, v in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        v = v.detach().numpy()
        if prefix in bns:
            tree, name = ((stats, {"running_mean": "mean",
                                   "running_var": "var"}[leaf])
                          if leaf.startswith("running") else
                          (params, {"weight": "scale", "bias": "bias"}[leaf]))
        elif leaf == "weight":
            tree, name = params, "kernel"
            v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        else:
            tree, name = params, "bias"
        node = tree
        for part in prefix.split("."):
            node = node.setdefault(part, {})
        node[name] = jnp.asarray(np.ascontiguousarray(v))
    return {"params": params, "batch_stats": stats}


def shake(model, seed):
    """Random BN affines and running statistics, so that every term of
    BatchNorm counts."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.add_(0.1 * torch.randn(m.weight.shape,
                                                generator=gen))
                m.bias.add_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model


def stft_bank(wins, samples, seed):
    """A mixture's STFT bank from lass_tpu (numpy), a condition, and the
    same as the port's model input."""
    rng = np.random.RandomState(seed)
    wave = (0.1 * rng.randn(BATCH, 1, samples)).astype(np.float32)
    bank = {w: tuple(np.asarray(a) for a in t)
            for w, t in jax_bank(jnp.asarray(wave), wins).items()}
    cond = rng.randn(BATCH, 512).astype(np.float32)
    return bank, cond


def model_input(bank, cond, wins, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    out = {f"stft_mixture_{part}": {w: conv(bank[w][i]) for w in wins}
           for i, part in enumerate(("mag", "cos", "sin"))}
    out["condition"] = conv(cond)
    return out


def port_model(wins):
    """A port model with seeded random weights and shaken BatchNorms, in
    eval mode."""
    torch.manual_seed(0)
    return shake(MultiSTFTResUNet30(win_lengths=wins), 1).eval()
