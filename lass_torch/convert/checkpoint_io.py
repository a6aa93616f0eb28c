"""Checkpoint loading and saving for the port's separator.

``load_ss_model`` (the reference's ``utils.load_ss_model``) accepts:

- a reference PyTorch Lightning ``.ckpt`` / ``.pt`` (keys under
  ``ss_model.``, one FiLM Linear per conditioned path), or a checkpoint the
  port wrote with ``save_ss_checkpoint`` (the same layout);
- an npz pack from ``scripts/convert_checkpoint.py --kind audiosep`` (the
  JAX package's parameter tree, '/'-joined keys).

An orbax directory written by the JAX trainer needs orbax and JAX to read;
convert it to an npz pack first.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from lass_torch.convert.from_jax import resunet30_state_dict_from_jax
from lass_torch.models.film import FilmEntry, resunet30_film_spec

# frozen DFT conv weights of the reference's STFT/ISTFT front and back end;
# the port computes the transforms itself
_IGNORED_PREFIXES = ("base.stft.", "base.istft.")


def load_npz_variables(path: str) -> Dict[str, Any]:
    """Load an npz parameter pack back into nested dicts keyed by the
    '/'-joined paths."""
    out: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def _film_key(path) -> str:
    return "film." + "->".join(path)


def pack_film(sd: Dict[str, torch.Tensor],
              spec: Optional[Tuple[FilmEntry, ...]] = None
              ) -> Dict[str, torch.Tensor]:
    """Replace the reference's per-path FiLM Linears with the fused
    ``film.weight`` / ``film.bias``, rows in the order of ``spec`` (the
    model's FiLM spec; ResUNet30's by default). The per-path keys must be
    exactly the spec's: any other raises."""
    spec = resunet30_film_spec() if spec is None else spec
    want = {f"{_film_key(p)}.{leaf}" for p, _, _ in spec
            for leaf in ("weight", "bias")}
    have = {k for k in sd if k.startswith("film.")}
    if have != want:
        raise KeyError(f"FiLM keys do not fit the spec: missing "
                       f"{sorted(want - have)[:4]}, unexpected "
                       f"{sorted(have - want)[:4]}")
    out = {k: v for k, v in sd.items() if not k.startswith("film.")}
    out["film.weight"] = torch.cat(
        [sd[f"{_film_key(p)}.weight"] for p, _, _ in spec], dim=0)
    out["film.bias"] = torch.cat(
        [sd[f"{_film_key(p)}.bias"] for p, _, _ in spec], dim=0)
    return out


def unpack_film(sd: Dict[str, torch.Tensor],
                spec: Optional[Tuple[FilmEntry, ...]] = None
                ) -> Dict[str, torch.Tensor]:
    """Inverse of ``pack_film``: the reference's per-path Linears. The
    fused rows must be exactly the spec's features: any other count
    raises."""
    spec = resunet30_film_spec() if spec is None else spec
    rows = sum(feat for _, feat, _ in spec)
    if sd["film.weight"].shape[0] != rows or sd["film.bias"].shape[0] != rows:
        raise ValueError(f"fused FiLM has {sd['film.weight'].shape[0]} rows, "
                         f"the spec {rows}")
    out = {k: v for k, v in sd.items() if not k.startswith("film.")}
    offset = 0
    for path, feat, _ in spec:
        key = _film_key(path)
        out[f"{key}.weight"] = sd["film.weight"][offset:offset + feat]
        out[f"{key}.bias"] = sd["film.bias"][offset:offset + feat]
        offset += feat
    return out


def separator_state_dict(checkpoint_path: str,
                         spec: Optional[Tuple[FilmEntry, ...]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Read a separator checkpoint (see the module docstring) into the
    port's state-dict layout; ``spec``: the model's FiLM spec (ResUNet30's
    by default; an npz pack is always a ResUNet30's)."""
    if os.path.isdir(checkpoint_path):
        raise ValueError(
            f"{checkpoint_path} is a directory (an orbax checkpoint of the "
            "JAX trainer?). Reading orbax needs JAX; write an npz pack "
            "with scripts/convert_checkpoint.py or the JAX package and "
            "load that.")
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(checkpoint_path)
    if checkpoint_path.endswith(".npz"):
        pack = load_npz_variables(checkpoint_path)
        return resunet30_state_dict_from_jax(pack)
    blob = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return separator_layout(blob, spec)


def separator_layout(blob: Dict[str, Any],
                     spec: Optional[Tuple[FilmEntry, ...]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A separator checkpoint's state dict (``ss_model.`` keys or bare,
    FiLM fused or per path) in the port's layout, FiLM fused by ``spec``."""
    sd = {k: torch.as_tensor(v) for k, v in blob.items()}
    if any(k.startswith("ss_model.") for k in sd):
        sd = {k[len("ss_model."):]: v for k, v in sd.items()
              if k.startswith("ss_model.")}
    sd = {k: v for k, v in sd.items() if not k.startswith(_IGNORED_PREFIXES)}
    if "film.weight" not in sd:
        sd = pack_film(sd, spec)
    return sd


def load_separator(model: torch.nn.Module, checkpoint_path: str) -> None:
    """Load a checkpoint into a port ResUNet30. Only BatchNorm's
    ``num_batches_tracked`` counters may be absent; any other missing or
    unexpected key raises."""
    sd = separator_state_dict(checkpoint_path)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"checkpoint {checkpoint_path} does not fit ResUNet30: "
                       f"missing {missing[:8]}, unexpected {unexpected[:8]}")


def save_ss_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Write the separator in the reference's Lightning layout
    (``state_dict`` with ``ss_model.`` keys and per-path FiLM Linears), which
    the port, the JAX package's loader and the reference all read."""
    sd = unpack_film({k: v.detach().cpu()
                      for k, v in model.state_dict().items()})
    torch.save({"state_dict": {f"ss_model.{k}": v for k, v in sd.items()}},
               path)


def load_ss_model(configs, checkpoint_path: str, query_encoder=None,
                  device: str = "cuda", quantize: bool = False,
                  config: str = "default"):
    """Build the separator from a config (dict or Config) and a checkpoint;
    returns a SeparationInference on ``device`` with the CLAP query encoder
    (a random-weight one unless ``query_encoder`` is given).

    config: the serving configuration, a key of
    ``lass_torch.models.resunet.CONFIGS`` ("default", "A", "B"); every one
    loads the same checkpoint. quantize: the int8 eval path
    (``lass_torch/ops/quant.py``); calibrate before separating."""
    from lass_torch.config import Config, _build
    from lass_torch.evaluation.dcase import SeparationInference
    from lass_torch.models.query_encoder import CLAPQueryEncoder
    from lass_torch.models.resunet import CONFIGS, build_model

    if config not in CONFIGS:
        raise ValueError(f"config must be one of {sorted(CONFIGS)}, got "
                         f"{config!r}")
    cfg = configs if isinstance(configs, Config) else _build(Config, configs)
    model = build_model(cfg, quantize=quantize, **CONFIGS[config])
    load_separator(model, checkpoint_path)
    if query_encoder is None:
        query_encoder = CLAPQueryEncoder(device=device)
    return SeparationInference(model, query_encoder, device=device)
