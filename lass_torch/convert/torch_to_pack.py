"""Reference PyTorch checkpoints -> npz parameter packs, without JAX
(counterpart of lass_tpu/convert/torch_to_jax.py, function for function).

Each converter takes a state dict in the reference's layout (torch tensors
or numpy arrays) and returns the nested dicts of numpy arrays that the JAX
package's converter of the same name returns, array for array: the layout
of the npz packs that ``python -m lass_torch.convert_checkpoint`` writes
and ``lass_torch.convert.from_jax`` / ``CLAPQueryEncoder.from_npz`` read.
Nothing here imports torch or JAX at import time; ``convert_pann`` reads
the port's PANN variant table.

Checkpoints converted (SURVEY.md §5.4):
1. the AudioSep separation checkpoint (Lightning .ckpt, keys under
   ``ss_model.``, reference utils.py:356-400);
2. the CLAP checkpoint (``text_branch.`` RoBERTa, BERT or BART +
   ``text_projection`` MLP + ``audio_branch.`` HTSAT or PANN +
   ``audio_projection``; open_clip/factory.py:54-67 strips ``module.``),
   and the audio-only pretrained layouts (factory.py:165-231);
3. RoBERTa weights (any HF RobertaModel state dict).

Keys are picked by name; the rest (logit scales, ``text_transform.*``,
``audio_transform.*``, position-id buffers, the torchlibrosa front end,
HTSAT's ``head.*``, ``num_batches_tracked``, BART's decoder) is ignored. A
needed key that is missing raises ``KeyError``.

Layout rules:
- Linear:        torch (out, in)        -> kernel (in, out)      [transpose]
- Conv2d:        torch (O, I, kh, kw)   -> kernel (kh, kw, I, O)
- ConvTranspose: torch (I, O, kh, kw)   -> kernel (kh, kw, O, I)
  (flax transpose_kernel=True convention)
- BatchNorm:     weight->scale, bias->bias; running stats -> batch_stats
- FiLM: the reference's ~40 Linears named 'a->b->beta1'
  (resunet.py:31,51-57) pack into the fused kernel's column blocks in
  ``film_spec`` order (``lass_torch.models.film.resunet30_film_spec()``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

Array = np.ndarray
StateDict = Dict[str, Array]


def _t(w: Array) -> Array:
    return np.ascontiguousarray(w.T)


def _conv(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _convT(w: Array) -> Array:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _linear(sd: StateDict, prefix: str) -> Dict[str, Array]:
    out = {"kernel": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _bn(sd: StateDict, prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    return params, stats


def _conv_layer(sd: StateDict, prefix: str) -> Dict[str, Array]:
    out = {"kernel": _conv(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _conv_block(sd: StateDict, prefix: str) -> Tuple[Dict, Dict]:
    p_bn1, s_bn1 = _bn(sd, f"{prefix}.bn1")
    p_bn2, s_bn2 = _bn(sd, f"{prefix}.bn2")
    params = {
        "bn1": p_bn1, "bn2": p_bn2,
        "conv1": _conv_layer(sd, f"{prefix}.conv1"),
        "conv2": _conv_layer(sd, f"{prefix}.conv2"),
    }
    if f"{prefix}.shortcut.weight" in sd:
        params["shortcut"] = _conv_layer(sd, f"{prefix}.shortcut")
    return params, {"bn1": s_bn1, "bn2": s_bn2}


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out


def to_numpy_state_dict(sd) -> StateDict:
    """Accept torch tensors or numpy arrays."""
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


# --------------------------------------------------------------------------
# ResUNet30 (reference AudioSep checkpoint, ss_model.* keys)
# --------------------------------------------------------------------------

_ENCODERS = ["encoder_block1", "encoder_block2", "encoder_block3",
             "encoder_block4", "encoder_block5", "encoder_block6",
             "conv_block7a"]
_DECODERS = ["decoder_block1", "decoder_block2", "decoder_block3",
             "decoder_block4", "decoder_block5", "decoder_block6"]


def convert_resunet30(sd: StateDict, film_spec) -> Dict[str, Any]:
    """ss_model state dict -> {'params': ..., 'batch_stats': ...}, the
    pack layout of ResUNet30. ``film_spec`` is
    resunet30_film_spec(). Ignores the frozen stft/istft DFT conv weights
    (the port computes the transforms itself)."""
    sd = to_numpy_state_dict(sd)
    if any(k.startswith("ss_model.") for k in sd):
        sd = strip_prefix(sd, "ss_model.")

    params: Dict[str, Any] = {"base": {}}
    stats: Dict[str, Any] = {"base": {}}

    p_bn0, s_bn0 = _bn(sd, "base.bn0")
    params["bn0"], stats["bn0"] = p_bn0, s_bn0
    params["base"]["pre_conv"] = _conv_layer(sd, "base.pre_conv")
    params["base"]["after_conv"] = _conv_layer(sd, "base.after_conv")

    for name in _ENCODERS:
        p, s = _conv_block(sd, f"base.{name}.conv_block1")
        params["base"][name] = {"conv_block1": p}
        stats["base"][name] = {"conv_block1": s}
    for name in _DECODERS:
        p_bn1, s_bn1 = _bn(sd, f"base.{name}.bn1")
        p_cb, s_cb = _conv_block(sd, f"base.{name}.conv_block2")
        params["base"][name] = {
            "bn1": p_bn1,
            "conv1": {"kernel": _convT(sd[f"base.{name}.conv1.weight"])},
            "conv_block2": p_cb,
        }
        stats["base"][name] = {"bn1": s_bn1, "conv_block2": s_cb}

    # FiLM: pack per-path Linears into the fused kernel
    cond = sd["film.encoder_block1->conv_block1->beta1.weight"].shape[1]
    total = sum(f for _, f, _ in film_spec)
    kernel = np.zeros((cond, total), np.float32)
    bias = np.zeros((total,), np.float32)
    offset = 0
    for path, feat, _used in film_spec:
        key = "film." + "->".join(path)
        kernel[:, offset:offset + feat] = _t(sd[f"{key}.weight"])
        bias[offset:offset + feat] = sd[f"{key}.bias"]
        offset += feat
    params["film"] = {"kernel": kernel, "bias": bias}

    return {"params": params, "batch_stats": stats}


# --------------------------------------------------------------------------
# RoBERTa / CLAP text branch
# --------------------------------------------------------------------------

def convert_hf_roberta_state(sd: StateDict, num_layers: int
                             ) -> Dict[str, Any]:
    """HF RobertaModel state dict -> RobertaModel params in the pack
    layout (fused QKV)."""
    sd = to_numpy_state_dict(sd)
    params: Dict[str, Any] = {
        "word_embeddings": {
            "embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd["embeddings.position_embeddings.weight"]},
        "token_type_embeddings": {
            "embedding": sd["embeddings.token_type_embeddings.weight"]},
        "embeddings_ln": {"scale": sd["embeddings.LayerNorm.weight"],
                          "bias": sd["embeddings.LayerNorm.bias"]},
        "pooler": _linear(sd, "pooler.dense"),
    }
    for i in range(num_layers):
        e = f"encoder.layer.{i}"
        qkv_w = np.concatenate([sd[f"{e}.attention.self.query.weight"],
                                sd[f"{e}.attention.self.key.weight"],
                                sd[f"{e}.attention.self.value.weight"]], 0)
        qkv_b = np.concatenate([sd[f"{e}.attention.self.query.bias"],
                                sd[f"{e}.attention.self.key.bias"],
                                sd[f"{e}.attention.self.value.bias"]], 0)
        params[f"layer_{i}"] = {
            "attention": {
                "qkv": {"kernel": _t(qkv_w), "bias": qkv_b},
                "out": _linear(sd, f"{e}.attention.output.dense"),
            },
            "attention_ln": {
                "scale": sd[f"{e}.attention.output.LayerNorm.weight"],
                "bias": sd[f"{e}.attention.output.LayerNorm.bias"]},
            "intermediate": _linear(sd, f"{e}.intermediate.dense"),
            "output": _linear(sd, f"{e}.output.dense"),
            "output_ln": {"scale": sd[f"{e}.output.LayerNorm.weight"],
                          "bias": sd[f"{e}.output.LayerNorm.bias"]},
        }
    return params


def convert_hf_bert_state(sd: StateDict, num_layers: int) -> Dict[str, Any]:
    """HF BertModel state dict -> BertModel params in the pack layout. HF's
    BertModel and RobertaModel use identical parameter names
    (embeddings.* / encoder.layer.N.* / pooler.dense), so the mapping is
    the roberta one (open_clip/model.py:503 'bert' branch)."""
    return convert_hf_roberta_state(sd, num_layers)


def convert_hf_bart_encoder_state(sd: StateDict, num_layers: int = 6
                                  ) -> Dict[str, Any]:
    """HF BartModel state dict (encoder side) -> BartEncoderModel params
    in the pack layout, fused QKV (open_clip/model.py:533 'bart' branch)."""
    sd = to_numpy_state_dict(sd)
    if any(k.startswith("model.") for k in sd):
        sd = strip_prefix(sd, "model.")
    tok = sd.get("shared.weight", sd.get("encoder.embed_tokens.weight"))
    if tok is None:
        raise KeyError("shared.weight or encoder.embed_tokens.weight")
    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": tok},
        "embed_positions": {
            "embedding": sd["encoder.embed_positions.weight"]},
        "layernorm_embedding": {
            "scale": sd["encoder.layernorm_embedding.weight"],
            "bias": sd["encoder.layernorm_embedding.bias"]},
    }
    for i in range(num_layers):
        e = f"encoder.layers.{i}"
        qkv_w = np.concatenate([sd[f"{e}.self_attn.q_proj.weight"],
                                sd[f"{e}.self_attn.k_proj.weight"],
                                sd[f"{e}.self_attn.v_proj.weight"]], 0)
        qkv_b = np.concatenate([sd[f"{e}.self_attn.q_proj.bias"],
                                sd[f"{e}.self_attn.k_proj.bias"],
                                sd[f"{e}.self_attn.v_proj.bias"]], 0)
        params[f"layer_{i}"] = {
            "attention": {
                "qkv": {"kernel": _t(qkv_w), "bias": qkv_b},
                "out": _linear(sd, f"{e}.self_attn.out_proj"),
            },
            "attention_ln": {
                "scale": sd[f"{e}.self_attn_layer_norm.weight"],
                "bias": sd[f"{e}.self_attn_layer_norm.bias"]},
            "intermediate": _linear(sd, f"{e}.fc1"),
            "output": _linear(sd, f"{e}.fc2"),
            "output_ln": {"scale": sd[f"{e}.final_layer_norm.weight"],
                          "bias": sd[f"{e}.final_layer_norm.bias"]},
        }
    return params


def _dense_from_conv1x1(w: Array) -> Array:
    """torch Conv1d k=1 (O, I, 1) or Conv2d 1x1 (O, I, 1, 1) -> Dense
    kernel (I, O)."""
    return _t(w.reshape(w.shape[0], w.shape[1]))


def _att_branch(sd: StateDict, prefix: str, conv_idx, bn_idx
                ) -> Tuple[Dict, Dict]:
    """AFF/iAFF attention branch: Sequential(Conv, BN, ReLU, Conv, BN)
    (feature_fusion.py:34-49 1D / :71-87 2D; global variants have a
    leading AdaptiveAvgPool shifting the indices)."""
    p_bn1, s_bn1 = _bn(sd, f"{prefix}.{bn_idx[0]}")
    p_bn2, s_bn2 = _bn(sd, f"{prefix}.{bn_idx[1]}")
    params = {
        "fc1": {"kernel": _dense_from_conv1x1(
                    sd[f"{prefix}.{conv_idx[0]}.weight"]),
                "bias": sd[f"{prefix}.{conv_idx[0]}.bias"]},
        "fc2": {"kernel": _dense_from_conv1x1(
                    sd[f"{prefix}.{conv_idx[1]}.weight"]),
                "bias": sd[f"{prefix}.{conv_idx[1]}.bias"]},
        "bn1": p_bn1, "bn2": p_bn2,
    }
    return params, {"bn1": s_bn1, "bn2": s_bn2}


def _fusion_model(sd: StateDict, prefix: str) -> Tuple[Dict, Dict]:
    """AFF/iAFF params (DAF has none). local_att indices (0,3)/(1,4);
    global_att has the AvgPool at 0 so (1,4)/(2,5). iAFF adds local_att2;
    its global_att2 exists in checkpoints but the reference forward reuses
    global_att (feature_fusion.py:124) so it is intentionally dropped."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    branches = [("local_att", (0, 3), (1, 4)),
                ("global_att", (1, 4), (2, 5))]
    if f"{prefix}.local_att2.0.weight" in sd:
        branches.append(("local_att2", (0, 3), (1, 4)))
    for name, conv_idx, bn_idx in branches:
        p, s = _att_branch(sd, f"{prefix}.{name}", conv_idx, bn_idx)
        params[name], stats[name] = p, s
    return params, stats


def convert_htsat(sd: StateDict, depths=(2, 2, 12, 2)) -> Dict[str, Any]:
    """HTSAT state dict (audio_branch.* stripped) -> HTSAT params +
    batch_stats in the pack layout. Skips the front-end torchlibrosa conv
    weights (the port computes the log-mel itself) and the unused
    classification `head` Linear (the embedding path never touches it,
    htsat.py:1040-1060). Fusion variants (mel_conv1d/mel_conv2d/
    fusion_model, reference htsat.py:116-150, :979-991) are mapped when
    present."""
    sd = to_numpy_state_dict(sd)
    p_bn0, s_bn0 = _bn(sd, "bn0")
    params: Dict[str, Any] = {
        "bn0": p_bn0,
        "patch_embed_proj": _conv_layer(sd, "patch_embed.proj"),
        "patch_embed_norm": {"scale": sd["patch_embed.norm.weight"],
                             "bias": sd["patch_embed.norm.bias"]},
        "norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
        "tscam_conv": _conv_layer(sd, "tscam_conv"),
    }
    stats: Dict[str, Any] = {"bn0": s_bn0}

    # fusion variants (present only for enable_fusion checkpoints)
    if "mel_conv1d.0.weight" in sd:  # Conv1d(64,64,k5,s3) + BatchNorm1d
        params["mel_conv1d"] = {
            "kernel": np.ascontiguousarray(
                np.transpose(sd["mel_conv1d.0.weight"], (2, 1, 0))),
            "bias": sd["mel_conv1d.0.bias"],
        }
        p, s = _bn(sd, "mel_conv1d.1")
        params["mel_conv1d_bn"], stats["mel_conv1d_bn"] = p, s
    if "patch_embed.mel_conv2d.weight" in sd:
        params["mel_conv2d"] = _conv_layer(sd, "patch_embed.mel_conv2d")
    for fusion_prefix in ("fusion_model", "patch_embed.fusion_model"):
        if f"{fusion_prefix}.local_att.0.weight" in sd:
            p, s = _fusion_model(sd, fusion_prefix)
            params["fusion_model"], stats["fusion_model"] = p, s

    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            params[f"layers_{i}_blocks_{j}"] = {
                "norm1": {"scale": sd[f"{b}.norm1.weight"],
                          "bias": sd[f"{b}.norm1.bias"]},
                "norm2": {"scale": sd[f"{b}.norm2.weight"],
                          "bias": sd[f"{b}.norm2.bias"]},
                "attn": {
                    "qkv": _linear(sd, f"{b}.attn.qkv"),
                    "proj": _linear(sd, f"{b}.attn.proj"),
                    "relative_position_bias_table":
                        sd[f"{b}.attn.relative_position_bias_table"],
                },
                "mlp_fc1": _linear(sd, f"{b}.mlp.fc1"),
                "mlp_fc2": _linear(sd, f"{b}.mlp.fc2"),
            }
        if i < len(depths) - 1:
            d = f"layers.{i}.downsample"
            params[f"layers_{i}_downsample"] = {
                "norm": {"scale": sd[f"{d}.norm.weight"],
                         "bias": sd[f"{d}.norm.bias"]},
                "reduction": {"kernel": _t(sd[f"{d}.reduction.weight"])},
            }
    return {"params": params, "batch_stats": stats}


def convert_pann(sd: StateDict, model_name: str = "Cnn14"
                 ) -> Dict[str, Any]:
    """PANN state dict (audio_branch.* stripped) -> PANN params +
    batch_stats in the pack layout (reference pann_model.py:171-684 incl.
    fusion variants; the CLAP factory's PANN audio-ckpt rekeying is
    factory.py:165-197). Skips the torchlibrosa front-end weights."""
    from lass_torch.models.clap.pann import _VARIANTS

    sd = to_numpy_state_dict(sd)
    channels, double, _, _, _ = _VARIANTS[model_name]
    p_bn0, s_bn0 = _bn(sd, "bn0")
    params: Dict[str, Any] = {
        "bn0": p_bn0,
        "fc1": _linear(sd, "fc1"),
        "fc_audioset": _linear(sd, "fc_audioset"),
    }
    stats: Dict[str, Any] = {"bn0": s_bn0}
    for i in range(len(channels)):
        name = f"conv_block{i + 1}"
        p_bn1, s_bn1 = _bn(sd, f"{name}.bn1")
        p = {"conv1": _conv_layer(sd, f"{name}.conv1"), "bn1": p_bn1}
        s = {"bn1": s_bn1}
        if double:
            p_bn2, s_bn2 = _bn(sd, f"{name}.bn2")
            p["conv2"] = _conv_layer(sd, f"{name}.conv2")
            p["bn2"], s["bn2"] = p_bn2, s_bn2
        params[name], stats[name] = p, s
    if "mel_conv1d.0.weight" in sd:
        params["mel_conv1d"] = {
            "kernel": np.ascontiguousarray(
                np.transpose(sd["mel_conv1d.0.weight"], (2, 1, 0))),
            "bias": sd["mel_conv1d.0.bias"],
        }
        p, s = _bn(sd, "mel_conv1d.1")
        params["mel_conv1d_bn"], stats["mel_conv1d_bn"] = p, s
    if "mel_conv2d.0.weight" in sd:
        params["mel_conv2d"] = {
            "kernel": _conv(sd["mel_conv2d.0.weight"]),
            "bias": sd["mel_conv2d.0.bias"],
        }
        p, s = _bn(sd, "mel_conv2d.1")
        params["mel_conv2d_bn"], stats["mel_conv2d_bn"] = p, s
    if "fusion_model.local_att.0.weight" in sd:
        p, s = _fusion_model(sd, "fusion_model")
        params["fusion_model"], stats["fusion_model"] = p, s
    return {"params": params, "batch_stats": stats}


def convert_clap_audio_encoder(sd: StateDict, depths=(2, 2, 12, 2)
                               ) -> Dict[str, Any]:
    """CLAP checkpoint -> CLAPAudioEncoder variables (HTSAT audio_branch +
    audio_projection MLP, open_clip/model.py:565-570, 754-781)."""
    sd = to_numpy_state_dict(sd)
    if any(k.startswith("module.") for k in sd):
        sd = strip_prefix(sd, "module.")
    htsat = convert_htsat(strip_prefix(sd, "audio_branch."), depths)
    params = {
        "audio_branch": htsat["params"],
        "audio_projection": {
            "fc1": _linear(sd, "audio_projection.0"),
            "fc2": _linear(sd, "audio_projection.2"),
        },
    }
    return {"params": params,
            "batch_stats": {"audio_branch": htsat["batch_stats"]}}


def rekey_pretrained_audio(ckpt: Any, amodel_name: str, filename: str
                           ) -> StateDict:
    """Audio-only pretrained-checkpoint key remapping — reference
    factory.py:165-231. ``ckpt`` is the loaded checkpoint object (the
    caller torch.load()s it); returns audio_branch.-prefixed keys exactly
    as the reference feeds model.load_state_dict(strict=False).

    Recognized layouts:
    - PANN official ('Cnn14_mAP' in path): ckpt['model'], every key except
      the torchlibrosa front-end gains 'audio_branch.'
    - PANN/HTSAT trained via the HTSAT codebase (basename starts
      PANN/HTSAT): ckpt['state_dict'], 'sed_model.' -> 'audio_branch.'
    - HTSAT official ('HTSAT_AudioSet_Saved'): ckpt['state_dict'],
      'sed_model.' -> 'audio_branch.' with the front-end skipped
    - linear-probe ('finetuned...'): used as-is
    """
    import os as _os

    name = _os.path.basename(filename)
    front_end = ("spectrogram_extractor", "logmel_extractor")

    def _rekey(sd, strip_prefix_len, require_sed, skip_front):
        out = {}
        for k, v in sd.items():
            if require_sed and not k.startswith("sed_model"):
                out[k] = v
                continue
            if skip_front and any(f in k for f in front_end):
                out[k] = v
                continue
            out["audio_branch." + k[strip_prefix_len:]] = v
        return out

    if amodel_name.startswith("PANN"):
        if "Cnn14_mAP" in filename:
            return _rekey(ckpt["model"], 0, False, True)
        if name.startswith("PANN"):
            return _rekey(ckpt["state_dict"], 10, True, False)
        if name.startswith("finetuned"):
            return dict(ckpt)
        raise ValueError(f"unknown PANN audio checkpoint: {name}")
    if amodel_name.startswith("HTSAT"):
        if "HTSAT_AudioSet_Saved" in filename:
            return _rekey(ckpt["state_dict"], 10, True, True)
        if name.startswith("HTSAT"):
            return _rekey(ckpt["state_dict"], 10, True, False)
        if name.startswith("finetuned"):
            return dict(ckpt)
        raise ValueError(f"unknown HTSAT audio checkpoint: {name}")
    raise ValueError(f"unsupported audio encoder: {amodel_name}")


def convert_pretrained_audio(ckpt: Any, amodel_name: str, filename: str
                             ) -> Dict[str, Any]:
    """Pretrained audio-only checkpoint -> audio-branch variables
    (rekey per factory.py:165-231, strip the prefix, dispatch to the
    matching converter)."""
    sd = to_numpy_state_dict(rekey_pretrained_audio(ckpt, amodel_name,
                                                    filename))
    branch = strip_prefix(sd, "audio_branch.")
    if amodel_name.startswith("PANN"):
        model_name = {"PANN-14": "Cnn14", "PANN-10": "Cnn10",
                      "PANN-6": "Cnn6"}.get(amodel_name, "Cnn14")
        return convert_pann(branch, model_name)
    return convert_htsat(branch)


def convert_clap_text_encoder(sd: StateDict, num_layers: int = 12,
                              model_type: str = "roberta"
                              ) -> Dict[str, Any]:
    """CLAP checkpoint -> CLAP*TextEncoder params: text_branch
    (roberta/bert/bart, open_clip/model.py:475-549) + 2-layer
    text_projection MLP (:517-531)."""
    sd = to_numpy_state_dict(sd)
    if any(k.startswith("module.") for k in sd):
        sd = strip_prefix(sd, "module.")
    branch_sd = strip_prefix(sd, "text_branch.")
    if model_type == "roberta":
        branch = {"roberta": convert_hf_roberta_state(branch_sd, num_layers)}
    elif model_type == "bert":
        branch = {"bert": convert_hf_bert_state(branch_sd, num_layers)}
    elif model_type == "bart":
        branch = {"bart": convert_hf_bart_encoder_state(branch_sd,
                                                        num_layers)}
    else:
        raise NotImplementedError(f"text model_type '{model_type}'")
    branch["text_projection"] = {
        "fc1": _linear(sd, "text_projection.0"),
        "fc2": _linear(sd, "text_projection.2"),
    }
    return branch
