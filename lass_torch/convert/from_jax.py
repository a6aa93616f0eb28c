"""lass_tpu parameter trees (numpy) -> the port's state dicts.

The inverse of the JAX package's torch -> JAX converters
(``lass_tpu/convert/torch_to_jax.py``), written from its layout rules:

- Linear:        kernel (in, out)        -> weight (out, in)
- Conv2d:        kernel (kh, kw, I, O)   -> weight (O, I, kh, kw)
- ConvTranspose: kernel (kh, kw, O, I)   -> weight (I, O, kh, kw)
- BatchNorm:     scale/bias + batch_stats mean/var -> weight/bias +
                 running_mean/running_var (num_batches_tracked 0)
- FiLM:          the fused kernel (cond, sum C_i), columns in spec order
                 -> the port's fused ``film.weight`` (sum C_i, cond), rows
                 in the same order
- RoBERTa:       fused QKV -> HF query/key/value
- LayerNorm:     scale/bias -> weight/bias
- HTSAT:         ``layers_{i}_blocks_{j}`` -> ``layers.{i}.blocks.{j}``,
                 ``mel_conv1d`` kernel (k, I, O) -> Conv1d (O, I, k), the
                 fusion blocks' Dense kernels (I, O) -> 1x1 Conv1d (O, I, 1)
                 (1D fusion) or Conv2d (O, I, 1, 1) (2D fusion)
- PANN:          ``conv_block{i}``, ``fc1``, ``fc_audioset`` as they are;
                 ``mel_conv1d(_bn)`` -> ``mel_conv1d.{0,1}``,
                 ``mel_conv2d(_bn)`` -> ``mel_conv2d.{0,1}``
- linear probe:  ``clap_model`` -> ``clap_model.*``, ``lp_layer`` (a Dense,
                 or MLPLayers' ``linear{i}``) -> ``lp_layer`` (a Linear, or
                 the Sequential's index 3 * i)
- CLAP pretraining: the ``CLAPTrainState`` params (audio, text, both logit
                 scales) and batch_stats -> one flat state dict with a CLAP
                 checkpoint's keys
- int8 state:    the ``quant`` collection (amax per input channel, at
                 ``<block>/<name>_in``) and the ``qpack`` collection
                 (``<block>/<name>_q`` = {kq (kh, kw, I, O) int8, sw, bc})
                 -> the buffers of the port's QConv ``<block>.<name>_q``
                 (amax; kq (O, I, kh, kw), sw, bc)

Inputs are nested dicts of numpy arrays (``{'params', 'batch_stats'}`` for
the separator), as the JAX package holds them or as an npz pack from
scripts/convert_checkpoint.py stores them. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_ENCODERS = ["encoder_block1", "encoder_block2", "encoder_block3",
             "encoder_block4", "encoder_block5", "encoder_block6",
             "conv_block7a"]
_DECODERS = ["decoder_block1", "decoder_block2", "decoder_block3",
             "decoder_block4", "decoder_block5", "decoder_block6"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # owned copy


def _conv_w(kernel) -> torch.Tensor:
    """(kh, kw, I, O) -> (O, I, kh, kw); the same permutation takes a
    transposed-conv kernel (kh, kw, O, I) to torch's (I, O, kh, kw)."""
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _linear(out: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _conv_w(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _bn(out: StateDict, prefix: str, p: Dict, s: Dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(s["mean"])
    out[f"{prefix}.running_var"] = _t(s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _conv_block(out: StateDict, prefix: str, p: Dict, s: Dict) -> None:
    _bn(out, f"{prefix}.bn1", p["bn1"], s["bn1"])
    _bn(out, f"{prefix}.bn2", p["bn2"], s["bn2"])
    _conv(out, f"{prefix}.conv1", p["conv1"])
    _conv(out, f"{prefix}.conv2", p["conv2"])
    if "shortcut" in p:
        _conv(out, f"{prefix}.shortcut", p["shortcut"])


def resunet30_state_dict_from_jax(variables: Dict[str, Any]) -> StateDict:
    """``{'params', 'batch_stats'}`` of lass_tpu ResUNet30 -> the port's
    ResUNet30 state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    base_p, base_s = params["base"], stats["base"]
    out: StateDict = {}
    _linear(out, "film", params["film"])
    _bn(out, "base.bn0", params["bn0"], stats["bn0"])
    _conv(out, "base.pre_conv", base_p["pre_conv"])
    _conv(out, "base.after_conv", base_p["after_conv"])
    for name in _ENCODERS:
        _conv_block(out, f"base.{name}.conv_block1",
                    base_p[name]["conv_block1"], base_s[name]["conv_block1"])
    for name in _DECODERS:
        p, s = base_p[name], base_s[name]
        _bn(out, f"base.{name}.bn1", p["bn1"], s["bn1"])
        out[f"base.{name}.conv1.weight"] = _conv_w(p["conv1"]["kernel"])
        _conv_block(out, f"base.{name}.conv_block2", p["conv_block2"],
                    s["conv_block2"])
    return out


def multistft_state_dict_from_jax(variables: Dict[str, Any]) -> StateDict:
    """``{'params', 'batch_stats'}`` of lass_tpu MultiSTFTResUNet30 ->
    the port's MultiSTFTResUNet30 state dict (the same module names; the
    windows are read from the ``bn0_<win>`` entries). A
    ``neg_query_fusion`` entry of params (a NegQueryAudioSepTask's state)
    is left out: ``neg_query_fusion_state_dict_from_jax`` takes it."""
    params, stats = variables["params"], variables["batch_stats"]
    wins = sorted(int(k[len("bn0_"):]) for k in params
                  if k.startswith("bn0_"))
    out: StateDict = {}
    _linear(out, "film", params["film"])
    for w in wins:
        _bn(out, f"bn0_{w}", params[f"bn0_{w}"], stats[f"bn0_{w}"])
        _conv(out, f"pre_conv_{w}", params[f"pre_conv_{w}"])
        name = f"encoder_block1_{w}"
        _conv_block(out, f"{name}.conv_block1", params[name]["conv_block1"],
                    stats[name]["conv_block1"])
    for name in _ENCODERS[1:]:
        _conv_block(out, f"{name}.conv_block1", params[name]["conv_block1"],
                    stats[name]["conv_block1"])
    for name in _DECODERS:
        p, s = params[name], stats[name]
        _bn(out, f"{name}.bn1", p["bn1"], s["bn1"])
        out[f"{name}.conv1.weight"] = _conv_w(p["conv1"]["kernel"])
        _conv_block(out, f"{name}.conv_block2", p["conv_block2"],
                    s["conv_block2"])
    _conv(out, "after_conv", params["after_conv"])
    return out


def neg_query_fusion_state_dict_from_jax(params: Dict[str, Any]
                                         ) -> StateDict:
    """``params['neg_query_fusion']`` of a lass_tpu NegQueryAudioSepTask
    state -> the port's NegQueryFusion state dict."""
    out: StateDict = {}
    _linear(out, "fusion", params["fusion"])
    return out


def roberta_state_dict_from_jax(params: Dict[str, Any], num_layers: int,
                                prefix: str = "") -> StateDict:
    """lass_tpu RobertaModel params -> HF ``RobertaModel`` names."""
    out: StateDict = {}
    emb = f"{prefix}embeddings"
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{emb}.{name}.weight"] = _t(params[name]["embedding"])
    out[f"{emb}.LayerNorm.weight"] = _t(params["embeddings_ln"]["scale"])
    out[f"{emb}.LayerNorm.bias"] = _t(params["embeddings_ln"]["bias"])
    for i in range(num_layers):
        p = params[f"layer_{i}"]
        e = f"{prefix}encoder.layer.{i}"
        qkv_w = np.asarray(p["attention"]["qkv"]["kernel"]).T  # (3h, h)
        qkv_b = np.asarray(p["attention"]["qkv"]["bias"])
        h = qkv_w.shape[1]
        for j, name in enumerate(("query", "key", "value")):
            out[f"{e}.attention.self.{name}.weight"] = _t(
                qkv_w[j * h:(j + 1) * h])
            out[f"{e}.attention.self.{name}.bias"] = _t(
                qkv_b[j * h:(j + 1) * h])
        _linear(out, f"{e}.attention.output.dense", p["attention"]["out"])
        out[f"{e}.attention.output.LayerNorm.weight"] = _t(
            p["attention_ln"]["scale"])
        out[f"{e}.attention.output.LayerNorm.bias"] = _t(
            p["attention_ln"]["bias"])
        _linear(out, f"{e}.intermediate.dense", p["intermediate"])
        _linear(out, f"{e}.output.dense", p["output"])
        out[f"{e}.output.LayerNorm.weight"] = _t(p["output_ln"]["scale"])
        out[f"{e}.output.LayerNorm.bias"] = _t(p["output_ln"]["bias"])
    _linear(out, f"{prefix}pooler.dense", params["pooler"])
    return out


def clap_text_state_dict_from_jax(params: Dict[str, Any], num_layers: int
                                  ) -> StateDict:
    """lass_tpu CLAPTextEncoder params -> the port's CLAPTextEncoder state
    dict, whose keys are a CLAP checkpoint's (``text_branch.*`` HF RoBERTa
    names, ``text_projection.{0,2}``)."""
    out = roberta_state_dict_from_jax(params["roberta"], num_layers,
                                      prefix="text_branch.")
    _linear(out, "text_projection.0", params["text_projection"]["fc1"])
    _linear(out, "text_projection.2", params["text_projection"]["fc2"])
    return out


def _ln(out: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _fusion_model(out: StateDict, prefix: str, p: Dict, s: Dict,
                  dims: int) -> None:
    """AFF / iAFF branches: Sequential(Conv, BN, ReLU, Conv, BN), the
    global one after an AdaptiveAvgPool (indices shifted by one)."""
    for name, p_branch in p.items():
        first = 1 if name.startswith("global") else 0
        s_branch = s[name]
        for k, idx in (("fc1", first), ("fc2", first + 3)):
            w = np.asarray(p_branch[k]["kernel"]).T  # (O, I)
            out[f"{prefix}.{name}.{idx}.weight"] = _t(
                w.reshape(w.shape + (1,) * dims))
            out[f"{prefix}.{name}.{idx}.bias"] = _t(p_branch[k]["bias"])
        for k, idx in (("bn1", first + 1), ("bn2", first + 4)):
            _bn(out, f"{prefix}.{name}.{idx}", p_branch[k], s_branch[k])


def swin_block_from_jax(out: StateDict, prefix: str, p: Dict[str, Any]
                        ) -> None:
    """One lass_tpu SwinBlock's params -> the port's SwinBlock keys."""
    _ln(out, f"{prefix}.norm1", p["norm1"])
    _linear(out, f"{prefix}.attn.qkv", p["attn"]["qkv"])
    _linear(out, f"{prefix}.attn.proj", p["attn"]["proj"])
    out[f"{prefix}.attn.relative_position_bias_table"] = _t(
        p["attn"]["relative_position_bias_table"])
    _ln(out, f"{prefix}.norm2", p["norm2"])
    _linear(out, f"{prefix}.mlp.fc1", p["mlp_fc1"])
    _linear(out, f"{prefix}.mlp.fc2", p["mlp_fc2"])


def patch_merging_from_jax(out: StateDict, prefix: str, p: Dict[str, Any]
                           ) -> None:
    _ln(out, f"{prefix}.norm", p["norm"])
    _linear(out, f"{prefix}.reduction", p["reduction"])


def htsat_state_dict_from_jax(variables: Dict[str, Any],
                              depths=(2, 2, 12, 2)) -> StateDict:
    """``{'params', 'batch_stats'}`` of lass_tpu HTSAT -> the port's HTSAT
    state dict (the reference's ``audio_branch.*`` names without the
    prefix), fusion keys included when present: the exact inverse of
    ``convert_htsat`` in lass_tpu/convert/torch_to_jax.py."""
    params, stats = variables["params"], variables["batch_stats"]
    out: StateDict = {}
    _bn(out, "bn0", params["bn0"], stats["bn0"])
    _conv(out, "patch_embed.proj", params["patch_embed_proj"])
    _ln(out, "patch_embed.norm", params["patch_embed_norm"])
    for i, depth in enumerate(depths):
        for j in range(depth):
            swin_block_from_jax(out, f"layers.{i}.blocks.{j}",
                                params[f"layers_{i}_blocks_{j}"])
        if i < len(depths) - 1:
            patch_merging_from_jax(out, f"layers.{i}.downsample",
                                   params[f"layers_{i}_downsample"])
    _ln(out, "norm", params["norm"])
    _conv(out, "tscam_conv", params["tscam_conv"])
    if "mel_conv1d" in params:  # 1D fusion
        out["mel_conv1d.0.weight"] = _t(np.transpose(
            np.asarray(params["mel_conv1d"]["kernel"]), (2, 1, 0)))
        out["mel_conv1d.0.bias"] = _t(params["mel_conv1d"]["bias"])
        _bn(out, "mel_conv1d.1", params["mel_conv1d_bn"],
            stats["mel_conv1d_bn"])
    if "mel_conv2d" in params:  # 2D fusion
        _conv(out, "patch_embed.mel_conv2d", params["mel_conv2d"])
    if "fusion_model" in params:
        two_d = "mel_conv2d" in params
        _fusion_model(out, "patch_embed.fusion_model" if two_d
                      else "fusion_model", params["fusion_model"],
                      stats["fusion_model"], 2 if two_d else 1)
    return out


def clap_audio_state_dict_from_jax(variables: Dict[str, Any],
                                   depths=(2, 2, 12, 2)) -> StateDict:
    """lass_tpu CLAPAudioEncoder variables -> the port's CLAPAudioEncoder
    state dict (``audio_branch.*``, ``audio_projection.{0,2}``): the exact
    inverse of ``convert_clap_audio_encoder``."""
    return _audio_tower(variables,
                        lambda v: htsat_state_dict_from_jax(v, depths))


def pann_state_dict_from_jax(variables: Dict[str, Any]) -> StateDict:
    """``{'params', 'batch_stats'}`` of lass_tpu PANN -> the port's PANN
    state dict (the reference's names): the inverse of ``convert_pann``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: StateDict = {}
    _bn(out, "bn0", params["bn0"], stats["bn0"])
    i = 1
    while f"conv_block{i}" in params:
        p, s = params[f"conv_block{i}"], stats[f"conv_block{i}"]
        for k in ("1", "2"):
            if f"conv{k}" in p:
                _conv(out, f"conv_block{i}.conv{k}", p[f"conv{k}"])
                _bn(out, f"conv_block{i}.bn{k}", p[f"bn{k}"], s[f"bn{k}"])
        i += 1
    _linear(out, "fc1", params["fc1"])
    _linear(out, "fc_audioset", params["fc_audioset"])
    if "mel_conv1d" in params:  # 1D fusion
        out["mel_conv1d.0.weight"] = _t(np.transpose(
            np.asarray(params["mel_conv1d"]["kernel"]), (2, 1, 0)))
        out["mel_conv1d.0.bias"] = _t(params["mel_conv1d"]["bias"])
        _bn(out, "mel_conv1d.1", params["mel_conv1d_bn"],
            stats["mel_conv1d_bn"])
    if "mel_conv2d" in params:  # 2D fusion
        _conv(out, "mel_conv2d.0", params["mel_conv2d"])
        _bn(out, "mel_conv2d.1", params["mel_conv2d_bn"],
            stats["mel_conv2d_bn"])
    if "fusion_model" in params:
        _fusion_model(out, "fusion_model", params["fusion_model"],
                      stats["fusion_model"], 2 if "mel_conv2d" in params
                      else 1)
    return out


def _audio_tower(variables: Dict[str, Any], branch_fn) -> StateDict:
    """``audio_branch`` through ``branch_fn``, ``audio_projection``."""
    params, stats = variables["params"], variables["batch_stats"]
    branch = branch_fn({"params": params["audio_branch"],
                        "batch_stats": stats["audio_branch"]})
    out: StateDict = {f"audio_branch.{k}": v for k, v in branch.items()}
    _linear(out, "audio_projection.0", params["audio_projection"]["fc1"])
    _linear(out, "audio_projection.2", params["audio_projection"]["fc2"])
    return out


def clap_pann_audio_state_dict_from_jax(variables: Dict[str, Any]
                                        ) -> StateDict:
    """lass_tpu CLAPPANNAudioEncoder variables -> the port's
    CLAPPANNAudioEncoder state dict."""
    return _audio_tower(variables, pann_state_dict_from_jax)


def linear_probe_state_dict_from_jax(variables: Dict[str, Any],
                                     audio_model: str = "HTSAT",
                                     depths=(2, 2, 12, 2)) -> StateDict:
    """lass_tpu LinearProbe variables -> the port's LinearProbe state dict
    (``clap_model.audio_branch.*``, ``clap_model.audio_projection.*``,
    ``lp_layer.*``)."""
    params, stats = variables["params"], variables["batch_stats"]
    branch = (pann_state_dict_from_jax if audio_model.upper() == "PANN"
              else lambda v: htsat_state_dict_from_jax(v, depths))
    trunk = _audio_tower({"params": params["clap_model"],
                          "batch_stats": stats["clap_model"]}, branch)
    out: StateDict = {f"clap_model.{k}": v for k, v in trunk.items()}
    lp = params["lp_layer"]
    if "kernel" in lp:
        _linear(out, "lp_layer", lp)
    else:  # MLPLayers: Linear i at Sequential index 3 * i
        for i in range(len(lp)):
            _linear(out, f"lp_layer.{3 * i}", lp[f"linear{i}"])
    return out


def clap_pretrain_state_dict_from_jax(params: Dict[str, Any],
                                      batch_stats: Dict[str, Any],
                                      num_text_layers: int = 12,
                                      audio_model: str = "HTSAT",
                                      depths=(2, 2, 12, 2)) -> StateDict:
    """A lass_tpu ``CLAPTrainState``'s params (``audio``, ``text``,
    ``logit_scale_a``, ``logit_scale_t``) and batch_stats (the audio
    tower's BN running statistics) -> the flat state dict of the port's
    ``CLAPPretrainTask`` (``audio_branch.*``, ``audio_projection.*``,
    ``text_branch.*``, ``text_projection.*``, ``logit_scale_a``,
    ``logit_scale_t``)."""
    branch = (pann_state_dict_from_jax if audio_model.upper() == "PANN"
              else lambda v: htsat_state_dict_from_jax(v, depths))
    out = _audio_tower({"params": params["audio"],
                        "batch_stats": batch_stats}, branch)
    out.update(clap_text_state_dict_from_jax(params["text"],
                                             num_text_layers))
    for key in ("logit_scale_a", "logit_scale_t"):
        out[key] = _t(params[key])
    return out


def quant_state_from_jax(quant: Dict[str, Any],
                         qpack: Dict[str, Any] = None) -> StateDict:
    """lass_tpu ResUNet30(quantize=True)'s ``quant`` collection, and its
    ``qpack`` collection if given, -> the QConv buffers of the port's
    ResUNet30(quantize=True), for ``lass_torch.ops.quant.load_quant_state``.
    """
    out: StateDict = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict) and "kq" in value:
                layer = f"{prefix}{key}"
                out[f"{layer}.kq"] = torch.from_numpy(np.transpose(
                    np.asarray(value["kq"], np.int8), (3, 2, 0, 1)).copy())
                out[f"{layer}.sw"] = _t(value["sw"])
                out[f"{layer}.bc"] = _t(value["bc"])
            elif isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
            elif key.endswith("_in"):
                out[f"{prefix}{key[:-len('_in')]}_q.amax"] = _t(value)
            else:
                raise KeyError(f"unexpected int8 state {prefix}{key}")

    walk(quant, "")
    if qpack is not None:
        walk(qpack, "")
    return out
