"""HTSAT, the CLAP audio tower (counterpart of lass_tpu/models/clap/htsat.py).

The reference's models/CLAP/open_clip/htsat.py. HTSAT-base
(create_htsat_model :1275-1288): spec_size 256, patch 4x4 stride 4, embed
128, depths (2, 2, 12, 2), heads (4, 8, 16, 32), window 8, 527 classes,
log-mel at 48 kHz / n_fft 1024 / hop 480 / 64 mels (:864-902); the
frequency-ratio-4 time-to-frequency interleave (reshape_wav2img
:1076-1103); shifted-window attention with a relative position bias
(:352-464); PatchMerging (:640-680); the token-semantic tscam head and the
average-pooled ``embedding`` (:1012-1062). Module and parameter names are
the reference's (``patch_embed.proj``, ``layers.{i}.blocks.{j}.attn.qkv``,
``tscam_conv``...), so the state dict converts with the JAX package's
``convert_htsat`` and back with ``lass_torch.convert.from_jax``.

As in the JAX package:

- LayerNorm epsilon is flax's default 1e-6 (the reference's torch
  LayerNorms use 1e-5);
- the bicubic time stretch (1001 -> 1024 frames, align_corners=True) is one
  precomputed (1024, T) matmul (``_bicubic_matrix``), not
  ``F.interpolate``;
- the relative position indices and the shifted-window masks are numpy
  constants; attention is plain matmul + softmax (the JAX package has no
  Pallas kernel here);
- fusion-enabled configurations take a (B, 4, T, n_mels) mel stack and a
  (B,) ``longer`` flag; the local branch is computed for every item and
  picked with ``torch.where(longer)``.

Activations are NCHW around the convs, (B, tokens, C) through the Swin
stages. Train mode (``.train()``, CLAP pretraining) takes batch statistics
in bn0 (and in ``mel_conv1d`` and the fusion blocks) and spec-augments the
log-mel after bn0 (after the 1D fusion; on the 4-channel stack, stripes
shared by the channels, for 2D fusion and channel_map): two time stripes
up to 64 frames and two frequency stripes up to 8 bins per item, as
torchlibrosa's SpecAugmentation (reference htsat.py:896-901). The stripes
come from the forward's ``generator`` on the CPU (``draw_stripes``), then
``stripe_keep`` builds the mask from them on the mel's device, so a card
and a CPU run of one seed mask alike.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lass_torch.dsp.mel import LogMelConfig, log_mel_spectrogram
from lass_torch.models.clap.fusion import fusion_block
from lass_torch.nn.layers import BatchNorm
from lass_torch.parallel.host import row_span
from lass_torch.utils.precision import ieee_float32

LN_EPS = 1e-6  # flax nn.LayerNorm's default, which lass_tpu keeps
FUSION_1D = ("daf_1d", "aff_1d", "iaff_1d")
FUSION_2D = ("daf_2d", "aff_2d", "iaff_2d")
# spec-augment (torchlibrosa SpecAugmentation as HTSAT configures it):
# (widest stripe, stripes per item) in time and in frequency
TIME_STRIPES = (64, 2)
FREQ_STRIPES = (8, 2)


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    in_chans: int = 1
    num_classes: int = 527
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 12, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    mel: LogMelConfig = LogMelConfig()
    # long-audio mel fusion (reference htsat.py:116-150, :979-991,
    # :1150-1207)
    enable_fusion: bool = False
    fusion_type: str = "None"  # daf/aff/iaff x _1d/_2d, or channel_map

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel.n_mels

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


def htsat_base_config() -> HTSATConfig:
    return HTSATConfig()


def htsat_tiny_config() -> HTSATConfig:
    return HTSATConfig(embed_dim=96, depths=(2, 2, 6, 2))


def htsat_large_config() -> HTSATConfig:
    return HTSATConfig(embed_dim=256, depths=(2, 2, 12, 2))


# ---------------------------------------------------------------------------
# numpy constants (copies of the JAX package's)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _relative_position_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))  # (2, w, w)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, w*w, w*w)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)  # (w*w, w*w)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w) 0/-100 mask for SW-MSA (reference htsat.py:549-575)."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    windows = img.reshape(h // window, window, w // window, window)
    windows = windows.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bicubic_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """(dst, src) torch-style bicubic align_corners=True interpolation
    weights (Keys kernel, A=-0.75)."""
    if src == dst:
        return np.eye(src, dtype=np.float32)

    def kernel(x):
        x = np.abs(x)
        return np.where(
            x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0))

    scale = (src - 1) / (dst - 1)
    out = np.zeros((dst, src))
    for i in range(dst):
        pos = i * scale
        base = int(np.floor(pos))
        frac = pos - base
        for t in range(-1, 3):
            idx = min(max(base + t, 0), src - 1)
            out[i, idx] += kernel(t - frac)
    return out.astype(np.float32)


# made outside inference mode whatever the caller's mode (as the STFT
# window in dsp/stft.py)
@functools.lru_cache(maxsize=16)
def _bicubic_on(src: int, dst: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_bicubic_matrix(src, dst)).to(device)


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window*window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_reverse(x: torch.Tensor, window: int, h: int, w: int
                    ) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


# ---------------------------------------------------------------------------
# train-mode draws
# ---------------------------------------------------------------------------

def draw_stripes(batch: int, size: int, width: int, count: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, lengths), each (batch, count) int64 on the CPU: starts in
    [0, max(size - width, 1)), lengths in [0, width], the ranges of the
    JAX package's ``_spec_augment``; drawn for the global batch
    (``row_span``) and cut to this rank's rows."""
    total, first = row_span(batch)
    starts = torch.randint(0, max(size - width, 1), (total, count),
                           generator=generator)
    lengths = torch.randint(0, width + 1, (total, count),
                            generator=generator)
    return (starts[first:first + batch], lengths[first:first + batch])


def stripe_keep(starts: torch.Tensor, lengths: torch.Tensor, size: int,
                device=None) -> torch.Tensor:
    """(B, size) bool, False inside any of an item's stripes
    [start, start + length)."""
    starts, lengths = starts.to(device), lengths.to(device)
    idx = torch.arange(size, device=starts.device)
    hit = (idx >= starts[..., None]) & (idx < (starts + lengths)[..., None])
    return ~hit.any(dim=1)


def spec_augment(mel: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Zero random time and frequency stripes of (B, T, F) or (B, C, T, F)
    (shared across C); time stripes are drawn first, starts before
    lengths."""
    b, t, f = mel.shape[0], mel.shape[-2], mel.shape[-1]
    tkeep = stripe_keep(*draw_stripes(b, t, *TIME_STRIPES, generator), t,
                        mel.device)
    fkeep = stripe_keep(*draw_stripes(b, f, *FREQ_STRIPES, generator), f,
                        mel.device)
    mask = (tkeep[:, :, None] & fkeep[:, None, :]).to(mel.dtype)
    return mel * (mask[:, None] if mel.dim() == 4 else mask)


def device_generator(generator: Optional[torch.Generator],
                     device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from one draw of ``generator``
    (for masks too large to draw on the host: dropout)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def fuse_1d(mel_conv1d: nn.Module, fusion_model: nn.Module,
            mel4: torch.Tensor, longer: torch.Tensor) -> torch.Tensor:
    """1D mel fusion of HTSAT and PANN (reference htsat.py:1157-1196,
    pann_model.py:304-343): channel 0 is the global mel; channels 1:4 go
    through ``mel_conv1d`` (a stride-3 conv + BN over time, the mel bins as
    channels), are concatenated in time and attention-fused into the global
    one where ``longer``. (B, 4, T, F) -> (B, T, F)."""
    b, _, t, f = mel4.shape
    glob = mel4[:, 0]
    local = mel4[:, 1:].reshape(b * 3, t, f).transpose(1, 2)
    h = mel_conv1d(local)  # (3B, F, T2)
    t2 = h.shape[2]
    h = h.reshape(b, 3, f, t2).permute(0, 2, 1, 3).reshape(b, f, 3 * t2)
    h = h[:, :, :t] if 3 * t2 >= t else F.pad(h, (0, t - 3 * t2))
    fused = fusion_model(glob.transpose(1, 2), h).transpose(1, 2)
    return torch.where(longer.to(torch.bool)[:, None, None], fused, glob)


def _init_linear(layer: nn.Linear) -> nn.Linear:
    """The reference Swin's init: truncated normal 0.02, zero bias."""
    nn.init.trunc_normal_(layer.weight, std=0.02)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = _init_linear(nn.Linear(dim, 3 * dim))
        self.proj = _init_linear(nn.Linear(dim, dim))
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window - 1) ** 2,
                                              num_heads), std=0.02))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        bw, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (hd ** -0.5), qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)  # (bw, nh, n, n)
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(n, n, nh).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, nh, n, n)
                    + mask[None, :, None]).reshape(bw, nh, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = _init_linear(nn.Linear(dim, hidden))
        self.fc2 = _init_linear(nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact GELU


class SwinBlock(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        h, w = input_resolution
        if min(h, w) <= window:
            window, shift = min(h, w), 0
        self.input_resolution = (h, w)
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = (torch.from_numpy(_shift_attn_mask(h, w, window, shift))
                if shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        window, shift = self.window, self.shift
        b, l, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        x = self.attn(_window_partition(x, window), self.attn_mask)
        x = _window_reverse(x, window, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.input_resolution = input_resolution
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = _init_linear(nn.Linear(4 * dim, 2 * dim,
                                                bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    """One Swin stage: its blocks (shift 0, window/2, 0, ...) and, but for
    the last stage, a PatchMerging."""

    def __init__(self, dim: int, resolution: Tuple[int, int], depth: int,
                 num_heads: int, window: int, mlp_ratio: float,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, resolution, num_heads, window,
                      0 if j % 2 == 0 else window // 2, mlp_ratio)
            for j in range(depth)])
        self.downsample = (PatchMerging(resolution, dim) if downsample
                           else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    """``proj`` (p x p conv, stride p) and ``norm``; with 2D fusion also
    ``mel_conv2d`` (p x 3p, stride (p, 3p)) and ``fusion_model``
    (reference htsat.py:116-202)."""

    def __init__(self, cfg: HTSATConfig, in_chans: int, fusion_2d: bool):
        super().__init__()
        p, s, e = cfg.patch_size, cfg.patch_stride, cfg.embed_dim
        self.proj = nn.Conv2d(in_chans, e, p, stride=s)
        self.norm = nn.LayerNorm(e, eps=LN_EPS)
        if fusion_2d:
            self.mel_conv2d = nn.Conv2d(1, e, (p, 3 * p), stride=(s, 3 * s))
            self.fusion_model = fusion_block(cfg.fusion_type, e, 2)


class HTSAT(nn.Module):
    """waveform (B, L) at 48 kHz -> {'embedding': (B, num_features),
    'fine_grained_embedding', 'clipwise_output', 'framewise_output'}.

    A fusion-enabled configuration takes ``mel_fusion`` (B, 4, T, n_mels)
    and ``longer`` (B,) bool instead (the get_audio_features 'fusion'
    stack, ``audio_features.prepare_audio_fusion``)."""

    def __init__(self, cfg: HTSATConfig = HTSATConfig()):
        super().__init__()
        self.cfg = cfg
        fusion = cfg.enable_fusion
        self.fusion_1d = fusion and cfg.fusion_type in FUSION_1D
        self.fusion_2d = fusion and cfg.fusion_type in FUSION_2D
        if fusion and not (self.fusion_1d or self.fusion_2d
                           or cfg.fusion_type == "channel_map"):
            raise NotImplementedError(cfg.fusion_type)
        m = cfg.mel.n_mels
        self.bn0 = BatchNorm(m, dim=-1)  # over the mel axis
        # channel_map feeds the 4-channel stack straight into proj
        in_chans = 4 if fusion and cfg.fusion_type == "channel_map" \
            else cfg.in_chans
        self.patch_embed = PatchEmbed(cfg, in_chans, self.fusion_2d)
        if self.fusion_1d:
            # torch mel_conv1d: Conv1d + BatchNorm1d (momentum 0.1)
            self.mel_conv1d = nn.Sequential(
                nn.Conv1d(m, m, 5, stride=3, padding=2), BatchNorm(m, 0.1))
            self.fusion_model = fusion_block(cfg.fusion_type, m, 1)
        res = cfg.spec_size // cfg.patch_stride
        layers = []
        for i, depth in enumerate(cfg.depths):
            last = i == len(cfg.depths) - 1
            layers.append(BasicLayer(
                int(cfg.embed_dim * 2 ** i), (res, res), depth,
                cfg.num_heads[i], cfg.window_size, cfg.mlp_ratio,
                downsample=not last))
            res = res if last else res // 2
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(cfg.num_features, eps=LN_EPS)
        sf = cfg.spec_size // 2 ** (len(cfg.depths) - 1) // cfg.patch_stride
        self.tscam_conv = nn.Conv2d(cfg.num_features, cfg.num_classes,
                                    (sf // cfg.freq_ratio, 3), padding=(0, 1))

    def forward(self, waveform: Optional[torch.Tensor] = None, *,
                mel_fusion: Optional[torch.Tensor] = None,
                longer: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """``generator`` (a CPU generator) draws train mode's spec-augment
        stripes; torch's default one when None."""
        cfg = self.cfg
        train = self.training
        if cfg.enable_fusion:
            if mel_fusion is None or longer is None:
                raise ValueError("fusion-enabled HTSAT takes "
                                 "mel_fusion=(B,4,T,M) and longer=(B,)")
            mel4 = self.bn0(mel_fusion.float())  # (B, 4, T, M)
            if self.fusion_1d:
                mel = fuse_1d(self.mel_conv1d, self.fusion_model, mel4,
                              longer)
                if train:
                    mel = spec_augment(mel, generator)
                x = self._reshape_wav2img(mel)
            else:  # 2D families and channel_map keep the 4 channels
                if train:
                    mel4 = spec_augment(mel4, generator)
                x = self._reshape_wav2img_multi(mel4)
        else:
            mel = self.bn0(log_mel_spectrogram(waveform, cfg.mel))
            if train:
                mel = spec_augment(mel, generator)
            x = self._reshape_wav2img(mel)  # (B, 1, S, S)
        frames_num = x.shape[2]

        if self.fusion_2d:
            x = self._patch_embed_fused_2d(x, longer)
        else:
            x = self.patch_embed.proj(x)
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for layer in self.layers:
            x = layer(x)
        x = self.norm(x)

        # token-semantic head (reference forward_features :1012-1062)
        b, _, c = x.shape
        down = 2 ** (len(cfg.depths) - 1)
        sf = st = frames_num // down // cfg.patch_stride
        img = x.transpose(1, 2).reshape(b, c, sf, st)
        c_freq_bin = sf // cfg.freq_ratio
        img = img.reshape(b, c, sf // c_freq_bin, c_freq_bin, st)
        img = img.permute(0, 1, 3, 2, 4).reshape(b, c, c_freq_bin, -1)
        repeat = 8 * cfg.patch_stride
        fine = img.mean(dim=2)  # (B, C, T')
        logits = self.tscam_conv(img)[:, :, 0].transpose(1, 2)  # (B, T', K)
        return {
            "embedding": img.reshape(b, c, -1).mean(dim=-1),
            "fine_grained_embedding": fine.transpose(1, 2).repeat_interleave(
                repeat, dim=1),
            "clipwise_output": torch.sigmoid(logits.mean(dim=1)),
            "framewise_output": torch.sigmoid(logits).repeat_interleave(
                repeat, dim=1),
        }

    def _reshape_wav2img(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> (B, 1, S, S): the frequency-ratio interleave
        (reference :1076-1103), after the bicubic stretch to
        (spec_size * ratio, spec_size / ratio)."""
        cfg = self.cfg
        b, t, f = mel.shape
        target_t = cfg.spec_size * cfg.freq_ratio
        target_f = cfg.spec_size // cfg.freq_ratio
        if t > target_t or f > target_f:
            raise ValueError(f"mel ({t},{f}) larger than swin input "
                             f"({target_t},{target_f})")
        with ieee_float32():
            if t < target_t:
                mel = torch.matmul(_bicubic_on(t, target_t, mel.device), mel)
            if f < target_f:
                mel = torch.matmul(
                    mel, _bicubic_on(f, target_f, mel.device).t())
        # (B, F, T) -> (B, F, ratio, T/ratio) -> (B, ratio, F, T/ratio)
        x = mel.transpose(1, 2).reshape(b, target_f, cfg.freq_ratio,
                                        target_t // cfg.freq_ratio)
        x = x.transpose(1, 2).reshape(b, cfg.freq_ratio * target_f,
                                      target_t // cfg.freq_ratio)
        return x[:, None]

    def _reshape_wav2img_multi(self, mel4: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F) -> (B, C, S, S), the interleave per channel."""
        b, c, t, f = mel4.shape
        img = self._reshape_wav2img(mel4.reshape(b * c, t, f))
        return img.reshape(b, c, img.shape[2], img.shape[3])

    def _patch_embed_fused_2d(self, x: torch.Tensor, longer: torch.Tensor
                              ) -> torch.Tensor:
        """2D patch-embed fusion (reference htsat.py:151-190): the global
        channel through proj; the local ones through mel_conv2d, width-
        concatenated chunk-major, cropped or zero-padded to the global
        width, fused. (B, 4, S, S) -> (B, E, gh, gw)."""
        pe = self.patch_embed
        b, _, s1, s2 = x.shape
        glob = pe.proj(x[:, 0:1])  # (B, E, gh, gw)
        loc = pe.mel_conv2d(x[:, 1:4].reshape(b * 3, 1, s1, s2))
        e, th, tw = loc.shape[1:]
        loc = loc.reshape(b, 3, e, th, tw).permute(0, 2, 3, 1, 4).reshape(
            b, e, th, 3 * tw)
        gw = glob.shape[3]
        loc = loc[..., :gw] if 3 * tw >= gw else F.pad(loc, (0, gw - 3 * tw))
        fused = pe.fusion_model(glob, loc)
        return torch.where(longer.to(torch.bool)[:, None, None, None], fused,
                           glob)
