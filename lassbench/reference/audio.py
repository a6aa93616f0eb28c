"""CLAP's HTSAT-base audio branch and projection, plain float32, and the
16 -> 48 kHz resampling and log-mel in front of it (eval mode, no fusion).

(B, L) at ``rate`` -> resample to 48 kHz (hann-windowed sinc, width 6,
rolloff 0.99, as one strided conv) -> log-mel (48 kHz, n_fft 1024, hop
480, 64 slaney mels 50-14000 Hz, power, 10 log10) -> ``bn0`` over the mel
bins -> bicubic stretch (align_corners) to 1024 frames and the
frequency-ratio-4 interleave into a 256 x 256 image -> patch embedding
(4 x 4, stride 4) -> 4 Swin stages (depths 2, 2, 12, 2; heads 4, 8, 16,
32; window 8, shifted every second block; relative position bias) with
patch merging between them -> LayerNorm -> the token-semantic head's
average-pooled embedding (B, 1024) -> ``audio_projection`` -> L2
normalised (B, 512). LayerNorm epsilon 1e-6 (flax's default, which the
JAX package and its port keep). Keys: ``audio_branch.*`` (the
reference's HTSAT names) and ``audio_projection.{0,2}``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lassbench.signals import resample_kernel, resampled_length

LN_EPS = 1e-6


# --- resampling and log-mel ---------------------------------------------

def resample(x: torch.Tensor, orig: int, new: int) -> torch.Tensor:
    """(N, L) -> (N, ceil(L * new / orig))."""
    if orig == new:
        return x
    kernel, _, step = resample_kernel(orig, new)
    width = (kernel.shape[1] - step) // 2
    length = x.shape[-1]
    steps = -(-length // step)
    xp = F.pad(x[:, None].float(), (width, width + steps * step - length))
    w = torch.from_numpy(kernel)[:, None, :].to(x.device)
    out = F.conv1d(xp, w, stride=step).transpose(1, 2).reshape(x.shape[0], -1)
    return out[:, :resampled_length(length, orig, new)]


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(f >= min_hz, min_hz / f_sp
                    + np.log(np.maximum(f, 1e-10) / min_hz) / step, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    min_mel, step = min_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_mel, min_hz * np.exp(step * (m - min_mel)),
                    m * f_sp)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels): librosa's slaney-normalised filters."""
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                 n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def log_mel(x: torch.Tensor, mel: Dict) -> torch.Tensor:
    """(N, L) at mel['sample_rate'] -> (N, T, n_mels) dB."""
    n = mel["n_fft"]
    k = torch.arange(n, dtype=torch.float64, device=x.device)
    win = (0.5 - 0.5 * torch.cos(2 * np.pi * k / n)).float()
    spec = torch.stft(x.float(), n, mel["hop_length"], window=win,
                      center=True, pad_mode="reflect", return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    fb = torch.from_numpy(mel_filterbank(mel["sample_rate"], n,
                                         mel["n_mels"], mel["fmin"],
                                         mel["fmax"])).to(x.device)
    return 10.0 * torch.log10(torch.clamp(power @ fb, min=1e-10))


def bicubic_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """(dst, src) align_corners=True bicubic weights (Keys, A = -0.75)."""
    if src == dst:
        return np.eye(src, dtype=np.float32)

    def kern(x):
        x = np.abs(x)
        return np.where(x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                        np.where(x < 2, a * x ** 3 - 5 * a * x ** 2
                                 + 8 * a * x - 4 * a, 0.0))

    scale = (src - 1) / (dst - 1)
    out = np.zeros((dst, src))
    for i in range(dst):
        pos = i * scale
        base = int(np.floor(pos))
        for t in range(-1, 3):
            out[i, min(max(base + t, 0), src - 1)] += kern(t - (pos - base))
    return out.astype(np.float32)


# --- Swin ----------------------------------------------------------------

def _rel_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def _shift_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // win, win, w // win, win).transpose(
        0, 2, 1, 3).reshape(-1, win * win)
    return np.where(wins[:, None, :] != wins[:, :, None], -100.0,
                    0.0).astype(np.float32)


def _partition(x, win):
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def _reverse(x, win, h, w):
    c = x.shape[-1]
    x = x.reshape(-1, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


class Attention(nn.Module):
    def __init__(self, dim, win, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * win - 1) ** 2, heads))
        self.register_buffer("index", torch.from_numpy(
            _rel_index(win).reshape(-1)), persistent=False)

    def forward(self, x, mask):
        bw, n, c = x.shape
        nh, hd = self.heads, c // self.heads
        qkv = self.qkv(x).reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = (qkv[0] * hd ** -0.5) @ qkv[1].transpose(-2, -1)
        attn = attn + self.relative_position_bias_table[self.index].reshape(
            n, n, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, nh, n, n)
                    + mask[None, :, None]).reshape(bw, nh, n, n)
        out = (torch.softmax(attn, -1) @ qkv[2]).transpose(1, 2)
        return self.proj(out.reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, res, heads, win, shift, mlp_ratio):
        super().__init__()
        if min(res) <= win:
            win, shift = min(res), 0
        self.res, self.win, self.shift = res, win, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, win, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = (torch.from_numpy(_shift_mask(*res, win, shift))
                if shift else None)
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, x):
        (h, w), win, s = self.res, self.win, self.shift
        b, l, c = x.shape
        y = self.norm1(x).reshape(b, h, w, c)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = _reverse(self.attn(_partition(y, win), self.mask), win, h, w)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + y.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class Merge(nn.Module):
    def __init__(self, res, dim):
        super().__init__()
        self.res = res
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        (h, w), (b, _, c) = self.res, x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class Stage(nn.Module):
    def __init__(self, dim, res, depth, heads, win, mlp_ratio, merge):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(dim, res, heads, win, 0 if j % 2 == 0 else win // 2,
                  mlp_ratio) for j in range(depth))
        self.downsample = Merge(res, dim) if merge else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, p, s, e):
        super().__init__()
        self.proj = nn.Conv2d(1, e, p, stride=s)
        self.norm = nn.LayerNorm(e, eps=LN_EPS)


class BatchNormStats(nn.Module):
    """Eval BatchNorm's parameters and statistics (checkpoint names)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):  # over the last axis
        inv = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return (x - self.running_mean) * inv + self.bias


class HTSAT(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        m = cfg["mel"]["n_mels"]
        e, p = cfg["embed_dim"], cfg["patch_size"]
        self.bn0 = BatchNormStats(m)
        self.patch_embed = PatchEmbed(p, cfg["patch_stride"], e)
        res = cfg["spec_size"] // cfg["patch_stride"]
        layers, depths = [], cfg["depths"]
        for i, depth in enumerate(depths):
            last = i == len(depths) - 1
            layers.append(Stage(e * 2 ** i, (res, res), depth,
                                cfg["num_heads"][i], cfg["window_size"],
                                cfg["mlp_ratio"], not last))
            res = res if last else res // 2
        self.layers = nn.ModuleList(layers)
        feats = e * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(feats, eps=LN_EPS)
        ratio = cfg["spec_size"] // m
        sf = cfg["spec_size"] // 2 ** (len(depths) - 1) // cfg["patch_stride"]
        self.tscam_conv = nn.Conv2d(feats, cfg["num_classes"],
                                    (sf // ratio, 3), padding=(0, 1))

    def forward(self, wave48: torch.Tensor) -> torch.Tensor:
        """(B, L) at 48 kHz -> (B, num_features) embedding."""
        cfg = self.cfg
        mel = self.bn0(log_mel(wave48, cfg["mel"]))  # (B, T, M)
        b, t, f = mel.shape
        ratio = cfg["spec_size"] // f
        tt, tf = cfg["spec_size"] * ratio, cfg["spec_size"] // ratio
        mel = torch.from_numpy(bicubic_matrix(t, tt)).to(mel.device) @ mel
        if f < tf:
            mel = mel @ torch.from_numpy(bicubic_matrix(f, tf)).to(
                mel.device).t()
        x = mel.transpose(1, 2).reshape(b, tf, ratio, tt // ratio)
        x = x.transpose(1, 2).reshape(b, ratio * tf, tt // ratio)[:, None]
        frames = x.shape[2]
        x = self.patch_embed.proj(x)
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for layer in self.layers:
            x = layer(x)
        x = self.norm(x)
        c = x.shape[2]
        sf = frames // 2 ** (len(cfg["depths"]) - 1) // cfg["patch_stride"]
        img = x.transpose(1, 2).reshape(b, c, sf, sf)
        cfb = sf // ratio
        img = img.reshape(b, c, sf // cfb, cfb, sf).permute(
            0, 1, 3, 2, 4).reshape(b, c, cfb, -1)
        return img.reshape(b, c, -1).mean(-1)


class AudioTower(nn.Module):
    """Keys ``audio_branch.*`` and ``audio_projection.{0,2}``."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.audio_branch = HTSAT(cfg)
        feats = cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)
        e = cfg["joint_embed_dim"]
        self.audio_projection = nn.Sequential(
            nn.Linear(feats, e), nn.ReLU(), nn.Linear(e, e))

    def forward(self, audio: torch.Tensor, rate: int) -> torch.Tensor:
        """(B, L) at ``rate`` -> normalised (B, joint_embed_dim); every
        clip is 10 s, so its 48 kHz length is the tower's clip length."""
        wave = resample(audio, rate, self.audio_branch.cfg["mel"][
            "sample_rate"])
        z = self.audio_projection(self.audio_branch(wave))
        return z / torch.clamp(torch.linalg.vector_norm(
            z, dim=-1, keepdim=True), min=1e-12)


def param_shapes(cfg: Dict) -> List[Tuple[str, tuple]]:
    with torch.device("meta"):
        tower = AudioTower(cfg)
    return [(k, tuple(v.shape)) for k, v in tower.state_dict().items()]


def build(cfg: Dict, sd: Dict, device) -> AudioTower:
    with torch.device("meta"):
        tower = AudioTower(cfg)
    tower = tower.to_empty(device=device)
    tower.load_state_dict(sd)
    for blk in tower.modules():  # non-persistent constants
        if isinstance(blk, Attention):
            win = int(math.isqrt(blk.relative_position_bias_table.shape[0]))
            blk.index = torch.from_numpy(
                _rel_index((win + 1) // 2).reshape(-1)).to(device)
        if isinstance(blk, Block) and blk.shift:
            blk.mask = torch.from_numpy(_shift_mask(
                *blk.res, blk.win, blk.shift)).to(device)
    return tower.eval()
