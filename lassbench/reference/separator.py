"""ResUNet30 (AudioSep), plain float32, as functions of a state dict.

mixture (B, 1, L) + condition (B, 512) -> separated (B, 1, L): STFT
(window 1024, hop 160, centre reflect, periodic hann) -> magnitude ->
``bn0`` over the 513 bins -> time padded to a multiple of 32, frequency
cut to 512 bins -> ``pre_conv`` -> 6 encoder blocks, ``conv_block7a``, 6
decoder blocks, each residual block FiLM-conditioned (a beta added after
each BatchNorm) -> ``after_conv`` -> K=3 complex mask (sigmoid magnitude,
tanh phase normalised, rotated against the mixture's phase; the Nyquist
bin zero) -> inverse STFT (overlap-add over the squared-window
envelope).

State-dict keys are the checkpoint's ``base.*``; FiLM's per-layer
Linears are one matrix ``film.weight`` (rows in ``film_spec()`` order)
with ``film.bias``. ``training=True`` normalises with batch statistics
(no running statistics are read or kept) and ``checkpointed=True``
recomputes each residual block in the backward pass, which leaves the
arithmetic as it is. ``quant`` (a control) rounds through the given
low-precision cast every tensor that a lower-precision program would
hold: each convolution's input, weight and output, and each
normalisation, FiLM addition, activation, residual sum, pooling and
up-sampling output.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

N_FFT, HOP = 1024, 160
BINS = N_FFT // 2 + 1
ENCODER = [("encoder_block1", 32, 32, (2, 2)),
           ("encoder_block2", 32, 64, (2, 2)),
           ("encoder_block3", 64, 128, (2, 2)),
           ("encoder_block4", 128, 256, (2, 2)),
           ("encoder_block5", 256, 384, (2, 2)),
           ("encoder_block6", 384, 384, (1, 2)),
           ("conv_block7a", 384, 384, (1, 1))]
DECODER = [("decoder_block1", 384, 384, (1, 2)),
           ("decoder_block2", 384, 384, (2, 2)),
           ("decoder_block3", 384, 256, (2, 2)),
           ("decoder_block4", 256, 128, (2, 2)),
           ("decoder_block5", 128, 64, (2, 2)),
           ("decoder_block6", 64, 32, (2, 2))]
SLOPE = 0.01
EPS = 1e-5

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def film_spec() -> List[Tuple[str, int]]:
    """(beta's key, width) in the checkpoint's order; each decoder block's
    ``beta2`` is a dead row block that nothing reads."""
    spec = []
    for name, cin, cout, _ in ENCODER:
        spec += [(f"{name}.conv_block1.beta1", cin),
                 (f"{name}.conv_block1.beta2", cout)]
    for name, cin, cout, _ in DECODER:
        spec += [(f"{name}.beta1", cin), (f"{name}.beta2", cin),
                 (f"{name}.conv_block2.beta1", 2 * cout),
                 (f"{name}.conv_block2.beta2", cout)]
    return spec


def _bn_shapes(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,)), (f"{prefix}.bias", (c,)),
            (f"{prefix}.running_mean", (c,)), (f"{prefix}.running_var", (c,)),
            (f"{prefix}.num_batches_tracked", ())]


def _block_shapes(prefix: str, cin: int, cout: int):
    out = _bn_shapes(f"{prefix}.bn1", cin)
    out.append((f"{prefix}.conv1.weight", (cout, cin, 3, 3)))
    out += _bn_shapes(f"{prefix}.bn2", cout)
    out.append((f"{prefix}.conv2.weight", (cout, cout, 3, 3)))
    if cin != cout:
        out += [(f"{prefix}.shortcut.weight", (cout, cin, 1, 1)),
                (f"{prefix}.shortcut.bias", (cout,))]
    return out


def param_shapes(condition_size: int = 512) -> List[Tuple[str, tuple]]:
    """Every state-dict entry (key, shape) in the checkpoint's order."""
    rows = sum(w for _, w in film_spec())
    out = [("film.weight", (rows, condition_size)), ("film.bias", (rows,))]
    out += _bn_shapes("base.bn0", BINS)
    out += [("base.pre_conv.weight", (32, 1, 1, 1)),
            ("base.pre_conv.bias", (32,))]
    for name, cin, cout, _ in ENCODER:
        out += _block_shapes(f"base.{name}.conv_block1", cin, cout)
    for name, cin, cout, up in DECODER:
        out += _bn_shapes(f"base.{name}.bn1", cin)
        out.append((f"base.{name}.conv1.weight", (cin, cout) + up))
        out += _block_shapes(f"base.{name}.conv_block2", 2 * cout, cout)
    out += [("base.after_conv.weight", (3, 32, 1, 1)),
            ("base.after_conv.bias", (3,))]
    return out


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 at a per-tensor scale (amax to
    448), gradients straight through: the control one step of precision
    below the separator's bfloat16."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (t.detach() / scale).clamp(-448.0, 448.0).to(
        torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through bfloat16, gradients straight through: the
    reference at the separator's own precision (a witness, not a
    control)."""
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t).detach()


# --- DSP -----------------------------------------------------------------

def hann(device) -> torch.Tensor:
    n = torch.arange(N_FFT, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * np.pi * n / N_FFT)).float()


def stft(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, L) -> (real, imag) each (N, T, 513)."""
    spec = torch.stft(x.float(), N_FFT, HOP, window=hann(x.device),
                      center=True, pad_mode="reflect", return_complex=True)
    spec = spec.transpose(1, 2)
    return spec.real, spec.imag


def istft(real: torch.Tensor, imag: torch.Tensor, length: int
          ) -> torch.Tensor:
    """(N, T, 513) -> (N, length): each frame's inverse real FFT (the DC
    and Nyquist bins' imaginary parts, which a real signal lacks, dropped)
    times the window, overlap-added, over the squared-window envelope."""
    n_frames = real.shape[1]
    imag = imag.clone()
    imag[..., 0] = 0
    imag[..., -1] = 0
    win = hann(real.device)
    frames = torch.fft.irfft(torch.complex(real, imag), n=N_FFT, dim=-1) * win
    total = (n_frames - 1) * HOP + N_FFT
    y = F.fold(frames.transpose(1, 2), (1, total), (1, N_FFT),
               stride=(1, HOP))[:, 0, 0]
    env = F.fold((win * win).expand(1, n_frames, N_FFT).transpose(1, 2),
                 (1, total), (1, N_FFT), stride=(1, HOP))[:, 0, 0]
    y = y / torch.clamp(env, min=1e-11)
    return y[:, N_FFT // 2:N_FFT // 2 + length]


# --- layers --------------------------------------------------------------

def _q(t: torch.Tensor, quant: Quant) -> torch.Tensor:
    return t if quant is None else quant(t)


def batch_norm(x: torch.Tensor, sd: Dict, key: str, training: bool,
               dim: int = 1, quant: Quant = None) -> torch.Tensor:
    x = x.movedim(dim, 1)
    if training:
        y = F.batch_norm(x, None, None, sd[f"{key}.weight"],
                         sd[f"{key}.bias"], True, 0.0, EPS)
    else:
        y = F.batch_norm(x, sd[f"{key}.running_mean"],
                         sd[f"{key}.running_var"], sd[f"{key}.weight"],
                         sd[f"{key}.bias"], False, 0.0, EPS)
    return _q(y.movedim(1, dim), quant)


def conv(x, w, b, quant: Quant):
    return _q(F.conv2d(_q(x, quant), _q(w, quant), b,
                       padding=(w.shape[2] // 2, w.shape[3] // 2)), quant)


def film_act(x, beta, quant: Quant = None):
    return _q(F.leaky_relu(_q(x + beta[:, :, None, None], quant), SLOPE),
              quant)


def conv_block(sd, key, x, film, prefix, training, quant):
    h = conv(film_act(batch_norm(x, sd, f"{key}.bn1", training, quant=quant),
                      film[f"{prefix}.beta1"], quant),
             sd[f"{key}.conv1.weight"], None, quant)
    h = conv(film_act(batch_norm(h, sd, f"{key}.bn2", training, quant=quant),
                      film[f"{prefix}.beta2"], quant),
             sd[f"{key}.conv2.weight"], None, quant)
    if f"{key}.shortcut.weight" in sd:
        return _q(conv(x, sd[f"{key}.shortcut.weight"],
                       sd[f"{key}.shortcut.bias"], quant) + h, quant)
    return _q(x + h, quant)


def _encoder(sd, name, down, x, film, training, quant):
    enc = conv_block(sd, f"base.{name}.conv_block1", x, film,
                     f"{name}.conv_block1", training, quant)
    pooled = enc if down == (1, 1) else _q(F.avg_pool2d(enc, down, down),
                                           quant)
    return pooled, enc


def _decoder(sd, name, up, x, skip, film, training, quant):
    h = film_act(batch_norm(x, sd, f"base.{name}.bn1", training, quant=quant),
                 film[f"{name}.beta1"], quant)
    w = _q(sd[f"base.{name}.conv1.weight"], quant)
    h = torch.cat([_q(F.conv_transpose2d(_q(h, quant), w, None, up),
                      quant), skip], dim=1)
    return conv_block(sd, f"base.{name}.conv_block2", h, film,
                      f"{name}.conv_block2", training, quant)


def film_betas(sd: Dict, condition: torch.Tensor) -> Dict[str, torch.Tensor]:
    flat = condition.float() @ sd["film.weight"].t() + sd["film.bias"]
    out, offset = {}, 0
    for key, width in film_spec():
        out[key] = flat[:, offset:offset + width]
        offset += width
    return out


def unet(sd: Dict, x: torch.Tensor, film: Dict, training: bool = False,
         checkpointed: bool = False, quant: Quant = None) -> torch.Tensor:
    """(B, 1, T_pad, 512) -> mask logits (B, 3, T_pad, 512)."""
    def call(fn, *args):
        if checkpointed:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    x = conv(x, sd["base.pre_conv.weight"], sd["base.pre_conv.bias"], quant)
    skips = []
    for name, _, _, down in ENCODER:
        x, enc = call(lambda a, n=name, d=down: _encoder(
            sd, n, d, a, film, training, quant), x)
        skips.append(enc)
    # decoder_block1 takes conv_block7a's output and encoder_block6's skip
    for (name, _, _, up), skip in zip(DECODER, reversed(skips[:-1])):
        x = call(lambda a, s, n=name, u=up: _decoder(
            sd, n, u, a, s, film, training, quant), x, skip)
    return conv(x, sd["base.after_conv.weight"], sd["base.after_conv.bias"],
                quant)


def apply_mask(logits: torch.Tensor, real: torch.Tensor, imag: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (N, 3, T, 512), mixture spectrum (N, T, 513) -> the
    separated spectrum (N, T, 513), its Nyquist bin zero."""
    re, im = real[..., :-1], imag[..., :-1]
    mag = torch.sqrt(torch.clamp(re * re + im * im, min=1e-10))
    cos, sin = re / mag, im / mag
    mask_mag = torch.sigmoid(logits[:, 0])
    mr, mi = torch.tanh(logits[:, 1]), torch.tanh(logits[:, 2])
    norm = torch.clamp(torch.sqrt(mr * mr + mi * mi), min=1e-10)
    mc, ms = mr / norm, mi / norm
    out_mag = torch.relu(mag * mask_mag)
    out_re = out_mag * (cos * mc - sin * ms)
    out_im = out_mag * (sin * mc + cos * ms)
    return F.pad(out_re, (0, 1)), F.pad(out_im, (0, 1))


def separate(sd: Dict, mixture: torch.Tensor, condition: torch.Tensor,
             training: bool = False, checkpointed: bool = False,
             quant: Quant = None) -> torch.Tensor:
    """(B, 1, L) mixture and (B, 512) condition -> (B, 1, L)."""
    b, _, length = mixture.shape
    film = film_betas(sd, condition)
    real, imag = stft(mixture[:, 0])
    mag = torch.sqrt(torch.clamp(real * real + imag * imag, min=1e-10))
    x = batch_norm(_q(mag[:, None], quant), sd, "base.bn0", training, dim=3,
                   quant=quant)
    t = x.shape[2]
    x = F.pad(x, (0, 0, 0, -t % 32))[..., :BINS - 1]
    logits = unet(sd, x, film, training, checkpointed, quant)[:, :, :t]
    out_re, out_im = apply_mask(logits, real, imag)
    return istft(out_re, out_im, length)[:, None]
