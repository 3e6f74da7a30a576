"""The plain reference of CleanUMamba (mamba bottleneck): offline forward,
streaming as prime + one block, and the training loss.

Plain PyTorch in fp32, written from the reference's equations; it imports
nothing of the program.  Every product (the strided encoder conv, the 1x1
mixes, the transposed conv, the bottleneck's projections) goes through
:meth:`Prec.mm`, whose operands are rounded to ``precision`` first: "fp32"
(exact; the caller turns TF32 off), or a lower precision that stands in for
the program as the control: "tf32" (10-bit mantissa), "bf16", or "fp8"
(e4m3 with a per-tensor scale).  The scan and the elementwise math stay
fp32; in "bf16" and "fp8" the weights and the input of the offline forward
are rounded as well, as a mixed-precision step casts them.  Streaming
(normalised input) follows the per-frame semantics: frame
t's first-level input is divided by its running std s_t = std_t / n_t +
(1 - 1/n_t) s_(t-1); its output is multiplied by s_t.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# precisions of a mixed-precision forward: every weight and the input are
# cast too, as the program's bf16 training step casts them (TF32 rounds the
# products' operands alone)
CASTS = ("bf16", "fp8")

# leaves that keep fp32 when the weights are stored in bf16 (``A_log`` and
# the dt bias: the decay and the step size)
FP32_KEYS = ("A_log", "A_real", "A_imag", "inv_dt", "dt_proj_b")


class Prec:
    """Operand rounding of every product."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "tf32", "bf16", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def r(self, x):
        """``x`` rounded; under autograd the rounding passes the gradient
        through unchanged (straight through)."""
        if self.precision == "fp32":
            return x
        q = self._round(x.detach())
        return x + (q - x.detach()) if x.requires_grad else q

    def _round(self, x):
        if self.precision == "bf16":
            return x.to(torch.bfloat16).float()
        if self.precision == "tf32":  # to nearest at 10 mantissa bits
            bits = x.float().contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a, b):
        return self.r(a) @ self.r(b)


def stored(params, weights: str):
    """The weights as the program stores them: "fp32" as given; "bf16":
    every leaf of two or more dimensions outside ``FP32_KEYS`` rounded to
    bf16 (and computed in fp32)."""
    if weights == "fp32":
        return params
    if weights != "bf16":
        raise ValueError(weights)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        if t.ndim >= 2 and not set(path) & set(FP32_KEYS):
            return t.to(torch.bfloat16).float()
        return t

    return walk(params, ())


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_map(fn, v) for v in t]
    return fn(t)


def valid_length(length: int, geom: dict) -> int:
    D, K, S = geom["encoder_n_layers"], geom["kernel_size"], geom["stride"]
    for _ in range(D):
        length = 1 if length < K else 1 + math.ceil((length - K) / S)
    for _ in range(D):
        length = (length - 1) * S + K
    return length


def _std(x):
    """Population std over the last axis, + 1e-3."""
    return x.std(dim=-1, keepdim=True, correction=0) + 1e-3


# -- layers -------------------------------------------------------------------

def enc_level(p, x, geom, m: Prec):
    """Strided conv (valid) -> ReLU -> 1x1 -> GLU(sigmoid).  x (B, T, Cin)."""
    K, S = geom["kernel_size"], geom["stride"]
    B, T, C = x.shape
    n = (T - K) // S + 1
    win = torch.stack([x[:, k:k + S * (n - 1) + 1:S, :] for k in range(K)], dim=2)
    y = m.mm(win.reshape(B, n, K * C), p["conv_w"].reshape(K * C, -1)) + p["conv_b"]
    y = m.mm(torch.relu(y), p["mix_w"][0]) + p["mix_b"]
    h = y.shape[-1] // 2
    return y[..., :h] * torch.sigmoid(y[..., h:])


def dec_level(p, x, geom, m: Prec):
    """1x1 -> GLU(sigmoid) -> transposed conv, no ReLU.  (B, T, C) -> (B, (T-1)S+K, Cout)."""
    K, S = geom["kernel_size"], geom["stride"]
    y = m.mm(x, p["mix_w"][0]) + p["mix_b"]
    h = y.shape[-1] // 2
    y = y[..., :h] * torch.sigmoid(y[..., h:])
    B, T, C = y.shape
    w = p["convt_w"]  # (K, C, Cout)
    z = m.mm(y, w.permute(1, 0, 2).reshape(C, -1)).reshape(B, T, K, -1)
    out = y.new_zeros((B, (T - 1) * S + K, z.shape[-1]))
    for k in range(K):
        out[:, k:k + (T - 1) * S + 1:S] += z[:, :, k]
    return out + p["convt_b"]


def pointwise(p, x, m: Prec):
    return m.mm(x, p["w"][0]) + p["b"]


def layer_norm(p, x, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def scan(u, dt, A, Bm, Cm, h, chunk: int = 32):
    """h_t = exp(dt_t A) h_(t-1) + dt_t u_t B_t;  y_t = C_t . h_t, step by step
    in fp32.  u, dt (B, L, Di); A (Di, N); Bm, Cm (B, L, N); h (B, Di, N).
    Returns (y (B, L, Di), h_last)."""
    ys = []
    for c0 in range(0, u.shape[1], chunk):
        c1 = min(c0 + chunk, u.shape[1])
        dA = torch.exp(dt[:, c0:c1, :, None] * A)
        dBu = (dt[:, c0:c1] * u[:, c0:c1])[..., None] * Bm[:, c0:c1, None, :]
        hs = []
        for t in range(c1 - c0):
            h = dA[:, t] * h + dBu[:, t]
            hs.append(h)
        ys.append(torch.einsum("btdn,btn->btd", torch.stack(hs, 1), Cm[:, c0:c1]))
    return torch.cat(ys, 1), h


def mixer(p, x, cache, m: Prec, grad_chunks: bool = False):
    """Mamba mixer over x (B, T, d_model) from ``cache`` = (the last d_conv - 1
    pre-conv inputs (B, d_conv - 1, Di), the SSM state (B, Di, N))."""
    di = p["D"].shape[0]
    r = p["dt_proj_w"].shape[0]
    N = p["A_log"].shape[1]
    xz = m.mm(x, p["in_proj"])
    xs, z = xz[..., :di], xz[..., di:]
    hist, h0 = cache
    ctx = torch.cat([hist, xs], 1)
    Kc, T = p["conv_w"].shape[0], xs.shape[1]
    pre = sum(ctx[:, k:k + T] * p["conv_w"][k] for k in range(Kc)) + p["conv_b"]
    xs_a = F.silu(pre)
    dbc = m.mm(xs_a, p["x_proj"])
    dt = F.softplus(m.mm(dbc[..., :r], p["dt_proj_w"]) + p["dt_proj_b"])
    Bm, Cm = dbc[..., r:r + N], dbc[..., r + N:]
    A = -torch.exp(p["A_log"])
    if grad_chunks:  # training: keep one chunk's states at a time
        y, h = _scan_checkpointed(xs_a, dt, A, Bm, Cm, h0)
    else:
        y, h = scan(xs_a, dt, A, Bm, Cm, h0)
    y = (y + xs_a * p["D"]) * F.silu(z)
    return m.mm(y, p["out_proj"]), (ctx[:, ctx.shape[1] - (Kc - 1):], h)


def _scan_checkpointed(u, dt, A, Bm, Cm, h, chunk: int = 32):
    from torch.utils.checkpoint import checkpoint

    ys = []
    for c0 in range(0, u.shape[1], chunk):
        c1 = min(c0 + chunk, u.shape[1])
        y, h = checkpoint(scan, u[:, c0:c1], dt[:, c0:c1], A, Bm[:, c0:c1], Cm[:, c0:c1], h,
                          chunk, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, 1), h


def bottleneck(P, x, cache, geom, m: Prec, grad_chunks: bool = False):
    """Pre-norm residual Mamba layers and the final norm over (B, T, d_model)."""
    eps = geom.get("norm_epsilon", 1e-5)
    bp = P["bottleneck"]
    hidden, residual, new = x, None, []
    for l, lp in enumerate(bp["layers"]):
        residual = hidden if residual is None else hidden + residual
        hidden, c = mixer(lp["mixer"], layer_norm(lp["norm"], residual, eps), cache[l], m,
                          grad_chunks)
        new.append(c)
    return layer_norm(bp["norm_f"], hidden + residual, eps), new


def zero_cache(P, batch, device):
    out = []
    for lp in P["bottleneck"]["layers"]:
        mp = lp["mixer"]
        Kc, di = mp["conv_w"].shape
        out.append((torch.zeros((batch, Kc - 1, di), device=device),
                    torch.zeros((batch, di, mp["A_log"].shape[1]), device=device)))
    return out


# -- offline ------------------------------------------------------------------

def forward(P, noisy, geom, m: Prec = Prec(), grad_chunks: bool = False):
    """Offline denoising: noisy (B, L) -> (B, L)."""
    from torch.utils.checkpoint import checkpoint

    B, L = noisy.shape
    x = noisy.float()
    if m.precision in CASTS:  # mixed precision casts every weight and the input
        P, x = _tree_map(m.r, P), m.r(x)
    if geom.get("normalize_input", True):
        std = _std(x)
        x = x / std
    x = F.pad(x, (0, valid_length(L, geom) - L))[..., None]
    run = (lambda f, *a: checkpoint(f, *a, use_reentrant=False)) if grad_chunks else \
        (lambda f, *a: f(*a))
    skips = []
    for ep in P["encoder"]:
        x = run(lambda p, v: enc_level(p, v, geom, m), ep, x)
        skips.append(x)
    x = pointwise(P["tsfm_conv1"], x, m)
    x, _ = bottleneck(P, x, zero_cache(P, B, x.device), geom, m, grad_chunks)
    x = pointwise(P["tsfm_conv2"], x, m)
    D = len(P["decoder"])
    for j, dp in enumerate(P["decoder"]):
        x = x + skips[D - 1 - j][:, :x.shape[1]]
        x = run(lambda p, v: dec_level(p, v, geom, m), dp, x)
        if j != D - 1:
            x = torch.relu(x)
    y = x[:, :L, 0]
    return y * std if geom.get("normalize_input", True) else y


# -- streaming ------------------------------------------------------------------

def _decode(P, geom, skips, tokens, tails, m: Prec):
    """The streaming decoder over new bottleneck outputs ``tokens`` (B, T, C):
    per level, skip-add, mix, GLU, transposed conv, the carried tail added
    to the first S outputs (None at prime), ReLU but at the last level.
    Returns (out (B, T * total_stride, 1), new tails stored minus the bias)."""
    S, D = geom["stride"], geom["encoder_n_layers"]
    x, new = tokens, []
    for j, dp in enumerate(P["decoder"]):
        skip = skips[D - 1 - j]
        x = dec_level(dp, x + skip[:, :x.shape[1]], geom, m)
        new.append(x[:, -S:] - dp["convt_b"])
        x = x[:, :-S]
        if tails is not None:
            x = torch.cat([x[:, :S] + tails[j], x[:, S:]], 1)
        if j != D - 1:
            x = torch.relu(x)
    return x, new


def stream(P, geom, audio, m: Prec = Prec()):
    """A session's denoised output: ``audio`` (B, n) fed from its start, every
    frame of ``frame_length`` samples then every ``total_stride`` new ones;
    returns (B, total_stride * (1 + frames after the first)), the output of
    every whole frame, as a streaming step emits it."""
    D, K, S = geom["encoder_n_layers"], geom["kernel_size"], geom["stride"]
    ts, fl = S ** D, valid_length(1, geom)
    strides = [S ** (D - 1 - i) for i in range(D)]
    norm = geom.get("normalize_input", True)
    x = audio.float()
    B = x.shape[0]
    N = (x.shape[1] - fl) // ts
    # the running std of every frame, in float64 on the host
    n_frames = N + 1
    starts = torch.arange(n_frames) * ts
    frames = x.unfold(1, fl, ts)[:, :n_frames]  # (B, n_frames, fl)
    stds = _std(frames)[..., 0].double().cpu()
    ema = torch.empty_like(stds)
    for t in range(n_frames):
        n = t + 1  # frame t's count; the first frame's std is its own
        ema[:, t] = stds[:, t] if t == 0 else stds[:, t] / n + (1 - 1 / n) * ema[:, t - 1]
    ema = ema.float().to(x.device) if norm else torch.ones_like(ema, dtype=torch.float32,
                                                                     device=x.device)
    # prime: the first frame whole
    h = (x[:, :fl] / ema[:, :1])[..., None]
    outs0 = []
    for ep in P["encoder"]:
        h = enc_level(ep, h, geom, m)
        outs0.append(h)
    tok, cache = bottleneck(P, pointwise(P["tsfm_conv1"], outs0[-1], m),
                            zero_cache(P, B, x.device), geom, m)
    y0, tails = _decode(P, geom, outs0, pointwise(P["tsfm_conv2"], tok, m), None, m)
    out = [y0[:, :ts, 0] * ema[:, :1]]
    if N == 0:
        return out[0]
    # every later frame as one block
    per = K + S * (strides[0] - 1)
    ends = fl + ts * torch.arange(1, n_frames)
    idx = (ends[:, None] - per + torch.arange(per)).to(x.device)  # (N, per)
    sl = x[:, idx] / ema[:, 1:, None]  # (B, N, per)
    new0 = enc_level(P["encoder"][0], sl.reshape(B * N, per, 1), geom, m)
    skips = [torch.cat([outs0[0][:, strides[0]:], new0.reshape(B, N * strides[0], -1)], 1)]
    for i in range(1, D):
        prev = skips[-1]
        n_new = N * strides[i]
        new = enc_level(P["encoder"][i], prev[:, prev.shape[1] - (K + S * (n_new - 1)):],
                        geom, m)
        skips.append(torch.cat([outs0[i][:, strides[i]:], new], 1))
    tok, _ = bottleneck(P, pointwise(P["tsfm_conv1"], skips[-1], m), cache, geom, m)
    y, _ = _decode(P, geom, skips, pointwise(P["tsfm_conv2"], tok, m), tails, m)
    out.append((y[:, :N * ts, 0].reshape(B, N, ts) * ema[:, 1:, None]).reshape(B, N * ts))
    return torch.cat(out, 1)


# -- training loss ------------------------------------------------------------

def stft_mag(x, n_fft, hop, win):
    w = torch.hann_window(win, dtype=torch.float32, device=x.device)
    s = torch.stft(x, n_fft, hop_length=hop, win_length=win, window=w, center=True,
                   pad_mode="reflect", return_complex=True)
    return torch.sqrt(torch.clamp(s.real.square() + s.imag.square(), min=1e-7))


def loss(denoised, clean, lc: dict):
    """L1 (``ell_p_lambda``) + multi-resolution STFT (spectral convergence and
    log-magnitude L1, each averaged over the resolutions and weighted)."""
    total = (denoised - clean).abs().mean() * lc["ell_p_lambda"]
    st = lc["stft_config"]
    sc = mag = 0.0
    for n_fft, hop, win in zip(st["fft_sizes"], st["hop_sizes"], st["win_lengths"]):
        xm, ym = stft_mag(denoised, n_fft, hop, win), stft_mag(clean, n_fft, hop, win)
        sc = sc + (ym - xm).norm() / ym.norm()
        mag = mag + (ym.log() - xm.log()).abs().mean()
    n = len(st["fft_sizes"])
    return total + lc["stft_lambda"] * (st["sc_lambda"] * sc / n + st["mag_lambda"] * mag / n)
