"""Mamba2 SSD (state-space duality) layer: the chunked dense-matmul scan.

The recurrence  s_t = a_t s_{t-1} + b_t x_t  is sequential; SSD rewrites
chunks of length l as dense masked products (the attention-like
C (L o decay) B^T form), with only a loop over S / l chunks carrying the
state between them:

  * intra-chunk: the (l, l) decay-masked C.B^T product;
  * inter-chunk: a loop over the chunk states (B, H, N, P), the only
    sequential part;
  * decode: one O(1) state update a token.

The reference computes all of it as plain einsums and a `lax.scan`,
outside any Pallas kernel, and so does the port: `torch.einsum` and a
Python loop. Shapes follow the Mamba2 paper: d_in = expand * d_model,
heads = d_in / headdim, B and C shared by the heads of a group.

Dtypes follow the reference at use: the projections run in the compute
dtype; the conv, dt, A, the gated norm and the state run in float32;
`d_skip` is read in the compute dtype by `ssm_forward` and in float32 by
`ssm_decode` and `ssm_reference`, as there. So `a_log`, `dt_bias`,
`conv_w`, `conv_b`, `d_skip` and `norm` stay float32 leaves.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

from .common import dense_param
from .config import ArchConfig


class SSMParams(NamedTuple):
    w_zx: torch.Tensor       # (d, 2*d_in): z (the gate) and x
    w_bc: torch.Tensor       # (d, 2*g*n): B and C
    w_dt: torch.Tensor       # (d, H): the per-head timestep
    conv_w: torch.Tensor     # (k, d_in + 2*g*n) depthwise causal conv
    conv_b: torch.Tensor     # (d_in + 2*g*n,)
    a_log: torch.Tensor      # (H,): A = -exp(a_log)
    d_skip: torch.Tensor     # (H,): the skip connection ("D")
    dt_bias: torch.Tensor    # (H,)
    norm: torch.Tensor       # (d_in,): the gated RMSNorm's scale
    w_out: torch.Tensor      # (d_in, d)


class SSMCache(NamedTuple):
    """Decode state, static shapes."""
    conv: torch.Tensor       # (B, k-1, d_in + 2*g*n): the last conv inputs
    state: torch.Tensor      # (B, H, n, p) float32


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_in, heads, groups, d_state)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.headdim, s.n_groups, s.d_state


def ssm_init(cfg: ArchConfig, generator: torch.Generator, *,
             device: DeviceLike = None,
             dtype: torch.dtype = torch.float32) -> SSMParams:
    """The port's own init (Mamba2's defaults; the draws differ from
    `jax.random`): the four projections in `dtype`, the rest float32."""
    device = resolve_device(device)
    s = cfg.ssm
    d = cfg.d_model
    d_in, n_heads, g, n = ssm_dims(cfg)
    conv_ch = d_in + 2 * g * n

    def dense(*shape):
        return dense_param(shape, generator, device=device, dtype=dtype)
    w_zx, w_bc, w_dt = dense(d, 2 * d_in), dense(d, 2 * g * n), dense(
        d, n_heads)
    # dt bias: softplus(dt_bias) spans [1e-3, 1e-1] (Mamba2's default)
    u = torch.rand(n_heads, generator=generator, device=generator.device)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt0 = torch.exp(u * (hi - lo) + lo)
    dt_bias = (dt0 + torch.log(-torch.expm1(-dt0))).to(device)
    conv_w = dense_param((s.conv_kernel, conv_ch), generator,
                         scale=1.0 / s.conv_kernel, device=device)
    return SSMParams(
        w_zx=w_zx, w_bc=w_bc, w_dt=w_dt, conv_w=conv_w,
        conv_b=torch.zeros(conv_ch, device=device),
        a_log=torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                     device=device)),
        d_skip=torch.ones(n_heads, device=device), dt_bias=dt_bias,
        norm=torch.ones(d_in, device=device), w_out=dense(d_in, d))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, log(1 + e^x) as logaddexp(x, 0) at every x
    (`F.softplus` returns x itself above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _gated_rms_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's RMSNormGated: norm(y * silu(z)) * scale, in float32."""
    yf = y.float() * F.silu(z.float())
    var = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d and SiLU, in float32. x: (B, S, C), w:
    (k, C); k shifted multiply-adds."""
    k = w.shape[0]
    pads = x if init is None else torch.cat([init, x], dim=1)
    if init is None:
        pads = F.pad(pads, (0, 0, k - 1, 0))
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + pads[:, i:i + s].float() * w[i].float()
    return F.silu(out + b.float()).to(x.dtype)


def _segsum_decay(da_cum: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(cum_i - cum_j) for j <= i, else 0. da_cum: (..., l).
    Above the diagonal exp may be inf: a select, not a multiply, drops it
    (inf * 0 is NaN)."""
    diff = da_cum[..., :, None] - da_cum[..., None, :]
    n = diff.shape[-1]
    mask = torch.ones(n, n, dtype=torch.bool, device=diff.device).tril()
    return torch.where(mask, torch.exp(diff), 0.0)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xh: (B,S,H,P), dt: (B,S,H) after softplus, a: (H,)
    negative, bmat/cmat: (B,S,G,N). Returns (y (B,S,H,P) in xh's dtype,
    final state (B,H,N,P) float32). A ragged last chunk is padded with
    dt = 0 (decay 1, no update) and cut off the output."""
    b, s, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g
    l = min(chunk, s)
    s_orig = s
    pad = (-s) % l
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // l

    xc = xh.reshape(b, nc, l, h, p)
    dtc = dt.reshape(b, nc, l, h).float()
    bc = bmat.reshape(b, nc, l, g, n)
    cc = cmat.reshape(b, nc, l, g, n)

    da = dtc * a.float()                                  # (B,nc,l,H)
    da_cum = torch.cumsum(da, dim=2)
    da_total = da_cum[:, :, -1]                           # (B,nc,H)

    # intra-chunk: scores[b,c,h,i,j] = C_i.B_j L[i,j]; y_diag = scores @
    # (dt x). The product of compute-dtype operands sums in float32.
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc.float(), bc.float())
    lmat = _segsum_decay(da_cum.transpose(-1, -2))        # (B,nc,H,l,l)
    lmat = lmat.reshape(b, nc, g, hg, l, l)
    scores = cb[:, :, :, None] * lmat                     # (B,nc,G,hg,l,l)
    xdt = xc.float() * dtc[..., None]                     # (B,nc,l,H,P)
    xdt_g = xdt.reshape(b, nc, l, g, hg, p)
    y_diag = torch.einsum("bcghls,bcsghp->bclghp", scores, xdt_g)

    # chunk states: S_c = sum_j exp(da_total - da_cum_j) B_j (x) (dt_j x_j)
    decay_to_end = torch.exp(da_total[:, :, None] - da_cum)  # (B,nc,l,H)
    bw = bc[:, :, :, :, None, :] * decay_to_end.reshape(
        b, nc, l, g, hg)[..., None]
    states = torch.einsum("bclghn,bclghp->bcghnp", bw, xdt_g)

    # inter-chunk recurrence, the only loop: the state before each chunk
    st = (torch.zeros((b, g, hg, n, p), dtype=torch.float32,
                      device=xh.device) if init_state is None
          else init_state.reshape(b, g, hg, n, p).float())
    chunk_decay = torch.exp(da_total).reshape(b, nc, g, hg)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, ..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (B,nc,G,hg,N,P)

    # inter-chunk output: C_i . S_prev exp(da_cum_i)
    cdec = cc[:, :, :, :, None, :] * torch.exp(da_cum).reshape(
        b, nc, l, g, hg)[..., None]                       # (B,nc,l,G,hg,N)
    y_off = torch.einsum("bclghn,bcghnp->bclghp", cdec, prev_states)

    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y.to(xh.dtype), st.reshape(b, h, n, p)


def _project(p: SSMParams, cfg: ArchConfig, x: torch.Tensor):
    """The in-projections: (z, conv input (B, S, d_in + 2gn), raw dt)."""
    dt_ = cfg.dtype
    d_in = ssm_dims(cfg)[0]
    zx = x @ p.w_zx.to(dt_)
    z, xin = zx[..., :d_in], zx[..., d_in:]
    bcx = x @ p.w_bc.to(dt_)
    dt_raw = x @ p.w_dt.to(dt_)
    return z, torch.cat([xin, bcx], dim=-1), dt_raw


def _split_conv(cfg: ArchConfig, conv_out: torch.Tensor):
    """(x (..., d_in), B (..., g, n), C (..., g, n))."""
    d_in, _, g, n = ssm_dims(cfg)
    lead = conv_out.shape[:-1]
    return (conv_out[..., :d_in],
            conv_out[..., d_in:d_in + g * n].reshape(*lead, g, n),
            conv_out[..., d_in + g * n:].reshape(*lead, g, n))


def _dt_and_a(p: SSMParams, dt_raw: torch.Tensor):
    dt = softplus(dt_raw.float() + p.dt_bias.float())
    return dt, -torch.exp(p.a_log.float())


def ssm_forward(p: SSMParams, cfg: ArchConfig, x: torch.Tensor, *,
                return_state: bool = False):
    """Prefill forward. x: (B, S, d) -> (B, S, d); with `return_state`
    also the decode cache after the last position."""
    s_cfg = cfg.ssm
    dt_ = cfg.dtype
    d_in, n_heads, _, _ = ssm_dims(cfg)
    b, s, _ = x.shape
    z, conv_in, dt_raw = _project(p, cfg, x)
    conv_out = _causal_conv(conv_in, p.conv_w, p.conv_b)
    xin, bmat, cmat = _split_conv(cfg, conv_out)
    dt, a = _dt_and_a(p, dt_raw)
    xh = xin.reshape(b, s, n_heads, s_cfg.headdim)
    y, state = ssd_scan(xh, dt, a, bmat, cmat, chunk=s_cfg.chunk)
    y = y + xh * p.d_skip.to(dt_)[None, None, :, None]
    y = _gated_rms_norm(y.reshape(b, s, d_in), z, p.norm)
    out = y @ p.w_out.to(dt_)
    if return_state:
        k = s_cfg.conv_kernel
        return out, SSMCache(conv=conv_in[:, s - (k - 1):], state=state)
    return out


def ssm_decode(p: SSMParams, cfg: ArchConfig, x: torch.Tensor,
               cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One-token decode, an O(1) state update. x: (B, 1, d). Returns
    (out (B, 1, d), the new cache)."""
    s_cfg = cfg.ssm
    dt_ = cfg.dtype
    d_in, n_heads, g, _ = ssm_dims(cfg)
    b = x.shape[0]
    z, conv_in, dt_raw = _project(p, cfg, x)
    window = torch.cat([cache.conv, conv_in], dim=1)       # (B, k, C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p.conv_w.float())
    conv_out = F.silu(conv_out + p.conv_b.float()).to(dt_)  # (B, C)
    xin, bmat, cmat = _split_conv(cfg, conv_out)
    dt, a = _dt_and_a(p, dt_raw[:, 0])                     # (B, H)
    da = torch.exp(dt * a)
    xh = xin.reshape(b, n_heads, s_cfg.headdim).float()
    hg = n_heads // g
    bfull = bmat.repeat_interleave(hg, dim=1).float()      # (B, H, N)
    cfull = cmat.repeat_interleave(hg, dim=1).float()
    # s' = exp(dt a) s + dt B (x) x ; y = C . s'
    state = (cache.state * da[..., None, None]
             + dt[..., None, None] * bfull[..., None] * xh[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", cfull, state)
    y = y + xh * p.d_skip.float()[None, :, None]
    y = _gated_rms_norm(y.reshape(b, 1, d_in).to(dt_), z, p.norm)
    return y @ p.w_out.to(dt_), SSMCache(conv=window[:, 1:], state=state)


def ssm_init_cache(cfg: ArchConfig, batch: int, dtype=None, *,
                   device: DeviceLike = None) -> SSMCache:
    """Zero caches: the conv window in `dtype` (default the compute
    dtype), the state float32."""
    s = cfg.ssm
    d_in, n_heads, g, n = ssm_dims(cfg)
    device = resolve_device(device)
    return SSMCache(
        conv=torch.zeros((batch, s.conv_kernel - 1, d_in + 2 * g * n),
                         dtype=dtype or cfg.dtype, device=device),
        state=torch.zeros((batch, n_heads, n, s.headdim),
                          dtype=torch.float32, device=device))


def ssm_reference(p: SSMParams, cfg: ArchConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """The oracle: the sequential per-token recurrence (the form SSD
    rewrites), after the same projections and conv."""
    s_cfg = cfg.ssm
    dt_ = cfg.dtype
    d_in, n_heads, g, n = ssm_dims(cfg)
    b, s, _ = x.shape
    z, conv_in, dt_raw = _project(p, cfg, x)
    conv_out = _causal_conv(conv_in, p.conv_w, p.conv_b)
    xin, bmat, cmat = _split_conv(cfg, conv_out)
    dt, a = _dt_and_a(p, dt_raw)
    xh = xin.reshape(b, s, n_heads, s_cfg.headdim).float()
    hg = n_heads // g
    bfull = bmat.repeat_interleave(hg, dim=2).float()
    cfull = cmat.repeat_interleave(hg, dim=2).float()
    state = torch.zeros((b, n_heads, n, s_cfg.headdim), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a)
        state = (state * da[..., None, None]
                 + dt[:, t][..., None, None] * bfull[:, t][..., None]
                 * xh[:, t][:, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cfull[:, t], state))
    y = torch.stack(ys, dim=1) + xh * p.d_skip[None, None, :, None]
    y = _gated_rms_norm(y.reshape(b, s, d_in).to(dt_), z, p.norm)
    return y @ p.w_out.to(dt_)
