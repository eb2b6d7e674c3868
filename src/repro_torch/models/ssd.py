"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

PyTorch counterpart of ``repro.models.ssd``: the chunked formulation
(intra-chunk terms as dense products against a decay mask, inter-chunk
terms as a short scan over O(h·p·n) states), in ``repro``'s layouts.  The
reference has no Pallas kernel here (its scan is XLA einsums), so plain
PyTorch is the port.

Every multi-operand einsum of the reference is written as two-operand
products in a fixed order, ``(C·Bᵀ) ⊙ L`` then ``· x`` for the diagonal
blocks, ``(x ⊙ decay)ᵀ · B`` for the chunk states and ``(C · state) ⊙
decay`` for the off-diagonal term, so the fp32 rounding is the same on the
CPU and the card whatever contraction path ``torch.einsum`` would pick.
``jax.lax.scan`` over chunks is a Python loop.

In a sharded program (``DTensor`` s inside ``use_rules``) the scan runs on
each rank's rows and heads (its B and C groups with them, or whole when
there is one group), and a decode step on each rank's rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed.sharding import local_region

from .common import dense, rms_norm


class SSDParams(NamedTuple):
    w_in: torch.Tensor      # (d, 2·d_inner + 2·g·n + h)
    conv_w: torch.Tensor    # (width, conv_channels)  depthwise
    conv_b: torch.Tensor    # (conv_channels,)
    a_log: torch.Tensor     # (h,)
    d_skip: torch.Tensor    # (h,)
    dt_bias: torch.Tensor   # (h,)
    out_norm: torch.Tensor  # (d_inner,)
    w_out: torch.Tensor     # (d_inner, d)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(cfg: SSMConfig, d_model: int, zxbcdt):
    d_in = cfg.d_inner(d_model)
    h = cfg.n_heads(d_model)
    gn = cfg.n_groups * cfg.d_state
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * gn, h], dim=-1)
    return z, xbc, dt, d_in, h, gn


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv over (B, L, C) with kernel (W, C)."""
    w = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1], :] * conv_w[i] for i in range(w))
    return F.silu(out + conv_b)


def _segsum(a):
    """(..., l) → (..., l, l) lower-tri segment sums (−inf above diag)."""
    l = a.shape[-1]
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan(x, a, B, C, chunk: int, initial_state=None):
    """Chunked SSD.  x (b,l,h,p) pre-multiplied by dt; a (b,l,h) = dt·A;
    B, C (b,l,g,n).  Returns y (b,l,h,p) and final state (b,h,p,n)."""
    region = _scan_one_group if B.shape[2] == 1 else _scan_groups
    return region(x, a, B, C, initial_state, chunk=chunk)


def _ssd_scan(x, a, B, C, initial_state=None, *, chunk: int):
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    chunk = min(chunk, l)
    if l % chunk != 0:   # repro's rule: a single chunk
        chunk = l
    c = l // chunk
    rep = h // g

    xc = x.reshape(b, c, chunk, h, p).permute(0, 1, 3, 2, 4)     # (b,c,h,l,p)
    ac = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)           # (b,h,c,l)
    Bh = B.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3) \
        .permute(0, 1, 3, 2, 4)                                  # (b,c,h,l,n)
    Ch = C.reshape(b, c, chunk, g, n).repeat_interleave(rep, dim=3) \
        .permute(0, 1, 3, 2, 4)

    a_cum = torch.cumsum(ac, -1)                                 # (b,h,c,l)
    L = torch.exp(_segsum(ac)).permute(0, 2, 1, 3, 4)            # (b,c,h,l,s)
    # y_diag = ((C · Bᵀ) ⊙ L) · x
    y_diag = torch.matmul(torch.matmul(Ch, Bh.transpose(-1, -2)) * L, xc)

    # states = (x ⊙ decay)ᵀ · B: the state each chunk adds, at its end
    decay_states = torch.exp(a_cum[..., -1:] - a_cum).permute(0, 2, 1, 3)  # (b,c,h,l)
    states = torch.matmul((xc * decay_states[..., None]).transpose(-1, -2),
                          Bh)                                    # (b,c,h,p,n)

    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    chunk_decay = torch.exp(a_cum[..., -1])                      # (b,h,c)
    carry, entering = initial_state, []
    for i in range(c):           # emit the state *entering* each chunk
        entering.append(carry)
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    entering = torch.stack(entering, dim=1)                      # (b,c,h,p,n)

    # y_off = (C · stateᵀ) ⊙ decay
    state_decay = torch.exp(a_cum).permute(0, 2, 1, 3)           # (b,c,h,l)
    y_off = torch.matmul(Ch, entering.transpose(-1, -2)) * state_decay[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, l, h, p)
    return y, carry


_X = ("batch", None, "ssm_heads", None)
_A = ("batch", None, "ssm_heads")
_STATE = ("batch", "ssm_heads", None, None)
# one group serves every head: each rank takes it whole; more groups shard
# with the heads (one name), so a rank holds the groups of its heads
_scan_one_group = local_region(_ssd_scan, (_X, _A, ("batch", None, None, None),
                                           ("batch", None, None, None), _STATE), (_X, _STATE))
_scan_groups = local_region(_ssd_scan, (_X, _A, _X, _X, _STATE), (_X, _STATE))


def ssd_block(p: SSDParams, cfg: SSMConfig, d_model: int, x, *, norm_eps=1e-5,
              return_state: bool = False, initial=None):
    """Full Mamba-2 block on (B, L, d_model).  ``initial``/returned state is
    (conv_state (B,W−1,C), ssm_state (B,h,p,n)) for decode handoff; the
    returned state never shares storage with ``initial``."""
    b, l, _ = x.shape
    z, xbc, dt, d_in, h, gn = _split_proj(cfg, d_model, dense(x, p.w_in))
    if initial is not None:
        conv_in = torch.cat([initial[0], xbc], dim=1)
        xbc_conv = _causal_conv(conv_in, p.conv_w, p.conv_b)[:, initial[0].shape[1]:]
    else:
        xbc_conv = _causal_conv(xbc, p.conv_w, p.conv_b)
    xs, B, C = torch.split(xbc_conv, [d_in, gn, gn], dim=-1)
    B = B.reshape(b, l, cfg.n_groups, cfg.d_state)
    C = C.reshape(b, l, cfg.n_groups, cfg.d_state)
    dt = softplus(dt + p.dt_bias)                                # (b,l,h)
    a = dt * (-torch.exp(p.a_log))                               # (b,l,h)
    xh = xs.reshape(b, l, h, cfg.head_dim)
    y, final_ssm = ssd_scan(
        xh * dt[..., None], a, B, C, cfg.chunk,
        initial_state=None if initial is None else initial[1],
    )
    y = y + xh * p.d_skip[None, None, :, None]
    y = y.reshape(b, l, d_in) * F.silu(z)
    out = dense(rms_norm(y, p.out_norm, norm_eps), p.w_out)
    if return_state:
        w = p.conv_w.shape[0]
        tail = xbc if initial is None else conv_in
        conv_state = tail[:, -(w - 1):, :]
        return out, (conv_state, final_ssm)
    return out


def ssd_decode(p: SSDParams, cfg: SSMConfig, d_model: int, x, state, *, norm_eps=1e-5):
    """Single-token recurrence.  x (B,1,d); state = (conv_state, ssm_state).
    The new state is computed apart from ``state`` (the caller may copy it
    into the same tensors)."""
    out, conv, ssm = _decode_region(x, state[0], state[1], *p, cfg=cfg, d_model=d_model,
                                    norm_eps=norm_eps)
    return out, (conv, ssm)


def _ssd_decode(x, conv_state, ssm_state, *params, cfg: SSMConfig, d_model: int, norm_eps):
    p = SSDParams(*params)                                        # (B,W−1,C), (B,h,p,n)
    b = x.shape[0]
    z, xbc, dt, d_in, h, gn = _split_proj(cfg, d_model, dense(x, p.w_in))
    full = torch.cat([conv_state, xbc], dim=1)                    # (B,W,C)
    conv_out = F.silu((full * p.conv_w[None]).sum(1, keepdim=True) + p.conv_b)
    new_conv_state = full[:, 1:, :]
    xs, B, C = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    B = B.reshape(b, cfg.n_groups, cfg.d_state)
    C = C.reshape(b, cfg.n_groups, cfg.d_state)
    rep = h // cfg.n_groups
    Bh = B.repeat_interleave(rep, dim=1)                          # (B,h,n)
    Ch = C.repeat_interleave(rep, dim=1)
    dt = softplus(dt[:, 0] + p.dt_bias)                           # (B,h)
    decay = torch.exp(dt * (-torch.exp(p.a_log)))                 # (B,h)
    xh = xs[:, 0].reshape(b, h, cfg.head_dim) * dt[..., None]
    ssm_state = ssm_state * decay[..., None, None] + xh[..., None] * Bh[:, :, None, :]
    y = torch.matmul(ssm_state, Ch[..., None])[..., 0]            # (B,h,p)
    y = y + xs[:, 0].reshape(b, h, cfg.head_dim) * p.d_skip[:, None]
    y = y.reshape(b, 1, d_in) * F.silu(z)
    out = dense(rms_norm(y, p.out_norm, norm_eps), p.w_out)
    return out, new_conv_state, ssm_state


# a decode step runs on each rank's rows with whole weights
_ROWS = ("batch", None, None)
_decode_region = local_region(
    _ssd_decode, (_ROWS, _ROWS, ("batch", None, None, None)) + ((None, None), (None, None))
    + ((None,),) * 5 + ((None, None),), (_ROWS, _ROWS, ("batch", None, None, None)))
