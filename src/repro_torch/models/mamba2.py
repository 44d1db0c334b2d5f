"""Mamba2 SSD (state-space duality) block: chunked parallel scan for
prefill and O(1)-state single-token decode.

The counterpart of the JAX package's ``models/mamba2.py``. Within a chunk
the recurrence is expanded into a masked, decay-weighted attention-like
product; across chunks a small recurrence carries the (H, P, N) state.
``use_pallas=True`` sends the scan to the fused chunk-scan kernel
(:func:`repro_torch.kernels.ops.fused_ssd`) instead of the model's own
chunked path (:func:`ssd_chunked`).

Shapes: x (B, S, H, P); dt (B, S, H); A (H,) negative reals via
-exp(A_log); B/C (B, S, G, N) with G groups broadcast over heads.

The block takes no sharding hint, as the reference's (whose note on the
scan body's miscompile is an XLA matter); under sharding rules the scan
runs on each rank's batch rows and heads (:func:`_scan_specs`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (active_rules, local_apply,
                                              pin_grad)
from repro_torch.kernels.ops import fused_ssd
from repro_torch.models.layers import ParamGroup, normal_init, rmsnorm

__all__ = ["ssd_chunked", "ssd_decode_step", "mamba2_block",
           "mamba2_decode_block", "init_mamba2_params", "conv1d_causal",
           "MAMBA2_PARAM_NAMES"]

MAMBA2_PARAM_NAMES = ("wz", "wx", "wB", "wC", "wdt", "conv_w", "conv_b",
                      "A_log", "dt_bias", "D_skip", "gnorm", "out_proj",
                      "ln")


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} a[..., k], -inf for j > i.
    a: (..., Q) → (..., Q, Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(..., G, N) → (..., H, N): each group broadcast over its heads."""
    g, n = t.shape[-2], t.shape[-1]
    return t[..., :, None, :].expand(*t.shape[:-2], g, h // g, n).reshape(
        *t.shape[:-2], h, n)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk

    a = (-torch.exp(a_log.float()))[None, None, :] * dt.float()  # (B,S,H)
    xdt = x.float() * dt.float()[..., None]

    # chunked views
    ar = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)         # (B,H,nc,Q)
    xr = xdt.reshape(bsz, nc, chunk, h, p)
    brh = _heads(b.float().reshape(bsz, nc, chunk, g, n), h)
    crh = _heads(c.float().reshape(bsz, nc, chunk, g, n), h)

    a_cum = torch.cumsum(ar, dim=-1)                              # (B,H,nc,Q)

    # 1) intra-chunk ("diagonal block") output
    L = torch.exp(_segsum(ar))                                    # (B,H,nc,Q,Q)
    scores = torch.einsum("bclhn,bcshn->bhcls", crh, brh) * L
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xr)
    del L, scores

    # 2) per-chunk states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)             # (B,H,nc,Q)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          brh * decay_states.permute(0, 2, 3, 1)[..., None],
                          xr)

    # 3) inter-chunk recurrence (a short loop over nc)
    chunk_decay = torch.exp(a_cum[..., -1])                       # (B,H,nc)
    hprev = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * chunk_decay[:, :, ci, None, None] + states[:, ci]
    final = hprev
    h_prevs = torch.stack(h_prevs)                                # (nc,B,H,P,N)

    # 4) state→output for each chunk
    state_decay = torch.exp(a_cum)                                # (B,H,nc,Q)
    y_off = torch.einsum("bclhn,cbhpn->bclhp", crh, h_prevs) \
        * state_decay.permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p).to(x.dtype)
    return y, final


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, a_log: torch.Tensor,
                    b_t: torch.Tensor, c_t: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step. state (B,H,P,N); x_t (B,H,P); dt_t (B,H);
    b_t/c_t (B,G,N). Returns (y_t (B,H,P), new_state)."""
    h = x_t.shape[1]
    bh = _heads(b_t, h).float()
    ch = _heads(c_t, h).float()
    dt_f = dt_t.float()
    decay = torch.exp(-torch.exp(a_log.float())[None] * dt_f)
    upd = torch.einsum("bhp,bhn->bhpn", x_t.float() * dt_f[..., None], bh)
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x_t.dtype), new_state


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  buf: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,C); w (W,C); bias (C,).
    If ``buf`` (B, W-1, C) is given it is prepended (decode path)."""
    width = w.shape[0]
    if buf is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([buf.to(x.dtype), x], dim=1)
    out = sum(xp[:, i: i + x.shape[1], :] * w[i][None, None]
              for i in range(width))
    return F.silu(out + bias[None, None])


# ---------------------------------------------------------------------------
# full block (the pre-norm residual wrapper lives in transformer.py)
# ---------------------------------------------------------------------------


def init_mamba2_params(cfg, generator: torch.Generator, *, device,
                       dtype=torch.float32) -> ParamGroup:
    """One mixer's weights, random from ``generator`` (same shapes and
    scales as the JAX package's ``init_mamba2_params``)."""
    d = cfg.d_model
    din = cfg.ssm_d_inner
    h = cfg.ssm_num_heads
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width
    sc = d ** -0.5
    conv_ch = din + 2 * g * n
    kw = dict(device=device, dtype=dtype)

    def normal(shape, scale):
        return normal_init(shape, scale, generator, **kw)

    return ParamGroup(
        wz=normal((d, din), sc),
        wx=normal((d, din), sc),
        wB=normal((d, g * n), sc),
        wC=normal((d, g * n), sc),
        wdt=normal((d, h), sc),
        conv_w=normal((w, conv_ch), w ** -0.5),
        conv_b=torch.zeros((conv_ch,), **kw),
        A_log=torch.zeros((h,), **kw),            # A = -exp(0) = -1
        dt_bias=torch.full((h,), -2.0, **kw),     # softplus(-2) ≈ 0.12
        D_skip=torch.ones((h,), **kw),
        gnorm=torch.zeros((din,), **kw),
        out_proj=normal((din, d), din ** -0.5),
        ln=torch.zeros((d,), **kw))


def _project(cfg, p, u):
    z = u @ p["wz"]
    x = u @ p["wx"]
    b = u @ p["wB"]
    c = u @ p["wC"]
    dt = F.softplus((u @ p["wdt"]).float() + p["dt_bias"].float())
    return z, x, b, c, dt


def _gated_norm(y, z, w, eps):
    return rmsnorm(pin_grad(y * F.silu(z), "data", None, "model"), w, eps)


def _scan_specs(cfg) -> tuple:
    """(heads axis, groups axis) of the scan's per-rank layout: the heads
    split over ``model`` when it divides them and each rank's heads keep
    their own groups (one group, or groups split the same way); whole
    heads otherwise."""
    r = active_rules()
    if r is None:
        return None, None
    hax = r.over_model(cfg.ssm_num_heads)
    gax = r.over_model(cfg.ssm_groups) if cfg.ssm_groups > 1 else None
    if hax is None or (cfg.ssm_groups > 1 and gax is None):
        return None, None
    return hax, gax


def mamba2_block(cfg, p: ParamGroup, u: torch.Tensor,
                 return_state: bool = False, use_pallas: bool = False):
    """Full-sequence Mamba2 mixer. u (B,S,D) → (B,S,D).

    With ``return_state``, also returns ``(ssm_state (B,H,P,N),
    conv_buf (B, W-1, C))`` — the serving cache a following
    :func:`mamba2_decode_block` continues from.
    """
    bsz, s, _ = u.shape
    din, h = cfg.ssm_d_inner, cfg.ssm_num_heads
    g, n, hd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    z, x, b, c, dt = _project(cfg, p, u)
    xbc_raw = torch.cat([x, b, c], dim=-1)
    # on each rank's batch rows, channels whole (a sharded pad is
    # malformed in torch 2.11's DTensor)
    whole = ("data", None, None)
    xbc = local_apply(conv1d_causal, (xbc_raw, p["conv_w"], p["conv_b"]),
                      (whole, (None, None), (None,)),
                      (whole, xbc_raw.shape))
    x, b, c = torch.split(xbc, [din, g * n, g * n], dim=-1)
    x = x.reshape(bsz, s, h, hd)
    b = b.reshape(bsz, s, g, n)
    c = c.reshape(bsz, s, g, n)
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s  # short or ragged sequence: a single chunk
    scan = fused_ssd if use_pallas else ssd_chunked

    def scan_skip(x, dt, a_log, b, c, d_skip):
        y, st = scan(x, dt, a_log, b, c, chunk)
        y = y + x * d_skip.to(x.dtype)[None, None, :, None]
        return y.reshape(*x.shape[:2], -1), st

    hs, gs = _scan_specs(cfg)
    y, final_state = local_apply(
        scan_skip, (x, dt, p["A_log"], b, c, p["D_skip"]),
        (("data", None, hs, None), ("data", None, hs), (hs,),
         ("data", None, gs, None), ("data", None, gs, None), (hs,)),
        ((("data", None, hs), (bsz, s, din)),
         (("data", hs, None, None), (bsz, h, hd, n))))
    y = _gated_norm(y, z, p["gnorm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    w = cfg.ssm_conv_width
    if s >= w - 1:
        # a copy, not a view: a view would keep the whole (B, S, C)
        # projection alive for as long as the cache entry lives
        conv_buf = xbc_raw[:, s - (w - 1):, :].clone()
    else:  # pad short prompts on the left with zeros
        conv_buf = F.pad(xbc_raw, (0, 0, w - 1 - s, 0))
    return out, (final_state, conv_buf)


def mamba2_decode_block(cfg, p: ParamGroup, u: torch.Tensor,
                        ssm_state: torch.Tensor, conv_buf: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token mixer. u (B,1,D); ssm_state (B,H,P,N);
    conv_buf (B, W-1, din+2gn). Returns (y (B,1,D), state, buf)."""
    bsz = u.shape[0]
    din, h = cfg.ssm_d_inner, cfg.ssm_num_heads
    g, n, hd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    z, x, b, c, dt = _project(cfg, p, u)
    xbc = torch.cat([x, b, c], dim=-1)                       # (B,1,C)
    new_buf = torch.cat([conv_buf[:, 1:], xbc.to(conv_buf.dtype)], dim=1)
    xbc = conv1d_causal(xbc, p["conv_w"], p["conv_b"], buf=conv_buf)
    x, b, c = torch.split(xbc[:, 0], [din, g * n, g * n], dim=-1)

    def step_skip(state, x, dt, a_log, b, c, d_skip):
        y, st = ssd_decode_step(state, x, dt, a_log, b, c)
        y = y + x * d_skip.to(x.dtype)[None, :, None]
        return y.reshape(y.shape[0], 1, -1), st

    hs, gs = _scan_specs(cfg)
    y, new_state = local_apply(
        step_skip, (ssm_state, x.reshape(bsz, h, hd), dt[:, 0], p["A_log"],
                    b.reshape(bsz, g, n), c.reshape(bsz, g, n), p["D_skip"]),
        (("data", hs, None, None), ("data", hs, None), ("data", hs), (hs,),
         ("data", gs, None), ("data", gs, None), (hs,)),
        ((("data", None, hs), (bsz, 1, din)),
         (("data", hs, None, None), (bsz, h, hd, n))))
    y = _gated_norm(y, z, p["gnorm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state, new_buf
