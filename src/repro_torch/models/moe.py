"""Mixture-of-Experts with the paper's cluster-wise dispatch dataflow.

The counterpart of the JAX package's ``models/moe.py``. The token→expert
assignment is a sparse A matrix (one nonzero per (token, slot)) and the
expert weight stack is the B operand:

  1. *row reordering* — each batch row's (token, slot) pairs are sorted by
     expert id (a stable sort, as ``jnp.argsort`` is), so the tokens that
     meet the same expert's weights become consecutive;
  2. *variable-length clustering* — the per-expert runs are the clusters;
     capacity bucketing pads them to a rectangular (E, C) slab and drops
     the pairs past an expert's capacity;
  3. *cluster-wise computation* — one grouped SwiGLU product per expert.

The reference's three sharding hints sit at the same places
(:func:`~repro_torch.distributed.sharding.constrain`). The routing, the
dispatch and the combine are row-local, so under sharding rules they run
on each rank's batch rows (plain tensors); only the expert products run
on the expert-sharded layout. The combine is a gather, not the reference's scatter-add: each (token,
slot) pair finds its place in the sorted order, and a token's k expert
outputs are summed in ascending sorted position — the order in which the
reference's scatter adds them — with no atomics.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, local_apply
from repro_torch.models.layers import ParamGroup, normal_init

__all__ = ["init_moe_params", "moe_route", "moe_ffn", "moe_capacity"]


def init_moe_params(cfg, generator: torch.Generator, *, device,
                    dtype=torch.float32) -> ParamGroup:
    """One MoE block's weights: the router (kept in fp32), the expert
    stacks ``wg``/``wu`` (E, D, F) and ``wd`` (E, F, D) over the padded
    expert count, and the pre-norm."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts_padded
    kw = dict(device=device, dtype=dtype)
    return ParamGroup(
        router=normal_init((d, e), d ** -0.5, generator, device=device,
                           dtype=torch.float32),
        wg=normal_init((e, d, f), d ** -0.5, generator, **kw),
        wu=normal_init((e, d, f), d ** -0.5, generator, **kw),
        wd=normal_init((e, f, d), f ** -0.5, generator, **kw),
        ln=torch.zeros((d,), **kw))


def moe_capacity(cfg, seq: int) -> int:
    """Slots per expert per batch row for ``seq`` tokens (Python float
    arithmetic, as the reference computes it)."""
    sk = seq * cfg.experts_per_token
    return max(8, int(sk / cfg.num_experts_padded * cfg.moe_capacity_factor)
               + 1)


def moe_route(cfg, p: ParamGroup, x: torch.Tensor) -> dict:
    """The dispatch of :func:`moe_ffn` for x (B, S, D): ``order`` (B, S·k)
    the stable sort of the (token, slot) pairs — pair t·k + j is token t's
    j-th choice — by expert; in sorted order ``slot`` (the pair's row of
    the (E·C) slab, E·C when dropped), ``keep`` (False for a pair past
    its expert's capacity) and the weight ``sw``; ``cap`` the capacity
    C."""
    bsz, s, _ = x.shape
    e, k = cfg.num_experts_padded, cfg.experts_per_token
    sk = s * k
    dev = x.device

    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    if e != cfg.num_experts:   # padded (dummy) experts never win routing
        logits[..., cfg.num_experts:] = float("-inf")
    topw, topi = torch.topk(logits, k, dim=-1)                # (B, S, k)
    topw = torch.softmax(topw, dim=-1).to(x.dtype)

    # ---- 1) row reordering within each row: sort (token, slot) by expert
    flat_e = topi.reshape(bsz, sk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    sw = topw.reshape(bsz, sk).gather(1, order)

    # ---- 2) variable-length clusters → rectangular (E, C) capacity slab
    cap = moe_capacity(cfg, s)
    counts = F.one_hot(flat_e, e).sum(dim=1)                  # (B, E)
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(sk, device=dev)[None] - starts.gather(1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)        # overflow bin
    return {"order": order, "slot": slot, "keep": keep, "sw": sw,
            "cap": cap}


def _dispatch(cfg, x: torch.Tensor, router: torch.Tensor):
    """Route x (B, S, D) and gather each expert's slab of tokens: (xe (B,
    E, C, D), order, slot, keep, sw)."""
    bsz, s, d = x.shape
    e, k = cfg.num_experts_padded, cfg.experts_per_token
    r = moe_route(cfg, {"router": router}, x)
    cap, slot, keep = r["cap"], r["slot"], r["keep"]
    # kept pairs own distinct slots; the overflow bin is cut off
    st = torch.div(r["order"], k, rounding_mode="floor")      # sorted tokens
    tok_for_slot = torch.zeros((bsz, e * cap + 1), dtype=torch.long,
                               device=x.device).scatter_(1, slot, st)[
        :, : e * cap]
    live = torch.zeros((bsz, e * cap + 1), dtype=torch.bool,
                       device=x.device).scatter_(1, slot, keep)[:, : e * cap]

    # dispatch: (B, E, C, D)
    xe = x.gather(1, tok_for_slot[..., None].expand(bsz, e * cap, d))
    xe = (xe * live[..., None].to(x.dtype)).reshape(bsz, e, cap, d)
    return xe, r["order"], slot, keep, r["sw"]


def _combine(cfg, ye: torch.Tensor, order: torch.Tensor, slot: torch.Tensor,
             keep: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """Each token gathers its k pairs' weighted outputs from ye (B, E, C,
    D), summed in ascending sorted position; a dropped pair reads the zero
    row at E·C."""
    bsz, e, cap, d = ye.shape
    k = cfg.experts_per_token
    s = order.shape[1] // k
    ye_flat = torch.cat([ye.reshape(bsz, e * cap, d),
                         torch.zeros((bsz, 1, d), dtype=ye.dtype,
                                     device=ye.device)], dim=1)
    where = torch.argsort(order, dim=-1).reshape(bsz, s, k)
    where = torch.sort(where, dim=-1).values    # ascending sorted positions
    zero = torch.zeros((), dtype=sw.dtype, device=ye.device)
    out = None
    for j in range(k):
        pos = where[..., j]                                   # (B, S)
        w_j = torch.where(keep.gather(1, pos), sw.gather(1, pos), zero)
        part = ye_flat.gather(1, slot.gather(1, pos)[..., None].expand(
            bsz, s, d)) * w_j[..., None]
        out = part if out is None else out + part
    return out


def moe_ffn(cfg, p: ParamGroup, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → (B, S, D); top-k routing, per-row capacity
    bucketing, grouped expert products."""
    bsz, s, d = x.shape
    e, k = cfg.num_experts_padded, cfg.experts_per_token
    cap = moe_capacity(cfg, s)
    # SP boundary: routing sorts across the whole sequence, so gather the
    # seq dim here (batch stays data-sharded; dispatch is then row-local)
    x = constrain(x, "data", None, None)
    row = (("data", None), (bsz, s * k))
    xe, order, slot, keep, sw = local_apply(
        functools.partial(_dispatch, cfg), (x, p["router"]),
        (("data", None, None), (None, None)),
        ((("data", None, None, None), (bsz, e, cap, d)), row, row, row, row))
    # pin the EP all-to-all: batch-sharded → expert-sharded
    xe = constrain(xe, None, "model", None, None)

    # ---- 3) cluster-wise computation: grouped SwiGLU per expert ----------
    g = F.silu(torch.einsum("becd,edf->becf", xe, p["wg"]))
    u = torch.einsum("becd,edf->becf", xe, p["wu"])
    ye = torch.einsum("becf,efd->becd", g * u, p["wd"])       # (B, E, C, D)
    del xe, g, u

    rows = ("data", None)
    out = local_apply(
        functools.partial(_combine, cfg), (ye, order, slot, keep, sw),
        (("data", None, None, None), rows, rows, rows, rows),
        (("data", None, None), (bsz, s, d)))
    return constrain(out, "data", None, None)
