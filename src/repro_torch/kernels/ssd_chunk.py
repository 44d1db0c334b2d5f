"""The Mamba2 SSD chunk scan on the card.

Per (batch·head, chunk), with dt already folded into ``x`` and ``a``::

    L      = exp(segsum(a))                 (Q, Q), lower triangle
    y      = ((C Bᵀ) ∘ L) X + exp(a_cum) ∘ (C h_prev)
    h_new  = h_prev · exp(Σ a) + (B ∘ exp(a_cum[-1] − a_cum))ᵀ X

with the state ``h`` carried across chunks and the last one returned. The
kernel (``csrc/ssd_chunk.cu``, the counterpart of the JAX package's
``kernels/ssd_chunk.py::ssd_chunk_scan``) runs it as a chunk-parallel
scan: C·Bᵀ once per (group, chunk) when heads share a group, the chunk
states, the recurrence over chunks, and the output tiles, a few launches
on the current stream counted as one. It takes any chunk length Q,
including the single chunk of a whole sequence that the model falls back
to.

B and C may be given per head, ``(BH, nc, Q, N)`` as the JAX kernel takes
them, or per group, ``(BH / heads_per_group, nc, Q, N)``: head ``bh``
reads group ``bh // heads_per_group``.

:func:`ssd_chunk_scan` is the wrapper: on a CUDA tensor it launches the
kernel (counting the launch in its ``launches`` attribute) or raises; on a
CPU tensor it runs :func:`ssd_chunk_scan_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_chunk_scan", "ssd_chunk_scan_plain"]

# the kernel's limits: 64-row tiles, P ≤ 128, N ≤ 256, and the shared
# memory of one CTA
KERNEL_TILE = 64
KERNEL_MAX_P = 128
KERNEL_MAX_N = 256
KERNEL_MAX_SMEM = 232_448


def _check(x, a, b, c, rep):
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError("expected x (BH, nc, Q, P), a (BH, nc, Q), "
                         "b/c (BH / heads_per_group, nc, Q, N)")
    bh, nc, q, _ = x.shape
    if rep < 1 or bh % rep:
        raise ValueError(f"heads_per_group={rep} does not divide BH={bh}")
    if tuple(a.shape) != (bh, nc, q) \
            or tuple(b.shape[:3]) != (bh // rep, nc, q) \
            or b.shape != c.shape:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, heads_per_group={rep}")
    if not (x.device == a.device == b.device == c.device):
        raise ValueError("x, a, b, c must be on one device")


def ssd_chunk_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, heads_per_group: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD over chunks: x (BH, nc, Q, P), a (BH, nc, Q), b/c
    (BH / heads_per_group, nc, Q, N), dt-discretised. Returns (y
    (BH, nc, Q, P) in x's dtype, final state (BH, N, P) fp32).

    CUDA tensors launch the hand-written kernel (fp32 operands; one added
    to ``ssd_chunk_scan.launches``); CPU tensors run the plain version;
    any other device raises."""
    _check(x, a, b, c, heads_per_group)
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, a, b, c,
                                    heads_per_group=heads_per_group)
    return _launch(x, a, b, c, heads_per_group)


ssd_chunk_scan.launches = 0


def ssd_chunk_scan_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, *, heads_per_group: int = 1
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`ssd_chunk_scan`, on any device:
    each group's B and C repeated over its heads, then the chunks in
    order, each as batched fp32 matrix products over BH; ``exp`` is taken
    on the lower triangle of the segment sums only."""
    _check(x, a, b, c, heads_per_group)
    if heads_per_group > 1:
        b = b.repeat_interleave(heads_per_group, dim=0)
        c = c.repeat_interleave(heads_per_group, dim=0)
    bh, nc, q, p = x.shape
    n = b.shape[-1]
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    lower = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                  device=x.device))
    for ci in range(nc):
        xc = x[:, ci].float()
        bc = b[:, ci].float()
        cc = c[:, ci].float()
        a_cum = torch.cumsum(a[:, ci].float(), dim=-1)          # (BH, Q)
        seg = a_cum[:, :, None] - a_cum[:, None, :]
        decay = torch.where(lower, torch.exp(torch.where(lower, seg, 0.0)),
                            0.0)
        scores = torch.bmm(cc, bc.transpose(1, 2)) * decay
        yc = torch.bmm(scores, xc)
        yc = yc + torch.exp(a_cum)[:, :, None] * torch.bmm(cc, h)
        to_end = torch.exp(a_cum[:, -1:] - a_cum)               # (BH, Q)
        h = (h * torch.exp(a_cum[:, -1])[:, None, None]
             + torch.bmm((bc * to_end[:, :, None]).transpose(1, 2), xc))
        y[:, ci] = yc.to(x.dtype)
    return y, h


def _smem_bytes(p: int, n: int, rep: int) -> int:
    """The most shared memory one CTA of the kernel's tile passes asks
    for (``smem_bytes`` in the source)."""
    t = KERNEL_TILE
    pp = 64 if p <= 64 else 128
    ld = -(-n // t) * t + 4
    states = 4 * (t * ld + t * pp + t)
    ld = -(-n // 8) * 8 + 4
    k8 = -(-n // 8) * 8
    out = 4 * (t * ld + 2 * t * pp + max(t * (t + 4), k8 * pp) + 3 * t
               + (0 if rep > 1 else 2 * t * ld))
    return max(states, out)


def _workspace_floats(bh: int, nc: int, q: int, p: int, n: int,
                      rep: int) -> int:
    """a_cum (BH, nc, Q), the chunk states (BH, nc, N, P) and, when heads
    share a group, its C·Bᵀ tiles (BH / rep, nc, pairs, 64 · 64); each
    region rounded up to 4 floats, so that the next starts 16-byte
    aligned for the kernels' float4 accesses."""
    tiles = -(-q // KERNEL_TILE)
    pairs = tiles * (tiles + 1) // 2
    round4 = lambda m: -(-m // 4) * 4  # noqa: E731
    floats = round4(bh * nc * q) + round4(bh * nc * n * p)
    if rep > 1:
        floats += bh // rep * nc * pairs * KERNEL_TILE * KERNEL_TILE
    return floats


def _launch(x, a, b, c, rep):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: tensors on {dev}; the kernel "
                         "runs on CUDA, the plain version on the CPU")
    if not (x.dtype == a.dtype == b.dtype == c.dtype == torch.float32):
        raise ValueError("ssd_chunk_scan kernel takes float32 operands")
    bh, nc, q, p = x.shape
    n = b.shape[-1]
    if not (p <= KERNEL_MAX_P and n <= KERNEL_MAX_N
            and _smem_bytes(p, n, rep) <= KERNEL_MAX_SMEM):
        raise ValueError(f"ssd_chunk_scan kernel takes P ≤ {KERNEL_MAX_P}, "
                         f"N ≤ {KERNEL_MAX_N} within {KERNEL_MAX_SMEM} "
                         f"bytes of shared memory, got P={p}, N={n}")
    y = torch.empty_like(x)
    h = torch.empty((bh, n, p), dtype=torch.float32, device=dev)
    if bh == 0 or nc == 0 or q == 0:
        return y, h.zero_()
    x, a, b, c = (t.contiguous() for t in (x, a, b, c))
    ws = torch.empty(_workspace_floats(bh, nc, q, p, n, rep),
                     dtype=torch.float32, device=dev)
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), h.data_ptr(), ws.data_ptr(), bh, nc, q, p, n, rep,
            stream)
    if rc != 0:
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        lib.ssd_chunk_error_string.argtypes = [ctypes.c_int]
        msg = lib.ssd_chunk_error_string(rc).decode()
        raise RuntimeError(f"ssd_chunk_scan launch failed: {msg}")
    ssd_chunk_scan.launches += 1
    return y, h
