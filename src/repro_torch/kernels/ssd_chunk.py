"""The fused Mamba2 SSD chunk scan on the card.

Per (batch·head, chunk), with dt already folded into ``x`` and ``a``::

    L      = exp(segsum(a))                 (Q, Q), lower triangle
    y      = ((C Bᵀ) ∘ L) X + exp(a_cum) ∘ (C h_prev)
    h_new  = h_prev · exp(Σ a) + (B ∘ exp(a_cum[-1] − a_cum))ᵀ X

with the state ``h`` carried across chunks and the last one returned. The
kernel (``csrc/ssd_chunk.cu``, the counterpart of the JAX package's
``kernels/ssd_chunk.py::ssd_chunk_scan``) gives each batch·head one CTA
that walks its chunks with the state in shared memory; it takes any chunk
length Q, including the single chunk of a whole sequence that the model
falls back to.

:func:`ssd_chunk_scan` is the wrapper: on a CUDA tensor it launches the
kernel (counting the launch in its ``launches`` attribute) or raises; on a
CPU tensor it runs :func:`ssd_chunk_scan_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_chunk_scan", "ssd_chunk_scan_plain"]

# the kernel's limits: 64-row tiles, 256 threads, ≤ 32 accumulators each
KERNEL_TILE = 64
KERNEL_MAX_ACC = 32 * 256
KERNEL_MAX_SMEM = 232_448


def _check(x, a, b, c):
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError("expected x (BH, nc, Q, P), a (BH, nc, Q), "
                         "b/c (BH, nc, Q, N)")
    bh, nc, q, _ = x.shape
    if tuple(a.shape) != (bh, nc, q) or b.shape[:3] != (bh, nc, q) \
            or b.shape != c.shape:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}")
    if not (x.device == a.device == b.device == c.device):
        raise ValueError("x, a, b, c must be on one device")


def ssd_chunk_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused SSD over chunks: x (BH, nc, Q, P), a (BH, nc, Q), b/c
    (BH, nc, Q, N), dt-discretised. Returns (y (BH, nc, Q, P) in x's
    dtype, final state (BH, N, P) fp32).

    CUDA tensors launch the hand-written kernel (fp32 operands; one added
    to ``ssd_chunk_scan.launches``); CPU tensors run the plain version;
    any other device raises."""
    _check(x, a, b, c)
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, a, b, c)
    return _launch(x, a, b, c)


ssd_chunk_scan.launches = 0


def ssd_chunk_scan_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`ssd_chunk_scan`, on any device:
    the chunks in order, each as batched fp32 matrix products over BH;
    ``exp`` is taken on the lower triangle of the segment sums only."""
    _check(x, a, b, c)
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


def _smem_bytes(p: int, n: int) -> int:
    t = KERNEL_TILE
    return 4 * (n * p + 2 * t * (n + 1) + t * p + t * (t + 1) + 2 * t)


def _launch(x, a, b, c):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: tensors on {dev}; the kernel "
                         "runs on CUDA, the plain version on the CPU")
    if not (x.dtype == a.dtype == b.dtype == c.dtype == torch.float32):
        raise ValueError("ssd_chunk_scan kernel takes float32 operands")
    bh, nc, q, p = x.shape
    n = b.shape[-1]
    if KERNEL_TILE * p > KERNEL_MAX_ACC or n * p > KERNEL_MAX_ACC \
            or _smem_bytes(p, n) > KERNEL_MAX_SMEM:
        raise ValueError(f"ssd_chunk_scan kernel takes 64·P and N·P ≤ "
                         f"{KERNEL_MAX_ACC} within {KERNEL_MAX_SMEM} bytes "
                         f"of shared memory, got P={p}, N={n}")
    y = torch.empty_like(x)
    h = torch.empty((bh, n, p), dtype=torch.float32, device=dev)
    if bh == 0 or nc == 0 or q == 0:
        return y, h.zero_()
    x, a, b, c = (t.contiguous() for t in (x, a, b, c))
    ws = torch.empty((bh, q), dtype=torch.float32, device=dev)  # a_cum
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), h.data_ptr(), ws.data_ptr(), bh, nc, q, p, n,
            stream)
    if rc != 0:
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        lib.ssd_chunk_error_string.argtypes = [ctypes.c_int]
        msg = lib.ssd_chunk_error_string(rc).decode()
        raise RuntimeError(f"ssd_chunk_scan launch failed: {msg}")
    ssd_chunk_scan.launches += 1
    return y, h
