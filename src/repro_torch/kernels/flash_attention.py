"""Flash attention on the card: softmax(QKᵀ/√D)·V with an online softmax.

The kernel (``csrc/flash_attention.cu``, the counterpart of the JAX
package's ``kernels/flash_attention.py::flash_attention``) keeps that
kernel's conventions: the causal mask ``q_pos >= k_pos`` aligned at the
top left (so it agrees with a bottom-right-aligned oracle only when
Sq = Sk), masked scores at -1e30, KV blocks above the diagonal skipped and
the row sum floored at 1e-30. It masks ragged tails, so any sequence
length works, and takes D up to 256. It is register-blocked for the CUDA
cores in IEEE fp32: a thread owns a 4 × 4 tile of each 64 × 64 score block
(4 × 2 of 64 × 32 above D = 128) and a 4-row slice of the output, with K
and V double-buffered by ``cp.async``. q, k and v may be fp32, bf16 or
fp16 (one library per dtype): as in the JAX kernel, the running max, sum
and accumulator stay fp32, P is rounded to v's dtype before P·V, and the
output is in q's dtype.

:func:`flash_attention` is the wrapper: on a CUDA tensor it launches the
kernel (counting the launch in its ``launches`` attribute) or raises; on a
CPU tensor it runs :func:`flash_attention_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_tolerance"]

NEG_INF = -1e30
KERNEL_MAX_D = 256
# the unit roundoff of each 16-bit dtype (round to nearest)
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
# the kernel library of each dtype
KERNEL_LIBS = {torch.float32: "flash_attention",
               torch.bfloat16: "flash_attention_bf16",
               torch.float16: "flash_attention_fp16"}


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, S, D)")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(BH, Sq, D) × (BH, Sk, D) → (BH, Sq, D), in q's dtype.

    CUDA tensors launch the hand-written kernel (fp32, bf16 or fp16,
    D ≤ 256; one added to ``flash_attention.launches``); CPU tensors run
    the plain version; any other device raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    return _launch(q, k, v, causal=causal)


flash_attention.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True
                          ) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention`, on any
    device: scores in fp32, the kernel's top-left causal mask at -1e30,
    P = exp(s - max) rounded to v's dtype for P·V while the row sum takes
    it unrounded (as the JAX kernel does), in slices of the BH axis."""
    _check(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    keep = None
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
    step = max(1, (1 << 27) // max(sq * sk, 1))
    for lo in range(0, bh, step):
        hi = min(lo + step, bh)
        s = torch.matmul(q[lo:hi].float(), k[lo:hi].float().transpose(1, 2))
        s = s * scale
        if keep is not None:
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        pv = torch.matmul(p.to(v.dtype).float(), v[lo:hi].float())
        out[lo:hi] = (pv / l).to(q.dtype)
    return out


def flash_attention_tolerance(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, want: torch.Tensor, *,
                              causal: bool = True) -> torch.Tensor:
    """Per-element limit on |kernel − plain| for 16-bit q, k, v, with
    ``want`` the plain version's output: 3u·((P·|V|)/l + |want|), u the
    unit roundoff of v's dtype, P and l in fp32 (the plain version on the
    widened operands with |v|). Each p is rounded to v's dtype, against
    the running max in the kernel and the final max in the plain version,
    so the two P·V/l differ by at most 2u·(P·|V|)/l; each output is
    rounded once more (u·|want| each). It scales with what each row sums,
    so a kernel that drops or mis-scales keys of a long row fails it."""
    u = UNIT_ROUNDOFF[v.dtype]
    mag = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                causal=causal)
    return 3 * u * (mag + want.float().abs())


def _launch(q, k, v, *, causal):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {dev}; the kernel "
                         "runs on CUDA, the plain version on the CPU")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in KERNEL_LIBS):
        raise ValueError(f"flash_attention kernel takes q, k, v of one "
                         f"dtype, float32, bfloat16 or float16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if not 0 < d <= KERNEL_MAX_D:
        raise ValueError(f"flash_attention kernel takes 0 < D <= "
                         f"{KERNEL_MAX_D}, got {d}")
    if -(-sq // 64) > 65535:
        raise ValueError(f"flash_attention kernel takes Sq <= {64 * 65535}, "
                         f"got {sq}")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = _build.load(KERNEL_LIBS[q.dtype])
    fn = lib.flash_attention_run
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            sk, d, 1.0 / (d ** 0.5), int(bool(causal)), stream)
    if rc != 0:
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg}")
    flash_attention.launches += 1
    return out
