"""Causal flash attention, forward with statistics (K1) and backward (K2).

Counterpart of kfunca_tpu/ops/pallas_kernels/flash_attention.py
(`flash_attention_fwd_stats`, `flash_attention_forward`,
`flash_attention_backward`).  On CUDA tensors the wrappers launch the
hand-written Hopper kernels in csrc/flash_attention.cu; on CPU tensors they
run the plain PyTorch versions below.  There is no fallback between the
two: a CUDA call that cannot launch its kernel raises.

Contract (both routes): q (B, H, Sq, D), k/v (B, Hkv, Skv, D) with
H % Hkv == 0 (query head h reads kv head h // (H // Hkv)); scale 1/sqrt(D);
top-left aligned causal mask (row i attends columns j <= i, j < Skv), and
with `window` only columns j > i - window.  fp32 softmax state; `out` in
q's dtype; `lse` (B, H, Sq) fp32, natural log.  A row that attends no
column gets out = 0 and lse = 0 and sends exact-zero gradients; kv rows
that no q row reads get exact-zero dk/dv.  (The einsum oracle in
ops/attention.py masks with finfo.min instead and returns the mean of V on
such a row; a model never meets one, since Sq == Skv there.)

Not ported, because they are TPU layout choices: the `bq`/`bk` block-size
arguments, `raw_stats`/`stats128` and the (B*H, Sq_padded, 128) exp2-domain
residual.  The statistic that travels from forward to backward is the
public (B, H, Sq) natural-log lse.

bf16 inputs: the kernels (and the plain versions) widen them to fp32, keep
P and dS in fp32 into the second product, and round results to bf16 once.
fp16 is not taken here: ops/attention.py widens it to fp32 first.

Layout: the kernels read contiguous (B, H, S, D) tensors.  The model hands
over transposed views of the fused projection, so the wrappers call
`.contiguous()` (a copy where needed) rather than take strides.  The
kernels are compiled for head dims 64 and 128; any other head dim up to 128
is zero-padded here to the next of the two (zeros change neither q.k nor
the outputs' first D columns), and a larger one raises.

The kernels launch on PyTorch's current stream and do not synchronize.  The
copies and the delta scratch a wrapper makes go out of scope when it
returns, before the kernels have run; that is safe because PyTorch's
allocator hands freed memory only to later work on the same stream.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...runtime import _kernels

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # 4 fp32 tiles of 64 x (D + 4) must fit 227 KB of shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _mask(sq, skv, window, device):
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(skv, device=device)[None, :]
    ok = col <= row
    if window is not None:
        ok = ok & (col > row - window)
    return ok


def flash_attention_plain(q, k, v, window=None):
    """Plain PyTorch version of K1 (same contract): (out, lse).

    Materializes the (B, H, Sq, Skv) scores in fp32; differentiable, and its
    autograd gradient is the plain version of K2."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    qf, kf, vf = q.float(), k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    ok = _mask(sq, skv, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / math.sqrt(d))
    s = torch.where(ok, s, NEG_INF)
    m = s.max(dim=-1, keepdim=True).values.detach()
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0
    out = torch.einsum("bhqk,bhkd->bhqd", p / torch.where(empty, 1.0, l), vf)
    lse = torch.where(empty, 0.0, m + torch.log(torch.where(empty, 1.0, l)))
    return out.to(q.dtype), lse[..., 0]


def flash_attention_backward_plain(q, k, v, g, window=None):
    """Plain PyTorch version of K2: autograd through `flash_attention_plain`
    in fp32, gradients returned in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        out, _ = flash_attention_plain(*leaves, window=window)
        dq, dk, dv = torch.autograd.grad(out, leaves, g.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, window):
    if window is not None and window <= 0:
        raise ValueError(f"window must be None or positive, got {window}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B, H, Sq, D) and k, v (B, Hkv, Skv, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}: same "
            "batch and head dim, and H a multiple of Hkv")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share one dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k, v are on different devices")


def _check_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    d = q.shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim {d} exceeds the kernel's limit of {MAX_HEAD_DIM}: its "
            "four fp32 tiles of 64 x (D + 4) must fit the 227 KB of shared "
            "memory a block can use")
    return 64 if d <= 64 else 128


def _prep(t, dp):
    """Contiguous (B, H, S, dp) copy or view of t, head dim zero-padded."""
    if t.shape[-1] != dp:
        t = F.pad(t, (0, dp - t.shape[-1]))
    return t.contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd_stats(q, k, v, save_stats=True, window=None):
    """(out, lse): out (B, H, Sq, D) in q's dtype, lse (B, H, Sq) fp32 natural
    log, or None when save_stats is False (the kernel then skips the write).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `flash_attention_fwd_stats.launches`) or raise."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, window)
        return out, (lse if save_stats else None)
    dp = _check_cuda(q)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qc, kc, vc = _prep(q, dp), _prep(k, dp), _prep(v, dp)
    out = torch.empty_like(qc)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if save_stats else None)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("flash_attention", "kf_flash_attention_fwd",
                           (vp,) * 5 + (i32,) * 7 + (_kernels.F32, i32, vp))
    err = fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
             lse.data_ptr() if save_stats else None, b, h, hkv, sq, skv, dp,
             0 if window is None else int(window), 1.0 / math.sqrt(d),
             _DTYPE_CODES[q.dtype], _stream(q))
    if err:
        raise RuntimeError(f"flash forward kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd_stats.launches += 1
    return (out if dp == d else out[..., :d]), lse


flash_attention_fwd_stats.launches = 0


def flash_attention_forward(q, k, v, window=None):
    """K1 without the statistic: the inference form."""
    return flash_attention_fwd_stats(q, k, v, save_stats=False,
                                     window=window)[0]


def flash_attention_backward(q, k, v, g, out, lse, window=None):
    """(dq, dk, dv) for cotangent g of `out`, from the forward's saved
    (out, lse).  dq as q; dk, dv as k, v, the GQA group summed in fp32.

    CPU tensors run the plain version (autograd through the plain forward,
    which recomputes out and lse); CUDA tensors launch the kernels (one
    count in `flash_attention_backward.launches` per call, whatever number
    of device functions it runs) or raise."""
    _check(q, k, v, window)
    if g.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} and out {tuple(out.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, g, window)
    dp = _check_cuda(q)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if g.dtype != q.dtype or out.dtype != q.dtype:
        raise TypeError(f"g and out must have q's dtype {q.dtype}; got "
                        f"{g.dtype} and {out.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 ({b}, {h}, {sq}); got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if len({t.device for t in (q, g, out, lse)}) != 1:
        raise ValueError("q, g, out, lse are on different devices")
    qc, kc, vc = _prep(q, dp), _prep(k, dp), _prep(v, dp)
    gc, oc, lc = _prep(g, dp), _prep(out, dp), lse.contiguous()
    dq, dk, dv = torch.empty_like(qc), torch.empty_like(kc), torch.empty_like(vc)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("flash_attention", "kf_flash_attention_bwd",
                           (vp,) * 10 + (i32,) * 7 + (_kernels.F32, i32, vp))
    err = fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
             oc.data_ptr(), lc.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, skv, dp,
             0 if window is None else int(window), 1.0 / math.sqrt(d),
             _DTYPE_CODES[q.dtype], _stream(q))
    if err:
        raise RuntimeError(f"flash backward kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_backward.launches += 1
    if dp != d:
        dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv


flash_attention_backward.launches = 0
