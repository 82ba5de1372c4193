"""One hop of ring attention, forward and backward (K12).

Counterpart of kfunca_tpu/ops/pallas_kernels/ring_hop.py
(`flash_attention_hop` :72, `flash_attention_bwd_hop` :221, and the helpers
`hop_carry_init`, `hop_finalize`, `bwd_carry_init`, `hop_lse`,
`lane_replicate_rows`).  On CUDA tensors the two hop wrappers launch the
hand-written Hopper kernels in csrc/ring_hop.cu; on CPU tensors they run the
plain PyTorch versions below.  There is no fallback between the two: a CUDA
call that cannot launch its kernel raises.

Contract (both routes, the TPU kernels'): q (B, H, Sq, D) arrives
PRE-SCALED by 1/sqrt(D) (the caller folds the scale into q once, in q's
dtype); k, v (B, H, Skv, D) in q's dtype; q_off and kv_off are the global
sequence offsets of the q and kv shards, and column j of the hop is valid
for row i when kv_off + j <= q_off + i and j < Skv.
- `flash_attention_hop` merges the hop into the online-softmax carry (m, l,
  acc) IN PLACE and returns it; acc stays unnormalized (`hop_finalize`
  divides once, after the last hop).  A row with no valid column in the hop
  keeps its carry bit for bit (its p is set to exactly 0, not left to
  underflow): that departs from K1, whose rows with no column get out = 0
  and lse = 0, because inside a ring such a row is only waiting for a later
  hop.
- `flash_attention_bwd_hop` recomputes p = exp(q.k - lse) from the GLOBAL
  lse of the whole ring, ds = p (dp - delta) with dp = g.v, and adds, IN
  PLACE, ds k to dq (unscaled: the caller multiplies by 1/sqrt(D) once,
  after the last hop), ds^T q to dk (q is already scaled) and p^T g to dv.

Layout (the port's own): m, l, lse and delta are (B*H, Sq) fp32; acc and dq
are (B*H, Sq, D) fp32, dk and dv (B*H, Skv, D) fp32, all contiguous.  The
TPU kernels' lane-replicated (B*H, Sq_padded, 128) statistics and the
padding of every length to 128 are TPU layout choices and are not ported;
`flat_rows` stands where `lane_replicate_rows` did.

The route is chosen by dtype alone, as in flash_attention.py.  bf16 runs
the wgmma bodies that K1 and K2 share with the hop (csrc/attention_wgmma.cuh,
TMA-fed): every product on the tensor cores with fp32 accumulators, p (and,
backward, ds) rounded to bf16 before the second products, as the TPU kernel
does (`_mxu_in`); the forward's l sums the fp32 p before that rounding.
Their launches are also counted in `.launches_wgmma` of each wrapper.  fp32
runs the fp32 tile (FFMA, never TF32).  There is no fallback between the
two.  The plain versions widen every input to fp32 and keep p and ds in
fp32 (the reference the kernels are held to).

Head dims 64, 128 and 256 run as they are; any other head dim up to 256 is
zero-padded here to the next of the three (zeros change neither q.k nor
the first D columns of a product; the fp32 accumulators go through a
padded copy), and a larger one raises flash_attention.HeadDimError: 256 is
wgmma's largest N, the width of the second products.  Each head dim runs
its own tiles (csrc/attention_wgmma.cuh WgDefaults): at 256 the forward
streams 64 kv rows through 2 stages and the backward 32-row tiles.

The kernels launch on PyTorch's current stream and do not synchronize.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...runtime import _kernels
from .flash_attention import _aligned, padded_head_dim

NEG_INF = -1e30
MAX_GRID_Y = 65535  # B * H rides the grid's y dimension
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -- helpers ----------------------------------------------------------------


def hop_carry_init(b, h, sq, d, *, device):
    """The forward carry before the first hop: m = NEG_INF, l = 0 (B*H, Sq)
    and acc = 0 (B*H, Sq, D), fp32."""
    m = torch.full((b * h, sq), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((b * h, sq), dtype=torch.float32, device=device)
    acc = torch.zeros((b * h, sq, d), dtype=torch.float32, device=device)
    return m, l, acc


def bwd_carry_init(b, h, sq, skv, d, *, device):
    """Zero fp32 accumulators: dq (B*H, Sq, D), dk and dv (B*H, Skv, D)."""
    dq = torch.zeros((b * h, sq, d), dtype=torch.float32, device=device)
    dk = torch.zeros((b * h, skv, d), dtype=torch.float32, device=device)
    return dq, dk, torch.zeros_like(dk)


def hop_lse(m, l):
    """Natural-log lse from the forward carry.  A row that saw no valid
    column over the whole ring (m = NEG_INF, l = 0: a padding row) gets
    lse = 0, so that the backward's exp(s - lse) stays finite there; its p
    only ever multiplies zero cotangents."""
    return torch.where(l == 0.0, 0.0, m + torch.log(l.clamp_min(1e-30)))


def hop_finalize(l, acc, b, h, sq, d, out_dtype):
    """acc / l (1 where l == 0) as (B, H, Sq, D) in out_dtype."""
    safe = torch.where(l == 0.0, 1.0, l)
    return (acc / safe[..., None]).reshape(b, h, sq, d).to(out_dtype)


def flat_rows(x):
    """(B, H, Sq) row statistic -> (B*H, Sq) fp32, contiguous: the carry's
    layout (counterpart of `lane_replicate_rows`)."""
    b, h, sq = x.shape
    return x.reshape(b * h, sq).float().contiguous()


def _hop_mask(sq, skv, q_off, kv_off, device):
    row = torch.arange(sq, device=device)[:, None] + q_off
    col = torch.arange(skv, device=device)[None, :] + kv_off
    return col <= row


def _flat(t):
    b, h, s, d = t.shape
    return t.reshape(b * h, s, d).float()


# -- plain versions -----------------------------------------------------------


def flash_attention_hop_plain(q, k, v, m, l, acc, q_off, kv_off):
    """Plain PyTorch version of the K12 forward (same contract): the hop's
    (B*H, Sq, Skv) scores in fp32, masked by the global offsets."""
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    ok = _hop_mask(q.shape[2], k.shape[2], q_off, kv_off, q.device)
    s = torch.where(ok, torch.bmm(qf, kf.transpose(1, 2)), NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
    l.mul_(alpha).add_(p.sum(dim=-1))
    acc.mul_(alpha[..., None]).add_(torch.bmm(p, vf))
    m.copy_(m_new)
    return m, l, acc


def flash_attention_bwd_hop_plain(q, k, v, g, lse, delta, dq, dk, dv, q_off,
                                  kv_off):
    """Plain PyTorch version of the K12 backward (same contract)."""
    qf, kf, vf, gf = _flat(q), _flat(k), _flat(v), _flat(g)
    ok = _hop_mask(q.shape[2], k.shape[2], q_off, kv_off, q.device)
    s = torch.bmm(qf, kf.transpose(1, 2))
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.bmm(gf, vf.transpose(1, 2)) - delta[..., None])
    dq.add_(torch.bmm(ds, kf))
    dk.add_(torch.bmm(ds.transpose(1, 2), qf))
    dv.add_(torch.bmm(p.transpose(1, 2), gf))
    return dq, dk, dv


# -- wrappers -----------------------------------------------------------------


def _check_qkv(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B, H, Sq, D) and k, v (B, H, Skv, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}: same batch, heads and head dim")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share one dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def _check_state(what, shape, tensors, device):
    for name, t in tensors.items():
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{what} {name} must be float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{what} {name} is on {t.device}, q on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} {name} must be contiguous")


def _check_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    b, h, _, d = q.shape
    dp = padded_head_dim(d)  # raises HeadDimError above 256
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} exceeds the grid's {MAX_GRID_Y}")
    return dp


def _prep(t, dp):
    """Contiguous copy or view of t with its last dim zero-padded to dp."""
    if t.shape[-1] != dp:
        t = F.pad(t, (0, dp - t.shape[-1]))
    return t.contiguous()


def _stats(t, pitch):
    """A (B*H, Sq) statistic as (B*H, pitch) rows, zero past Sq and
    16-byte aligned, for the bf16 backward: its dk/dv kernel bulk-copies
    whole 64-row tiles."""
    if t.shape[1] != pitch:
        t = F.pad(t, (0, pitch - t.shape[1]))
    return _aligned(t)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_hop(q, k, v, m, l, acc, q_off, kv_off):
    """Merge one hop into the carry (m, l, acc) in place; returns it.

    CPU tensors run the plain version; CUDA tensors launch the K12 forward
    (counted in `flash_attention_hop.launches`, and bf16 calls, which take
    the wgmma body, also in `.launches_wgmma`) or raise."""
    _check_qkv(q, k, v)
    b, h, sq, d = q.shape
    _check_state("carry", (b * h, sq), {"m": m, "l": l}, q.device)
    _check_state("carry", (b * h, sq, d), {"acc": acc}, q.device)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v are on different devices")
    if q.device.type == "cpu":
        return flash_attention_hop_plain(q, k, v, m, l, acc, q_off, kv_off)
    dp = _check_cuda(q)
    skv = k.shape[2]
    qc, kc, vc = (_aligned(_prep(t, dp)) for t in (q, k, v))
    acc_k = _prep(acc, dp)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("ring_hop", "kf_ring_hop_fwd",
                           (vp,) * 6 + (i32,) * 7 + (vp,))
    err = fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), m.data_ptr(),
             l.data_ptr(), acc_k.data_ptr(), b * h, sq, skv, dp, int(q_off),
             int(kv_off), _DTYPE_CODES[q.dtype], _stream(q))
    if err:
        raise RuntimeError(f"ring hop forward kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_hop.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_hop.launches_wgmma += 1
    if acc_k is not acc:
        acc.copy_(acc_k[..., :d])
    return m, l, acc


flash_attention_hop.launches = 0
flash_attention_hop.launches_wgmma = 0


def flash_attention_bwd_hop(q, k, v, g, lse, delta, dq, dk, dv, q_off,
                            kv_off):
    """Add one hop's share to (dq, dk, dv) in place; returns them.

    CPU tensors run the plain version; CUDA tensors launch the K12 backward
    (its dq and dk/dv kernels; one count in
    `flash_attention_bwd_hop.launches` a call, and for bf16, which takes the
    wgmma bodies, one in `.launches_wgmma`) or raise."""
    _check_qkv(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g must have q's shape {tuple(q.shape)} and dtype "
                         f"{q.dtype}; got {g.dtype} {tuple(g.shape)}")
    _check_state("statistic", (b * h, sq), {"lse": lse, "delta": delta},
                 q.device)
    _check_state("accumulator", (b * h, sq, d), {"dq": dq}, q.device)
    _check_state("accumulator", (b * h, skv, d), {"dk": dk, "dv": dv},
                 q.device)
    if len({t.device for t in (q, k, v, g)}) != 1:
        raise ValueError("q, k, v, g are on different devices")
    if q.device.type == "cpu":
        return flash_attention_bwd_hop_plain(q, k, v, g, lse, delta, dq, dk,
                                             dv, q_off, kv_off)
    dp = _check_cuda(q)
    qc, kc, vc, gc = (_aligned(_prep(t, dp)) for t in (q, k, v, g))
    accs = [_prep(t, dp) for t in (dq, dk, dv)]
    pitch = sq
    if q.dtype == torch.bfloat16:
        pitch = -(-sq // 64) * 64
        lse, delta = _stats(lse, pitch), _stats(delta, pitch)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("ring_hop", "kf_ring_hop_bwd",
                           (vp,) * 6 + (i32,) + (vp,) * 3 + (i32,) * 7 + (vp,))
    err = fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), pitch,
             *(t.data_ptr() for t in accs), b * h, sq, skv, dp, int(q_off),
             int(kv_off), _DTYPE_CODES[q.dtype], _stream(q))
    if err:
        raise RuntimeError(f"ring hop backward kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd_hop.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_bwd_hop.launches_wgmma += 1
    for t, t_k in zip((dq, dk, dv), accs):
        if t_k is not t:
            t.copy_(t_k[..., :d])
    return dq, dk, dv


flash_attention_bwd_hop.launches = 0
flash_attention_bwd_hop.launches_wgmma = 0
