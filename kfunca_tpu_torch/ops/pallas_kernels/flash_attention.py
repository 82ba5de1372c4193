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
public (B, H, Sq) natural-log lse.  In their place the bf16 bodies take
their own launch parameters, the tiles built in csrc/flash_attention.cu:
the forward's (`kv_rows` streamed a stage, `stages` of its ring) and the
backward's (`kv_rows` the dq kernel streams, `q_rows` the dk/dv kernel
streams, `stages`), listed per head dim by `fwd_tiles(head_dim)` and
`bwd_tiles(head_dim)` (FWD_TILES and BWD_TILES up to 128, one of the
forward's for head dims up to 64 only; FWD_TILES_256 and BWD_TILES_256
at 256, where only narrower tiles fit a block's shared memory); the first
of each is the default, any other raises ValueError, and the fp32 bodies
take only the default.
runtime/autotune.py sweeps them.  A tile changes the order of the fp32
sums, so its results agree with the default's within rounding; each tile
repeats bit for bit.

bf16 inputs run the wgmma bodies (csrc/flash_attention.cu, TMA-fed): every
product on the tensor cores with fp32 accumulators, P (and, backward, dS)
rounded to bf16 before the second products, as the TPU kernel does; the
forward's l sums the fp32 P before that rounding, and `out` is rounded
once.  The forward is bound by operations (4·hd flops per unmasked
pair); what it leaves for later: overlapping one tile's softmax with the
next tile's S product and a persistent grid.  The plain versions stay in
fp32 throughout (the reference the kernels are held to).

fp32 inputs at head dims up to 128 run the split-TF32 wgmma bodies
(route "split_tf32"): every product as three TF32 tensor-core products,
a_hi.b_lo + a_lo.b_hi + a_hi.b_hi with hi = rna(x) and lo = rna(x - hi)
(`tf32_split`), each sum in fp32.  hi + lo holds x within 2^-22 |x| and the
dropped a_lo.b_lo is below 2^-22 |a.b|, so the results stand within fp32
rounding of the plain fp32 version (chip_smoke.py holds out, lse, dq, dk
and dv to a float64 evaluation within 1/64 of the plain version's own
error with TF32 allowed); single-pass TF32 would not.  At head dims
129-256 (padded to 256) fp32 keeps the FFMA tile of csrc/attention_tile.cuh
(route "fp32_tile"): q's lo parts would not fit beside a 256-wide
accumulator.  bf16 and split-TF32 launches are counted in
`.launches_wgmma` of each wrapper, fp32-tile launches in
`.launches_fp32_tile`.  fp16 is not taken here: ops/attention.py widens it
to fp32 first.

Layout: the kernels read contiguous (B, H, S, D) tensors.  The model hands
over transposed views of the fused projection, so the wrappers call
`.contiguous()` (a copy where needed) rather than take strides.  The
kernels are compiled for head dims 64, 128 and 256; any other head dim up
to 256 is zero-padded here to the next of the three (zeros change neither
q.k nor the outputs' first D columns), as the TPU kernels pad to 128-lane
multiples, and a larger one raises: 256 is wgmma's largest N, the width
of the second products (O += P.V and the gradients').

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
# wgmma's largest N: the second products' width is the head dim
MAX_HEAD_DIM = 256
HEAD_DIMS = (64, 128, 256)  # the kernels' head dims; others pad up
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 bodies' tiles (csrc/flash_attention.cu fwd_tile, bwd_tile)
FWD_TILES = ({"kv_rows": 64, "stages": 3}, {"kv_rows": 64, "stages": 2},
             {"kv_rows": 128, "stages": 2})
BWD_TILES = ({"kv_rows": 64, "q_rows": 64, "stages": 2},
             {"kv_rows": 32, "q_rows": 32, "stages": 2},
             {"kv_rows": 64, "q_rows": 64, "stages": 3})
# at head dim 256 (129-256 padded), where the hd-128 defaults do not fit a
# block's shared memory: the narrower tiles that won there on the card
FWD_TILES_256 = ({"kv_rows": 64, "stages": 2},)
BWD_TILES_256 = ({"kv_rows": 32, "q_rows": 32, "stages": 2},)


# a forward tile built for head dims up to 64 only: at 128 its consumers'
# 128-column score tile beside the 128-column accumulator spills
_HD64_ONLY = ({"kv_rows": 128, "stages": 2},)


class HeadDimError(ValueError):
    """A head dim above MAX_HEAD_DIM on a CUDA tensor."""


def padded_head_dim(head_dim: int) -> int:
    """The kernels' head dim that `head_dim` is zero-padded to; raises
    HeadDimError above MAX_HEAD_DIM."""
    for dp in HEAD_DIMS:
        if head_dim <= dp:
            return dp
    raise HeadDimError(
        f"head dim {head_dim} exceeds the kernels' limit of {MAX_HEAD_DIM}: "
        f"wgmma's N, the width of O += P.V, is at most 256")


def fwd_tiles(head_dim: int) -> tuple:
    """The forward tiles built for `head_dim` (padded to 64, 128 or 256)."""
    if head_dim > 128:
        return FWD_TILES_256
    if head_dim <= 64:
        return FWD_TILES
    return tuple(t for t in FWD_TILES if t not in _HD64_ONLY)


def bwd_tiles(head_dim: int) -> tuple:
    """The backward tiles built for `head_dim` (padded to 64, 128 or
    256)."""
    return BWD_TILES_256 if head_dim > 128 else BWD_TILES


def route(dtype, head_dim: int) -> str:
    """The body a CUDA call on `dtype` at `head_dim` launches: "wgmma"
    (bf16), "split_tf32" (fp32 up to head dim 128) or "fp32_tile" (fp32 at
    head dims 129-256)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    return "split_tf32" if padded_head_dim(head_dim) <= 128 else "fp32_tile"


def _count(wrapper, dtype, head_dim):
    wrapper.launches += 1
    if route(dtype, head_dim) == "fp32_tile":
        wrapper.launches_fp32_tile += 1
    else:
        wrapper.launches_wgmma += 1


def tf32_split(x):
    """(hi, lo) of fp32 x as the split-TF32 bodies carry it (the kernels'
    `cvt.rna.tf32.f32`): hi = x rounded to TF32 (10 fraction bits, to
    nearest, ties away from zero), lo = x - hi rounded the same way; by
    integer operations on the bits, so it runs alike on every device.  inf
    and NaN pass through hi.  For finite x below 2^128 - 2^114 (above, hi
    rounds to inf) hi + lo is x within 2^-22 |x|, or within 2^-137 (half a
    TF32 step) where x - hi is subnormal: two TF32 values cannot hold a
    finer remainder."""
    def rna(t):
        b = t.contiguous().view(torch.int32)
        finite = (b & 0x7F800000) != 0x7F800000
        r = (b + 0x1000) & ~0x1FFF  # add half an ulp of TF32, truncate
        return torch.where(finite, r, b).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _tile(tiles, dtype, given):
    """The full tile for the launch parameters given (None: the default's);
    raises for a tile the kernel was not built with."""
    tile = {**tiles[0], **{k: v for k, v in given.items() if v is not None}}
    if tile not in tiles:
        raise ValueError(f"no flash attention tile {tile} at this head dim: "
                         f"the bf16 bodies are built for the tiles "
                         f"{list(tiles)}")
    if dtype != torch.bfloat16 and tile != tiles[0]:
        raise ValueError(f"the {dtype} body's tile is fixed at {tiles[0]}; "
                         f"only bfloat16 takes the others")
    return tile


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
    return padded_head_dim(q.shape[-1])


def _prep(t, dp):
    """Contiguous (B, H, S, dp) copy or view of t, head dim zero-padded."""
    if t.shape[-1] != dp:
        t = F.pad(t, (0, dp - t.shape[-1]))
    return t.contiguous()


def _aligned(t):
    """t, or a copy of it if its data does not start on 16 bytes (TMA's
    base alignment; views of the model's tensors always do)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd_stats(q, k, v, save_stats=True, window=None,
                              kv_rows=None, stages=None):
    """(out, lse): out (B, H, Sq, D) in q's dtype, lse (B, H, Sq) fp32 natural
    log, or None when save_stats is False (the kernel then skips the write).
    `kv_rows`, `stages`: a tile of fwd_tiles(D) (None: the default's).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `flash_attention_fwd_stats.launches`, and by `route` also in
    `.launches_wgmma` or `.launches_fp32_tile`) or raise."""
    _check(q, k, v, window)
    tile = _tile(fwd_tiles(q.shape[-1]), q.dtype,
                 dict(kv_rows=kv_rows, stages=stages))
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, window)
        return out, (lse if save_stats else None)
    dp = _check_cuda(q)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qc, kc, vc = (_aligned(_prep(t, dp)) for t in (q, k, v))
    out = torch.empty_like(qc)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if save_stats else None)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("flash_attention", "kf_flash_attention_fwd",
                           (vp,) * 5 + (i32,) * 7 + (_kernels.F32,)
                           + (i32,) * 3 + (vp,))
    err = fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
             lse.data_ptr() if save_stats else None, b, h, hkv, sq, skv, dp,
             0 if window is None else int(window), 1.0 / math.sqrt(d),
             _DTYPE_CODES[q.dtype], tile["kv_rows"], tile["stages"],
             _stream(q))
    if err:
        raise RuntimeError(f"flash forward kernel launch failed: CUDA error "
                           f"{err}")
    _count(flash_attention_fwd_stats, q.dtype, d)
    return (out if dp == d else out[..., :d]), lse


flash_attention_fwd_stats.launches = 0
flash_attention_fwd_stats.launches_wgmma = 0
flash_attention_fwd_stats.launches_fp32_tile = 0


def flash_attention_forward(q, k, v, window=None, **tile):
    """K1 without the statistic: the inference form."""
    return flash_attention_fwd_stats(q, k, v, save_stats=False,
                                     window=window, **tile)[0]


def flash_attention_backward(q, k, v, g, out, lse, window=None, kv_rows=None,
                             q_rows=None, stages=None):
    """(dq, dk, dv) for cotangent g of `out`, from the forward's saved
    (out, lse).  dq as q; dk, dv as k, v, the GQA group summed in fp32.
    `kv_rows`, `q_rows`, `stages`: a tile of bwd_tiles(D) (None: the
    default's).

    CPU tensors run the plain version (autograd through the plain forward,
    which recomputes out and lse); CUDA tensors launch the kernels (one
    count in `flash_attention_backward.launches` per call, whatever number
    of device functions it runs, and by `route` one in `.launches_wgmma` or
    `.launches_fp32_tile`) or raise."""
    _check(q, k, v, window)
    tile = _tile(bwd_tiles(q.shape[-1]), q.dtype,
                 dict(kv_rows=kv_rows, q_rows=q_rows, stages=stages))
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
    qc, kc, vc = (_aligned(_prep(t, dp)) for t in (q, k, v))
    gc, oc, lc = _aligned(_prep(g, dp)), _prep(out, dp), lse.contiguous()
    dq, dk, dv = torch.empty_like(qc), torch.empty_like(kc), torch.empty_like(vc)
    # delta (and, for bf16, lse) per q row, padded to whole 64-row tiles
    sq_pad = -(-sq // 64) * 64
    delta = torch.empty((2, b * h, sq_pad), dtype=torch.float32,
                        device=q.device)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("flash_attention", "kf_flash_attention_bwd",
                           (vp,) * 10 + (i32,) * 7 + (_kernels.F32,)
                           + (i32,) * 4 + (vp,))
    err = fn(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), gc.data_ptr(),
             oc.data_ptr(), lc.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, skv, dp,
             0 if window is None else int(window), 1.0 / math.sqrt(d),
             _DTYPE_CODES[q.dtype], tile["kv_rows"], tile["q_rows"],
             tile["stages"], _stream(q))
    if err:
        raise RuntimeError(f"flash backward kernel launch failed: CUDA error "
                           f"{err}")
    _count(flash_attention_backward, q.dtype, d)
    if dp != d:
        dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.launches_wgmma = 0
flash_attention_backward.launches_fp32_tile = 0
