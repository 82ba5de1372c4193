"""Paged decode attention: one query token per sequence over a paged KV pool.

Counterpart of kfunca_tpu/ops/pallas_kernels/paged_attention.py: the two
entry points `paged_decode_attention_dma` (fused [k|v] pool or split pools;
fp32/bf16, or int8 with fp32 scales per (slot, kv head), slot-major or
head-major) and `paged_decode_attention` (split pools, 4-D or flat 3-D,
slot-major scale pair).  On CUDA tensors each launches the hand-written
Hopper kernel in csrc/paged_attention.cu (one device body; the pool forms
are stride choices) and counts it in its own `.launches`; on CPU tensors
each runs `paged_decode_attention_plain`, the gather path the JAX serving
engine runs off the TPU (kfunca_tpu/models/serve.py:507-549).  There is no
fallback between the two: a CUDA call that cannot launch the kernel raises.

Every pool form is first brought to one canonical set of VIEWS (no copy):
k, v as (n_pages, page, Hkv, hd) and, for int8 pools, sk, sv as
(n_pages, page, Hkv).  The plain version computes from those views; the
kernel gets their data pointers and strides.  So the layout arithmetic
that the CPU tests exercise is the one the kernel is handed.

`plain_paged_attention()` is a context that routes both entry points
through the plain version whatever the device: the yardstick an end-to-end
check holds the kernel path against.  No entry point of the package enters
it.
"""

from __future__ import annotations

import contextlib

import torch

from ...runtime import _kernels

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_plain = False  # set only inside plain_paged_attention()


@contextlib.contextmanager
def plain_paged_attention():
    """Route this module's entry points through the plain version whatever
    the device (launch counts stay untouched): the yardstick an end-to-end
    check holds the kernel path against.  It flips a module-level flag and
    is not thread-safe: entered while another thread serves, it would route
    that server's CUDA tensors to the plain version too.  For chip_smoke.py
    and the tests only; no entry point of the package enters it."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def _canonical(q, pool, pool_v, scales, head_major_scales):
    """Views (k, v, sk, sv) of the pools in the canonical form: k, v
    (n_pages, page, Hkv, hd); sk, sv (n_pages, page, Hkv) fp32, or None for
    fp pools.  Checks the pool form against q."""
    if q.ndim != 3:
        raise ValueError(f"expected q (B, H, hd), got {tuple(q.shape)}")
    _, h, hd = q.shape
    if pool_v is None:
        if pool.ndim != 3:
            raise ValueError(
                f"expected q (B, H, hd) and a fused pool (n_pages, page, "
                f"2*Hkv*hd); got {tuple(q.shape)} and {tuple(pool.shape)}")
        n_pages, page, kv2 = pool.shape
        hkv = kv2 // (2 * hd)
        if kv2 % (2 * hd) or hkv == 0 or h % hkv:
            raise ValueError(
                f"pool rows of {kv2} do not hold [k|v] heads of {hd} for {h} "
                "query heads")
        rows = pool.view(n_pages, page, 2, hkv, hd)
        k, v = rows[:, :, 0], rows[:, :, 1]
    else:
        if pool.shape != pool_v.shape or pool.ndim not in (3, 4):
            raise ValueError(
                f"split pools must be two (n_pages, page, Hkv, hd) or flat "
                f"(n_pages, page, Hkv*hd) tensors of one shape; got "
                f"{tuple(pool.shape)} and {tuple(pool_v.shape)}")
        n_pages, page = pool.shape[:2]
        width = pool.shape[2] * (pool.shape[3] if pool.ndim == 4 else 1)
        hkv = width // hd
        if (width % hd or hkv == 0 or h % hkv
                or (pool.ndim == 4 and pool.shape[3] != hd)):
            raise ValueError(
                f"pool rows of {tuple(pool.shape[2:])} do not hold kv heads "
                f"of {hd} for {h} query heads")
        k = pool.view(n_pages, page, hkv, hd)
        v = pool_v.view(n_pages, page, hkv, hd)
    if pool_v is not None and pool_v.dtype != pool.dtype:
        raise TypeError(f"pools of two dtypes: {pool.dtype}, {pool_v.dtype}")
    if (pool.dtype == torch.int8) != (scales is not None):
        raise TypeError("int8 pools need scales, and only int8 pools take "
                        f"them; got {pool.dtype} pools and scales "
                        f"{'given' if scales is not None else 'missing'}")
    if scales is None:
        return k, v, None, None
    if pool_v is None:
        # one slot-major (n_pages, page, 128) pool whose rows begin
        # [sk heads | sv heads]; the rest of the row is unused
        skv = scales[0] if isinstance(scales, tuple) else scales
        if skv.shape != (n_pages, page, 128) or 2 * hkv > 128:
            raise ValueError(
                f"the fused scale pool must be ({n_pages}, {page}, 128) with "
                f"2*Hkv <= 128; got {tuple(skv.shape)}, Hkv = {hkv}")
        sk, sv = skv[..., :hkv], skv[..., hkv:2 * hkv]
    else:
        sk, sv = scales
        if head_major_scales:  # (n_pages, Hkv, page)
            sk, sv = sk.transpose(1, 2), sv.transpose(1, 2)
        if sk.shape != (n_pages, page, hkv) or sv.shape != sk.shape:
            raise ValueError(
                f"scale pools must be ({n_pages}, {page}, {hkv}) slot-major "
                f"or ({n_pages}, {hkv}, {page}) head-major; got "
                f"{tuple(scales[0].shape)} and {tuple(scales[1].shape)}")
    if sk.dtype != torch.float32 or sv.dtype != torch.float32:
        raise TypeError("scale pools must be float32")
    return k, v, sk, sv


def _attend(q, k, v, sk, sv, page_tables, positions, window, page_base):
    """The gather path over canonical views; see the plain version."""
    bsz, h, hd = q.shape
    _, page, hkv, _ = k.shape
    group = h // hkv
    length = page_tables.shape[1] * page
    ids = page_tables.long() + page_base
    kc, vc = k[ids].float(), v[ids].float()  # (B, max_pages, page, Hkv, hd)
    if sk is not None:
        kc = kc * sk[ids][..., None]
        vc = vc * sv[ids][..., None]
    kc = kc.reshape(bsz, length, hkv, hd)
    vc = vc.reshape(bsz, length, hkv, hd)
    slot = torch.arange(length, device=q.device)[None, :]
    pos = positions.long()[:, None]
    ok = slot <= pos
    if window is not None:
        ok = ok & (slot > pos - window)  # (B, L)
    vc = torch.where(ok[:, :, None, None], vc, 0.0)
    qg = q.float().reshape(bsz, hkv, group, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, kc)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", p, vc)
    return out.reshape(bsz, h, hd).to(q.dtype)


def paged_decode_attention_plain(q, pool, page_tables, positions, window=None,
                                 page_base: int = 0, pool_v=None, scales=None,
                                 head_major_scales: bool = False):
    """Plain PyTorch version of the kernel, every pool form (same contract
    as `paged_decode_attention_dma`).

    Gathers every table slot's page, dequantizes int8 vectors by their
    scales, masks slots > position and, with a window, slots <= position -
    window, and takes an fp32 softmax over the full table width.  Masked
    slots' scores are replaced and their values zeroed before the product,
    so NaN in a dead page or a dead scale row cannot leak (the kernel never
    reads dead pages at all).  A position past the table width admits every
    table slot."""
    k, v, sk, sv = _canonical(q, pool, pool_v, scales, head_major_scales)
    return _attend(q, k, v, sk, sv, page_tables, positions, window, page_base)


def _check(q, n_pages, page_tables, positions, window, page_base, tensors):
    if window is not None and window <= 0:
        raise ValueError(f"window must be None or positive, got {window}")
    bsz = q.shape[0]
    if page_tables.ndim != 2 or page_tables.shape[0] != bsz:
        raise ValueError(f"page_tables must be (B={bsz}, max_pages), got "
                         f"{tuple(page_tables.shape)}")
    if positions.shape != (bsz,):
        raise ValueError(f"positions must be ({bsz},), got "
                         f"{tuple(positions.shape)}")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("page_tables and positions must be int32")
    if not 0 <= page_base < n_pages:
        raise ValueError(f"page_base {page_base} outside the pool's "
                         f"{n_pages} pages")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def _run(entry, q, pool, pool_v, page_tables, positions, window, scales,
         page_base, head_major_scales):
    """Shared body of the two entry points: checks, then the plain version
    (CPU tensors) or the kernel behind `entry` (CUDA tensors)."""
    k, v, sk, sv = _canonical(q, pool, pool_v, scales, head_major_scales)
    named = [("q", q), ("pool", pool), ("page_tables", page_tables),
             ("positions", positions)]
    if pool_v is not None:
        named.append(("pool_v", pool_v))
    if scales is not None:
        named += [(f"scales[{i}]", t) for i, t in enumerate(
            scales if isinstance(scales, tuple) else (scales,))]
    _check(q, k.shape[0], page_tables, positions, window, page_base,
           [t for _, t in named])
    if q.device.type == "cpu" or _plain:
        return _attend(q, k, v, sk, sv, page_tables, positions, window,
                       page_base)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or pool.dtype not in (
            q.dtype, torch.int8):
        raise TypeError(f"kernel takes float32 or bfloat16 q and pools of "
                        f"one dtype with it, or int8 pools; got {q.dtype} "
                        f"and {pool.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bsz, h, hd = q.shape
    n_pages, page, hkv, _ = k.shape
    row = k.stride(1)
    elems = 16 // pool.element_size()
    if (hd % elems or row % elems or k.data_ptr() % 16 or v.data_ptr() % 16
            or k.stride() != (page * row, row, hd, 1)
            or v.stride() != k.stride()):
        raise ValueError(f"the kernel's 16-byte loads need head_dim % {elems} "
                         "== 0 and 16-byte aligned pools")
    if sk is not None and sv.stride() != sk.stride():
        raise ValueError("the two scale pools must share one layout")
    vp, i32, i64 = _kernels.VP, _kernels.I32, _kernels.I64
    fn = _kernels.function(
        "paged_attention", f"kf_{entry.__name__}",
        (vp, vp, vp, i64, vp, vp, i64, i64, i64, vp, vp, vp, i32,
         i32, i32, i32, i32, i32, i64, i64, i32, i32, i32, vp))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    s_ptrs = (None, None) if sk is None else (sk.data_ptr(), sv.data_ptr())
    s_strides = (0, 0, 0) if sk is None else sk.stride()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), row, *s_ptrs,
             *s_strides, page_tables.data_ptr(), positions.data_ptr(),
             out.data_ptr(), bsz, h, hkv, hd, page, page_tables.shape[1],
             n_pages, page_base, 0 if window is None else int(window),
             _DTYPE_CODES[q.dtype], _DTYPE_CODES[pool.dtype], stream)
    if err:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")
    entry.launches += 1
    return out


def paged_decode_attention_dma(q, pool, page_tables, positions, window=None,
                               page_base: int = 0, pool_v=None, scales=None,
                               head_major_scales: bool = False):
    """q: (B, H, hd) PRE-SCALED by 1/sqrt(hd); page_tables: (B, max_pages)
    int32; positions: (B,) int32 (the query's slot); page_base: added to
    every table entry (selects a layer of a flattened layer-stacked pool).
    Returns (B, H, hd) in q's dtype: attention over slots <= position (and
    > position - window).

    pool alone is the fused (n_pages, page, 2*Hkv*hd) pool of rows
    [k heads | v heads]; with pool_v, pool and pool_v are split pools,
    (n_pages, page, Hkv, hd) or flat (n_pages, page, Hkv*hd).  Pools are
    q's dtype, or int8 with `scales`: for the fused pool ONE slot-major
    (n_pages, page, 128) fp32 pool whose rows begin [sk heads | sv heads];
    for split pools an (sk, sv) pair, slot-major (n_pages, page, Hkv) or,
    with head_major_scales, (n_pages, Hkv, page).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `paged_decode_attention_dma.launches`) or raise."""
    return _run(paged_decode_attention_dma, q, pool, pool_v, page_tables,
                positions, window, scales, page_base, head_major_scales)


paged_decode_attention_dma.launches = 0


def paged_decode_attention(q, pool_k, pool_v, page_tables, positions,
                           window=None, scales=None, page_base: int = 0,
                           fanin: int | None = None, mxu: bool = False):
    """The same attention over SPLIT pools: pool_k, pool_v
    (n_pages, page, Hkv, hd) or flat (n_pages, page, Hkv*hd), in q's dtype,
    or int8 with `scales` = (sk, sv), slot-major (n_pages, page, Hkv) fp32.
    `fanin` and `mxu` choose TPU grid and matrix-unit layouts in the JAX
    package; they are accepted and ignored here.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `paged_decode_attention.launches`) or raise."""
    del fanin, mxu
    if pool_v is None:
        raise ValueError("paged_decode_attention takes split pools; the "
                         "fused pool goes to paged_decode_attention_dma")
    return _run(paged_decode_attention, q, pool_k, pool_v, page_tables,
                positions, window, scales, page_base, False)


paged_decode_attention.launches = 0
