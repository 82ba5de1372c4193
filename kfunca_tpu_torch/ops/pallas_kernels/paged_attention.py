"""Paged decode attention: one query token per sequence over a paged KV pool.

Counterpart of kfunca_tpu/ops/pallas_kernels/paged_attention.py
(`paged_decode_attention_dma`, fused [k|v] pool, fp32/bf16).  On a CUDA
tensor the wrapper launches the hand-written Hopper kernel in
csrc/paged_attention.cu; on a CPU tensor it runs `paged_decode_attention_plain`,
the gather path the JAX serving engine runs off the TPU
(kfunca_tpu/models/serve.py:507-549).  There is no fallback between the
two: a CUDA call that cannot launch the kernel raises.

The int8-KV branch (scales) and split pools (`paged_decode_attention`)
are later slices of the port.
"""

from __future__ import annotations

import ctypes

import torch

from ...runtime import _kernels

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_plain(q, pool, page_tables, positions, window=None,
                                 page_base: int = 0):
    """Plain PyTorch version of the kernel (same contract).

    Gathers every table slot's page, masks slots > position and, with a
    window, slots <= position - window, and takes an fp32 softmax over the
    full table width.  Masked slots' values are zeroed before the product,
    so NaN in a dead page cannot leak (the TPU kernel never reads dead
    pages at all).  A position past the table width admits every table
    slot."""
    bsz, h, hd = q.shape
    _, page, kv2 = pool.shape
    hkv = kv2 // (2 * hd)
    group = h // hkv
    max_pages = page_tables.shape[1]
    length = max_pages * page
    kv = pool[page_tables.long() + page_base].reshape(bsz, length, kv2)
    k = kv[..., : hkv * hd].reshape(bsz, length, hkv, hd).float()
    v = kv[..., hkv * hd:].reshape(bsz, length, hkv, hd).float()
    slot = torch.arange(length, device=q.device)[None, :]
    pos = positions.long()[:, None]
    ok = slot <= pos
    if window is not None:
        ok = ok & (slot > pos - window)  # (B, L)
    v = torch.where(ok[:, :, None, None], v, 0.0)
    qg = q.float().reshape(bsz, hkv, group, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", p, v)
    return out.reshape(bsz, h, hd).to(q.dtype)


def _check(q, pool, page_tables, positions, window, page_base):
    if window is not None and window <= 0:
        raise ValueError(f"window must be None or positive, got {window}")
    if q.ndim != 3 or pool.ndim != 3:
        raise ValueError(
            f"expected q (B, H, hd) and a fused pool (n_pages, page, "
            f"2*Hkv*hd); got {tuple(q.shape)} and {tuple(pool.shape)}")
    bsz, h, hd = q.shape
    n_pages, _, kv2 = pool.shape
    if kv2 % (2 * hd) or h % (kv2 // (2 * hd)):
        raise ValueError(
            f"pool rows of {kv2} do not hold [k|v] heads of {hd} for {h} "
            "query heads")
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
    devices = {t.device for t in (q, pool, page_tables, positions)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def paged_decode_attention_dma(q, pool, page_tables, positions, window=None,
                               page_base: int = 0):
    """q: (B, H, hd) PRE-SCALED by 1/sqrt(hd); pool: fused
    (n_pages, page, 2*Hkv*hd) rows [k heads | v heads]; page_tables:
    (B, max_pages) int32; positions: (B,) int32 (the query's slot);
    page_base: added to every table entry (selects a layer of a flattened
    layer-stacked pool).  Returns (B, H, hd) in q's dtype: attention over
    slots <= position (and > position - window).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `paged_decode_attention_dma.launches`) or raise."""
    _check(q, pool, page_tables, positions, window, page_base)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool, page_tables, positions,
                                            window, page_base)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or pool.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q and pool of one "
                        f"dtype; got {q.dtype} and {pool.dtype}")
    bsz, h, hd = q.shape
    n_pages, page, kv2 = pool.shape
    elems = 16 // q.element_size()
    if hd % elems or pool.data_ptr() % 16:
        raise ValueError(f"the kernel's 16-byte loads need head_dim % {elems} "
                         "== 0 and a 16-byte aligned pool")
    for name, t in (("q", q), ("pool", pool), ("page_tables", page_tables),
                    ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _kernels.load("paged_attention")
    fn = lib.kf_paged_decode_attention_dma
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i64, i64,
                   i32, i32, vp]
    fn.restype = i32
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), pool.data_ptr(), page_tables.data_ptr(),
             positions.data_ptr(), out.data_ptr(), bsz, h, kv2 // (2 * hd), hd,
             page, page_tables.shape[1], n_pages, page_base,
             0 if window is None else int(window), _DTYPE_CODES[q.dtype],
             stream)
    if err:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{err}")
    paged_decode_attention_dma.launches += 1
    return out


paged_decode_attention_dma.launches = 0
