"""int8 and int4 quantized GEMMs for weight-quantized serving.

Counterpart of kfunca_tpu/ops/quant.py.  Scheme: symmetric per-channel int8.
  * weights: per-OUTPUT-column scales, quantized offline (quantize_cols);
  * activations: per-ROW dynamic absmax scales computed on the fly
    (quantize_rows, plain torch as it is plain XLA in the JAX package);
  * the exact int32 accumulator dequantizes with a rank-1 scale outer
    product in the kernel's epilogue:
        out[i, j] = (float(acc[i, j]) * a_scale[i]) * b_scale[j].

The quantizers divide by the scale and round half to even, as the JAX
package does (a multiply by the reciprocal lands on the other side of .5
for some inputs and the int8 values would differ).

`matmul_q8` is the K5 wrapper: on CUDA tensors it launches the hand-written
Hopper kernel in csrc/quant.cu, one launch a product whatever its split of
k (counted in `matmul_q8.launches`), or raises; on CPU tensors it runs
`matmul_q8_plain`.  There is no fallback between the two.

Engine.  The JAX package's default engine for the int8 product is XLA's
dot, with its Pallas kernel behind an environment knob.  PyTorch has no
public int8 GEMM of this contract, so the port has one engine and no knob:
`matmul_q8_auto` is `matmul_q8`, K5 on CUDA tensors.  No module of the
package calls a library's int8 product; chip_smoke.py keeps its own
cuBLASLt expression to time beside the kernel.

int4.  torch has no usable int4 dtype.  `quantize_cols_int4` returns the
weights PACKED two nibbles a byte along k, a uint8 (k/2, n) tensor whose
byte i holds row 2i in its low nibble and row 2i+1 in its high nibble
(two's complement, values in [-7, 7]), so the int4 weights take half the
memory of int8, as in the JAX package.  `unpack_int4` widens them to int8
(k, n); the w4 product unpacks inside the matmul.  The JAX package has no
Pallas kernel for the w4 product (it is an XLA batched dot), so the port's
stays plain torch: integer-valued float matmuls that are exact inside each
k-group, summed across groups in fp32.
"""

from __future__ import annotations

import contextlib

import torch

from ..runtime import _kernels
from ..runtime import autotune as _autotune

# |acc| <= k * 127 * 127 must fit an int32
MAX_K_INT32 = (2 ** 31 - 1) // (127 * 127)
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

_plain = False  # set only inside plain_matmul_q8()


@contextlib.contextmanager
def plain_matmul_q8():
    """Route `matmul_q8` through its plain version whatever the device
    (launch counts stay untouched): the yardstick an end-to-end check holds
    the kernel path against.  No entry point of the package enters it.  It
    flips a module-level flag and is not thread-safe: entered while another
    thread serves, it would route that server's CUDA tensors to the plain
    version too.  For chip_smoke.py and the tests only."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def _scale_of(absmax, levels: float):
    return torch.where(absmax == 0, 1.0, absmax / levels)


def _quantize(x, scale, levels: int):
    """Divide, round half to even, clip; row-major whatever x's strides (a
    transposed view, such as a tied embedding's, keeps its strides through
    elementwise ops, and the kernels take row-major operands)."""
    return torch.clamp(torch.round(x / scale), -levels, levels).contiguous()


def quantize_cols(w):
    """(k, n) float -> (int8 (k, n), fp32 scales (n,)): symmetric per-column."""
    wf = w.float()
    scale = _scale_of(wf.abs().amax(dim=0), 127.0)
    return _quantize(wf, scale, 127).to(torch.int8), scale


def quantize_rows(a, row_absmax=None):
    """(m, k) float -> (int8 (m, k), fp32 scales (m,)): symmetric per-row.
    `row_absmax` (m,) replaces the rows' own absmax: a tensor-parallel rank
    holding a slice of each row scales it by the whole row's max."""
    af = a.float()
    amax = af.abs().amax(dim=1) if row_absmax is None else row_absmax.float()
    scale = _scale_of(amax, 127.0)
    return _quantize(af, scale[:, None], 127).to(torch.int8), scale


def quantize_vecs(x):
    """float (..., d) -> (int8 (..., d), fp32 scales (...)): symmetric absmax
    over the trailing axis.  The KV-cache quantizer: one scale per stored
    (token, kv-head) vector (models/serve.py quantize_kv)."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1), 127.0)
    return _quantize(xf, scale[..., None], 127).to(torch.int8), scale


def _check_q8(a_q8, b_q8, a_scale, b_scale, out_dtype):
    if a_q8.ndim != 2 or b_q8.ndim != 2 or a_q8.shape[1] != b_q8.shape[0]:
        raise ValueError(f"expected (m, k) @ (k, n), got {tuple(a_q8.shape)} "
                         f"and {tuple(b_q8.shape)}")
    if a_q8.dtype != torch.int8 or b_q8.dtype != torch.int8:
        raise TypeError(f"operands must be int8, got {a_q8.dtype} and "
                        f"{b_q8.dtype}")
    m, k = a_q8.shape
    n = b_q8.shape[1]
    if a_scale.shape != (m,) or b_scale.shape != (n,):
        raise ValueError(f"scales must be ({m},) and ({n},), got "
                         f"{tuple(a_scale.shape)} and {tuple(b_scale.shape)}")
    if k > MAX_K_INT32:
        raise ValueError(f"k = {k} can overflow the int32 accumulator "
                         f"(limit {MAX_K_INT32})")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    devices = {t.device for t in (a_q8, b_q8, a_scale, b_scale)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def _dequant(acc, a_scale, b_scale, out_dtype):
    """The epilogue, in the kernel's order: (acc * a_scale[i]) * b_scale[j]."""
    return ((acc.float() * a_scale.float()[:, None])
            * b_scale.float()[None, :]).to(out_dtype)


def matmul_q8_plain(a_q8, b_q8, a_scale, b_scale, out_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel (the counterpart of the JAX
    package's matmul_q8_xla): exact integer accumulation, then the rank-1
    dequantization in the kernel's order, then the cast.

    On the CPU the sum is an int64 matmul.  torch has no integer matmul on
    CUDA, so there the sum runs in float64, which holds every partial sum
    exactly (|acc| <= k * 127^2 < 2^53) in any order."""
    _check_q8(a_q8, b_q8, a_scale, b_scale, out_dtype)
    if a_q8.device.type == "cpu":
        acc = a_q8.long() @ b_q8.long()
    else:
        acc = a_q8.double() @ b_q8.double()
    return _dequant(acc, a_scale, b_scale, out_dtype)


_SMS = 132  # streaming multiprocessors of an H100
Q8_TILE = (8, 128)  # rows x columns of an output tile of the K5 kernel
Q8_STAGE_ROWS = 64  # k rows of one stage of its ring
Q8_WAVE = 2 * _SMS  # the blocks a split plan aims at: two an SM
Q8_MIN_STAGES = 4  # the fewest stages a k slice is cut to


def q8_plan(m: int, k: int, n: int, wave: int = Q8_WAVE,
            min_stages: int = Q8_MIN_STAGES) -> tuple[int, int]:
    """(split, k_per_split): how the K5 kernel cuts k among the blocks of
    one output tile.

    The grid is (n / 128 column tiles, m / 8 row tiles, split).  A skinny
    decode product has too few tiles for the card, so k is cut into slices
    of whole 64-row stages until there are about `wave` blocks (default
    two an SM) or a slice would drop under `min_stages` stages (default
    4); the slices are then evened out (on the card, two blocks an SM with
    their 8 stages of b in flight read the decode shapes as fast as four,
    and fewer slices leave less to add).  `wave` and `min_stages` are the
    launch parameters runtime/autotune.py sweeps ("gemm_q8").  Shape and
    those two only, so the plan (and the bits) never depend on timing.
    The last block to finish a tile adds the slices' int32 tiles in slice
    order; integer sums are exact in any order, so the result does not
    depend on the plan."""
    if int(wave) < 1 or int(min_stages) < 1:
        raise ValueError(f"q8_plan takes wave >= 1 and min_stages >= 1, "
                         f"got {wave} and {min_stages}")
    tiles = -(-n // Q8_TILE[1]) * -(-m // Q8_TILE[0])
    stages = max(1, -(-k // Q8_STAGE_ROWS))  # k = 0: one slice, no stage
    want = max(1, min(int(wave) // tiles, stages // int(min_stages)))
    per = -(-stages // want)
    return -(-stages // per), per * Q8_STAGE_ROWS


_tickets: dict = {}


def _q8_tickets(device, stream: int, count: int):
    """The K5 kernel's tile tickets for (device, stream): int32 zeros,
    allocated once and grown when a product has more tiles; every launch
    leaves them at zero, and launches on one stream are ordered, so no
    call zeroes them again."""
    t = _tickets.get((device, stream))
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = t
    return t


def matmul_q8(a_q8, b_q8, a_scale, b_scale, out_dtype=torch.bfloat16,
              wave=Q8_WAVE, min_stages=Q8_MIN_STAGES):
    """int8 (m, k) @ int8 (k, n) with exact int32 accumulation and fused
    per-row x per-column dequantization:
    out[i, j] = (acc[i, j] * a_scale[i]) * b_scale[j], in fp32 or bf16.
    `wave`, `min_stages`: the split plan's parameters (q8_plan); the
    result does not depend on them.

    CPU tensors run the plain version; CUDA tensors launch the kernel, one
    launch a call (counted in `matmul_q8.launches`), or raise.  Any m, k,
    n: the kernel masks ragged edges itself."""
    _check_q8(a_q8, b_q8, a_scale, b_scale, out_dtype)
    m, k = a_q8.shape
    n = b_q8.shape[1]
    split, per = q8_plan(m, k, n, wave, min_stages)
    if a_q8.device.type == "cpu" or _plain:
        return matmul_q8_plain(a_q8, b_q8, a_scale, b_scale, out_dtype)
    if a_q8.device.type != "cuda":
        raise ValueError(f"unsupported device {a_q8.device}")
    for name, t in (("a_q8", a_q8), ("b_q8", b_q8)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sa = a_scale.float().contiguous()
    sb = b_scale.float().contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a_q8.device)
    if m == 0 or n == 0:
        return out
    tiles = -(-n // Q8_TILE[1]) * -(-m // Q8_TILE[0])
    stream = torch.cuda.current_stream(a_q8.device).cuda_stream
    scratch = tickets = None
    if split > 1:
        scratch = torch.empty(split * tiles * Q8_TILE[0] * Q8_TILE[1],
                              dtype=torch.int32, device=a_q8.device)
        tickets = _q8_tickets(a_q8.device, stream, tiles)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("quant", "kf_matmul_q8",
                           (vp,) * 7 + (i32,) * 7 + (vp,))
    err = fn(a_q8.data_ptr(), b_q8.data_ptr(), sa.data_ptr(), sb.data_ptr(),
             out.data_ptr(), None if scratch is None else scratch.data_ptr(),
             None if tickets is None else tickets.data_ptr(),
             0 if tickets is None else tickets.numel(), m, k, n, split, per,
             _OUT_CODES[out_dtype], stream)
    if err:
        raise RuntimeError(f"int8 matmul kernel launch failed: CUDA error "
                           f"{err}")
    matmul_q8.launches += 1
    return out


matmul_q8.launches = 0


def matmul_q8_auto(a_q8, b_q8, a_scale, b_scale, out_dtype=torch.bfloat16,
                   **kw):
    """The dispatched int8 GEMM of the JAX package's interface.  The port
    has one engine, so this is `matmul_q8` (see the module docstring), with
    the split plan autotune recorded for this shape class ("gemm_q8",
    keyed "int8", as the JAX package's), explicit kwargs winning."""
    dims = (a_q8.shape[0], a_q8.shape[1], b_q8.shape[1])
    plan = _autotune.tuned("gemm_q8", dims, "int8")
    return matmul_q8(a_q8, b_q8, a_scale, b_scale, out_dtype=out_dtype,
                     **{**plan, **kw})


def gemm_w8(a, w_q8, w_scale, out_dtype=None, row_absmax=None):
    """Weight-quantized GEMM: float activations (m, k) @ int8 weights (k, n).

    Activations are dynamically quantized per row (absmax), the product
    runs in int8 with exact int32 sums, and dequantization is fused into
    the epilogue.  The error against the float matmul is bounded by the
    two int8 roundings (~1% relative for well-scaled inputs).  `row_absmax`
    as quantize_rows takes it."""
    out_dtype = out_dtype or a.dtype
    a_q8, a_scale = quantize_rows(a, row_absmax)
    return matmul_q8_auto(a_q8, w_q8, a_scale, w_scale, out_dtype=out_dtype)


def gemm_w8_integer(a, w_q8, row_absmax=None):
    """gemm_w8 up to its epilogue: (float(acc) (m, n) fp32, the activation
    row scales (m,)), acc the exact int32 sum of a's int8 rows (quantized
    by `row_absmax` when given) against w_q8.  K5 with unit scales, so
    float(acc) is exact below 2^24.  Tensor-parallel ranks holding slices
    of k add these integer sums and dequantize once,
    (acc * a_scale[i]) * w_scale[j] as the kernel's epilogue does, which
    gives one device's product bit for bit."""
    a_q8, a_scale = quantize_rows(a, row_absmax)
    m, n = a_q8.shape[0], w_q8.shape[1]
    ones = torch.ones(max(m, n), dtype=torch.float32, device=a_q8.device)
    return matmul_q8_auto(a_q8, w_q8, ones[:m], ones[:n],
                          out_dtype=torch.float32), a_scale


# -----------------------------------------------------------------------------
# int4 weights (w4a8): group-wise quantization, packed two nibbles a byte
# -----------------------------------------------------------------------------


def pack_int4(q):
    """int8 (k, n) values in [-8, 7] -> uint8 (k/2, n): row 2i in the low
    nibble of byte i, row 2i+1 in the high nibble (two's complement)."""
    if q.shape[0] % 2:
        raise ValueError(f"packing two int4 rows a byte needs an even k, "
                         f"got {q.shape[0]}")
    u = q.to(torch.uint8) & 0xF
    return u[0::2] | (u[1::2] << 4)


def unpack_int4(packed):
    """uint8 (k/2, n) packed nibbles -> int8 (k, n) values in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    both = torch.stack([lo, hi], dim=1).reshape(-1, packed.shape[1])
    return (both ^ 8) - 8  # sign-extend the nibble


def quantize_cols_int4(w, group: int = 128):
    """(k, n) float -> (packed int4 uint8 (k/2, n), fp32 scales (k/group, n)).

    Symmetric GROUP-WISE quantization along k (the GPTQ/AWQ convention):
    one scale per (group of `group` k-rows, column), values in [-7, 7]."""
    k, n = w.shape
    if k % group:
        raise ValueError(f"k={k} not divisible by group={group}")
    wf = w.float().reshape(k // group, group, n)
    scale = _scale_of(wf.abs().amax(dim=1), 7.0)  # (k/group, n)
    q = _quantize(wf, scale[:, None, :], 7)
    return pack_int4(q.reshape(k, n).to(torch.int8)), scale


def matmul_w4(a_q8, w_q4, a_scale, w_scale, out_dtype=torch.bfloat16):
    """int8 activations (m, k) @ packed int4 weights (k/2, n) with group
    scales (the JAX package's matmul_w4_xla).

    The sum is exact INSIDE each k-group (an integer-valued float matmul:
    every partial sum is an integer below 2^24 in fp32, or 2^53 in fp64
    for groups past 18,000 rows), then each group's partial is scaled and
    the groups are summed in fp32."""
    m, k = a_q8.shape
    g, n = w_scale.shape
    if w_q4.dtype != torch.uint8 or w_q4.shape != (k // 2, n) or k % g:
        raise ValueError(
            f"expected packed uint8 weights ({k // 2}, {n}) and scales "
            f"(k/group, {n}); got {w_q4.dtype} {tuple(w_q4.shape)} and "
            f"{tuple(w_scale.shape)}")
    group = k // g
    exact = torch.float32 if group * 127 * 8 < 2 ** 24 else torch.float64
    ag = a_q8.reshape(m, g, group).transpose(0, 1).to(exact)  # (g, m, group)
    wg = unpack_int4(w_q4).reshape(g, group, n).to(exact)
    acc = torch.bmm(ag, wg)  # (g, m, n), exact per-group integers
    out = torch.einsum("gmn,gn->mn", acc.float(), w_scale.float())
    return (out * a_scale.float()[:, None]).to(out_dtype)


def gemm_w4(a, w_q4, w_scale, out_dtype=None, row_absmax=None):
    """Weight-only int4 GEMM: float activations (m, k) @ packed int4 weights.
    w4a8: activations quantize per row to int8 (`row_absmax` as
    quantize_rows takes it); the weights unpack inside the product (no
    float weight matrix is kept)."""
    out_dtype = out_dtype or a.dtype
    a_q8, a_scale = quantize_rows(a, row_absmax)
    return matmul_w4(a_q8, w_q4, a_scale, w_scale, out_dtype=out_dtype)


def dequant_weight(w_q, scale, dtype=torch.float32):
    """Quantized weight pair -> dense float weight: (int8 (k, n), (n,)
    column scales) or (packed int4 (k/2, n), (k/group, n) group scales),
    the storage formats of quantize_cols and quantize_cols_int4."""
    if scale.ndim == 1:  # int8 per-column
        return w_q.to(dtype) * scale.to(dtype)
    w = unpack_int4(w_q)
    k, n = w.shape
    g = scale.shape[0]
    wf = w.to(dtype).reshape(g, k // g, n) * scale.to(dtype)[:, None, :]
    return wf.reshape(k, n)
