"""Port parity: the bitonic sort K10 and the KFUNCA_PALLAS_SORT engine.

* The port's `bitonic_sort_pairs` (on the CPU, its plain version) against
  the JAX package's Pallas kernel in interpret mode, as
  tests/test_pallas_kernels.py runs it, on NaN-free fp32 / int32 rows with
  duplicates at n in {1, 100, 128, 129, 300}: keys and indices bitwise.
* `sort` / `topk` under KFUNCA_PALLAS_SORT=1 (on the CPU, K10's plain
  version behind the engine's key transforms) against the JAX package's
  `sort` / `topk` on shared numpy inputs, for every dtype the engine
  takes, both directions, a non-last dim and k in {257, n}; and against
  the JAX package's own K10 engine (`_pallas_sort_jit` with its kernel in
  interpret mode) on a few of them.  Bitwise: values and indices.  The
  JAX side runs the jitted functions its eager `sort` / `topk` dispatch to
  off the TPU (`_sort_jit`, `_topk_jit`) on jnp arrays, not its eager
  Tensors: those would leave freed blocks in the JAX package's caching
  allocator, which tests/test_runtime.py expects to find as it left them
  when the two files share a process.
* NaN rows: the port's K10 orders NaN after every number, ties by index,
  which is the default engine's order (the TPU network leaves NaN rows in
  no defined order; ROADMAP.md section 3).
* A pure-torch emulation of the CUDA network (csrc/bitonic_sort.cu: the
  ordered 32-bit key and the index per word, pads after every real cell,
  several rows a block, 8 words a thread in registers, each pass in
  registers, by a warp shuffle or through shared memory by its pair
  distance, the padded shared-memory layout free of bank conflicts) at
  tiny shapes and at P = 128, 1024 and 8192 against the plain version,
  bitwise.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kfunca_tpu_torch as tk
from kfunca_tpu.core.dtype import from_numpy_dtype
from kfunca_tpu.ops import sort as jsort
from kfunca_tpu.ops.pallas_kernels import bitonic_sort as jbs
from kfunca_tpu_torch.ops.pallas_kernels import bitonic_sort as tbs

DEV = "cpu"
NS = (1, 100, 128, 129, 300)


def _rows(n, dtype, rows=5, seed=0):
    rng = np.random.default_rng(seed + n)
    if np.issubdtype(dtype, np.integer):
        x = rng.integers(-1000, 1000, (rows, n)).astype(dtype)
    else:
        x = rng.uniform(-1000, 1000, (rows, n)).astype(dtype)
    x[:, ::7] = x[:, 0:1]  # duplicates exercise stability
    return x


@pytest.fixture(scope="module")
def jax_pairs():
    """The JAX kernel's (keys, indices) in interpret mode, per (n, dtype)."""
    out = {}
    for n in NS:
        for dtype in (np.float32, np.int32):
            x = _rows(n, dtype)
            ks, idx = jbs.bitonic_sort_pairs(jnp.asarray(x), interpret=True)
            out[n, dtype] = (x, np.asarray(ks), np.asarray(idx))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=lambda d: d.__name__)
@pytest.mark.parametrize("n", NS)
def test_plain_k10_matches_the_pallas_kernel(jax_pairs, n, dtype):
    x, want_k, want_i = jax_pairs[n, dtype]
    ks, idx = tbs.bitonic_sort_pairs(torch.from_numpy(x))
    assert ks.dtype == torch.from_numpy(x).dtype and idx.dtype == torch.int32
    np.testing.assert_array_equal(ks.numpy().view(np.int32), want_k.view(np.int32))
    np.testing.assert_array_equal(idx.numpy(), want_i)


# -- the engine --------------------------------------------------------------

DTYPES = [np.float32, np.float16, "bfloat16", np.int32, np.int16, np.int8, np.uint8]


@pytest.fixture
def k10(monkeypatch):
    """KFUNCA_PALLAS_SORT=1 for both packages (the JAX package stays on
    lax.sort off the TPU); counts the port's K10 calls."""
    monkeypatch.setenv("KFUNCA_PALLAS_SORT", "1")
    calls = []
    real = tbs.bitonic_sort_pairs

    def counted(keys):
        calls.append(tuple(keys.shape))
        return real(keys)

    monkeypatch.setattr(tbs, "bitonic_sort_pairs", counted)
    return calls


def _both(x, dtype):
    """The same values as a jnp array (the JAX side) and a port tensor."""
    if dtype == "bfloat16":
        j = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
        return j, tk.from_numpy(np.asarray(j), DEV)
    x = np.ascontiguousarray(x.astype(dtype))
    return jnp.asarray(x), tk.from_numpy(x, DEV)


def _jsort(j, dim, desc):
    """The JAX package's `sort` off the TPU (its dispatch takes `_sort_jit`
    there, the knob or not)."""
    return jsort._sort_jit(j, dim, desc)


def _jtopk(j, k, dim, largest):
    """The JAX package's `topk` off the TPU (`_topk_jit`)."""
    return jsort._topk_jit(j, k, dim, largest)


def _bits(a):
    """The bytes of a numpy array (bf16, which either package may hand out
    as float32, widened exactly to float32 first)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a.view(np.uint8)


def _same(j, t):
    """A jnp result and a port tensor: same dtype, shape and bits."""
    if not isinstance(j, jnp.ndarray):  # two port tensors
        assert j.dtype() == t.dtype() and j.sizes() == t.sizes()
        j = j.contiguous().numpy()
    else:
        assert from_numpy_dtype(j.dtype) == t.dtype()
        assert list(j.shape) == list(t.sizes())
    np.testing.assert_array_equal(_bits(j), _bits(t.contiguous().numpy()))


def _engine_input(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype in (np.int8, np.uint8, np.int16, np.int32):
        info = np.iinfo(dtype)
        x = rng.integers(max(info.min, -3000), min(info.max, 3000), shape)
        x.flat[0], x.flat[1] = info.min, info.max
        return x
    x = rng.uniform(-8, 8, shape)  # many ties once rounded to 16 bits
    x.flat[0], x.flat[1] = np.inf, -np.inf
    return x


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_sort_engine_matches_the_jax_package(k10, dtype):
    x = _engine_input(dtype, (4, 300), 1)
    j, t = _both(x, dtype)
    for desc in (False, True):
        (jv, ji), (tv, ti) = _jsort(j, 1, desc), t.sort(1, desc)
        _same(jv, tv)
        _same(ji, ti)
    # along a non-last dim: dim 0 of a (300, 3) view-shaped tensor
    j0, t0 = _both(np.ascontiguousarray(x.T), dtype)
    for desc in (False, True):
        (jv, ji), (tv, ti) = _jsort(j0, 0, desc), t0.sort(0, desc)
        _same(jv, tv)
        _same(ji, ti)
    assert k10 == [(4, 300)] * 2 + [(4, 300)] * 2


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_topk_engine_matches_the_jax_package(k10, dtype):
    x = _engine_input(dtype, (3, 300), 2)
    x.flat[:2] = x.flat[2:4]  # no +-inf: top_k and sort agree on the rest
    j, t = _both(x, dtype)
    for k in (257, 300):
        for largest in (True, False):
            (jv, ji), (tv, ti) = (_jtopk(j, k, 1, largest),
                                  t.topk(k, 1, largest))
            _same(jv, tv)
            _same(ji, ti)
    (jv, ji), (tv, ti) = _jtopk(j, 256, 1, True), t.topk(256, 1, True)
    _same(jv, tv)
    _same(ji, ti)
    assert len(k10) == 4  # k <= 256 keeps the present topk


@pytest.mark.parametrize("dtype,dim,desc", [
    (np.float32, 1, True), ("bfloat16", 1, False), (np.int8, 0, True),
    (np.uint8, 0, False), (np.int32, 1, True)], ids=str)
def test_sort_engine_matches_the_jax_k10_engine(monkeypatch, k10, dtype, dim,
                                                desc):
    """The JAX package's own K10 dispatch (`_pallas_sort_jit`: key
    transforms around bitonic_sort_pairs, here in interpret mode)."""
    monkeypatch.setattr(jbs, "bitonic_sort_pairs", functools.partial(
        jbs.bitonic_sort_pairs, interpret=True))
    x = _engine_input(dtype, (3, 130) if dim == 1 else (130, 3), 3)
    j, t = _both(x, dtype)
    jv, ji = jsort._pallas_sort_jit(j, dim, desc)
    tv, ti = t.sort(dim, desc)
    np.testing.assert_array_equal(_bits(jv), _bits(tv.numpy()))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert len(k10) == 1


def test_engine_dispatch_is_the_jax_packages(k10, monkeypatch):
    """K10 runs where `_pallas_eligible` holds: not for 64-bit or Bool keys,
    not for rows that pad past 1024, nor without the knob."""
    for shape, dtype, want in (((2, 1024), np.float32, 1), ((2, 1025), np.float32, 0),
                               ((2, 10), np.float64, 0), ((2, 10), np.int64, 0),
                               ((2, 1), np.float32, 1)):
        k10.clear()
        x = np.random.default_rng(4).integers(0, 50, shape).astype(dtype)
        v, i = tk.from_numpy(x, DEV).sort(-1, False)
        assert len(k10) == want, (shape, dtype)
        np.testing.assert_array_equal(i.numpy(), np.argsort(x, -1, kind="stable"))
    monkeypatch.delenv("KFUNCA_PALLAS_SORT")
    k10.clear()
    tk.from_numpy(np.ones((2, 8), np.float32), DEV).sort(1, False)
    assert k10 == []
    empty = tk.from_numpy(np.ones((0, 8), np.float32), DEV)
    monkeypatch.setenv("KFUNCA_PALLAS_SORT", "1")
    v, i = empty.sort(1, True)
    assert list(v.sizes()) == [0, 8] and list(i.sizes()) == [0, 8]


SORT_ROW = [3.0, np.nan, -0.0, 0.0, 1.0, 3.0, -np.nan, np.inf, -np.inf, 3.0, 0.0]


@pytest.mark.parametrize("dtype", [np.float32, np.float16, "bfloat16"], ids=str)
def test_nan_rows_take_the_default_engines_order(monkeypatch, dtype):
    """Under the knob a row with NaN comes back in the default engine's
    order (NaN last both ways, -0.0 tied with 0.0), which is also the JAX
    package's lax.sort order."""
    x = np.array([SORT_ROW, SORT_ROW[::-1]], np.float32)
    j, t = _both(x, dtype)
    want = {desc: t.sort(1, desc) for desc in (False, True)}
    monkeypatch.setenv("KFUNCA_PALLAS_SORT", "1")
    for desc in (False, True):
        tv, ti = t.sort(1, desc)
        _same(want[desc][0], tv)
        _same(want[desc][1], ti)
        _same(_jsort(j, 1, desc)[1], ti)


# -- the CUDA network, emulated ------------------------------------------------


def _ordered(keys):
    """csrc/bitonic_sort.cu `ordered`: the key's unsigned 32-bit image, as
    int64 in [0, 2^32)."""
    bits = keys.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if not keys.is_floating_point():
        return bits ^ 0x80000000
    bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
    u = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return torch.where(torch.isnan(keys), torch.full_like(u, 0xFFFFFFFF), u)


def _banks_apart(index):
    """Whether each 16 consecutive threads' 8-byte shared-memory words lie
    on distinct bank pairs (a warp's 64-bit access is served 16 lanes at a
    time)."""
    groups = (index % 16).reshape(-1, 16)
    return all(len(set(g.tolist())) == 16 for g in groups)


def _keep(mine, other, keep_min):
    """csrc/bitonic_sort.cu `keep`: the min of the two if keep_min, else the
    max."""
    return torch.where((other < mine) == keep_min, other, mine)


def emulate_k10(keys):
    """csrc/bitonic_sort.cu on the CPU: its blocks, the kE words each thread
    holds in registers, the padded shared-memory layout of the load and
    store phases, and each pass by where its pair lives (registers, a
    shuffle within the warp, or shared memory), with the lane-distance and
    direction rules.  A word (ordered key << 32 | index) is kept as the
    int64 (ordered key - 2^31) << 32 | index, whose signed order is the
    kernel's unsigned one."""
    rows, n = keys.shape
    e_ = tbs.WORDS_PER_THREAD
    p = tbs.padded_length(n)
    log2p = p.bit_length() - 1
    threads = max(128, p // e_)
    rpb = threads * e_ // p
    stride = threads + 16 // e_
    tid = torch.arange(threads)
    row_threads = p // e_
    t_row = tid & (row_threads - 1)
    base = t_row * e_
    e = torch.arange(threads * e_).reshape(e_, threads)  # e = k * threads + tid
    slot = (e % e_) * stride + e // e_  # where linear position e lives
    regs = torch.arange(e_)[:, None] * stride + tid  # word j of thread tid
    assert _banks_apart(slot) and _banks_apart(regs)
    out_k, out_i = torch.empty_like(keys), torch.empty((rows, n), dtype=torch.int32)
    for row0 in range(0, rows, rpb):
        pos = e & (p - 1)
        row = row0 + (e >> log2p)
        real = (pos < n) & (row < rows)
        key = torch.full(e.shape, 0xFFFFFFFF, dtype=torch.int64)
        src = keys[row.clamp(max=rows - 1), pos.clamp(max=n - 1)]
        key[real] = _ordered(src)[real]
        smem = torch.zeros(e_ * stride, dtype=torch.int64)
        smem[slot] = ((key - 2 ** 31) << 32) | pos
        w = smem[regs].T.clone()  # (threads, kE)
        size = 2
        while size <= p:
            d = size // 2
            ascending = (base & size) == 0
            while d >= 32 * e_:  # through shared memory
                m = d // e_
                assert ((tid ^ m) // row_threads == tid // row_threads).all()
                keep_min = (((t_row & m) == 0) == ascending)[:, None]
                smem[regs] = w.T
                w = _keep(w, smem[regs[:, tid ^ m]].T, keep_min)
                d //= 2
            while d >= e_:  # a shuffle at lane distance d / kE
                m = d // e_
                partner = tid ^ m
                assert (partner // 32 == tid // 32).all(), "a shuffle leaves its warp"
                assert (partner // row_threads == tid // row_threads).all()
                keep_min = (((t_row & m) == 0) == ascending)[:, None]
                w = _keep(w, w[partner], keep_min)
                d //= 2
            for dd in (e_ // 2 ** i for i in range(1, e_.bit_length())):  # registers
                if size < 2 * dd:
                    continue
                for j in range(e_):
                    if j & dd:
                        continue
                    asc = ((base + j) & size) == 0
                    a, b = w[:, j].clone(), w[:, j + dd].clone()
                    swap = (a > b) == asc
                    w[:, j], w[:, j + dd] = torch.where(swap, b, a), torch.where(swap, a, b)
            size *= 2
        smem[regs] = w.T
        idx = (smem[slot] & 0xFFFFFFFF).reshape(-1)  # linear position order
        for r in range(rpb):
            if row0 + r < rows:
                got = idx[r * p:r * p + n]
                assert bool((got < n).all()), "a pad sorted before a real cell"
                out_i[row0 + r] = got.to(torch.int32)
                out_k[row0 + r] = keys[row0 + r, got]
    return out_k, out_i


def _nan_rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4, 4, (rows, n)).astype(np.float32)
    x[:, ::5] = np.nan
    x[:, 1::6] = -np.nan
    x[:, 2::9] = -0.0
    x[:, 3::9] = 0.0
    x[:, 4::11] = np.inf
    x[:, 6::13] = -np.inf
    x[:, 7::7] = x[:, 0:1]
    return x


def _int_rows(rows, n, seed):
    x = np.random.default_rng(seed).integers(-20, 20, (rows, n)).astype(np.int32)
    x[:, ::4] = np.iinfo(np.int32).max  # the pads' key: pads must still sort last
    x[:, 1::9] = np.iinfo(np.int32).min
    return x


@pytest.mark.parametrize("case", [
    ("one", lambda: _nan_rows(3, 1, 0)),
    ("pads_and_nan", lambda: _nan_rows(5, 129, 1)),
    ("multi_row_blocks", lambda: _nan_rows(11, 100, 2)),  # 8 rows a block
    ("int_max_pads", lambda: _int_rows(9, 200, 3)),       # 4 rows a block
    ("one_row_a_block", lambda: _nan_rows(2, 1500, 4)),   # P = 2048
    ("p1024_one_row_a_group", lambda: _nan_rows(3, 1000, 5)),  # 128 threads
    ("p128_two_rows_a_warp", lambda: _int_rows(19, 128, 6)),   # 16 lanes a row
    ("p512_smem_pass", lambda: _nan_rows(5, 300, 7)),  # two rows a block
    ("p8192", lambda: _nan_rows(2, 8192, 8)),          # 15 of 91 in shared memory
], ids=lambda c: c[0])
def test_network_emulation_matches_plain(case):
    keys = torch.from_numpy(case[1]())
    got_k, got_i = emulate_k10(keys)
    want_k, want_i = tbs.bitonic_sort_pairs_plain(keys)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_k.view(torch.int32), want_k.view(torch.int32))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="float32 or int32"):
        tbs.bitonic_sort_pairs(torch.zeros((2, 4), dtype=torch.float16))
    with pytest.raises(ValueError, match="exceed"):
        tbs.bitonic_sort_pairs(torch.zeros((1, tbs.MAX_N + 1)))
    with pytest.raises(ValueError, match="rows, n"):
        tbs.bitonic_sort_pairs(torch.zeros(4))
    assert tbs.padded_length(1) == 128 and tbs.padded_length(1025) == 2048
