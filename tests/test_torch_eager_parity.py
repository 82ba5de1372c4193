"""Port parity: the eager Tensor API of kfunca_tpu_torch against kfunca_tpu.

The same numpy inputs, made from a seed, go through both packages (the
port on device="cpu", the JAX package on its CPU backend), and the same op
sequence builds the same strided views in both.  Where one strided view
must feed both, the JAX tensor's storage and view metadata are carried
across with `kfunca_tpu_torch.from_storage_numpy`.  Both engine settings
of the port run: the defaults, and every knob at `pallas`, which on CPU
tensors takes the plain versions of K3, K7, K8 and K9 (the JAX package on
the CPU stays on XLA whatever its knobs say).

Tolerances: integers, indices, views, dtypes, sort orders and IEEE-exact
ops (add, sub, mul, div, neg, abs, copy, casts) are compared exactly;
transcendentals to 2e-6 relative (libm against XLA's); sums, means, GEMMs
and attention, which add in another order, to 1e-5 relative in fp32 and
fp64 and one 16-bit step (2^-7 of the largest magnitude) in bf16/fp16.
"""

import numpy as np
import pytest

import kfunca_tpu as jk
import kfunca_tpu_torch as tk
from kfunca_tpu_torch.utils.errors import KfError

DEV = "cpu"
KNOBS = ("KFUNCA_GEMM_ENGINE", "KFUNCA_REDUCE_ENGINE", "KFUNCA_ELEMENTWISE_ENGINE")


@pytest.fixture(params=["default", "pallas"])
def engine(request, monkeypatch):
    for k in KNOBS:
        if request.param == "pallas":
            monkeypatch.setenv(k, "pallas")
        else:
            monkeypatch.delenv(k, raising=False)
    return request.param


def both(arr):
    arr = np.ascontiguousarray(arr)
    return jk.from_numpy(arr, 0), tk.from_numpy(arr, DEV)


def values(t):
    """A tensor of either package as a float64 (or int64) numpy array."""
    a = t.contiguous().numpy()
    return a.astype(np.float32).astype(np.float64) if a.dtype.name == "bfloat16" \
        else a.astype(np.int64 if a.dtype.kind in "biu" else np.float64)


def same(j, t, tol=0.0):
    """Same dtype, shape and values (within `tol` x max |value|)."""
    assert j.dtype() == t.dtype(), (j.dtype(), t.dtype())
    assert j.sizes() == t.sizes()
    a, b = values(j), values(t)
    if tol == 0.0:
        np.testing.assert_array_equal(a, b)
    else:
        scale = max(1.0, float(np.nanmax(np.abs(a))) if a.size else 1.0)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale)


RNG = np.random.default_rng(0)


def rand(shape, dtype=np.float32, lo=-4.0, hi=4.0):
    if np.issubdtype(np.dtype(dtype), np.integer):
        return RNG.integers(int(lo) * 10, int(hi) * 10, shape).astype(dtype)
    return RNG.uniform(lo, hi, shape).astype(dtype)


# -- views and carried state ---------------------------------------------------

VIEW_OPS = [
    ("permute", lambda t: t.permute(2, 0, 1)),
    ("slice_step", lambda t: t.slice(1, 1, 6, 2)),
    ("select", lambda t: t.select(2, 3)),
    ("narrow_permute", lambda t: t.narrow(0, 1, 2).permute(1, 2, 0)),
    ("getitem", lambda t: t[1, 1:5, ::2]),
    ("view", lambda t: t.view(4, -1)),
    ("split", lambda t: t.split([2, 4], 1)[1]),
    ("as_strided_neg", lambda t: t.as_strided((3, 4), (-8, 2), 40)),
]


@pytest.mark.parametrize("name,fn", VIEW_OPS, ids=[v[0] for v in VIEW_OPS])
def test_views_match(name, fn):
    x = rand((4, 6, 5))
    j, t = both(x)
    jv, tv = fn(j), fn(t)
    assert jv.sizes() == tv.sizes() and jv.strides() == tv.strides()
    assert jv.storage_offset() == tv.storage_offset()
    assert jv.is_contiguous() == tv.is_contiguous()
    same(jv.contiguous(), tv.contiguous())


@pytest.mark.parametrize("name,fn", VIEW_OPS[:5], ids=[v[0] for v in VIEW_OPS[:5]])
def test_carried_view_feeds_both(name, fn, engine):
    """A JAX-package view carried across by its storage and metadata gives
    the port the same view: same values, and the same results of ops."""
    x = rand((4, 6, 5))
    jv = fn(jk.from_numpy(x, 0))
    impl = jv.impl()
    tv = tk.from_storage_numpy(np.asarray(impl.storage.read()), impl.shape,
                               impl.strides, impl.offset, DEV)
    assert tv.sizes() == jv.sizes() and tv.strides() == jv.strides()
    same(jv.contiguous(), tv.contiguous())
    other = rand(tuple(jv.sizes()))
    jo, to = both(other)
    same(jv + jo, tv + to)
    same(jv * 2.5 - jo, tv * 2.5 - to)
    same(jv.sum(0), tv.sum(0), 1e-5)


def test_data_ptr_and_refcounts():
    arr = rand((3, 4))
    x = tk.from_numpy(arr, DEV)
    y = tk.from_numpy(arr, DEV)
    ptr = x.data_ptr()
    assert ptr != y.data_ptr()
    assert x[1].data_ptr() == ptr + 4 * 4
    x += y
    x *= 2
    assert x.data_ptr() == ptr
    assert x.storage_ref_count() == 1 and x.impl_ref_count() == 1


# -- elementwise families ------------------------------------------------------

DTYPES = [np.float32, np.float64, np.int32, np.int64, np.float16, "bfloat16"]


def _make(shape, dtype):
    if dtype == "bfloat16":
        j, t = both(rand(shape))
        return j.bfloat16(), t.bfloat16()
    if np.issubdtype(np.dtype(dtype), np.integer):
        return both(rand(shape, dtype))
    return both(rand(shape, dtype, lo=0.5, hi=4.0))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("op", ["+", "-", "*", "/"])
def test_binary_ops(op, dtype, engine):
    ja, ta = _make((5, 7), dtype)
    jb, tb = _make((5, 7), dtype)
    if np.issubdtype(np.dtype(dtype) if dtype != "bfloat16" else np.float32,
                     np.integer) and op == "/":
        jb, tb = both(np.where(values(jb) == 0, 3, values(jb)).astype(dtype))
    j, t = eval(f"ja {op} jb"), eval(f"ta {op} tb")
    same(j, t)
    # broadcast (no kernel: the JAX package's pallas path wants equal shapes)
    jc, tc = _make((1, 7), dtype)
    same(eval(f"ja {op} jc"), eval(f"ta {op} tc"))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, "bfloat16"], ids=str)
@pytest.mark.parametrize("op", ["+", "-", "*", "/"])
def test_scalar_ops_and_inplace(op, dtype, engine):
    ja, ta = _make((6, 3), dtype)
    s = 3
    same(eval(f"ja {op} s"), eval(f"ta {op} s"))
    jb, tb = _make((6, 3), dtype)
    if op == "/":
        jb, tb = both(np.full((6, 3), 2, np.int32)) if dtype == np.int32 else (jb, tb)
    jptr = ta.data_ptr()
    exec(f"ja {op}= jb")
    exec(f"ta {op}= tb")
    same(ja, ta)
    assert ta.data_ptr() == jptr


@pytest.mark.parametrize("name", ["neg", "abs", "exp", "log", "sqrt", "rsqrt",
                                  "relu", "sigmoid", "tanh"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=str)
def test_unary_ops(name, dtype, engine):
    x = rand((4, 9), lo=0.1, hi=3.0) if name in ("log", "sqrt", "rsqrt") else rand((4, 9))
    j, t = both(x)
    if dtype == "bfloat16":
        j, t = j.bfloat16(), t.bfloat16()
    exact = name in ("neg", "abs", "relu")
    same(getattr(j, name)(), getattr(t, name)(),
         0.0 if exact else (2.0 ** -7 if dtype == "bfloat16" else 2e-6))


PROMOTIONS = [
    (np.float16, "bfloat16"), (np.uint8, np.int8), (np.int32, np.float32),
    (np.int64, np.int32), (np.uint8, np.uint8), (np.int8, np.int16),
    (np.float32, np.float64), (np.bool_, np.int32), (np.float16, np.float32),
]


@pytest.mark.parametrize("da,db", PROMOTIONS, ids=lambda d: str(d))
def test_promotion_pairs(da, db, engine):
    def make(dt):
        if dt == "bfloat16":
            j, t = both(rand((3, 4)))
            return j.bfloat16(), t.bfloat16()
        if dt == np.bool_:
            return both(rand((3, 4)) > 0)
        if np.issubdtype(np.dtype(dt), np.integer):
            return both(RNG.integers(1, 9, (3, 4)).astype(dt))
        return both(rand((3, 4), dt))

    ja, ta = make(da)
    jb, tb = make(db)
    j, t = ja + jb, ta + tb
    assert t.dtype() == j.dtype()
    same(j, t)
    same(ja * jb, ta * tb)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8, np.int8])
def test_integer_division_by_zero(dtype, engine):
    info = np.iinfo(dtype)
    a = np.array([7, -7, 5, info.min, 3, -3, 0, info.max, 9, -9], np.int64)
    b = np.array([2, 2, 0, -1, -1, 0, 0, -1, 4, -4], np.int64)
    if info.min == 0:
        a, b = np.abs(a) % 256, np.abs(b)
    ja, ta = both(a.astype(dtype))
    jb, tb = both(b.astype(dtype))
    same(ja / jb, ta / tb)
    same(ja / 0, ta / 0)


@pytest.mark.parametrize("to", ["half", "bfloat16", "float", "double", "char", "byte"])
def test_convert_and_copy(to, engine):
    x = np.array([[1.5, -2.5, 300.7, -1e10], [0.1, 65504.0, 7e4, -0.0]], np.float32)
    j, t = both(x)
    if to in ("char", "byte"):
        code = {"char": "Char", "byte": "Byte"}[to]
        same(j._convert(getattr(jk.ScalarType, code)), t._convert(getattr(tk.ScalarType, code)))
        return
    same(getattr(j, to)(), getattr(t, to)())
    # copy_ with broadcast and a dtype cast into a strided target
    jd = jk.zeros((3, 2, 4), jk.double, 0)
    td = tk.zeros((3, 2, 4), tk.double, DEV)
    jd.permute(1, 0, 2).copy_(j.select(0, 1).view(1, 4).contiguous())
    td.permute(1, 0, 2).copy_(t.select(0, 1).view(1, 4).contiguous())
    same(jd, td)


def test_fill_through_views():
    x = rand((5, 6))
    j, t = both(x)
    j.slice(1, 1, 5, 2).fill_(7.5)
    t.slice(1, 1, 5, 2).fill_(7.5)
    same(j, t)
    ji, ti = both(np.arange(12, dtype=np.int32).reshape(3, 4))
    ji[1].fill_(2.9)
    ti[1].fill_(2.9)
    same(ji, ti)


# -- out= through views, and refused self-overlap ------------------------------


def test_out_through_views(engine):
    base = rand((6, 6))
    jb, tb = both(base)
    other = rand((6, 6))
    jo, to = both(other)
    jv, tv = jb.permute(1, 0), tb.permute(1, 0)
    jv += jo
    tv += to
    same(jb, tb)  # the write landed in the shared storage
    js, ts = jb.slice(0, 0, 6, 2), tb.slice(0, 0, 6, 2)
    js *= jo.slice(0, 1, 6, 2)
    ts *= to.slice(0, 1, 6, 2)
    same(jb, tb)
    # a view that reads the storage it writes: the write reads the old values
    jv2, tv2 = jb.permute(1, 0), tb.permute(1, 0)
    jv2 += jb
    tv2 += tb
    same(jb, tb)


def test_self_overlapping_write_is_refused(engine):
    jx, tx = both(rand((4,)))
    jview = jx.as_strided((3, 4), (0, 1), 0)
    tview = tx.as_strided((3, 4), (0, 1), 0)
    with pytest.raises(RuntimeError, match="self-overlapping"):
        jview += jk.from_numpy(np.ones((3, 4), np.float32), 0)
    with pytest.raises(KfError, match="self-overlapping"):
        tview += tk.from_numpy(np.ones((3, 4), np.float32), DEV)
    with pytest.raises(KfError, match="self-overlapping"):
        tview.fill_(1.0)


def test_index_put_through_a_view():
    x = rand((7, 8))
    jb, tb = both(x)
    idx = np.array([0, 3, -1, 2], np.int64)
    jv, tv = jb.permute(1, 0), tb.permute(1, 0)
    vals = rand((4, 7))
    jv.index_put_([jk.from_numpy(idx, 0)], jk.from_numpy(vals, 0))
    tv.index_put_([tk.from_numpy(idx, DEV)], tk.from_numpy(vals, DEV))
    same(jb, tb)
    i0 = np.array([0, 5, 1, 2], np.int64)
    i1 = np.array([0, 6, 1, -2], np.int64)
    v = rand((4,))
    jb.index_put_([jk.from_numpy(i0, 0), jk.from_numpy(i1, 0)], jk.from_numpy(v, 0))
    tb.index_put_([tk.from_numpy(i0, DEV), tk.from_numpy(i1, DEV)], tk.from_numpy(v, DEV))
    same(jb, tb)


# -- reductions, shape ops, sort ------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, "bfloat16"], ids=str)
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_sum_mean(dtype, dim, engine):
    shape = (70, 40, 30) if dim == 0 else (9, 11, 13)  # dim 0: K8's size
    ja, ta = _make(shape, dtype)
    tol = 0.0 if dtype == np.int32 else (2.0 ** -7 if dtype == "bfloat16" else 1e-5)
    same(ja.sum(dim), ta.sum(dim), tol)
    same(ja.mean(dim), ta.mean(dim), tol)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("take_sqrt", [False, True])
def test_mean_var(dim, take_sqrt):
    ja, ta = both(rand((13, 25, 7)))
    jm, jv = ja.mean_var(dim, take_sqrt)
    tm, tv = ta.mean_var(dim, take_sqrt)
    same(jm, tm, 1e-5)
    same(jv, tv, 1e-5)


@pytest.mark.parametrize("shape,dim", [((300, 70), 0), ((64, 128), 0),
                                       ((7, 30, 5), 1), ((40, 9), 1)])
def test_norm_stat(shape, dim, engine):
    """2-D fp32 over dim 0 is K7's plain version in the port (its default
    engine); the rest is the plain formula, as in the JAX package."""
    ja, ta = both(rand(shape, lo=-3, hi=5))
    jm, js = ja.norm_stat(dim)
    tm, ts = ta.norm_stat(dim)
    same(jm, tm, 1e-5)
    same(js, ts, 1e-5)


def test_cat_and_split():
    xs = [rand((3, n, 4)) for n in (2, 5, 1)]
    js = [jk.from_numpy(x, 0) for x in xs]
    ts = [tk.from_numpy(x, DEV) for x in xs]
    same(jk.cat(js, 1), tk.cat(ts, 1))
    same(jk.cat([js[0], js[1].half()], 1), tk.cat([ts[0], ts[1].half()], 1))
    for jp, tp in zip(jk.cat(js, 1).split([3, 4, 1], 1), tk.cat(ts, 1).split([3, 4, 1], 1)):
        same(jp.contiguous(), tp.contiguous())


# lax.sort / lax.top_k orders: NaN last both ways in sort, -0.0 == 0.0; top_k
# by the float total order (+NaN first, -NaN last), ties in index order
SORT_ROW = [3.0, np.nan, -0.0, 0.0, 1.0, 3.0, -np.nan, np.inf, -np.inf, 3.0, 0.0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16, "bfloat16"], ids=str)
def test_sort_topk_nan_and_ties(dtype):
    x = np.array([SORT_ROW, SORT_ROW[::-1]], np.float32)
    if dtype == "bfloat16":
        # the same bits in both: torch's CPU cast of float32 NaN to bf16
        # sets the sign bit, XLA's keeps it clear (ROADMAP.md section 3),
        # and top_k orders +NaN first and -NaN last
        j = jk.from_numpy(x, 0).bfloat16()
        t = tk.from_numpy(j.numpy(), DEV)
    else:
        j, t = both(x.astype(dtype))
    for desc in (False, True):
        (jv, ji), (tv, ti) = j.sort(1, desc), t.sort(1, desc)
        same(ji, ti)
        np.testing.assert_array_equal(values(jv), values(tv))
    for largest in (True, False):
        (jv, ji), (tv, ti) = j.topk(5, 1, largest), t.topk(5, 1, largest)
        same(ji, ti)
        np.testing.assert_array_equal(values(jv), values(tv))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_sort_topk_with_ties(dtype, dim):
    x = RNG.integers(-4, 5, (6, 7, 9)).astype(dtype)  # many ties
    x[0, 0, 0] = np.iinfo(np.int32).min if dtype == np.int32 else x[0, 0, 0]
    j, t = both(x)
    for desc in (False, True):
        (jv, ji), (tv, ti) = j.sort(dim, desc), t.sort(dim, desc)
        same(jv, tv)
        same(ji, ti)
    for largest in (True, False):
        (jv, ji), (tv, ti) = j.topk(3, dim, largest), t.topk(3, dim, largest)
        same(jv, tv)
        same(ji, ti)


def test_topk_past_top_k_limit():
    x = RNG.integers(-50, 50, (2, 2100)).astype(np.float32)
    j, t = both(x)
    (jv, ji), (tv, ti) = j.topk(2049, 1, True), t.topk(2049, 1, True)
    same(jv, tv)
    same(ji, ti)


# -- gemm, attention and the tape ---------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float16, "bfloat16", np.float64], ids=str)
@pytest.mark.parametrize("alpha", [1.0, 2.5])
def test_gemm(dtype, alpha, engine):
    a, b = rand((3, 5, 24), lo=-1, hi=1), rand((24, 16), lo=-1, hi=1)
    ja, ta = both(a)
    jb, tb = both(b)
    if dtype == "bfloat16":
        ja, ta, jb, tb = ja.bfloat16(), ta.bfloat16(), jb.bfloat16(), tb.bfloat16()
    elif dtype != np.float32:
        code = {np.float16: "Half", np.float64: "Double"}[dtype]
        ja, jb = ja._convert(getattr(jk.ScalarType, code)), jb._convert(getattr(jk.ScalarType, code))
        ta, tb = ta._convert(getattr(tk.ScalarType, code)), tb._convert(getattr(tk.ScalarType, code))
    tol = 2.0 ** -7 if dtype in (np.float16, "bfloat16") else 1e-5
    same(jk.gemm(ja, jb, alpha, 0.0), tk.gemm(ta, tb, alpha, 0.0), tol)


def test_causal_attention_forward_backward():
    q, k, v, g = (rand((2, 3, 17, 16), lo=-1, hi=1) for _ in range(4))
    jq, tq = both(q)
    jkk, tkk = both(k)
    jv, tv = both(v)
    for x in (jq, tq, jkk, tkk, jv, tv):
        x.set_requires_grad(True)
    jo = jk.causal_attention(jq, jkk, jv)
    to = tk.causal_attention(tq, tkk, tv)
    same(jo, to, 1e-5)
    # an in-place op on the result before backward changes no gradient:
    # the JAX package recomputes the forward, the port keeps its own copy
    jo += 1.0
    to += 1.0
    jo.backward(jk.from_numpy(g, 0))
    to.backward(tk.from_numpy(g, DEV))
    for a, b in ((jq, tq), (jkk, tkk), (jv, tv)):
        same(a.grad(), b.grad(), 1e-5)


def test_causal_attention_backward_after_an_edit_of_its_inputs():
    """q, k and v changed in place between forward and backward: both
    packages recompute the forward from the inputs as they are at backward
    time, so the gradients agree with each other and with a fresh forward
    over the edited inputs."""
    q, k, v, g = (rand((1, 2, 19, 16), lo=-1, hi=1) for _ in range(4))
    grads = {}
    for pkg, dev in ((jk, 0), (tk, DEV)):
        ts = [pkg.from_numpy(x, dev).set_requires_grad(True) for x in (q, k, v)]
        out = pkg.causal_attention(*ts)
        ts[0] *= 0.5
        ts[2] += 1.0
        out.backward(pkg.from_numpy(g, dev))
        grads[pkg] = [t.grad() for t in ts]
    fresh = [tk.from_numpy(x, DEV).set_requires_grad(True)
             for x in (q * np.float32(0.5), k, v + np.float32(1.0))]
    tk.causal_attention(*fresh).backward(tk.from_numpy(g, DEV))
    for jg, tg, fg in zip(grads[jk], grads[tk], fresh):
        same(jg, tg, 1e-5)
        same(fg.grad(), tg, 1e-6)


def test_tape_with_shared_inputs(engine):
    """a feeds four nodes, b two, the gemm output two: the tape's schedule
    and accumulation give the JAX package's gradients."""
    a, b, w, g = (rand((6, 8), lo=-1, hi=1), rand((6, 8), lo=-1, hi=1),
                  rand((8, 5), lo=-1, hi=1), rand((1, 5), lo=-1, hi=1))
    grads = []
    for pkg, dev in ((jk, 0), (tk, DEV)):
        ta, tb, tw = (pkg.from_numpy(x, dev).set_requires_grad(True) for x in (a, b, w))
        c = ta * tb + ta            # a twice
        d = c / (tb + 3.0) - ta     # a, b again
        h = pkg.gemm(d * ta, tw)    # a a fourth time
        r = (h.relu() + h * 0.5).tanh().mean(0)  # h twice
        r.backward(pkg.from_numpy(g, dev))
        grads.append([ta.grad(), tb.grad(), tw.grad()])
    for jg, tg in zip(*grads):
        same(jg, tg, 1e-5)


def test_leaf_used_twice_accumulates():
    x = rand((3, 4))
    out = []
    for pkg, dev in ((jk, 0), (tk, DEV)):
        t = pkg.from_numpy(x, dev).set_requires_grad(True)
        y = t + t
        z = y * t
        z.backward(pkg.from_numpy(np.ones((3, 4), np.float32), dev))
        out.append(t.grad())
    same(out[0], out[1], 1e-6)


def test_profiling_mode_records_each_op():
    """Launcher.set_profiling_mode: every eager op is timed and recorded
    under its name, in both packages (the port uses CUDA events on the
    card and the host clock here)."""
    from kfunca_tpu.utils.profiling import PROFILER as JP
    from kfunca_tpu_torch.utils.profiling import PROFILER as TP

    names = []
    for pkg, prof, dev in ((jk, JP, 0), (tk, TP, DEV)):
        t = pkg.from_numpy(rand((4, 5)), dev)
        prof.records.clear()
        pkg.launcher.set_profiling_mode(True)
        try:
            ((t + t) * 2.0).sum(0)
        finally:
            pkg.launcher.set_profiling_mode(False)
        assert all(r.seconds >= 0 for r in prof.records)
        names.append([r.name for r in prof.records])
    assert names[0] == names[1] == ["add", "mul_scalar", "sum"]
