"""Port parity: the port's native host core (csrc/core.cpp) against its
Python forms, routine by routine, mirroring tests/test_native_core.py:
promotion over all pairs, broadcasting, the loop-nest planner and
`plan_view` (and the view gathers built on it), the tape schedule, the
page pool, the request queue and the prefix cache.  Then the port against
the JAX package: `plan_loops`, the prefix-cache hash chain, and the
tokens served with prefix_cache=True, with and without the core.

The core is built by g++ into kfunca_tpu_torch/build/ (runtime/_native.py);
KFUNCA_NO_NATIVE=1 selects the Python forms.
"""

import ctypes
import shutil
import threading

import numpy as np
import pytest
import torch

import jax

import kfunca_tpu_torch as tk
from kfunca_tpu.core import iterator as jiter
from kfunca_tpu.core.dtype import from_numpy_dtype
from kfunca_tpu.models import serve as jserve
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu_torch.core import iterator as titer
from kfunca_tpu_torch.core import materialize as mat
from kfunca_tpu_torch.core.dtype import ScalarType, accumulate_type, promote
from kfunca_tpu_torch.core.tensor import Tensor
from kfunca_tpu_torch.models import serve as tserve
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax
from kfunca_tpu_torch.runtime import _native
from kfunca_tpu_torch.utils.errors import KfError

i64 = _native.i64_array


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port runs its Python forms")
    got = _native.get_lib()
    assert got is not None
    return got


@pytest.fixture
def python_forms(monkeypatch):
    monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
    assert _native.get_lib() is None


# -- the library and its build --------------------------------------------------


def test_core_builds_from_the_ports_source_into_its_build_dir(lib):
    so = _native.library_path()
    assert so.exists() and so.parent == _native.BUILD
    assert _native.SRC.name == "core.cpp" and _native.SRC.parent.name == "csrc"


def test_concurrent_builds_rename_their_own_files(tmp_path, monkeypatch, lib):
    """Two builds at once (as test workers start) each write a temporary
    file of their own and rename it into place; a failing compiler raises
    and leaves nothing behind."""
    src = tmp_path / "core.cpp"
    src.write_text(_native.SRC.read_text() + "\n// a fresh hash\n")
    monkeypatch.setattr(_native, "SRC", src)
    monkeypatch.setattr(_native, "BUILD", tmp_path / "build")
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(_native.build(shutil.which("g++"))))
        for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == [_native.library_path()] * 2 and got[0].exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [got[0].name]
    src.write_text(src.read_text() + "// another\n")
    with pytest.raises(RuntimeError, match="failed to build"):
        _native.build(shutil.which("false"))
    assert [p.name for p in (tmp_path / "build").iterdir()] == [got[0].name]


def test_no_native_selects_the_python_forms(python_forms):
    assert _native.get_lib() is None
    assert tserve.PagePool(4)._lib is None


# -- dtype promotion and broadcasting -------------------------------------------

TYPES = [t for t in ScalarType if t != ScalarType.Undefined]


def test_promote_parity_all_pairs(lib):
    for a in [*TYPES, ScalarType.Undefined]:
        for b in [*TYPES, ScalarType.Undefined]:
            assert lib.kf_promote(a, b) == promote(a, b), (a, b)


def test_accumulate_parity(lib):
    for t in TYPES:
        assert lib.kf_accumulate_type(t) == accumulate_type(t), t


@pytest.mark.parametrize("shapes", [
    [(16, 1), (1, 6)], [(162, 1, 345), (162, 6, 1)], [(5, 7, 11), (5, 1, 11)],
    [(3,), (2, 1, 3)], [(1,), (1,)], [(2, 1, 4), (3, 1), (1, 1, 1, 4)]], ids=str)
def test_broadcast_parity(lib, shapes):
    out_ndim, out_shape = ctypes.c_int64(), i64([0] * 12)
    rc = lib.kf_broadcast_shapes(len(shapes), i64([len(s) for s in shapes]),
                                 i64([d for s in shapes for d in s]),
                                 ctypes.byref(out_ndim), out_shape)
    assert rc == 0
    got = tuple(out_shape[i] for i in range(out_ndim.value))
    assert got == titer.broadcast_shapes(*shapes)


def test_broadcast_mismatch_rejected(lib):
    out_ndim, out_shape = ctypes.c_int64(), i64([0] * 12)
    assert lib.kf_broadcast_shapes(2, i64([2, 2]), i64([3, 4, 2, 4]),
                                   ctypes.byref(out_ndim), out_shape) == -1
    with pytest.raises(KfError, match="broadcast shape mismatch"):
        titer.broadcast_shapes((3, 4), (2, 4))


PLAN_INPUTS = [((2, 3, 1), np.float32, (3, 4), np.int32),
               ((4,), np.int8, (2, 1, 4), np.uint8),
               ((5, 1), np.float16, (1, 6), np.float64),
               ((1, 3), np.int64, (3, 1), np.int16)]


class _JaxOperand:
    """What the JAX package's `plan_loops` reads of an eager Tensor (its
    device, sizes and dtype), for a numpy array.  An eager Tensor would
    leave a freed block in the JAX package's caching allocator, which
    tests/test_runtime.py expects to find as it left it when the two files
    share a process."""

    def __init__(self, a):
        self._impl = type("Impl", (), dict(shape=tuple(a.shape),
                                           dtype=from_numpy_dtype(a.dtype)))

    def device(self):
        return 0

    def impl(self):
        return self._impl

    def sizes(self):
        return list(self._impl.shape)

    def dtype(self):
        return self._impl.dtype


@pytest.mark.parametrize("case", PLAN_INPUTS, ids=str)
def test_plan_loops_native_python_and_jax_agree(lib, monkeypatch, case):
    sa, da, sb, db = case
    a = np.ones(sa, da)
    b = np.ones(sb, db)
    tp = [tk.from_numpy(a, "cpu"), tk.from_numpy(b, "cpu")]
    native = titer.plan_loops(tp)
    monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
    python = titer.plan_loops(tp)
    jplan = jiter.plan_loops([_JaxOperand(a), _JaxOperand(b)])
    assert native.out_shape == python.out_shape == tuple(jplan.out_shape)
    assert native.common_dtype == python.common_dtype == int(jplan.common_dtype)


# -- the loop-nest planner and the view gathers ----------------------------------


def _plan_nest(lib, shape, strides_per_op):
    n, nd = len(strides_per_op), len(shape)
    out_shape, out_strides = i64([0] * nd), i64([0] * (nd * n))
    out_perm, out_gsize = i64([0] * nd), i64([0] * nd)
    rc = lib.kf_plan_loop_nest(n, nd, i64(shape),
                               i64([s for ss in strides_per_op for s in ss]),
                               out_shape, out_strides, out_perm, out_gsize)
    assert rc >= 0
    assert sum(out_gsize[i] for i in range(rc)) == nd
    return ([out_shape[i] for i in range(rc)],
            [[out_strides[t * rc + i] for i in range(rc)] for t in range(n)])


def test_loop_nest_coalesces_reorders_and_drops(lib):
    assert _plan_nest(lib, [4, 5, 6], [[30, 6, 1], [30, 6, 1]]) == ([120], [[1], [1]])
    cshape, _ = _plan_nest(lib, [4, 5, 6], [[30, 6, 1], [6, 0, 1]])
    assert len(cshape) > 1 and np.prod(cshape) == 120
    assert _plan_nest(lib, [6, 4], [[1, 6]]) == ([24], [[1]])
    assert _plan_nest(lib, [1, 5, 1, 7], [[35, 7, 7, 1]]) == ([35], [[1]])


VIEWS = [((4, 5, 6), (30, 6, 1)), ((6, 4), (1, 6)), ((3, 4), (-4, 1)),
         ((2, 3, 4), (12, -4, 1)), ((5, 3), (0, 1)), ((2, 2, 3), (1, 6, 2)),
         ((3, 1, 4), (-1, 5, 3)), ((7,), (-2,)), ((1, 1), (1, 1))]


@pytest.mark.parametrize("shape,strides", VIEWS, ids=str)
def test_plan_view_native_matches_python(lib, shape, strides):
    assert mat.plan_view(shape, strides) == mat._plan_view_py(shape, strides)


@pytest.mark.parametrize("shape,strides", VIEWS, ids=str)
def test_view_gather_over_the_coalesced_nest(lib, monkeypatch, shape, strides):
    """flat_indices over the planned nest names the same addresses as the
    full-rank sum of index * stride, with and without the core."""
    offset = 40
    want = torch.full(shape, offset, dtype=torch.int64)
    for d, (n, s) in enumerate(zip(shape, strides)):
        view = [1] * len(shape)
        view[d] = n
        want = want + torch.arange(n).reshape(view) * s
    assert torch.equal(mat.flat_indices(shape, strides, offset, "cpu"), want)
    monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
    assert torch.equal(mat.flat_indices(shape, strides, offset, "cpu"), want)


def test_negative_stride_views_read_and_write_the_same(lib, monkeypatch):
    base = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
    got = {}
    for native in (True, False):
        if not native:
            monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
        t = tk.from_numpy(base, "cpu")
        v = t.as_strided([3, 4], [-20, 1], 55)  # rows walked backwards
        read = v.contiguous().numpy()
        v += tk.from_numpy(np.ones((3, 4), np.float32), "cpu")
        got[native] = (read, t.numpy())
    np.testing.assert_array_equal(got[True][0], got[False][0])
    np.testing.assert_array_equal(got[True][1], got[False][1])


# -- the tape schedule -------------------------------------------------------------


def _schedule_both(lib, monkeypatch, n_nodes, edges):
    native = Tensor._schedule(n_nodes, edges)
    with monkeypatch.context() as m:
        m.setenv("KFUNCA_NO_NATIVE", "1")
        python = Tensor._schedule(n_nodes, edges)
    return native, python


def test_tape_schedule_reference_dag_and_multi_use(lib, monkeypatch):
    native, python = _schedule_both(lib, monkeypatch, 4, [(0, 1), (1, 2), (1, 3)])
    assert native == python and native[:2] == [0, 1] and set(native[2:]) == {2, 3}
    native, python = _schedule_both(lib, monkeypatch, 4,
                                    [(0, 1), (0, 2), (1, 3), (2, 3)])
    assert native == python and native.index(3) > max(native.index(1),
                                                      native.index(2))


@pytest.mark.parametrize("seed", range(4))
def test_tape_schedule_random_dags(lib, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    n = 12
    edges = [(u, v) for v in range(1, n) for u in rng.choice(v, size=min(v, 2),
                                                            replace=False)]
    native, python = _schedule_both(lib, monkeypatch, n, [tuple(map(int, e)) for e in edges])
    assert native == python and sorted(native) == list(range(n))


def test_eager_backward_through_both_schedulers(lib, monkeypatch):
    x = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    grads = []
    for native in (True, False):
        if not native:
            monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
        a = tk.from_numpy(x, "cpu").set_requires_grad(True)
        y = (a * a + a) * a
        y.backward(tk.from_numpy(np.ones((3, 4), np.float32), "cpu"))
        grads.append(a.grad().numpy())
    np.testing.assert_array_equal(grads[0], grads[1])


# -- the serving runtime: page pool, queue, prefix cache ---------------------------


def _pool_trace(pool):
    out = [pool.alloc(3), pool.alloc(0), pool.alloc(9), pool.available]
    pool.free(out[0][:2])
    out += [pool.alloc(4), pool.available, pool.alloc(2), pool.available]
    return out


def test_page_pool_native_matches_python(lib, monkeypatch):
    native = _pool_trace(tserve.PagePool(8))
    monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
    assert _pool_trace(tserve.PagePool(8)) == native
    assert native[:2] == [[0, 1, 2], []] and native[2] is None


def _queue_trace(q):
    out = [q.pop(), len(q)]
    for i in (5, 3, 9):
        q.push(i)
    out += [len(q), q.pop(), q.pop(), len(q), q.pop(), q.pop(), len(q)]
    return out


def test_queue_native_matches_python(lib, monkeypatch):
    native = _queue_trace(tserve.RequestQueue())
    monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
    assert _queue_trace(tserve.RequestQueue()) == native == [
        None, 0, 3, 5, 3, 1, 9, None, 0]


def test_prefix_cache_put_get_erase_and_lru(lib):
    h = lib.kf_pcache_create()
    try:
        assert lib.kf_pcache_get(h, 1, 2) == -1
        assert lib.kf_pcache_put(h, 1, 2, 7) == 1
        assert lib.kf_pcache_put(h, 1, 2, 99) == 0  # setdefault semantics
        assert lib.kf_pcache_get(h, 1, 2) == 7
        assert lib.kf_pcache_erase(h, 1, 2) == 7 and lib.kf_pcache_erase(h, 1, 2) == -1
        for i in range(4):
            lib.kf_pcache_put(h, i, i, 10 + i)
        assert lib.kf_pcache_touch(h, 0, 0) == 10
        ab, pages = (ctypes.c_uint64 * 8)(), (ctypes.c_int64 * 4)()
        assert lib.kf_pcache_lru(h, ab, pages, 4) == 4
        assert list(pages) == [11, 12, 13, 10]
        lib.kf_pcache_erase(h, 2, 2)
        lib.kf_pcache_put(h, 9, 9, 19)
        n = lib.kf_pcache_lru(h, ab, pages, 4)
        assert [pages[i] for i in range(n)] == [11, 13, 10, 19]
    finally:
        lib.kf_pcache_destroy(h)


def _exercise_index(idx):
    keys = idx.hash_chain(np.arange(24, dtype=np.int32), 8, 0)
    assert len(keys) == 3 and idx.hash_chain(np.arange(7), 8, 0) == []
    for i, k in enumerate(keys):
        assert idx.put(k, 100 + i)
    assert not idx.put(keys[0], 555) and idx.get(keys[0]) == 100
    idx.touch(keys[0])
    out = [[p for _, p in idx.lru_items()]]
    assert idx.erase(keys[1]) == 101 and idx.erase(keys[1]) is None
    assert keys[1] not in idx and keys[0] in idx
    return out + [len(idx)]


def test_prefix_index_native_matches_python(lib, monkeypatch):
    native = _exercise_index(tserve.PrefixIndex())
    monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
    assert _exercise_index(tserve.PrefixIndex()) == native == [[101, 102, 100], 2]


def test_hash_chain_is_the_jax_packages(lib):
    """The port's copy of kf_pcache_hash_chain gives the JAX package's
    128-bit keys (its native core, which the JAX server runs here), and
    commits to every earlier page and to the seed."""
    jidx, tidx = jserve.PrefixIndex(), tserve.PrefixIndex()
    base = np.arange(40, dtype=np.int32) * 7 % 31
    keys = tidx.hash_chain(base, 8, 3)
    if jidx._lib is not None:
        assert jidx.hash_chain(base, 8, 3) == keys
    assert all(isinstance(k, tuple) and len(k) == 2 for k in keys)
    mutated = base.copy()
    mutated[17] = -1  # inside page 2
    got = tidx.hash_chain(mutated, 8, 3)
    assert got[:2] == keys[:2] and all(a != b for a, b in zip(got[2:], keys[2:]))
    assert tidx.hash_chain(base, 8, 4)[0] != keys[0]


SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=512, max_seq_len=256, dtype="float32")


def test_prefix_cache_tokens_with_and_without_the_core_match_jax(lib, monkeypatch):
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, 24)
    prompts = [np.concatenate([shared, rng.integers(0, 256, n)]).tolist()
               for n in (3, 9, 1)] + [shared.tolist()]
    jc, tc = jtf.TransformerConfig(**SMALL), ttf.TransformerConfig(**SMALL)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jp, tc, device="cpu")
    kw = dict(batch_slots=2, page_size=8, n_pages=24, max_pages_per_seq=8,
              prefix_cache=True)

    def serve(srv):
        rids = [srv.submit(p, max_new=6) for p in prompts]
        out = {r: [] for r in rids}
        for rid, tok, _, _ in srv.stream():
            out[rid].append(int(tok))
        return [out[r] for r in rids], srv.throughput_stats()["prefix_hit_pages"]

    want = serve(jserve.InferenceServer(jp, jc, **kw))
    assert serve(tserve.InferenceServer(tp, tc, device="cpu", **kw)) == want
    monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
    assert serve(tserve.InferenceServer(tp, tc, device="cpu", **kw)) == want
    assert want[1] > 0
