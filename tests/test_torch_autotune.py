"""Port parity: runtime/autotune.py (a port of tests/test_autotune.py).

The cache: shape buckets, the record / lookup round trip through the file,
the measured cache over the shipped defaults, keys per card, tuned()'s
memo.  The sweep: `kfunca.autotune` over all seven of the JAX package's ops
(on the CPU, through the plain versions, which take no launch parameter:
the machinery, not a device time), each recorded under the JAX package's
own key; the winners read by `gemm` under KFUNCA_GEMM_ENGINE=pallas,
`matmul_q8_auto`, `causal_attention_fn`, `reduce_2d`, `welford_norm_stat`
and InferenceServer(page_size=None); every candidate a plan or tile the
kernels take (K5's whole 64-row stages, K7's and K8's split bounds, K1's
and K2's built tiles); and, in the place of the JAX package's
interpret-mode kernel tests, K1's blockwise online softmax emulated at
each streamed-row count against the plain version.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import kfunca_tpu_torch as kfunca
from kfunca_tpu.runtime import autotune as jautotune
from kfunca_tpu_torch.models import serve, transformer
from kfunca_tpu_torch.ops import attention as tattn
from kfunca_tpu_torch.ops import gemm as tgemm
from kfunca_tpu_torch.ops import quant as tquant
from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as tfa
from kfunca_tpu_torch.ops.pallas_kernels import welford as twf
from kfunca_tpu_torch.runtime import autotune


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """An empty cache file of the test's own, reloaded on first use."""
    path = tmp_path / "at.json"
    monkeypatch.setenv("KFUNCA_AUTOTUNE_CACHE", str(path))
    monkeypatch.setattr(autotune, "_CACHE", None)
    monkeypatch.setattr(autotune, "_DEFAULTS", None)
    return path


def test_shape_bucket_is_the_jax_packages():
    for dims in ((4096, 4000, 4096), (2048, 2049), (1,), (0, 3), (8, 1024)):
        assert autotune.shape_bucket(*dims) == jautotune.shape_bucket(*dims)
    assert autotune.shape_bucket(4096, 4000, 4096) == "4096x4096x4096"


def test_record_lookup_roundtrip(fresh):
    assert autotune.lookup("gemm", "64x64x64", torch.bfloat16) is None
    autotune.record("gemm", "64x64x64", torch.bfloat16, {"bm": 64, "bn": 64})
    got = autotune.lookup("gemm", "64x64x64", "bfloat16")
    assert got == {"bm": 64, "bn": 64}
    autotune._CACHE = None  # a fresh in-memory cache reloads the file
    assert autotune.lookup("gemm", "64x64x64", torch.bfloat16) == got
    on_disk = json.loads(fresh.read_text())
    assert list(on_disk) == [f"{autotune.chip_name()}|gemm|64x64x64|bfloat16"]


def test_measured_overlays_shipped_defaults(fresh):
    key = f"{autotune.chip_name()}|decode_page|8x1024|bfloat16"
    autotune._load()
    autotune._DEFAULTS = {key: {"page_size": 32}}
    assert autotune.lookup("decode_page", "8x1024", torch.bfloat16) == {
        "page_size": 32}
    autotune.record("decode_page", "8x1024", torch.bfloat16, {"page_size": 8})
    assert autotune.lookup("decode_page", "8x1024", torch.bfloat16) == {
        "page_size": 8}


def test_shipped_defaults_are_the_cards_own(fresh):
    """Every shipped entry is keyed by a CUDA card's name: none of the JAX
    package's v5e entries carried over."""
    autotune._load()
    assert all("TPU" not in k and "v5" not in k for k in autotune._DEFAULTS)
    jax_defaults = Path(jautotune.__file__).with_name("autotune_defaults.json")
    assert not set(autotune._DEFAULTS) & set(json.loads(jax_defaults.read_text()))


def test_shipped_gemm_tiles_are_built_tiles(fresh):
    """Every shipped K3 entry names a tile the wgmma body is built for, in
    a 16-bit dtype the sweep takes."""
    from kfunca_tpu_torch.ops.pallas_kernels import matmul

    autotune._load()
    gemm = {k: v for k, v in autotune._DEFAULTS.items() if "|gemm|" in k}
    assert gemm
    for key, tile in gemm.items():
        assert key.rsplit("|", 1)[1] in ("bfloat16", "float16"), key
        assert (tile["bm"], tile["bn"]) in matmul.TILES, (key, tile)


def test_default_cache_path_is_not_the_jax_packages(monkeypatch):
    monkeypatch.delenv("KFUNCA_AUTOTUNE_CACHE", raising=False)
    path = autotune.cache_path()
    assert path.endswith("kfunca_tpu_torch_autotune.json")
    assert path != jautotune.cache_path()


def test_chip_keying_isolates_entries(fresh, monkeypatch):
    autotune.record("gemm", "128x128x128", torch.float16, {"bm": 64, "bn": 64})
    monkeypatch.setattr(autotune, "chip_name", lambda: "some-other-card")
    assert autotune.lookup("gemm", "128x128x128", torch.float16) is None


def test_autotune_gemm_records_the_winner_and_gemm_reads_it(fresh, monkeypatch):
    cands = [{"bm": 128, "bn": 128}, {"bm": 128, "bn": 256}]
    res = kfunca.autotune("gemm", 64, 48, 80, dtype=torch.bfloat16,
                          candidates=cands, reps=1, iters=1, device="cpu",
                          verbose=False)
    assert res["params"] in cands and len(res["all"]) == 2 and res["ms"] > 0
    assert autotune.lookup("gemm", autotune.shape_bucket(64, 48, 80),
                           torch.bfloat16) == res["params"]
    # the pallas engine hands the recorded tile to K3
    autotune.record("gemm", autotune.shape_bucket(64, 48, 80), torch.bfloat16,
                    {"bm": 128, "bn": 64})
    seen = []

    def k3(a, b, out_dtype=None, **tile):
        seen.append(tile)
        return (a.float() @ b.float()).to(out_dtype)

    monkeypatch.setattr(tgemm, "k3_matmul", k3)
    monkeypatch.setenv("KFUNCA_GEMM_ENGINE", "pallas")
    a = np.ones((64, 48), np.float32)
    b = np.ones((48, 80), np.float32)
    out = kfunca.gemm(kfunca.from_numpy(a, "cpu").bfloat16(),
                      kfunca.from_numpy(b, "cpu").bfloat16())
    assert seen == [{"bm": 128, "bn": 64}]
    assert list(out.sizes()) == [64, 80]
    kfunca.gemm(kfunca.from_numpy(a[:5], "cpu"), kfunca.from_numpy(b, "cpu"))
    assert seen[-1] == {}  # no entry for this shape class and dtype


def test_k3_wrapper_takes_only_the_built_tiles():
    from kfunca_tpu_torch.ops.pallas_kernels import matmul

    a = torch.ones((4, 8), dtype=torch.bfloat16)
    b = torch.ones((8, 4), dtype=torch.bfloat16)
    for bm, bn in matmul.TILES:
        assert torch.equal(matmul.matmul(a, b, bm=bm, bn=bn),
                           matmul.matmul_plain(a, b))
    assert autotune.SWEEPS["gemm"] == [{"bm": bm, "bn": bn}
                                       for bm, bn in matmul.TILES]
    with pytest.raises(ValueError, match="tiles"):
        matmul.matmul(a, b, bm=32, bn=32)
    with pytest.raises(ValueError, match="tiles"):
        matmul.matmul(a, b, bm=64, bn=64)  # a tile of the earlier body
    with pytest.raises(ValueError, match="fixed"):
        matmul.matmul(a.float(), b.float(), bm=64, bn=64)
    with pytest.raises(ValueError, match="bfloat16 and float16"):
        kfunca.autotune("gemm", 8, 8, 8, dtype=torch.float32, device="cpu")


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown op"):
        kfunca.autotune("nope", 8)


def test_autotune_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kfunca.autotune("gemm", 8, 8, 8)


SMALL = dict(vocab_size=64, d_model=128, n_heads=1, n_layers=1, d_ff=128,
             max_seq_len=64, dtype="float32")


def test_decode_page_feeds_the_server_default(fresh):
    cands = [{"page_size": 8}, {"page_size": 16}]
    res = kfunca.autotune("decode_page", 2, 128, 64, candidates=cands, reps=1,
                          iters=1, device="cpu", verbose=False)
    assert res["params"] in cands
    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device="cpu")
    kw = dict(batch_slots=2, n_pages=32, max_pages_per_seq=8, device="cpu")
    srv = serve.InferenceServer(params, cfg, page_size=None, **kw)
    assert srv.page_size == res["params"]["page_size"]
    autotune.record("decode_page", autotune.shape_bucket(2, 128),
                    torch.bfloat16, {"page_size": 32})
    assert serve.InferenceServer(params, cfg, page_size=None,
                                 **kw).page_size == 32
    # without an entry the default stays 16
    autotune._CACHE, autotune._DEFAULTS = {}, {}
    assert serve.InferenceServer(params, cfg, page_size=None,
                                 **kw).page_size == 16
    rid = srv.submit([1, 2, 3], max_new=2)
    assert [r for r, *_ in srv.stream()] == [rid, rid]


# -- the seven ops of the JAX package ----------------------------------------

# op -> (tiny shape, the JAX package's dtype in its key, the port's dims of
# the shape class)
SWEEP_CASES = {
    "gemm": ((16, 24, 32), "bfloat16", (16, 24, 32)),
    "gemm_q8": ((8, 256, 128), "int8", (8, 256, 128)),
    "attn_fwd": ((1, 2, 40, 16), "bfloat16", (40, 40, 16)),
    "attn_bwd": ((1, 2, 40, 16), "bfloat16", (40, 40, 16)),
    "reduce": ((37, 19), "float32", (37, 19)),
    "welford": ((37, 19), "float32", (37, 19)),
    "decode_page": ((2, 128, 32), "bfloat16", (2, 128)),
}


def test_sweeps_cover_the_jax_packages_ops():
    assert sorted(autotune.SWEEPS) == sorted(jautotune._SWEEP_DEFAULTS)
    assert set(SWEEP_CASES) == set(autotune.SWEEPS)
    assert not hasattr(autotune, "FIXED_TILE")


@pytest.mark.parametrize("op", sorted(SWEEP_CASES))
def test_every_op_sweeps_and_records_under_the_jax_key(fresh, op):
    shape, jdtype, dims = SWEEP_CASES[op]
    cands = autotune.SWEEPS[op][:2]
    res = kfunca.autotune(op, *shape, candidates=cands, reps=1, iters=1,
                          device="cpu", verbose=False)
    assert res["params"] in cands and res["ms"] > 0 and res["tflops"] > 0
    assert [c["params"] for c in res["all"]] == cands
    on_disk = json.loads(fresh.read_text())
    key = jautotune._key(op, jautotune.shape_bucket(*dims), jdtype)
    assert list(on_disk) == [key] and on_disk[key] == res["params"]
    assert autotune.tuned(op, dims, jdtype if op != "welford" and op !=
                          "reduce" else torch.float32) == res["params"]


Q8_SHAPES = [(8, 4096, 6144), (8, 14336, 4096), (8, 4096, 32000),
             (1, 64, 128), (3, 100, 5), (8, 0, 128), (256, 4096, 4096)]


@pytest.mark.parametrize("plan", autotune.SWEEPS["gemm_q8"],
                         ids=lambda p: f"w{p['wave']}s{p['min_stages']}")
def test_q8_plan_cuts_k_into_whole_stages(plan):
    for m, k, n in Q8_SHAPES:
        split, per = tquant.q8_plan(m, k, n, **plan)
        stages = max(1, -(-k // tquant.Q8_STAGE_ROWS))
        assert per % tquant.Q8_STAGE_ROWS == 0 and per > 0
        assert split * per >= max(k, 1)  # the slices cover k
        assert (split - 1) * per < max(k, 1)  # and none is empty
        assert split <= stages
        tiles = -(-n // 128) * -(-m // 8)
        if split > 1:  # cut only while the wave wants more blocks
            assert tiles * split <= max(plan["wave"], tiles * 2)
    assert tquant.q8_plan(8, 4096, 6144) == tquant.q8_plan(
        8, 4096, 6144, **autotune.SWEEPS["gemm_q8"][0])
    with pytest.raises(ValueError, match="wave"):
        tquant.q8_plan(8, 64, 8, wave=0)


@pytest.mark.parametrize("cand", autotune.SWEEPS["reduce"],
                         ids=lambda c: str(c["target_blocks"]))
def test_split_count_stays_within_its_bounds(cand):
    for rows, cols, block in ((16387, 16387, 256), (4096, 4096, 512),
                              (17, 5, 256), (1, 1, 256), (65, 3, 512),
                              (100000, 64, 256)):
        s = twf.split_count(rows, cols, block, cand["target_blocks"])
        assert 1 <= s <= -(-rows // twf.CHUNK)
    assert twf.split_count(4096, 4096) == twf.split_count(
        4096, 4096, target=autotune.SWEEPS["reduce"][0]["target_blocks"])
    with pytest.raises(ValueError, match="target"):
        twf.split_count(8, 8, target=0)


def test_q8_candidates_give_the_same_bits(fresh):
    gen = torch.Generator().manual_seed(3)
    a = torch.randint(-127, 128, (8, 200), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (200, 40), generator=gen, dtype=torch.int8)
    sa, sb = torch.rand(8, generator=gen), torch.rand(40, generator=gen)
    want = tquant.matmul_q8(a, b, sa, sb)
    for plan in autotune.SWEEPS["gemm_q8"]:
        assert torch.equal(tquant.matmul_q8(a, b, sa, sb, **plan), want)


def _spy(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def spy(*args, **kw):
        seen.append({k: v for k, v in kw.items()
                     if k in ("kv_rows", "q_rows", "stages", "wave",
                              "min_stages")})
        return real(*args, **kw)

    spy.__dict__ = real.__dict__  # the wrapper counts its launches on itself

    monkeypatch.setattr(module, name, spy)
    return seen


def test_causal_attention_fn_launches_the_recorded_tiles(fresh, monkeypatch):
    fwd_seen = _spy(monkeypatch, tattn, "flash_attention_fwd_stats")
    bwd_seen = _spy(monkeypatch, tattn, "flash_attention_backward")
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2, 40, 16)),
                            dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    tattn.causal_attention_fn(q, k, v).float().sum().backward()
    assert fwd_seen == [{}] and bwd_seen == [{}]  # an empty cache: today's
    fwd, bwd = tfa.FWD_TILES[2], tfa.BWD_TILES[1]
    autotune.record("attn_fwd", autotune.shape_bucket(40, 40, 16),
                    torch.bfloat16, fwd)
    autotune.record("attn_bwd", autotune.shape_bucket(40, 40, 16),
                    torch.bfloat16, bwd)
    out = tattn.causal_attention_fn(q, k, v)
    out.float().sum().backward()
    assert fwd_seen[-1] == fwd and bwd_seen[-1] == bwd
    # the eager Tensor API consults the same entries
    tq, tk, tv = (kfunca.from_torch(t.detach(), "cpu") for t in (q, k, v))
    tq.set_requires_grad(True)
    ev = kfunca.causal_attention(tq, tk, tv)
    assert fwd_seen[-1] == fwd
    ev.backward(kfunca.from_torch(torch.ones((1, 2, 40, 16)), "cpu"))
    assert fwd_seen[-1] == fwd and bwd_seen[-1] == bwd
    # the windowed form consults nothing, as the JAX package's
    tattn.make_flash_attention(8)(q, k, v).float().sum().backward()
    assert fwd_seen[-1] == {} and bwd_seen[-1] == {}
    # fp32 has one tile: nothing is consulted
    tattn.causal_attention_fn(*(t.detach().float() for t in (q, k, v)))
    assert fwd_seen[-1] == {}


def test_matmul_q8_auto_launches_the_recorded_plan(fresh, monkeypatch):
    seen = _spy(monkeypatch, tquant, "matmul_q8")
    a = torch.randn(8, 256)
    w_q8, w_scale = tquant.quantize_cols(torch.randn(256, 128))
    want = tquant.gemm_w8(a, w_q8, w_scale)
    assert seen == [{}]
    plan = autotune.SWEEPS["gemm_q8"][3]
    autotune.record("gemm_q8", autotune.shape_bucket(8, 256, 128), "int8",
                    plan)
    assert torch.equal(tquant.gemm_w8(a, w_q8, w_scale), want)
    assert seen[-1] == plan
    a_q8, a_scale = tquant.quantize_rows(a)
    tquant.matmul_q8_auto(a_q8, w_q8, a_scale, w_scale, wave=7)
    assert seen[-1] == {**plan, "wave": 7}  # explicit kwargs win


def test_reduce_and_welford_read_the_recorded_target(fresh, monkeypatch):
    from kfunca_tpu_torch.ops.pallas_kernels import reduce as trd

    seen, real = [], twf.split_target

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(twf, "split_target", spy)
    monkeypatch.setattr(trd, "split_target", spy)
    x = torch.tensor(np.random.default_rng(5).standard_normal((37, 19)),
                     dtype=torch.float32)
    want_sum, want_stat = trd.reduce_2d(x, "sum"), twf.welford_norm_stat(x)
    assert seen == [twf.TARGET_BLOCKS] * 2  # an empty cache: today's
    t8 = autotune.SWEEPS["reduce"][1]["target_blocks"]
    t7 = autotune.SWEEPS["welford"][3]["target_blocks"]
    bucket = autotune.shape_bucket(37, 19)
    autotune.record("reduce", bucket, torch.float32, {"target_blocks": t8})
    autotune.record("welford", bucket, torch.float32, {"target_blocks": t7})
    assert torch.equal(trd.reduce_2d(x, "sum"), want_sum)
    assert seen[-1] == t8
    got = twf.welford_norm_stat(x)
    assert seen[-1] == t7
    assert all(torch.equal(a, b) for a, b in zip(got, want_stat))
    trd.reduce_2d(x, "max", target_blocks=5)
    assert seen[-1] == 5  # an explicit target wins
    with pytest.raises(ValueError, match="target"):
        twf.welford_norm_stat(x, target_blocks=0)


def test_tuned_memo_clears_on_record(fresh, monkeypatch):
    calls = []
    real = autotune.lookup

    def counting(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(autotune, "lookup", counting)
    dims = (8, 4096, 4096)
    assert autotune.tuned("gemm_q8", dims, "int8") == {}
    assert autotune.tuned("gemm_q8", dims, "int8") == {}
    assert len(calls) == 1  # the second call is the memo's
    plan = {"wave": 132, "min_stages": 4}
    autotune.record("gemm_q8", autotune.shape_bucket(*dims), "int8", plan)
    assert autotune._MEMO == {}
    assert autotune.tuned("gemm_q8", dims, "int8") == plan
    assert len(calls) == 2
    autotune._CACHE = None  # a reloaded cache empties the memo too
    autotune.tuned("gemm_q8", dims, "int8")
    assert len(calls) == 3


def test_untuned_attention_tiles_raise():
    q = torch.zeros((1, 1, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile"):
        tfa.flash_attention_fwd_stats(q, q, q, kv_rows=16)
    with pytest.raises(ValueError, match="tile"):
        tfa.flash_attention_fwd_stats(q, q, q, kv_rows=128, stages=3)
    out, lse = tfa.flash_attention_fwd_stats(q, q, q)
    with pytest.raises(ValueError, match="tile"):
        tfa.flash_attention_backward(q, q, q, q, out, lse, q_rows=128)
    for tile in tfa.FWD_TILES:  # every built tile is taken
        tfa.flash_attention_fwd_stats(q, q, q, **tile)
    q128 = torch.zeros((1, 1, 8, 128), dtype=torch.bfloat16)
    assert tfa.fwd_tiles(128) == tfa.FWD_TILES[:2]
    with pytest.raises(ValueError, match="head dim"):  # built for hd <= 64
        tfa.flash_attention_fwd_stats(q128, q128, q128, **tfa.FWD_TILES[2])
    for tile in tfa.BWD_TILES:
        tfa.flash_attention_backward(q, q, q, q, out, lse, **tile)
    q32 = q.float()
    with pytest.raises(ValueError, match="fixed"):
        tfa.flash_attention_fwd_stats(q32, q32, q32, stages=2)
    tfa.flash_attention_fwd_stats(q32, q32, q32, **tfa.FWD_TILES[0])
    for op in ("attn_fwd", "attn_bwd"):
        with pytest.raises(ValueError, match="bfloat16"):
            kfunca.autotune(op, 1, 1, 8, 16, dtype=torch.float32,
                            device="cpu")


def _k1_blockwise(q, k, v, kv_rows, window=None, bf16_p=False):
    """K1's bf16 body emulated in torch: q tiles of 128 rows in consumers of
    64; k, v streamed `kv_rows` at a time over the tile's live range; the
    online softmax in the exp2 domain from m = -1e30 (masked scores -inf,
    their p exactly 0); l sums the fp32 p, P optionally rounded to bf16
    before P.V; out = O / l (1 for l = 0) and lse = m ln 2 + ln l."""
    b, h, s, d = q.shape
    sl2 = math.log2(math.e) / math.sqrt(d)
    out = torch.zeros_like(q)
    lse = torch.zeros((b, h, s))
    for lo in range(0, s, 64):  # a consumer's 64 rows
        rows = torch.arange(lo, min(lo + 64, s))
        row0 = lo - lo % 128
        hi_col = min(row0 + 127, s - 1)
        first = max(row0 - window + 1, 0) if window else 0
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros((b, h, len(rows)))
        o = torch.zeros((b, h, len(rows), d))
        for c0 in range(first // kv_rows * kv_rows, hi_col + 1, kv_rows):
            cols = torch.arange(c0, min(c0 + kv_rows, s))
            sc = q[:, :, rows] @ k[:, :, cols].transpose(-1, -2)
            ok = cols[None, :] <= rows[:, None]
            if window:
                ok &= cols[None, :] > rows[:, None] - window
            sc = torch.where(ok, sc, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1) * sl2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc * sl2 - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = p.bfloat16().float() if bf16_p else p
            o = o * alpha[..., None] + pv @ v[:, :, cols]
            m = m_new
        out[:, :, rows] = o / torch.where(l == 0, 1.0, l)[..., None]
        lse[:, :, rows] = torch.where(l == 0, 0.0,
                                      m * math.log(2) + torch.log(l))
    return out, lse


@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("kv_rows", sorted({t["kv_rows"] for t in
                                            tfa.FWD_TILES + tfa.BWD_TILES}))
def test_k1_blockwise_online_softmax_at_each_streamed_rows(kv_rows, window):
    rng = np.random.default_rng(kv_rows)
    q, k, v = (torch.tensor(rng.standard_normal((1, 2, 300, 64)),
                            dtype=torch.float32) for _ in range(3))
    ref_out, ref_lse = tfa.flash_attention_plain(q, k, v, window)
    out, lse = _k1_blockwise(q, k, v, kv_rows, window)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=2e-5)
    # with P rounded to bf16 as the kernel rounds it: one bf16 step of out
    out16, _ = _k1_blockwise(q, k, v, kv_rows, window, bf16_p=True)
    assert float((out16 - ref_out).abs().max()) <= 2.0 ** -7 * float(
        ref_out.abs().max())


@pytest.mark.parametrize("op,tiles", [("attn_fwd", "FWD_TILES_256"),
                                      ("attn_bwd", "BWD_TILES_256")])
def test_attention_sweeps_take_the_head_dims_tiles(fresh, op, tiles):
    """At head dims above 128 the sweeps run the hd-256 tables, the only
    tiles built there, and record the winner under the head dim's class;
    at 128 and below they run the tables of today's kernels."""
    res = kfunca.autotune(op, 1, 2, 40, 200, reps=1, iters=1, device="cpu",
                          verbose=False)
    assert [c["params"] for c in res["all"]] == list(getattr(tfa, tiles))
    assert autotune.tuned(op, (40, 40, 200), "bfloat16") == res["params"]
    small = kfunca.autotune(op, 1, 2, 40, 128, reps=1, iters=1, device="cpu",
                            verbose=False)
    want = tfa.fwd_tiles(128) if op == "attn_fwd" else tfa.BWD_TILES
    assert [c["params"] for c in small["all"]] == list(want)
