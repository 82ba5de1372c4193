"""Port parity: runtime/autotune.py (a port of tests/test_autotune.py).

The cache: shape buckets, the record / lookup round trip through the file,
the measured cache over the shipped defaults, keys per card.  The sweep:
`kfunca.autotune` over K3's tiles (on the CPU, through the plain version,
which takes no tile: the machinery, not a device time), the winner read by
`gemm` under KFUNCA_GEMM_ENGINE=pallas, `decode_page` feeding
InferenceServer(page_size=None), the ops whose kernel has a fixed tile
raising NotImplementedError with its name, and an unknown op ValueError.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kfunca_tpu_torch as kfunca
from kfunca_tpu.runtime import autotune as jautotune
from kfunca_tpu_torch.models import serve, transformer
from kfunca_tpu_torch.ops import gemm as tgemm
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


@pytest.mark.parametrize("op", sorted(autotune.FIXED_TILE))
def test_fixed_tile_ops_raise_with_their_kernel(op):
    with pytest.raises(NotImplementedError, match=r"K\d+ \w+"):
        kfunca.autotune(op, 128, 128, 128)


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
