"""Port parity: save_orbax / load_orbax without orbax (utils/orbax_format.py).

Both directions against the JAX package, bit for bit: directories written
by its save_orbax (a tiny transformer's params with {"step": 9} and an
eager Tensor; leaves in bf16, fp16, int8, int32 and bool, a scalar, nested
lists; an array orbax wrote in several chunks) load in the port, and the
port's directories load in its load_orbax.  Within the port: a round trip,
a ShardedParams tree saved and restored as its global tree, the committed
JAX-written fixture against its generator.  Named errors for a wrong
`like`, zarr3, an unknown dtype, a corrupted crc32c and a missing native
core.  The native zstd decoder held to `zstandard` at levels 1, 3 and 19
on random, repetitive and fp32-weight data, empty and multi-block frames,
and corrupted checksums; the OCDBT reader held to TensorStore's on a tree
with interior nodes.  The JAX-written directories are made once per
module (orbax's save costs about a second).
"""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import tensorstore as ts
import zstandard

import kfunca_tpu as jkfunca
from kfunca_tpu.models import transformer as jtf
from kfunca_tpu.utils import checkpoint as jck
from kfunca_tpu_torch.models import transformer as ttf
from kfunca_tpu_torch.models.weights import params_from_jax
from kfunca_tpu_torch.parallel import mesh as tmesh
from kfunca_tpu_torch.runtime import _native
from kfunca_tpu_torch.utils import checkpoint as tck
from kfunca_tpu_torch.utils import orbax_format as of

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=48, max_seq_len=16, dtype="bfloat16")
FIXTURE = Path(__file__).with_name("fixtures") / "orbax_tiny"


def _mixed():
    """Leaves of every dtype the port writes, a scalar and nested lists, as
    numpy (bf16 as ml_dtypes)."""
    rng = np.random.default_rng(5)
    return {
        "bf": rng.standard_normal((3, 7)).astype(jnp.bfloat16),
        "half": rng.standard_normal((5,)).astype(np.float16),
        "nest": [[rng.integers(-128, 128, (4, 2), dtype=np.int8),
                  rng.integers(-9, 9, (6,), dtype=np.int32)],
                 {"flag": rng.random((2, 3)) < 0.5}],
        "x": np.float32(2.75),
        "w": rng.standard_normal((9, 4)).astype(np.float32),
        "step": 9,
    }


def _params_tree():
    jp = jtf.init_params(jax.random.PRNGKey(0), jtf.TransformerConfig(**CFG))
    t = jkfunca.from_numpy(
        np.random.default_rng(1).uniform(-1, 1, (4, 8)).astype(np.float32), 0)
    return {"params": jp, "step": 9, "t": t}


def _to_torch(x):
    if isinstance(x, int):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _torch_like(tree):
    """The JAX tree as the port's (torch leaves, the same structure)."""
    def conv(x):
        if isinstance(x, jkfunca.Tensor):
            return _to_torch(x.numpy())
        return _to_torch(x)

    return jax.tree_util.tree_map(
        conv, tree, is_leaf=lambda x: isinstance(x, jkfunca.Tensor))


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
        return str(x.dtype)[6:], tuple(x.shape), x.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_same(got, want):
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if isinstance(w, int):
            assert g == w and type(g) is int
            continue
        assert _bits(g) == _bits(w), (_bits(g)[:2], _bits(w)[:2])


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """Directories the JAX package's save_orbax (and orbax, for chunks)
    wrote: name -> (path, the tree as the port holds it)."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    tree = _params_tree()
    jck.save_orbax(str(root / "params"), tree)
    out["params"] = (root / "params", _torch_like(tree))
    mixed = _mixed()
    jck.save_orbax(str(root / "mixed"), jax.tree_util.tree_map(
        lambda x: x if isinstance(x, int) else jnp.asarray(x), mixed))
    out["mixed"] = (root / "mixed", _torch_like(mixed))
    big = np.random.default_rng(7).standard_normal((40, 33)).astype(np.float32)
    args = {"big": ocp.SaveArgs(chunk_byte_size=1024)}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(root / "chunked"), {"big": jnp.asarray(big)},
               save_args=args)
    ckptr.wait_until_finished()
    out["chunked"] = (root / "chunked", {"big": torch.from_numpy(big)})
    return out


@pytest.mark.parametrize("name", ["params", "mixed", "chunked"])
def test_jax_checkpoint_loads_in_the_port(jax_dirs, name):
    path, like = jax_dirs[name]
    got = tck.load_orbax(str(path), like, device="cpu")
    _assert_same(got, like)
    if name == "chunked":  # orbax cut it into chunks of the .zarray's grid
        meta = json.loads(bytes(of.OcdbtReader(str(path)).get("big/.zarray")))
        assert meta["chunks"] != meta["shape"]


@pytest.mark.parametrize("name", ["params", "mixed"])
def test_port_checkpoint_loads_in_jax(tmp_path, name):
    tree = _params_tree() if name == "params" else _mixed()
    port_tree = _torch_like(tree)
    if name == "params":  # an eager Tensor of the port as the leaf
        port_tree["t"] = __import__("kfunca_tpu_torch").from_torch(
            port_tree["t"], "cpu")
    tck.save_orbax(str(tmp_path / "c"), port_tree)
    jlike = jax.tree_util.tree_map(
        lambda x: x if isinstance(x, int) else jnp.asarray(
            x.numpy() if isinstance(x, jkfunca.Tensor) else x), tree,
        is_leaf=lambda x: isinstance(x, jkfunca.Tensor))
    back = jck.load_orbax(str(tmp_path / "c"), jlike)
    want = _torch_like(tree)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        if isinstance(w, int):
            assert int(g) == w
            continue
        assert _bits(np.asarray(g)) == _bits(w)
    # and it loads in the port too
    _assert_same(tck.load_orbax(str(tmp_path / "c"), want, device="cpu"),
                 want)


def test_sharded_params_save_as_their_global_tree(tmp_path):
    jp = jtf.init_params(jax.random.PRNGKey(3), jtf.TransformerConfig(**CFG))
    tc = ttf.TransformerConfig(**CFG)
    params = params_from_jax(jp, tc, device="cpu")
    sp = tmesh.shard_params(params, tmesh.LocalMesh(1, 2, "cpu"), False,
                            cfg=tc)
    tck.save_orbax(str(tmp_path / "s"), {"params": sp, "step": 3})
    like = {"params": params, "step": 0}
    got = tck.load_orbax(str(tmp_path / "s"), like, device="cpu")
    _assert_same(got["params"], params)
    assert got["step"] == 3
    again = tck.load_orbax(str(tmp_path / "s"), {"params": sp, "step": 0},
                           device="cpu")  # a ShardedParams `like`: global
    _assert_same(again["params"], params)


PORT_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8,
               torch.int32, torch.int64, torch.uint8, torch.bool]


@pytest.mark.parametrize("dtype", PORT_DTYPES, ids=lambda d: str(d)[6:])
def test_every_dtype_round_trips_in_the_port(tmp_path, dtype):
    gen = torch.Generator().manual_seed(4)
    x = (torch.randn((5, 3, 2), generator=gen) * 50).to(dtype)
    tree = {"a": x, "scalar": x[0, 0, 0].clone(), "t": (x[1],)}
    tck.save_orbax(str(tmp_path / "c"), tree)
    got = tck.load_orbax(str(tmp_path / "c"), tree, device="cpu")
    assert isinstance(got["t"], tuple)
    _assert_same(got, tree)


def test_save_replaces_a_directory_and_keeps_no_temporary(tmp_path):
    d = tmp_path / "c"
    tck.save_orbax(str(d), {"a": torch.ones(3)})
    tck.save_orbax(str(d), {"b": torch.zeros(2, dtype=torch.int32)})
    assert sorted(os.listdir(tmp_path)) == ["c"]
    got = tck.load_orbax(str(d), {"b": torch.ones(2, dtype=torch.int32)},
                         device="cpu")
    assert torch.equal(got["b"], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"no leaf \('a',\)"):
        tck.load_orbax(str(d), {"a": torch.ones(3)}, device="cpu")


def test_wrong_like_raises_naming_the_leaf(jax_dirs):
    path, like = jax_dirs["mixed"]
    with pytest.raises(ValueError, match=r"no leaf \('missing',\)"):
        tck.load_orbax(str(path), {**like, "missing": torch.zeros(1)},
                       device="cpu")
    with pytest.raises(ValueError, match=r"\('w',\).*\(9, 4\).*\(4, 9\)"):
        tck.load_orbax(str(path), {**like, "w": torch.zeros(4, 9)},
                       device="cpu")


def test_unread_layouts_raise(tmp_path, jax_dirs):
    src, like = jax_dirs["mixed"]
    d = tmp_path / "z3"
    shutil.copytree(src, d)
    meta = json.loads((d / "_METADATA").read_text())
    (d / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3"):
        tck.load_orbax(str(d), like, device="cpu")
    # an unknown zarr dtype
    d2 = tmp_path / "c64"
    d2.mkdir()
    of.write_ocdbt(str(d2), {"v/.zarray": [of.zarray_json([2], "<c8")],
                             "v/0": [b"\0" * 16]})
    (d2 / "_METADATA").write_text(json.dumps({
        "tree_metadata": {"('v',)": {}}, "use_ocdbt": True,
        "use_zarr3": False}))
    with pytest.raises(ValueError, match="<c8"):
        tck.load_orbax(str(d2), {"v": torch.zeros(2)}, device="cpu")
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        tck.load_orbax(str(tmp_path), like, device="cpu")


def test_corrupted_crc32c_raises(tmp_path):
    d = tmp_path / "c"
    tck.save_orbax(str(d), {"a": torch.arange(5)})
    raw = bytearray((d / "manifest.ocdbt").read_bytes())
    raw[20] ^= 1
    (d / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        tck.load_orbax(str(d), {"a": torch.arange(5)}, device="cpu")


def test_without_the_native_core_load_raises_and_save_works(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(_native, "get_lib", lambda: None)
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    tck.save_orbax(str(tmp_path / "c"), tree)
    with pytest.raises(RuntimeError, match="native core"):
        tck.load_orbax(str(tmp_path / "c"), tree, device="cpu")
    monkeypatch.undo()
    _assert_same(tck.load_orbax(str(tmp_path / "c"), tree, device="cpu"),
                 tree)


def test_crc32c_known_answers():
    assert of.crc32c(b"") == 0
    assert of.crc32c(b"123456789") == 0xE3069283  # RFC 3720's check value
    assert of.crc32c(bytes(32)) == 0x8A9136AA  # RFC 3720 B.4, 32 zeros
    assert of.crc32c(b"6789", of.crc32c(b"12345")) == 0xE3069283


def test_committed_fixture_is_its_generators_arrays():
    spec = importlib.util.spec_from_file_location(
        "make_orbax_tiny", FIXTURE.with_name("make_orbax_tiny.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    want = gen.arrays()
    like = jax.tree_util.tree_map(
        lambda x: x if isinstance(x, int) else torch.from_numpy(
            np.array(x)), want)
    like["emb"] = like["emb"].bfloat16()
    got = tck.load_orbax(str(FIXTURE), like, device="cpu")
    assert got["emb"].dtype == torch.bfloat16
    assert torch.equal(got["emb"].float(), torch.from_numpy(want["emb"]))
    got["emb"] = got["emb"].float()
    like["emb"] = torch.from_numpy(want["emb"])
    _assert_same(got, like)


# -- the format pieces -------------------------------------------------------

_RNG = np.random.default_rng(11)
DATA = {
    "random": _RNG.bytes(300_000),
    "repetitive": b"kfunca orbax " * 20_000 + bytes(70_000),
    "fp32": _RNG.standard_normal(200_000).astype(np.float32).tobytes(),
}


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", sorted(DATA))
def test_native_zstd_matches_zstandard(level, kind):
    data = DATA[kind]
    for checksum in (False, True):
        frame = zstandard.ZstdCompressor(
            level=level, write_checksum=checksum).compress(data)
        assert of.zstd_decompress(frame).tobytes() == data
        assert of.zstd_decompress(frame, len(data)).tobytes() == data


def test_native_zstd_empty_multiblock_and_corrupt_frames():
    assert of.zstd_decompress(zstandard.ZstdCompressor().compress(b"")
                              ).tobytes() == b""
    data = DATA["fp32"] * 3  # a streamed frame of many blocks, no size
    obj = zstandard.ZstdCompressor(level=3).compressobj()
    frame = obj.compress(data) + obj.flush()
    assert of.zstd_decompress(frame).tobytes() == data
    tail = zstandard.ZstdCompressor().compress(b"next frame")
    assert of.zstd_decompress(frame + tail).tobytes() == data + b"next frame"
    bad = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(
        DATA["repetitive"]))
    bad[-1] ^= 0x40
    with pytest.raises(ValueError, match="checksum"):
        of.zstd_decompress(bytes(bad))
    with pytest.raises(ValueError, match="zstd"):
        of.zstd_decompress(bytes(bad[:-200]))
    with pytest.raises(ValueError, match="expected"):
        of.zstd_decompress(frame, len(data) - 1)


@pytest.mark.parametrize("claimed", [1 << 63, (1 << 64) - 1, 1 << 40])
def test_native_zstd_refuses_a_size_its_input_cannot_give(claimed):
    # a single-segment frame whose 8-byte content size is `claimed`, then
    # one empty raw block: refused before anything is reserved from it
    frame = (b"\x28\xb5\x2f\xfd\xe0" + claimed.to_bytes(8, "little")
             + b"\x01\x00\x00")
    with pytest.raises(ValueError, match="corrupt"):
        of.zstd_decompress(frame)


def test_raw_block_frames_decode_everywhere():
    data = _RNG.bytes(3 * of.ZSTD_RAW_BLOCK + 5)
    for n in (0, 1, of.ZSTD_RAW_BLOCK, len(data)):
        frame = b"".join(bytes(p) for p in of.zstd_raw_frame_parts(
            memoryview(data[:n])))
        assert zstandard.ZstdDecompressor().decompress(frame) == data[:n]
        assert of.zstd_decompress(frame).tobytes() == data[:n]


def _ts_values(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}"}).result()
    return {k.decode(): bytes(kv.read(k).result().value)
            for k in kv.list().result()}


def test_ocdbt_reader_takes_interior_nodes(tmp_path):
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"max_decoded_node_bytes": 256,
                       "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    with ts.Transaction() as txn:
        for i in range(60):
            kv.with_transaction(txn).write(
                f"p{i % 7}.{i:03d}/0.0", bytes([i]) * (3 + 5 * (i % 9))
            ).result()
    want = _ts_values(tmp_path)
    store = of.OcdbtReader(str(tmp_path))
    assert store.height >= 2  # interior nodes above the leaves
    assert {k.decode() for k in store.keys} == set(want)
    for k, v in want.items():
        assert bytes(store.get(k)) == v


def test_port_store_reads_in_tensorstore(tmp_path):
    values = {f"k{i:02d}/0": [bytes([i]) * (1 + 300 * i)] for i in range(12)}
    values["a/.zarray"] = [b"{}", b"{\"x\": 1}"]
    of.write_ocdbt(str(tmp_path), values)
    want = {k: b"".join(v) for k, v in values.items()}
    assert _ts_values(tmp_path) == want
    store = of.OcdbtReader(str(tmp_path))
    assert {k: bytes(store.get(k)) for k in want} == want
