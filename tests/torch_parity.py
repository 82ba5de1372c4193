"""Shared helpers of the port's parity tests for Mamba-2 and the vision
family (tests/test_torch_{mamba2,vision,encoder,hf_vision,clip,dit}.py):
the tolerance checks and the one-thread fixture."""

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny torch models run on one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol, what=""):
    """max |got - want| <= tol x max(1, max |want|)."""
    got, want = as_numpy(got), as_numpy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def leaf_close(got, want, tol, what=""):
    """max |got - want| <= tol x the leaf's largest |entry|."""
    got, want = as_numpy(got), as_numpy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def trees_close(got, want, tol, check=leaf_close):
    """Two trees of the same paths, leaf by leaf (a port tree of tensors
    against a JAX tree of arrays)."""
    gl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(as_numpy, got))
    wl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(as_numpy, want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        check(g, w, tol, jax.tree_util.keystr(path))


def same_shapes(port_tree, jax_tree):
    """The port's init and the JAX init give the same paths and shapes."""
    pl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: tuple(t.shape), port_tree,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)))
    jl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), jax_tree))
    assert [(p, s) for p, s in pl] == [(p, s) for p, s in jl]
