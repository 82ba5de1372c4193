"""tests/test_nn.py against the port (kfunca_tpu_torch on the CPU): the
reference test/test_nn.py plus attention-backward extensions (the reference
has no attention backward at all)."""

import numpy as np
import torch
import torch.nn.functional as F

import kfunca_tpu_torch as kfunca
from common import assert_allclose

# Deterministic draws: the reference suite is unseeded and its fp16
# round-trip margin (test_convert) sits within one fp16 double-rounding of
# the 1e-3 tolerance, so unlucky draws fail ~5% of runs there too.
np.random.seed(0)

DEV = "cpu"


class TestNN:
    def test_causal_attention(self):
        batch_size_ = (2, 3, 5)
        nheads_ = (4, 5, 16)
        q_seq_length_ = (32, 64, 65)
        kv_seq_length_ = (256, 32, 33)
        hidden_size_ = (128, 64, 123)

        for (batch_size, nheads, q_seq_length, kv_seq_length, hidden_size) in zip(
            batch_size_, nheads_, q_seq_length_, kv_seq_length_, hidden_size_
        ):
            print(batch_size, nheads, q_seq_length, kv_seq_length, hidden_size)
            q_ = np.random.uniform(
                -10, 10, size=(batch_size, nheads, q_seq_length, hidden_size)
            ).astype(np.float32)
            k_ = np.random.uniform(
                -10, 10, size=(batch_size, nheads, kv_seq_length, hidden_size)
            ).astype(np.float32)
            v_ = np.random.uniform(
                -10, 10, size=(batch_size, nheads, kv_seq_length, hidden_size)
            ).astype(np.float32)
            q = kfunca.from_numpy(q_, DEV)
            k = kfunca.from_numpy(k_, DEV)
            v = kfunca.from_numpy(v_, DEV)
            out = kfunca.causal_attention(q, k, v).numpy()
            q_ref = torch.from_numpy(q_)
            k_ref = torch.from_numpy(k_)
            v_ref = torch.from_numpy(v_)
            out_ref = F.scaled_dot_product_attention(q_ref, k_ref, v_ref, is_causal=True).numpy()
            assert_allclose(out, out_ref)

    def test_causal_attention_backward(self):
        """fwd+bwd vs torch autograd (capability extension; BASELINE.json
        names attention fwd+bwd as a target)."""
        b, h, sq, skv, d = 2, 3, 16, 16, 32
        q_ = np.random.uniform(-1, 1, size=(b, h, sq, d)).astype(np.float32)
        k_ = np.random.uniform(-1, 1, size=(b, h, skv, d)).astype(np.float32)
        v_ = np.random.uniform(-1, 1, size=(b, h, skv, d)).astype(np.float32)
        g_ = np.random.uniform(-1, 1, size=(b, h, sq, d)).astype(np.float32)

        q = kfunca.from_numpy(q_, DEV).set_requires_grad(True)
        k = kfunca.from_numpy(k_, DEV).set_requires_grad(True)
        v = kfunca.from_numpy(v_, DEV).set_requires_grad(True)
        out = kfunca.causal_attention(q, k, v)
        out.backward(kfunca.from_numpy(g_, DEV))

        qt = torch.from_numpy(q_).requires_grad_(True)
        kt = torch.from_numpy(k_).requires_grad_(True)
        vt = torch.from_numpy(v_).requires_grad_(True)
        out_t = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        out_t.backward(torch.from_numpy(g_))

        assert_allclose(out, out_t.detach())
        assert_allclose(q.grad(), qt.grad)
        assert_allclose(k.grad(), kt.grad)
        assert_allclose(v.grad(), vt.grad)


if __name__ == "__main__":
    test_instance = TestNN()
    for method_name in dir(test_instance):
        if method_name.startswith("test_"):
            method = getattr(test_instance, method_name)
            print(f"Running {method_name}...")
            method()


class TestMakeFlashAttention:
    def test_gqa_window_grad_flows(self):
        """ops-level differentiable GQA+window attention (the plain path on
        CPU tensors; the kernels are held to it on the card)."""
        from kfunca_tpu_torch.ops.attention import make_flash_attention, _sdpa_xla_gqa

        fn = make_flash_attention(window=32)
        rng = np.random.default_rng(0)
        q = torch.tensor(rng.uniform(-1, 1, (1, 4, 64, 32)), dtype=torch.float32)
        k = torch.tensor(rng.uniform(-1, 1, (1, 2, 64, 32)), dtype=torch.float32)
        v = torch.tensor(rng.uniform(-1, 1, (1, 2, 64, 32)), dtype=torch.float32)
        out = fn(q, k, v)
        ref = _sdpa_xla_gqa(q, k, v, window=32)
        assert np.allclose(out.numpy(), ref.numpy(), atol=1e-5)

        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves) ** 2).sum().backward()
        gq, gk, gv = (t.grad for t in leaves)
        assert gk.shape == k.shape and gv.shape == v.shape
        assert float(gq.abs().max()) > 0 and float(gk.abs().max()) > 0
        # same fn object returned per window
        assert make_flash_attention(window=32) is fn
