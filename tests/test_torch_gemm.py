"""tests/test_gemm.py against the port (kfunca_tpu_torch on the CPU): the
reference test/test_gemm.py plus dtype/backward extensions."""

import numpy as np

import kfunca_tpu_torch as kfunca
from common import assert_allclose

# Deterministic draws: the reference suite is unseeded and its fp16
# round-trip margin (test_convert) sits within one fp16 double-rounding of
# the 1e-3 tolerance, so unlucky draws fail ~5% of runs there too.
np.random.seed(0)

DEV = "cpu"


class TestGemm:
    def test_gemm_base(self):
        a = np.random.uniform(-10, 10, size=(123, 457))
        b = np.random.uniform(-10, 10, size=(457, 234))
        a_gpu = kfunca.from_numpy(a, DEV)
        b_gpu = kfunca.from_numpy(b, DEV)
        print(a_gpu.sizes(), b_gpu.sizes())
        out_gpu = kfunca.gemm(a_gpu, b_gpu, 1.0, 0.0)
        out = np.matmul(a, b)
        assert_allclose(out, out_gpu)

    # -- extensions beyond the reference suite ------------------------------

    def test_gemm_fp32_batched_lhs(self):
        """rank-3 LHS flattens to (m, k) (reference gemm_kernel.cu:8-20)."""
        a = np.random.uniform(-1, 1, size=(4, 37, 64)).astype(np.float32)
        b = np.random.uniform(-1, 1, size=(64, 96)).astype(np.float32)
        out = kfunca.gemm(kfunca.from_numpy(a, DEV), kfunca.from_numpy(b, DEV), 1.0, 0.0)
        assert out.sizes() == [4, 37, 96]
        assert_allclose(np.matmul(a, b), out)

    def test_gemm_alpha(self):
        a = np.random.uniform(-1, 1, size=(32, 48)).astype(np.float32)
        b = np.random.uniform(-1, 1, size=(48, 16)).astype(np.float32)
        out = kfunca.gemm(kfunca.from_numpy(a, DEV), kfunca.from_numpy(b, DEV), 2.5, 0.0)
        assert_allclose(2.5 * np.matmul(a, b), out)

    def test_gemm_bf16(self):
        a = np.random.uniform(-1, 1, size=(64, 128)).astype(np.float32)
        b = np.random.uniform(-1, 1, size=(128, 32)).astype(np.float32)
        a_bf = kfunca.from_numpy(a, DEV).bfloat16()
        b_bf = kfunca.from_numpy(b, DEV).bfloat16()
        out = kfunca.gemm(a_bf, b_bf, 1.0, 0.0)
        assert_allclose(np.matmul(a, b), out.float(), atol=0.5, rtol=0.5)

    def test_gemm_backward(self):
        a = np.random.uniform(-1, 1, size=(16, 24)).astype(np.float32)
        b = np.random.uniform(-1, 1, size=(24, 8)).astype(np.float32)
        g = np.random.uniform(-1, 1, size=(16, 8)).astype(np.float32)
        a_t = kfunca.from_numpy(a, DEV).set_requires_grad(True)
        b_t = kfunca.from_numpy(b, DEV).set_requires_grad(True)
        out = kfunca.gemm(a_t, b_t, 1.0, 0.0)
        out.backward(kfunca.from_numpy(g, DEV))
        assert_allclose(a_t.grad(), g @ b.T)
        assert_allclose(b_t.grad(), a.T @ g)


if __name__ == "__main__":
    test_instance = TestGemm()
    for method_name in dir(test_instance):
        if method_name.startswith("test_"):
            method = getattr(test_instance, method_name)
            print(f"Running {method_name}...")
            method()
