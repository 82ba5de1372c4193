"""PyTorch/CUDA port of kfunca_tpu for one NVIDIA Hopper card (sm_90a).

The package mirrors kfunca_tpu's module layout so each counterpart is easy
to find; kfunca_tpu stays the reference the port is tested against.  Plain
tensor code is PyTorch, and every Pallas TPU kernel on a ported path has a
hand-written CUDA kernel under `csrc/`, built with nvcc at first use
(runtime/_kernels.py) and bound through ctypes.

Ported so far: the single-chip paged-KV serving path
(models/serve.InferenceServer: fused or split page pools, fp or int8 KV,
int8/int4 weight-quantized decode, prefix caching; models/generate.py)
with its paged decode attention kernels (ops/pallas_kernels/
paged_attention.py, csrc/paged_attention.cu) and its int8 matmul kernel
(ops/quant.py, csrc/quant.cu), and the training path (models/train.make_train_step, models/trainer.Trainer, the
losses, data, eval and checkpoints) with the flash attention forward and
backward kernels (ops/attention.py, ops/pallas_kernels/flash_attention.py,
csrc/flash_attention.cu).

Entry points run on the CUDA device unless the caller passes
device="cpu"; on CPU tensors each kernel wrapper runs its plain PyTorch
version.
"""
