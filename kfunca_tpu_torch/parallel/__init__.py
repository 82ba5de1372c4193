"""Parallelism over devices (counterpart of kfunca_tpu/parallel/).

Ported so far: context-parallel ring attention (`ring_attention`).
"""
