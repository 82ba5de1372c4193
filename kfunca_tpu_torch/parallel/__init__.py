"""Parallelism over devices (counterpart of kfunca_tpu/parallel/).

Ported so far: context-parallel ring attention (`ring_attention`), the
(dp, tp) mesh in its two forms and the sharding rules (`mesh`), the
differentiable collectives (`collectives`) and the multi-process glue
(`multihost`).
"""
