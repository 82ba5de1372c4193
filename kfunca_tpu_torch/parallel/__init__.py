"""Parallelism over devices (counterpart of kfunca_tpu/parallel/).

Ported: context-parallel ring attention (`ring_attention`), the mesh over
named axes in its two forms and the sharding rules (`mesh`), the
differentiable collectives (`collectives`), the multi-process glue
(`multihost`), GPipe and interleaved pipelines (`pipeline`) and the
zero-bubble schedules (`zero_bubble`).
"""
