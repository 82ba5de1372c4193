"""Caching allocator bookkeeping (counterpart of kfunca_tpu/runtime/allocator.py).

The reference's DeviceAllocator (device_allocator.cpp:37-78,
device_allocator.h:48-57) pools cudaMalloc'd blocks in size classes.  On
the card PyTorch's own caching allocator owns the memory: every Storage
holds a torch tensor, and freed memory returns to PyTorch's pools.  What
this module keeps is the reference's bookkeeping over logical blocks --
size-class pools bounded at 4K/64K/256K/1M/4M/64M/256M/inf, 1 KB alignment,
best-fit reuse -- and `memstat`, the Python path of the JAX package.  The
JAX package's parked-buffer recycling is not ported: PyTorch's allocator
already hands a freed block to the next request of its size.

The reference's latent bug -- erasing the pool-set iterator before reading
it (device_allocator.cpp:56-60) -- is deliberately not reproduced.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass

ALIGNMENT = 1024
# Upper byte-bounds of the size-class pools (reference device_allocator.h:48-57).
POOL_BOUNDS = [
    4 * 1024,
    64 * 1024,
    256 * 1024,
    1024 * 1024,
    4 * 1024 * 1024,
    64 * 1024 * 1024,
    256 * 1024 * 1024,
    float("inf"),
]


def _round_up(n: int, align: int) -> int:
    return ((n + align - 1) // align) * align


def _pool_index(nbytes: int) -> int:
    for i, bound in enumerate(POOL_BOUNDS):
        if nbytes <= bound:
            return i
    return len(POOL_BOUNDS) - 1


@dataclass
class Block:
    block_id: int
    size: int  # rounded-up byte size
    device: object
    in_use: bool = True


class DeviceAllocator:
    """Singleton bookkeeping allocator: size-class pools with best-fit reuse."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = itertools.count(1)
        # device -> pool_index -> list[Block] (kept sorted by size)
        self._pools: dict = {}
        self._live: dict[int, Block] = {}
        self._bytes_in_use = 0
        self._bytes_pooled = 0
        self._alloc_count = 0
        self._reuse_count = 0

    @classmethod
    def instance(cls) -> "DeviceAllocator":
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _device_pools(self, device) -> list[list[Block]]:
        if device not in self._pools:
            self._pools[device] = [[] for _ in POOL_BOUNDS]
        return self._pools[device]

    def allocate(self, nbytes: int, device=0) -> Block:
        """Best-fit allocation from the size-class pool, else a fresh block
        (reference device_allocator.cpp:37-55)."""
        nbytes = max(int(nbytes), 1)
        rounded = _round_up(nbytes, ALIGNMENT)
        with self._lock:
            pool = self._device_pools(device)[_pool_index(rounded)]
            # best fit: smallest pooled block >= rounded (pool kept sorted)
            for i, blk in enumerate(pool):
                if blk.size >= rounded:
                    pool.pop(i)
                    blk.in_use = True
                    self._bytes_pooled -= blk.size
                    self._bytes_in_use += blk.size
                    self._reuse_count += 1
                    self._live[blk.block_id] = blk
                    return blk
            bid = next(self._next_id)
            blk = Block(block_id=bid, size=rounded, device=device)
            self._alloc_count += 1
            self._bytes_in_use += blk.size
            self._live[bid] = blk
            return blk

    def free(self, block: Block) -> None:
        """Return a block to its pool (reference device_allocator.cpp:66-72)."""
        with self._lock:
            if not block.in_use:
                return
            block.in_use = False
            self._live.pop(block.block_id, None)
            self._bytes_in_use -= block.size
            self._bytes_pooled += block.size
            pool = self._device_pools(block.device)[_pool_index(block.size)]
            pool.append(block)
            pool.sort(key=lambda b: b.size)

    # -- observability (reference memstat: device_allocator.cpp:17-35) -----

    def stats(self) -> dict:
        with self._lock:
            pools = {}
            for device, dpools in self._pools.items():
                pools[device] = [
                    {"bound": bound, "blocks": len(p), "bytes": sum(b.size for b in p)}
                    for bound, p in zip(POOL_BOUNDS, dpools)
                ]
            return {
                "bytes_in_use": self._bytes_in_use,
                "bytes_pooled": self._bytes_pooled,
                "live_blocks": len(self._live),
                "fresh_allocs": self._alloc_count,
                "pool_reuses": self._reuse_count,
                "pools": pools,
            }

    def print(self) -> None:
        s = self.stats()
        print("=== kfunca_tpu_torch memstat ===")
        print(f"bytes in use   : {s['bytes_in_use']}")
        print(f"bytes pooled   : {s['bytes_pooled']}")
        print(f"live blocks    : {s['live_blocks']}")
        print(f"fresh allocs   : {s['fresh_allocs']}")
        print(f"pool reuses    : {s['pool_reuses']}")
        for device, pools in s["pools"].items():
            for entry in pools:
                if entry["blocks"]:
                    print(
                        f"device {device} pool<= {entry['bound']}: "
                        f"{entry['blocks']} blocks, {entry['bytes']} bytes"
                    )


def memstat() -> None:
    DeviceAllocator.instance().print()
