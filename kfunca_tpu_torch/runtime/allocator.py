"""Device memory statistics (counterpart of kfunca_tpu/runtime/allocator.py).

The reference's DeviceAllocator (device_allocator.cpp:37-78) pools
cudaMalloc'd blocks in size classes, and the JAX package keeps the same
bookkeeping over logical blocks, since XLA owns TPU memory.  On the card
PyTorch's caching allocator owns the memory and pools it itself (a small
pool for blocks up to 1 MB, a large pool above), so the port keeps no
bookkeeping of its own: `DeviceAllocator.stats()` and `memstat` read
`torch.cuda.memory_stats` of every visible card under the JAX package's
`stats()` keys.  Without a card every count is 0.
"""

from __future__ import annotations

import threading

import torch

# PyTorch's two pools: blocks up to 1 MB, and the rest
POOL_BOUNDS = [1024 * 1024, float("inf")]
_POOLS = ("small_pool", "large_pool")


class DeviceAllocator:
    """The JAX package's allocator interface over PyTorch's allocator."""

    _instance = None
    _instance_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "DeviceAllocator":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def stats(self) -> dict:
        """bytes_in_use: allocated bytes; bytes_pooled: reserved but not
        allocated; live_blocks: live allocations; fresh_allocs: segments
        reserved with cudaMalloc; pool_reuses: allocations served
        from memory already reserved; pools: per card, per PyTorch pool,
        live blocks and their bytes.  Summed over the visible cards."""
        out = dict(bytes_in_use=0, bytes_pooled=0, live_blocks=0,
                   fresh_allocs=0, pool_reuses=0, pools={})
        if not torch.cuda.is_available():
            return out
        for dev in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(dev)
            used = s.get("allocated_bytes.all.current", 0)
            segments = s.get("segment.all.allocated", 0)
            out["bytes_in_use"] += used
            out["bytes_pooled"] += s.get("reserved_bytes.all.current", 0) - used
            out["live_blocks"] += s.get("allocation.all.current", 0)
            out["fresh_allocs"] += segments
            out["pool_reuses"] += max(
                0, s.get("allocation.all.allocated", 0) - segments)
            out["pools"][dev] = [
                {"bound": bound,
                 "blocks": s.get(f"allocation.{pool}.current", 0),
                 "bytes": s.get(f"allocated_bytes.{pool}.current", 0)}
                for bound, pool in zip(POOL_BOUNDS, _POOLS)]
        return out

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
