"""Ring attention: context-parallel causal attention over a ring of ranks.

Counterpart of kfunca_tpu/parallel/ring_attention.py: `_block_attend`
(:39), `_ring_fused` (:63), `_ring_fused_diff` and its backward
`_ring_fused_bwd` (:104-164), `ring_attention_spmd` (:167), `_ring_einsum`
(:182) and `make_ring_attention` (:218).

The sequence is split over the n ranks of a `cp` axis: rank r holds the q,
k and v shards of tokens [r S_local, (r + 1) S_local).  At hop i, rank r
holds the k/v shard of rank (r - i) mod n and merges it into its q shard's
online-softmax carry with K12 (ops/pallas_kernels/ring_hop.py), masking by
global positions; then every rank sends its k/v to rank r + 1.  After n
hops every q row has seen every column, and the result equals causal
attention over the gathered sequence.  The backward (`_RingAttention`)
recomputes p from the saved global lse hop by hop: dq stays with its q
shard, and dk/dv travel the ring with their k/v shards, so that after n
rotations they are home.

The hop loop is written once, over a ring object that names the ranks this
process holds and a `ppermute` that sends each held shard to rank
(r + 1) mod n:
- `ProcessGroupRing(group)` holds one rank of a torch.distributed process
  group and exchanges shards with `dist.batch_isend_irecv` (gloo on the
  CPU, NCCL on CUDA cards).  NCCL takes one rank a card, so this form needs
  one card a rank.
- `LocalRing(n)` holds all n ranks on one device and steps them in
  lockstep inside one thread; its `ppermute` rotates the list of shards.
  It computes exactly what an n-rank `cp` group computes, with the same
  hops and offsets; it is how a one-card machine runs the ring.  (A thread
  a rank would deadlock: every thread's CUDA backward runs on autograd's
  one device thread.)

Inputs are what this process holds: the local (B, H, S_local, D) shards
under a ProcessGroupRing, the global (B, H, S, D), split into n shards
along S, under a LocalRing.  q, k and v have equal heads (repeat grouped kv
heads first), as `_block_attend`'s einsum does in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops.pallas_kernels import ring_hop

NEG_INF = ring_hop.NEG_INF


class LocalRing:
    """The n ranks of a `cp` axis, all held by this process on one device."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs at least one rank, got {n}")
        self.n = n
        self.ranks = tuple(range(n))

    def split(self, x):
        """The n shards of x along the sequence (dim 2), contiguous."""
        if x.shape[2] % self.n:
            raise ValueError(f"sequence length {x.shape[2]} does not split "
                             f"into {self.n} equal shards")
        return [t.contiguous() for t in x.chunk(self.n, dim=2)]

    def join(self, shards):
        return torch.cat(shards, dim=2)

    def ppermute(self, shards):
        """Each rank's item goes to rank (r + 1) mod n."""
        return [shards[(j - 1) % self.n] for j in range(self.n)]


class ProcessGroupRing:
    """One rank of a torch.distributed process group."""

    def __init__(self, group=None):
        self.group = dist.group.WORLD if group is None else group
        self.n = dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        self.ranks = (rank,)
        self._next = dist.get_global_rank(self.group, (rank + 1) % self.n)
        self._prev = dist.get_global_rank(self.group, (rank - 1) % self.n)

    def split(self, x):
        return [x.contiguous()]

    def join(self, shards):
        return shards[0]

    def ppermute(self, shards):
        """Send this rank's item (a tuple of tensors) to rank r + 1 and take
        rank r - 1's, all tensors in one batch of point-to-point calls."""
        if self.n == 1:
            return shards
        (item,) = shards
        sends = [t.contiguous() for t in item]
        recvs = [torch.empty_like(t) for t in sends]
        ops = []
        for tag, (s, r) in enumerate(zip(sends, recvs)):
            ops.append(dist.P2POp(dist.isend, s, self._next, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, r, self._prev, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(recvs)]


def _hops(use_kernel: bool):
    """(forward hop, backward hop): the K12 wrappers, or their plain
    versions on any device."""
    if use_kernel:
        return ring_hop.flash_attention_hop, ring_hop.flash_attention_bwd_hop
    return (ring_hop.flash_attention_hop_plain,
            ring_hop.flash_attention_bwd_hop_plain)


def _scaled(q):
    """q * 1/sqrt(D), the scale folded into q once in q's dtype
    (`_ring_fused`, :82 and :134)."""
    return q * torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)


def _ring_forward(ring, hop, qs, ks, vs):
    """The forward hop loop over the held shards: (outs, lses)."""
    n = ring.n
    b, h, s, d = qs[0].shape
    qs = [_scaled(q) for q in qs]
    carries = [ring_hop.hop_carry_init(b, h, s, d, device=q.device)
               for q in qs]
    kv = list(zip(ks, vs))
    for i in range(n):
        for j, r in enumerate(ring.ranks):
            hop(qs[j], *kv[j], *carries[j], r * s, ((r - i) % n) * s)
        if i + 1 < n:
            kv = ring.ppermute(kv)
    outs = [ring_hop.hop_finalize(l, acc, b, h, s, d, q.dtype)
            for q, (_, l, acc) in zip(qs, carries)]
    return outs, [ring_hop.hop_lse(m, l) for m, l, _ in carries]


def _ring_backward(ring, hop, qs, ks, vs, outs, lses, gs):
    """The backward hop loop: (dqs, dks, dvs) in the inputs' dtypes."""
    n = ring.n
    b, h, s, d = qs[0].shape
    qd, kd = qs[0].dtype, ks[0].dtype
    qs = [_scaled(q) for q in qs]
    deltas = [ring_hop.flat_rows((g.float() * o.float()).sum(dim=-1))
              for g, o in zip(gs, outs)]
    accs = [ring_hop.bwd_carry_init(b, h, s, s, d, device=q.device)
            for q in qs]
    dqs = [a[0] for a in accs]
    kv = list(zip(ks, vs))
    dkv = [a[1:] for a in accs]
    for i in range(n):
        for j, r in enumerate(ring.ranks):
            hop(qs[j], *kv[j], gs[j], lses[j], deltas[j], dqs[j], *dkv[j],
                r * s, ((r - i) % n) * s)
        if i + 1 < n:  # k, v and their accumulators travel together
            both = ring.ppermute([x + y for x, y in zip(kv, dkv)])
            kv, dkv = [t[:2] for t in both], [t[2:] for t in both]
        else:  # after the n-th rotation dk and dv are home
            dkv = ring.ppermute(dkv)
    scale = 1.0 / math.sqrt(d)
    return ([(dq * scale).reshape(b, h, s, d).to(qd) for dq in dqs],
            [dk.reshape(b, h, s, d).to(kd) for dk, _ in dkv],
            [dv.reshape(b, h, s, d).to(kd) for _, dv in dkv])


class _RingAttention(torch.autograd.Function):
    """Counterpart of `_ring_fused_diff`: the hop loop forward, saving (q,
    k, v, out, lse), and the hop loop backward."""

    @staticmethod
    def forward(ctx, q, k, v, ring, use_kernel):
        fwd, _ = _hops(use_kernel)
        outs, lses = _ring_forward(ring, fwd, ring.split(q), ring.split(k),
                                   ring.split(v))
        out = ring.join(outs)
        ctx.save_for_backward(q, k, v, out, *lses)
        ctx.ring, ctx.use_kernel = ring, use_kernel
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, *lses = ctx.saved_tensors
        ring = ctx.ring
        _, bwd = _hops(ctx.use_kernel)
        dqs, dks, dvs = _ring_backward(
            ring, bwd, ring.split(q), ring.split(k), ring.split(v),
            ring.split(out), lses, ring.split(g.to(q.dtype)))
        return ring.join(dqs), ring.join(dks), ring.join(dvs), None, None


def ring_attention_spmd(q, k, v, *, ring, use_kernel=None):
    """Causal attention of what this process holds over `ring`.

    use_kernel=None takes K12 for CUDA tensors and the plain hops for CPU
    tensors (the JAX package's auto-select, :173-176); True takes the K12
    wrappers (which run their plain versions on CPU tensors and raise on
    what the kernel does not take, fp64 among it); False the plain hops.
    Both go through the same autograd Function.  K12 takes fp32 and bf16
    (bf16 on the wgmma bodies, which round p and ds to bf16 before the
    second products, as the JAX hop does; the plain hops keep them fp32):
    fp16 runs widened to fp32 and comes back in fp16, as
    ops/attention.py's flash path does."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"expected q, k, v of one shape (B, H, S, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if use_kernel and q.dtype == k.dtype == v.dtype == torch.float16:
        out = _RingAttention.apply(q.float(), k.float(), v.float(), ring, True)
        return out.to(torch.float16)
    return _RingAttention.apply(q, k, v, ring, bool(use_kernel))


def make_ring_attention(mesh, *, cp_axis: str = "cp"):
    """fn(q, k, v) over the `cp_axis` dimension of a DeviceMesh (this
    rank's local shards in and out), or over a LocalRing (the global
    (B, H, S, D) on one device, split along S into its n shards)."""
    ring = (mesh if isinstance(mesh, LocalRing)
            else ProcessGroupRing(mesh.get_group(cp_axis)))

    def ring_attention(q, k, v):
        return ring_attention_spmd(q, k, v, ring=ring)

    return ring_attention


# -- the oracle -----------------------------------------------------------------


def _block_attend(q, k, v, q_off, kv_off, m, l, acc, scale):
    """One online-softmax accumulation of q against a (k, v) block, as the
    JAX package's einsum path: q (B, H, Sq, D) and k, v fp32, m and l
    (B, H, Sq, 1), acc like q; the scale applied to the scores."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    sq, sk = q.shape[2], k.shape[2]
    row = q_off + torch.arange(sq, device=q.device)[:, None]
    col = kv_off + torch.arange(sk, device=q.device)[None, :]
    ok = col <= row
    s = torch.where(ok, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.where(ok, torch.exp(s - m_new), 0.0)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, acc_new


def _ring_einsum(q, k, v, ring):
    """The independent oracle: the einsum ring over `ring`, differentiable
    by autograd under a LocalRing (its ppermute is a list rotation; the
    process-group form's is not differentiable)."""
    n = ring.n
    qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
    s_local = qs[0].shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    outs = []
    state = []
    for qj in qs:
        m = torch.full(qj.shape[:3] + (1,), NEG_INF, dtype=torch.float32,
                       device=q.device)
        state.append([qj.float(), m, torch.zeros_like(m),
                      torch.zeros(qj.shape, dtype=torch.float32,
                                  device=q.device)])
    kv = list(zip(ks, vs))
    for i in range(n):
        for j, r in enumerate(ring.ranks):
            qf, m, l, acc = state[j]
            state[j][1:] = _block_attend(
                qf, kv[j][0].float(), kv[j][1].float(), r * s_local,
                ((r - i) % n) * s_local, m, l, acc, scale)
        kv = ring.ppermute(kv)
    for qf, m, l, acc in state:
        outs.append((acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype))
    return ring.join(outs)
