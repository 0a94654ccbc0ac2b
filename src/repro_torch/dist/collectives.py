"""Collectives across a mesh's shards: the distributed-LSE decode
attention and the hierarchical gradient all-reduce (the port of
``repro.dist.collectives``).

One controller drives every shard (launch.mesh), so a collective is
explicit: each shard's part is computed on its device, and the parts
meet on the home device as a max, or as a sum in shard order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.dist.sharding import MODEL_AXIS, Sharded
from repro_torch.models.flash import NEG_INF
from repro_torch.tree import leaves, unflatten


def _seq_parts(x, n: int, devices) -> List[torch.Tensor]:
    """Shard i's slice of dim 1 of ``x`` on ``devices[i]``: the blocks of
    a ``Sharded`` split on dim 1 over 'model', or contiguous slices of a
    whole tensor."""
    if isinstance(x, Sharded) and x.spec[1] == MODEL_AXIS:
        return [x.shards[x.mesh.index(model=i)].to(devices[i])
                for i in range(n)]
    if isinstance(x, Sharded):
        x = x.gather()
    S_loc = x.shape[1] // n
    return [x[:, i * S_loc:(i + 1) * S_loc].to(devices[i]) for i in range(n)]


def lse_combine_decode_attention(mesh, q: torch.Tensor, k, v,
                                 kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention over a sequence-sharded KV cache without
    resharding: each 'model' shard computes a partial softmax over its
    local KV slice and the partials merge with a log-sum-exp combine: the
    global max is the max over shards; the weighted numerators and the
    denominators are summed over shards in shard order; the output is
    o / max(l, 1e-30).

    q: [B, Kv, G, Dh] (replicated); k, v: [B, S, Kv, Dh], whole or
    ``Sharded`` over seq on 'model'; kv_len: i32[B]. Returns [B, Kv, G,
    Dh] in q's dtype on the home device."""
    B, Kv, G, Dh = q.shape
    S = k.shape[1]
    n = mesh.shape[MODEL_AXIS]
    assert S % n == 0, (S, n)
    S_loc = S // n
    devs = mesh.axis_devices(MODEL_AXIS)
    home = mesh.home
    ks, vs = _seq_parts(k, n, devs), _seq_parts(v, n, devs)
    scores = []
    for i, dev in enumerate(devs):
        pos = i * S_loc + torch.arange(S_loc, device=dev)
        qb = q.to(dev)
        s = torch.einsum("bkgd,bskd->bkgs",
                         (qb * torch.tensor(Dh ** -0.5, dtype=qb.dtype))
                         .float(), ks[i].float())
        bias = torch.where(pos[None, :] < kv_len.to(dev)[:, None], 0.0,
                           NEG_INF)
        scores.append(s + bias[:, None, None, :])
    m = None                                             # global max
    for s in scores:
        m_loc = s.amax(dim=-1).to(home)
        m = m_loc if m is None else torch.maximum(m, m_loc)
    alive = m > NEG_INF / 2
    m0 = torch.where(alive, m, 0.0)
    l = o = None
    for s, vb, dev in zip(scores, vs, devs):
        p = torch.exp(s - m0.to(dev)[..., None])
        p = torch.where(alive.to(dev)[..., None], p, 0.0)
        l_i = p.sum(dim=-1).to(home)
        o_i = torch.einsum("bkgs,bskd->bkgd", p.to(vb.dtype).float(),
                           vb.float()).to(home)
        l = l_i if l is None else l + l_i
        o = o_i if o is None else o + o_i
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def hierarchical_grad_allreduce(
        mesh, grads: Any,
        compress: Optional[Tuple[Callable, Callable]] = None) -> Any:
    """Gradient all-reduce across the batch axes: the sum over the fast
    intra-pod 'data' axis first, then over the slow cross-pod 'pod' axis,
    optionally through an (encode, decode) pair so only the encoded
    values cross the pod link: dec(sum over pods of enc(x))).

    ``grads``: one tree that every shard holds (the reference's
    replicated input), or a list of ``mesh.size`` trees, shard i's at i.
    The 'model' axis is not reduced: the value at model coordinate 0 is
    taken. Returns the reduced tree on the home device."""
    per = grads if isinstance(grads, list) and len(grads) == mesh.size \
        else [grads] * mesh.size
    enc, dec = compress if compress is not None else (None, None)
    home = mesh.home
    n_pod = mesh.shape.get("pod", 1)
    n_data = mesh.shape.get("data", 1)
    flat = [leaves(t) for t in per]
    out = []
    for j in range(len(flat[0])):
        total = None
        for p in range(n_pod):
            x = None
            for d in range(n_data):
                v = flat[mesh.index(pod=p, data=d)][j].to(home)
                x = v if x is None else x + v
            if enc is not None and "pod" in mesh.axis_names:
                x = enc(x)
            total = x if total is None else total + x
        if dec is not None and "pod" in mesh.axis_names:
            total = dec(total)
        out.append(total)
    return unflatten(per[0], out)


__all__ = ["hierarchical_grad_allreduce", "lse_combine_decode_attention"]
