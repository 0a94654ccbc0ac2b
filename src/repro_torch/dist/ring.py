"""Ring attention: sequence-parallel attention where KV blocks rotate
around the 'model' axis while each shard keeps its query block (the port
of ``repro.dist.ring``). The rotation (the reference's ``ppermute``) is a
``.to(next device)`` of each shard's K/V slice; memory stays O(S/n) a
shard."""

from __future__ import annotations

import torch

from repro_torch.dist.collectives import _seq_parts
from repro_torch.dist.sharding import MODEL_AXIS
from repro_torch.models.flash import NEG_INF, _gqa_out, _gqa_scores


def ring_attention(mesh, q, k, v, *, causal: bool = True,
                   block_kv: int = 512) -> torch.Tensor:
    """q: [B, S, Kv, G, Dh]; k, v: [B, S, Kv, Dh] (whole, or ``Sharded``
    over seq on 'model'). Shards S over 'model' and runs n ring steps of
    online-softmax accumulation; returns [B, S, Kv, G, Dh] in q's dtype on
    the home device. ``block_kv`` is kept for the reference's signature
    (each ring step scores one whole slice, as the reference's does)."""
    B, S, Kv, G, Dh = q.shape
    n = mesh.shape[MODEL_AXIS]
    assert S % n == 0, (S, n)
    S_loc = S // n
    devs = mesh.axis_devices(MODEL_AXIS)
    qs = _seq_parts(q, n, devs)
    kc, vc = _seq_parts(k, n, devs), _seq_parts(v, n, devs)
    state = []
    for i, dev in enumerate(devs):
        state.append([
            torch.full((B, Kv, G, S_loc), NEG_INF, dtype=torch.float32,
                       device=dev),
            torch.zeros((B, Kv, G, S_loc), dtype=torch.float32, device=dev),
            torch.zeros((B, Kv, G, S_loc, Dh), dtype=torch.float32,
                        device=dev)])
    for step in range(n):
        for i, dev in enumerate(devs):
            m, l, o = state[i]
            q_pos = i * S_loc + torch.arange(S_loc, device=dev)
            src = (i - step) % n           # origin shard of the block held
            kv_pos = src * S_loc + torch.arange(S_loc, device=dev)
            qf = qs[i] * torch.tensor(Dh ** -0.5, dtype=qs[i].dtype)
            s = _gqa_scores(qf, kc[i])     # f32 [B, Kv, G, Sl, Sl]
            if causal:
                bias = torch.where(kv_pos[None, :] <= q_pos[:, None],
                                   0.0, NEG_INF)
                s = s + bias[None, None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            alive = m_new > NEG_INF / 2
            p = torch.exp(s - torch.where(alive, m_new, 0.0)[..., None])
            p = torch.where(alive[..., None], p, 0.0)
            corr = torch.where(alive, torch.exp(m - m_new), 0.0)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + _gqa_out(p, vc[i])
            state[i] = [m_new, l, o]
        # each shard's K/V slice moves on to the next shard
        kc = [kc[(i - 1) % n].to(devs[i]) for i in range(n)]
        vc = [vc[(i - 1) % n].to(devs[i]) for i in range(n)]
    outs = []
    for (m, l, o), qb in zip(state, qs):
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.movedim(-2, 1).to(qb.dtype).to(mesh.home))
    return torch.cat(outs, dim=1)


__all__ = ["ring_attention"]
