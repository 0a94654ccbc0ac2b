"""Elastic mesh handling: reshard a param tree onto a (possibly
degraded) mesh, and the degraded mesh shape after replica loss. Values
are kept exactly: resharding gathers the blocks and cuts them again, pure
data movement.

Serving wires this in through ``serve.fleet.Fleet``: ``scale_down``
treats the fleet as the outermost (replicated) axis of a
(replicas, model_shards) pod mesh and uses ``degrade_mesh`` to pick the
surviving replica count, and ``reap`` calls ``reshard_params`` (through
``reshard_surviving``) to re-place each surviving mesh-sharded replica's
weights after the drained replicas retire."""

from __future__ import annotations

from typing import Any, Tuple

from repro_torch.dist import sharding as shd


def degrade_mesh(shape: Tuple[int, ...], n_failed: int) -> Tuple[int, ...]:
    """Drop ``n_failed`` replicas from the outermost (replicated batch)
    axis, floored at one; the model axis is load-bearing and never
    shrinks."""
    return (max(1, shape[0] - n_failed),) + tuple(shape[1:])


def reshard_params(params: Any, cfg, mesh, policy=None) -> Any:
    """``params`` (whole, or placed on another mesh) placed for ``mesh``
    per ``params_shardings`` (fsdp by default, as the reference)."""
    whole = shd.gather_tree(params)
    specs = shd.params_shardings(whole, cfg, mesh,
                                 policy or shd.ShardingPolicy(fsdp=True))
    return shd.shard_tree(whole, specs, mesh)


__all__ = ["degrade_mesh", "reshard_params"]
