"""Elastic mesh handling: the degraded mesh shape after replica loss.

Serving uses it through ``serve.fleet.Fleet.scale_down``, which treats
the fleet as the outermost (replicated) axis of a (replicas,
model_shards) pod mesh and takes the surviving replica count from
``degrade_mesh``. Resharding a param tree onto a degraded device mesh
(the reference's ``reshard_params``) comes with multi-device serving:
the port serves one device, so a fleet's replicas have no mesh to
re-pin."""

from __future__ import annotations

from typing import Tuple


def degrade_mesh(shape: Tuple[int, ...], n_failed: int) -> Tuple[int, ...]:
    """Drop ``n_failed`` replicas from the outermost (replicated batch)
    axis, floored at one; the model axis is load-bearing and never
    shrinks."""
    return (max(1, shape[0] - n_failed),) + tuple(shape[1:])


__all__ = ["degrade_mesh"]
