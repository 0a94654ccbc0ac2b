"""Distribution layer of the port: meshes of shards driven by one
controller (launch.mesh).

  * ``sharding`` — ``ShardingPolicy`` and the reference's spec decisions
    (``params_shardings`` / ``batch_shardings`` / ``cache_shardings``),
    the placement of trees on a mesh (``shard_tree``, ``gather_tree``,
    ``Sharded``), the activation scope and the ``constrain_*`` points.
  * ``collectives`` — ``lse_combine_decode_attention`` and the
    hierarchical gradient all-reduce.
  * ``ring`` — ring attention over the sequence axis.
  * ``elastic`` — ``reshard_params`` and ``degrade_mesh``.
  * ``compression`` — the blockwise int8 codec (8-bit Adam's moments).
"""
