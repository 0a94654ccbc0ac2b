"""Mesh shardings, the placement of trees on a mesh, and the activation
scope the model code consults.

Axis convention (launch.mesh): ``pod`` and ``data`` are batch axes,
``model`` is the tensor/sequence-parallel axis. Policy knobs:

  * fsdp           — shard params across the data axis too (ZeRO-3-style)
  * seq_shard      — Megatron-SP: residuals sharded over seq on 'model'
  * pod_param_shard— extend fsdp across the pod axis (400B-class models)
  * shard_kv_seq   — decode KV cache sharded over seq on 'model'

A spec is a tuple with one entry per dim: ``None`` (whole), an axis name,
or a tuple of axis names (the dim splits over their combined size). The
decisions (``_param_spec``, ``params_shardings``, ``batch_shardings``,
``cache_shardings``) are the reference's, entry for entry, but for the
serving layout's tied embedding (``params_shardings``).

Placement is the port's own: ``shard_tree`` cuts each leaf into the
contiguous blocks its spec names and puts block i on mesh device i (a
``Sharded`` leaf); a leaf whose spec names no axis stays one tensor on the
mesh's home device, where the controller computes it once.
``gather_tree`` puts the whole tree back together on the home device.

``constrain_*`` are identity unless an ``activation_sharding_scope`` is
active, so model code calls them unconditionally. In scope,
``constrain_tp_exact`` is the all-gather of the bit-reproducible serving
layout: per-shard parts concatenated on the home device, never summed.
The residual stream stays whole on the home device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_map

BATCH_AXIS_NAMES = ("pod", "data")
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = False
    seq_shard: bool = False
    pod_param_shard: bool = False
    shard_kv_seq: bool = False
    # Bit-reproducible tensor parallelism (sharded serving): shard every
    # weight on its OUTPUT dim and all-gather activations at the
    # constrain_tp_exact points, so every collective is a CONCATENATION
    # (order-preserving) and never a summation.
    exact_tp: bool = False


def _batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The batch axes of ``mesh`` whose combined size divides ``batch``."""
    axes, n = [], 1
    for a in BATCH_AXIS_NAMES:
        if a in mesh.axis_names and batch % (n * mesh.shape[a]) == 0:
            axes.append(a)
            n *= mesh.shape[a]
    return tuple(axes)


def _entry(axes: Tuple[str, ...]):
    """A spec entry naming ``axes``: one axis by its name, several as a
    tuple (the reference's PartitionSpec normalizes a 1-tuple so)."""
    return axes[0] if len(axes) == 1 else axes


def _model_size(mesh) -> int:
    return mesh.shape[MODEL_AXIS] if MODEL_AXIS in mesh.axis_names else 1


# ---------------------------------------------------------------------------
# Parameter / input / cache shardings


def _param_spec(shape, mesh, policy: ShardingPolicy) -> tuple:
    """Tensor-parallel on 'model' over the largest divisible trailing dim;
    fsdp shards one remaining dim over the data (and optionally pod) axes.
    Stacked-unit leaves keep axis 0 (the unit axis) whole.

    ``policy.exact_tp`` shards ONLY the last dim — for matmul weights
    that is the OUTPUT dim, so a replicated activation times a
    column-sharded weight needs no cross-shard reduction. A leaf whose
    last dim doesn't divide stays fully replicated."""
    shape = tuple(shape)
    spec: List[Any] = [None] * len(shape)
    msize = _model_size(mesh)
    lo = 1 if len(shape) >= 3 else 0  # skip the [U, ...] stack axis
    if msize > 1 and len(shape) >= 2:
        if policy.exact_tp:
            cands = [len(shape) - 1]
        else:
            cands = sorted(range(lo, len(shape)),
                           key=lambda i: shape[i], reverse=True)
        for i in cands:
            if shape[i] % msize == 0 and shape[i] >= msize:
                spec[i] = MODEL_AXIS
                break
    if policy.fsdp:
        axes = tuple(a for a in BATCH_AXIS_NAMES if a in mesh.axis_names)
        if not policy.pod_param_shard:
            axes = axes[-1:]
        dsize = 1
        for a in axes:
            dsize *= mesh.shape[a]
        if dsize > 1:
            for i in range(lo, len(shape)):
                if spec[i] is None and shape[i] % dsize == 0 \
                        and shape[i] >= dsize:
                    spec[i] = _entry(axes)
                    break
    return tuple(spec)


def map_with(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, o)`` over the leaves of ``tree`` (dicts, NamedTuples,
    lists and tuples of tensors or of objects with a ``shape``), ``o`` the
    entry of ``other`` at the same place. ``other``'s entries may be
    tuples themselves (specs): the recursion follows ``tree``."""
    if isinstance(tree, dict):
        return {k: map_with(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_with(fn, v, getattr(other, f))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with(fn, v, o) for v, o in zip(tree, other))
    if tree is None:
        return None
    return fn(tree, other)


def params_shardings(params_shapes, cfg, mesh,
                     policy: Optional[ShardingPolicy] = None):
    """The spec tree of a param tree (tensors or anything with ``shape``).

    One leaf departs from the reference: under ``exact_tp`` on a
    model-only mesh a tied embedding [V, d] splits on its vocab rows
    (whole where V does not divide), so the tied head's logits are the
    shards' own products, concatenated, and no step gathers the table
    (the lookup takes each token's row from its shard)."""
    policy = policy or ShardingPolicy()
    specs = tree_map(lambda l: _param_spec(tuple(l.shape), mesh, policy),
                     params_shapes)
    msize = _model_size(mesh)
    if policy.exact_tp and msize > 1 and mesh.size == msize \
            and cfg.tie_embeddings and not cfg.n_codebooks:
        vocab = params_shapes["embed"].shape[0]
        specs["embed"] = (MODEL_AXIS, None) if vocab % msize == 0 \
            else (None, None)
    return specs


def batch_shardings(cfg, mesh, b: int, s: int, kind: str,
                    policy: Optional[ShardingPolicy] = None) -> dict:
    """Specs for every possible model-input key (callers filter)."""
    bt = _batch_axes(mesh, b)
    lead = (_entry(bt),) if bt else ()
    return {"tokens": lead, "labels": lead, "mask": lead,
            "vision_embeds": lead, "audio_embeds": lead,
            "mrope_positions": (None, _entry(bt)) if bt else ()}


def cache_shardings(cfg, mesh, batch: int,
                    policy: Optional[ShardingPolicy] = None,
                    paged: bool = False):
    """Returns fn(path, leaf) -> spec for a decode cache's leaves; ``path``
    is the tuple of dict keys down to the leaf.

    Contiguous cache (``paged=False``, {"lens": [B], "units": {bj: leaf
    [U, B, ...]}}): batch-sharded over the batch axes; with
    ``policy.shard_kv_seq`` the K/V seq axis additionally shards over
    'model' (the LSE-combine decode layout).

    Paged block pool (``paged=True``, {"lens": [B], "block_tables":
    [B, MB], "units": {bj: k/v [U, n_blocks, bs, Kv, Dh] (+ _scale
    leaves)}}): the KV-HEAD axis shards over 'model' — the tensor-
    parallel partition matching column-sharded wk/wv, so each shard
    writes and reads only its local heads of every block. The BLOCK axis
    is never sharded: block tables address arbitrary physical blocks, so
    every shard holds (its head slice of) every block — that is what
    keeps allocation, refcounts, COW and defrag host-side and
    shard-agnostic. lens/block_tables are replicated host-truth,
    republished by the runner every step."""
    bt = _batch_axes(mesh, batch)
    msize = _model_size(mesh)
    kv_seq = bool(policy and policy.shard_kv_seq) and msize > 1

    def fn(path, leaf) -> tuple:
        last = path[-1] if path else None
        ndim = len(leaf.shape)
        if paged:
            if last in ("k", "v", "k_scale", "v_scale") and ndim >= 5 \
                    and msize > 1 and leaf.shape[3] % msize == 0 \
                    and leaf.shape[3] >= msize:
                spec = [None] * ndim
                spec[3] = MODEL_AXIS        # [U, nb, bs, Kv, Dh|1]
                return tuple(spec)
            return ()
        if last in ("lens", "block_tables"):
            return (_entry(bt),) if bt else ()
        if ndim >= 2 and bt:
            spec = [None] * ndim
            spec[1] = _entry(bt)
            if kv_seq and ndim >= 3 and last in ("k", "v") \
                    and leaf.shape[2] % msize == 0:
                spec[2] = MODEL_AXIS
            return tuple(spec)
        return ()

    return fn


def map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a dict tree's leaves (non-tensor leaves
    such as a paged cache's ``trash_rows`` pass through)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if not hasattr(tree, "shape"):
        return tree
    return fn(path, tree)


# ---------------------------------------------------------------------------
# Placement


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _pad(spec: tuple, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def block_slices(spec: tuple, shape: Sequence[int], mesh, i: int
                 ) -> Tuple[slice, ...]:
    """The part of a leaf of ``shape`` that spec ``spec`` puts on shard
    ``i``: per dim, the contiguous block at the shard's combined
    coordinate over the dim's axes (row-major in the listed order)."""
    coords = mesh.coords(i)
    out = []
    for n_dim, entry in zip(shape, _pad(spec, len(shape))):
        c, size = 0, 1
        for a in _axes(entry):
            c = c * mesh.shape[a] + coords[a]
            size *= mesh.shape[a]
        blk = n_dim // size
        out.append(slice(c * blk, (c + 1) * blk))
    return tuple(out)


def _key(sl: Tuple[slice, ...]) -> tuple:
    return tuple((s.start, s.stop) for s in sl)


class Sharded:
    """One leaf placed on a mesh: ``shards[i]`` is the contiguous block
    that ``spec`` puts on device ``mesh.devices[i]``, a separate
    allocation there (shards on one device holding one block share it).
    ``shape`` is the whole leaf's. Indexing with an int takes one entry of
    an unsharded leading dim (a stacked unit), shard by shard."""

    def __init__(self, shards: Sequence[torch.Tensor], spec: tuple,
                 shape: Sequence[int], mesh):
        self.shards = tuple(shards)
        self.spec = _pad(spec, len(shape))
        self.shape = torch.Size(shape)
        self.mesh = mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def slices(self, i: int) -> Tuple[slice, ...]:
        return block_slices(self.spec, self.shape, self.mesh, i)

    def __getitem__(self, i: int) -> "Sharded":
        if not isinstance(i, int) or self.spec[0] is not None:
            raise TypeError("a Sharded leaf takes an int index on an "
                            "unsharded leading dim only")
        return Sharded([s[i] for s in self.shards], self.spec[1:],
                       self.shape[1:], self.mesh)

    def model_parts(self, dim: int = -1
                    ) -> Optional[Tuple[torch.Tensor, ...]]:
        """The per-shard blocks of a leaf split on ``dim`` alone over a
        model-only mesh (the serving layout), in shard order; None for any
        other layout."""
        dim %= self.ndim
        if self.mesh.size != _model_size(self.mesh) \
                or self.spec[dim] != MODEL_AXIS \
                or any(e for j, e in enumerate(self.spec) if j != dim):
            return None
        return self.shards

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole leaf on ``device`` (default the home device): each
        block copied into place, values kept exactly."""
        device = self.mesh.home if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for i, s in enumerate(self.shards):
            sl = self.slices(i)
            if _key(sl) not in done:
                done.add(_key(sl))
                out[sl] = s.to(device)
        return out

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, spec={self.spec}, "
                f"shards={len(self.shards)})")


def place(t: torch.Tensor, spec: tuple, mesh):
    """``t`` placed per ``spec``: a ``Sharded`` of fresh contiguous blocks,
    or, for a spec naming no axis, one tensor on the home device."""
    if isinstance(t, Sharded):
        t = t.gather()
    spec = _pad(spec, t.ndim)
    if not any(spec):
        return t.to(mesh.home)
    made: Dict[tuple, torch.Tensor] = {}
    shards = []
    for i, dev in enumerate(mesh.devices):
        sl = block_slices(spec, t.shape, mesh, i)
        key = (str(dev), _key(sl))
        if key not in made:
            made[key] = t[sl].to(dev, copy=True,
                                 memory_format=torch.contiguous_format)
        shards.append(made[key])
    return Sharded(shards, spec, t.shape, mesh)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` placed per the spec tree ``specs`` (``place`` each leaf;
    a leaf already ``Sharded`` is gathered first)."""
    return map_with(lambda t, s: place(t, s, mesh), tree, specs)


def gather_tree(tree: Any, device: Optional[torch.device] = None) -> Any:
    """The whole tree: every ``Sharded`` leaf gathered (on ``device``, by
    default its mesh's home device); other leaves as they are, moved to
    ``device`` where given."""
    def one(t):
        if isinstance(t, Sharded):
            return t.gather(device)
        return t if device is None else t.to(device)
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# Activation-sharding scope

# the active scope, per thread: a fleet may poll its replicas (each with
# its own mesh, or none) from a thread pool
_LOCAL = threading.local()


def current_scope():
    """The active (mesh, policy) activation-sharding scope of this thread,
    or None.

    Model code consults this on every call to pick its sharded code path
    (attention.attn_step_paged routes single-token decode through the
    LSE-combine collective when policy.shard_kv_seq)."""
    return getattr(_LOCAL, "scope", None)


@contextlib.contextmanager
def activation_sharding_scope(mesh, policy: ShardingPolicy):
    prev = current_scope()
    _LOCAL.scope = (mesh, policy)
    try:
        yield
    finally:
        _LOCAL.scope = prev


def _home(x):
    scope = current_scope()
    if scope is None or not isinstance(x, torch.Tensor):
        return x
    return x.to(scope[0].home)


def constrain_residual(x):
    """[B, S, d] residual. In scope the single controller keeps the
    residual stream whole on the home device (the reference shards it
    over the batch axes, and over 'model' under ``seq_shard``, where its
    devices run the rows); off-scope the identity."""
    return _home(x)


def constrain_seq_gathered(x):
    """[B, S, d] activation entering a tensor-parallel matmul: sequence
    gathered. In scope it is whole on the home device already."""
    return _home(x)


def constrain_tp_exact(x):
    """All-gather point of the bit-reproducible serving layout: in scope,
    a list of per-shard parts (split on the last dim, in shard order) is
    concatenated on the home device — concatenation keeps every value
    bit for bit, where a sum of partial products would re-order the
    accumulation — and a ``Sharded`` leaf is gathered. A whole tensor
    passes through; off-scope the identity."""
    scope = current_scope()
    if scope is None:
        return x
    home = scope[0].home
    if isinstance(x, (list, tuple)):
        return torch.cat([p.to(home) for p in x], dim=-1)
    if isinstance(x, Sharded):
        return x.gather(home)
    return x


def constrain_moe_dispatch(t):
    """[E, cap, ...] expert-parallel dispatch: experts over 'model' in the
    reference. Sharded MoE is not in the port (the engine refuses an MoE
    stack under a mesh); the identity."""
    return t


def column_parts(w) -> Optional[Tuple[torch.Tensor, ...]]:
    """Per-shard column blocks of a weight split on its last (output) dim
    under the active scope; None for a whole weight."""
    if current_scope() is None or not isinstance(w, Sharded):
        return None
    return w.model_parts()


def row_parts(w) -> Optional[Tuple[torch.Tensor, ...]]:
    """Per-shard row blocks of a leaf split on its first dim alone (the
    tied embedding's vocab rows, ``params_shardings``) under the active
    scope; None for any other leaf."""
    if current_scope() is None or not isinstance(w, Sharded):
        return None
    return w.model_parts(0)


def whole(w) -> torch.Tensor:
    """A weight as one tensor on the home device (gathered if sharded)."""
    return w.gather() if isinstance(w, Sharded) else w


def column_block(b: Any, i: int, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of a bias ``b`` for shard i under the active
    scope: the shard's own block where ``b`` is split there alike, else a
    slice of the whole (gathered once a call)."""
    parts = column_parts(b)
    if parts is not None and parts[i].shape[-1] == hi - lo:
        return parts[i]
    return whole(b)[..., lo:hi]


def colwise(x: torch.Tensor, w, b: Optional[Any] = None):
    """``x @ w (+ b)``. Off-scope, or for a whole ``w``, one product (on
    the home device under a scope). For a column-sharded ``w``, one
    product per shard on its device with its columns (and its block of
    the bias ``b``, whole or split alike), concatenated on the home
    device: the output columns are the whole product's, bit for bit
    where the GEMM's sum order does not depend on the column count."""
    parts = column_parts(w)
    if parts is None:
        y = x @ whole(w)
        return y if b is None else y + whole(b)
    outs = []
    c0 = 0
    for i, p in enumerate(parts):
        y = x.to(p.device) @ p
        c1 = c0 + p.shape[-1]
        if b is not None:
            y = y + column_block(b, i, c0, c1).to(p.device)
        c0 = c1
        outs.append(y)
    return constrain_tp_exact(outs)


__all__ = ["BATCH_AXIS_NAMES", "MODEL_AXIS", "ShardingPolicy", "Sharded",
           "activation_sharding_scope", "batch_shardings", "block_slices",
           "cache_shardings", "colwise", "column_block", "column_parts",
           "constrain_moe_dispatch", "constrain_residual",
           "constrain_seq_gathered", "constrain_tp_exact", "current_scope",
           "gather_tree", "map_with", "map_with_path", "params_shardings",
           "place", "row_parts", "shard_tree", "whole"]
