"""The training loop: a train step with microbatch accumulation, the
global-norm clip and the optimizer update, its sharded form over a
(data x model) mesh (``compile_train_step``), and the single-device
training loop ``run_training`` (the port of ``repro.train.loop``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import hierarchical_grad_allreduce
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, tree_map, unflatten


def value_and_grad(params: Any, cfg: ModelConfig, batch: dict):
    """(loss, metrics, grads) of ``transformer.loss_fn`` at ``params``;
    the grads have the params' structure. Every leaf must get a gradient:
    a leaf the loss does not reach raises, as a forward that left the
    autograd graph would."""
    flat = [t.detach().requires_grad_(True) for t in leaves(params)]
    with torch.enable_grad():
        loss, metrics = transformer.loss_fn(unflatten(params, flat), cfg,
                                            batch)
        grads = torch.autograd.grad(loss, flat)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, list(grads)))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With ``tcfg.microbatch`` n > 1 the batch splits into n
    along its first axis: the gradient is the sum of the micro-gradients
    (in f32) divided by n, the loss their mean, the other metrics the
    last micro's."""
    _, update = opt.make_optimizer(tcfg)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _loss_and_grads(params, cfg, tcfg, batch)
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
        params, opt_state = update(params, grads, opt_state, tcfg)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def _loss_and_grads(params, cfg: ModelConfig, tcfg: TrainConfig,
                    batch: dict):
    """(loss, metrics, grads) of one step's batch, with ``tcfg.microbatch``
    accumulation (see ``make_train_step``)."""
    n = tcfg.microbatch
    if not n or n <= 1:
        return value_and_grad(params, cfg, batch)
    grads, loss = None, 0.0
    for j in range(n):
        mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[j]
              for k, v in batch.items()}
        l, metrics, g = value_and_grad(params, cfg, mb)
        grads = tree_map(lambda g: g.float(), g) if grads is None \
            else tree_map(torch.add, grads, g)
        loss = loss + l
    return loss / n, metrics, tree_map(lambda g: g / n, grads)


def compile_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                       params_shapes, opt_shapes, batch_shapes,
                       policy: shd.ShardingPolicy = shd.ShardingPolicy(),
                       donate: bool = True):
    """The train step laid out on ``mesh`` (launch.mesh.Mesh). Returns
    (fn, (p_sh, o_sh, x_sh)): the spec trees of the params
    (``params_shardings``), the optimizer state (``_opt_shardings``) and
    the batch (``batch_shardings``); place the trees with
    ``dist.sharding.shard_tree`` before the first call. ``fn(params,
    opt_state, batch) -> (params, opt_state, metrics)`` takes and returns
    placed trees:

      * each data shard (the batch's rows split over the batch axes)
        runs ``make_train_step``'s forward and backward on its rows with
        the gathered params, on the device at its model coordinate 0
        (kernel 3 through ``ops.ReluFFN`` on the card for nectar);
      * its gradients are weighted by its mask sum over the whole
        batch's and summed by ``hierarchical_grad_allreduce``, so the
        result is the unsharded step's mean (the loss and ce likewise);
      * then the global-norm clip on the home device, then the update:
        fp32 AdamW updates each shard's block of the params and moments
        on its device (the step is elementwise); 8-bit AdamW's int8
        moment blocks run over the whole flattened leaf, which a
        last-dim slice does not tile, so that update runs on the
        gathered leaves and the params and blocks go back to their
        shards.

    ``donate`` is the reference's argument; the placed trees are replaced,
    not donated."""
    _, update = opt.make_optimizer(tcfg)
    p_sh = shd.params_shardings(params_shapes, cfg, mesh, policy)
    o_sh = _opt_shardings(opt_shapes, p_sh, mesh)
    b, s = _batch_dims(batch_shapes)
    x_sh = shd.batch_shardings(cfg, mesh, b, s, "train", policy)
    x_sh = {k: x_sh[k] for k in batch_shapes}
    bt = shd._batch_axes(mesh, b)

    def group(i: int) -> int:
        c, g = mesh.coords(i), 0
        for a in bt:
            g = g * mesh.shape[a] + c[a]
        return g

    first: dict = {}                    # data shard -> its first device
    for i in range(mesh.size):
        first.setdefault(group(i), i)
    n_groups = len(first)
    # the devices the all-reduce reads: model coordinate 0 of every
    # (pod, data) coordinate
    reduce_at = [mesh.index(pod=p, data=d)
                 for p in range(mesh.shape.get("pod", 1))
                 for d in range(mesh.shape.get("data", 1))]

    def rows(leaf, g: int) -> torch.Tensor:
        if isinstance(leaf, shd.Sharded):
            return leaf.shards[first[g]]
        n = leaf.shape[0] // n_groups
        return leaf[g * n:(g + 1) * n].to(mesh.devices[first[g]])

    def step(params, opt_state, batch):
        whole = shd.gather_tree(params)
        outs = []
        for g in range(n_groups):
            dev = mesh.devices[first[g]]
            part = {k: rows(v, g) for k, v in batch.items()}
            loss, metrics, grads = _loss_and_grads(
                tree_map(lambda t: t.to(dev), whole), cfg, tcfg, part)
            tok = part["tokens"]
            w = part["mask"].float().sum() if "mask" in part else \
                torch.tensor(float(tok.shape[0] * tok.shape[1]), device=dev)
            outs.append((loss, metrics, grads, w))
        home = mesh.home
        total = sum(outs[group(i)][3].to(home) for i in reduce_at)
        scaled = [tree_map(lambda t, f=(w / total.to(w.device)): t * f,
                           grads) for _, _, grads, w in outs]
        grads = hierarchical_grad_allreduce(
            mesh, [scaled[group(i)] for i in range(mesh.size)])
        frac = [outs[g][3].to(home) / total
                * sum(1 for i in reduce_at if group(i) == g)
                for g in range(n_groups)]
        loss = sum(f * o[0].to(home) for f, o in zip(frac, outs))
        metrics = {k: sum(f * o[1][k].to(home) for f, o in zip(frac, outs))
                   for k in outs[0][1] if k != "ppl"}
        metrics["ppl"] = torch.exp(metrics["ce"])
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
        if isinstance(opt_state, opt.AdamState):
            params, opt_state = _sharded_adam(params, grads, opt_state, tcfg)
        else:
            new_p, new_o = update(whole, grads, shd.gather_tree(opt_state),
                                  tcfg)
            params = shd.shard_tree(new_p, p_sh, mesh)
            opt_state = shd.shard_tree(new_o, o_sh, mesh)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return step, (p_sh, o_sh, x_sh)


def _sharded_adam(params, grads, state: opt.AdamState, tcfg: TrainConfig):
    """fp32 AdamW over placed trees: each distinct block of a sharded leaf
    updates on its device from its slice of the whole gradient; a whole
    leaf updates on the home device."""
    step = state.step + 1
    lr, c1, c2 = opt._corrections(tcfg, step)
    out_p, out_m, out_v = [], [], []
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        if not isinstance(p, shd.Sharded):
            p2, m2, v2 = opt.adam_leaf(p, g.to(p.device), m, v,
                                       lr.to(p.device), c1.to(p.device),
                                       c2.to(p.device), tcfg)
            out_p.append(p2), out_m.append(m2), out_v.append(v2)
            continue
        done: dict = {}
        shards = ([], [], [])
        for i, (pb, mb, vb) in enumerate(zip(p.shards, m.shards, v.shards)):
            if id(pb) not in done:
                dev = pb.device
                done[id(pb)] = opt.adam_leaf(
                    pb, g[p.slices(i)].to(dev), mb, vb, lr.to(dev),
                    c1.to(dev), c2.to(dev), tcfg)
            for k in range(3):
                shards[k].append(done[id(pb)][k])
        for k, out in enumerate((out_p, out_m, out_v)):
            out.append(shd.Sharded(shards[k], p.spec, p.shape, p.mesh))
    return (unflatten(params, out_p),
            opt.AdamState(step=step, m=unflatten(params, out_m),
                          v=unflatten(params, out_v)))


def _batch_dims(batch_shapes):
    t = batch_shapes["tokens"]
    return t.shape[0], t.shape[1]


def _opt_shardings(opt_shapes, p_sh, mesh):
    """Optimizer state inherits param specs where shapes match; the
    int8-moment blocks ((nb, BLOCK) layout) shard nb across as many mesh
    axes as divide it; scalars replicate."""
    axis_sets = [tuple(mesh.axis_names)]
    for i in range(1, len(mesh.axis_names)):
        axis_sets.append(tuple(mesh.axis_names[i:]))
    axis_sets.append(tuple(mesh.axis_names[-1:]))

    def block_spec(leaf) -> tuple:
        if len(leaf.shape) != 2:
            return ()
        for axes in axis_sets:
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            if n > 1 and leaf.shape[0] % n == 0:
                return (shd._entry(axes), None)
        return ()

    if hasattr(opt_shapes, "_fields"):  # AdamState / Adam8State
        vals = []
        for name in opt_shapes._fields:
            sub = getattr(opt_shapes, name)
            if name == "step":
                vals.append(())
            elif name in ("m", "v"):
                # fp32 moments: the params' tree, so their specs
                vals.append(p_sh)
            else:
                vals.append(tree_map(block_spec, sub))
        return type(opt_shapes)(*vals)
    return tree_map(lambda l: (), opt_shapes)


def run_training(model, cfg: ModelConfig, tcfg: TrainConfig, source,
                 steps: int, params=None, opt_state=None, start_step: int = 0,
                 guard=None, on_checkpoint=None, log_every: int = 10,
                 device: Optional[Union[str, torch.device]] = None):
    """Single-device training driver on ``device`` (default CUDA; without
    a card it raises, see ``resolve_device``). Params default to
    ``model.init`` from a generator seeded with ``tcfg.seed`` (the
    reference's law, not its bits); params and optimizer state given are
    moved to the device. Batch i comes from ``source.iterate``. Metrics
    are read on the host at the logged steps only (every ``log_every``
    steps and the last). ``guard.should_stop`` checkpoints through
    ``on_checkpoint(step, params, opt_state)`` and stops; so does every
    ``tcfg.checkpoint_every``-th step, without stopping. Returns (params,
    opt_state, {"history": [(step, metrics)], "wall_s", "steps_done"})."""
    device = resolve_device(device)
    init, _ = opt.make_optimizer(tcfg)
    if params is None:
        params = model.init(torch.Generator(device=device)
                            .manual_seed(tcfg.seed), device=device)
    params = tree_map(lambda t: t.to(device), params)
    opt_state = init(params) if opt_state is None \
        else tree_map(lambda t: t.to(device), opt_state)
    train_step = make_train_step(cfg, tcfg)

    history = []
    it = source.iterate(start=start_step)
    t0 = time.time()
    step = start_step - 1
    for step in range(start_step, steps):
        _, np_batch = next(it)
        batch = {k: torch.as_tensor(v).to(device) for k, v in np_batch.items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            history.append((step, {k: float(v) for k, v in metrics.items()}))
        if guard is not None and guard.should_stop:
            if on_checkpoint:
                on_checkpoint(step + 1, params, opt_state)
            break
        if on_checkpoint and (step + 1) % tcfg.checkpoint_every == 0:
            on_checkpoint(step + 1, params, opt_state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return params, opt_state, {"history": history, "wall_s": time.time() - t0,
                               "steps_done": step + 1 - start_step}
