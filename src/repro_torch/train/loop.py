"""The training loop: a train step with microbatch accumulation, the
global-norm clip and the optimizer update, and a single-device driver
(the port of ``repro.train.loop``).

The reference's ``compile_train_step`` and ``_opt_shardings`` shard the
step over a mesh; they come with the port's multi-device work.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
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
        n = tcfg.microbatch
        if n and n > 1:
            grads, loss = None, 0.0
            for j in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[j]
                      for k, v in batch.items()}
                l, metrics, g = value_and_grad(params, cfg, mb)
                grads = tree_map(lambda g: g.float(), g) if grads is None \
                    else tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / n, grads)
            loss = loss / n
        else:
            loss, metrics, grads = value_and_grad(params, cfg, batch)
        grads, gnorm = opt.clip_by_global_norm(grads, tcfg.grad_clip)
        params, opt_state = update(params, grads, opt_state, tcfg)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


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
