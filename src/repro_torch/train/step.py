"""The functional train step.

Port of ``repro.train.step``. ``make_train_step(model, opt_cfg)`` returns
``step(state, batch) -> (new_state, metrics)`` where
``state = {"params": {name: t}, "opt": {m, v, master, count}, "step": int32 []}``
and the parameter names are the model's ``named_parameters`` names. The
step is a function of its inputs: the parameters go into the model through
``torch.func.functional_call`` and nothing is updated in place, so the same
step is timed on the card and traced by ``make_fx`` on fake tensors
(``repro_torch.core.profiler``).

Attention and the SSD scan run plain inside the step, as the reference
trains on its XLA path (their kernels have no backward and refuse inputs
that autograd tracks); RMSNorm keeps its impl, so on the card its forward
and backward kernels run. Optional gradient accumulation runs microbatches
in a loop, the gradients averaged in fp32 (the reference scans them).

``state_from_jax`` carries a reference checkpoint's arrays into the port's
state, so a run can continue from the JAX package's ``Trainer`` without
replaying ``jax.random``.

On a mesh, ``state_shardings`` / ``batch_shardings`` / ``metric_shardings``
give the reference's layouts (parameters by the sharding rules, optimizer
moments and master additionally over the data axes under ZeRO-1) and
``distribute_state`` lays a state out as DTensors. The same step then runs
on DTensor leaves: ``functional_call`` and ``autograd.grad`` take them, and
DTensor redistributes wherever two operands' layouts differ (a ZeRO moment
against its gradient), as GSPMD does. Tensors the model makes for itself
(positions, masks) count as replicated there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.distributed import sharding as shd
from repro_torch.distributed import zero as zero_lib
from repro_torch.models.api import use_impls
from repro_torch.models.module import params_from_jax, unstack_layers
from repro_torch.train import optimizer as opt_lib


class _LossAndGrads(nn.Module):
    """The model's loss and its gradients in one module call, so that the
    remat recompute, which runs inside ``autograd.grad``, sees the same
    parameters as the forward pass did."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, leaves, batch):
        loss, metrics = self.model.loss(batch)
        # a parameter the loss does not read (whisper's encoder: no decoder
        # layer attends to it) gets a zero gradient, as under jax.grad
        return loss, metrics, torch.autograd.grad(loss, leaves, allow_unused=True,
                                                  materialize_grads=True)


def make_train_step(model, opt_cfg: opt_lib.OptConfig, accum: int = 1):
    loss_and_grads = _LossAndGrads(model)

    def grad_fn(params, batch):
        leaves = {f"model.{k}": v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad(), use_impls(attention="plain", ssd="plain"):
            loss, metrics, grads = functional_call(loss_and_grads, leaves,
                                                   (list(leaves.values()), batch))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def compute_grads(params, batch):
        with shd.replicate_plain_tensors(next(iter(params.values()))):
            return _compute_grads(params, batch)

    def _compute_grads(params, batch):
        if accum <= 1:
            return grad_fn(params, batch)
        # the sum starts from the first microbatch's share (the reference
        # adds it to zeros: the same values), so it takes the gradients'
        # layout on a mesh, where zeros made here would be whole parameters
        # on every rank
        acc = None
        for i in range(accum):
            loss, _, grads = grad_fn(params, {k: _microbatch(v, i, accum)
                                              for k, v in batch.items()})
            share = {k: g.float() / accum for k, g in grads.items()}
            acc = share if acc is None else {k: a + share[k] for k, a in acc.items()}
        return loss, {"loss": loss}, acc  # the last microbatch's loss, as the reference

    @torch.no_grad()
    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        with shd.replicate_plain_tensors(state["step"]):
            loss, metrics, grads = compute_grads(state["params"], batch)
            grads = _reduced_into(grads, state["opt"]["m"])
            new_params, new_opt, opt_metrics = opt_lib.apply_updates(
                opt_cfg, state["params"], grads, state["opt"])
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return _laid_out_like(new_state, state), metrics

    train_step.compute_grads = compute_grads  # (params, batch) -> (loss, metrics, grads)
    return train_step


def _microbatch(v, i: int, accum: int):
    """Microbatch ``i`` of ``accum``: a contiguous block of rows, as the
    reference splits the batch. On a mesh it is laid out as the whole batch
    as far as its rows split evenly (DTensor moves the block's rows to the
    ranks that hold them; ``_block_layout``)."""
    n = v.shape[0] // accum
    block = v[i * n:(i + 1) * n]
    pls = _block_layout(v, n)
    if pls is None or tuple(block.placements) == pls:
        return block
    return block.redistribute(block.device_mesh, pls)


def _block_layout(v, rows: int):
    """The placements of a block of ``rows`` rows of the DTensor ``v``: its
    row split kept on the leading mesh dims over which the block's rows
    still split evenly (``sharding.even_axes``), and held whole on the rest
    (a block of 8 rows of a batch split over (4, 4) ranks is split over the
    first 4), as the model's sharder lays a microbatch's activations out.
    DTensor splits an uneven dim as ``torch.chunk`` does, and its views of
    such a dim take the wrong local shapes. None for a plain tensor."""
    from torch.distributed.tensor import Replicate

    pls = getattr(v, "placements", None)
    if pls is None:
        return None
    mesh = v.device_mesh
    names = mesh.mesh_dim_names
    split = [names[i] for i, p in enumerate(pls) if p.is_shard() and p.dim % v.ndim == 0]
    keep = shd.even_axes(tuple(split), rows, mesh)
    return tuple(Replicate() if p.is_shard() and p.dim % v.ndim == 0 and names[i] not in keep
                 else p for i, p in enumerate(pls))


def _reduced_into(grads, moments):
    """Each DTensor gradient left partial over a mesh dim (the sum of the
    ranks' parts: a weight a per-shard region reads as it is stored, such
    as experts split over ``model`` while the rows split over ``data``)
    reduced once, into its moment's layout (its ZeRO shard), where the
    optimizer reads it; DTensor would reduce it again at each use (the
    norm, each moment, the master)."""
    out = {}
    for k, g in grads.items():
        pls = getattr(g, "placements", None)
        if pls is not None and any(p.is_partial() for p in pls):
            g = g.redistribute(g.device_mesh, moments[k].placements)
        out[k] = g
    return out


def _laid_out_like(new, old):
    """Each DTensor leaf of ``new`` in its ``old`` leaf's layout: the state
    keeps its shardings from step to step (a moment left partial over the
    data axis is reduce-scattered into its ZeRO shard)."""
    if isinstance(new, dict):
        return {k: _laid_out_like(v, old[k]) for k, v in new.items()}
    pls = getattr(old, "placements", None)
    if pls is None or tuple(new.placements) == tuple(pls):
        return new
    return new.redistribute(new.device_mesh, pls)


def _params(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in model.named_parameters()}


def init_state(model, opt_cfg: opt_lib.OptConfig, generator: torch.Generator):
    """Initialise the model's parameters from ``generator`` and return the
    train state; its parameters share storage with the model's."""
    params = _params(model.init(generator))
    return {"params": params,
            "opt": opt_lib.init_opt_state(opt_cfg, params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def state_shapes(model, opt_cfg: opt_lib.OptConfig):
    """The train state as ``meta`` tensors (shapes and dtypes, no data)."""
    params = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in _params(model).items()}
    return {"params": params,
            "opt": opt_lib.opt_state_shapes(opt_cfg, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_from_jax(cfg, arrays: Dict[str, torch.Tensor]):
    """A reference checkpoint's arrays, keyed by their ``|``-joined tree paths
    as ``ckpt.checkpoint.read_arrays`` reads them (``params|...``,
    ``opt|m|...``, ``opt|v|...``, ``opt|master|...``, ``opt|count``,
    ``step``), as the port's train state on the CPU. The parameters take the
    model's dtypes (``params_from_jax``); the moments and the fp32 master
    keep the dtypes they were written in."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {"params": {}, "m": {}, "v": {}, "master": {}}
    for key, t in arrays.items():
        path = key.split("|")
        if path[0] == "params":
            groups["params"]["/".join(path[1:])] = t
        elif path[0] == "opt" and path[1] in groups:
            groups[path[1]]["/".join(path[2:])] = t

    def carry(name):
        flat = groups[name]
        if set(flat) != set(groups["params"]):
            raise KeyError(f"opt|{name} keys differ from the parameters': "
                           f"{sorted(set(flat) ^ set(groups['params']))[:5]}")
        return unstack_layers(flat, cfg)

    params = params_from_jax(cfg, {k: t.float().numpy() for k, t in groups["params"].items()})
    opt = {"m": carry("m"), "v": carry("v"),
           "master": carry("master") if groups["master"] else {},
           "count": arrays["opt|count"].to(torch.int32)}
    return {"params": params, "opt": opt, "step": arrays["step"].to(torch.int32)}


# ---------------------------------------------------------------------------
# Shardings on a mesh
# ---------------------------------------------------------------------------


def _has_master(model, opt_cfg) -> bool:
    return opt_cfg.keep_master and any(
        p.dtype != torch.float32 for p in model.parameters())


def state_shardings(model, opt_cfg: opt_lib.OptConfig, mesh,
                    rules: Optional[shd.ShardingRules] = None,
                    zero: bool = True, scheme: str = "sp",
                    fsdp_params: bool = False):
    """The train state's layout on ``mesh``: a tree of ``NamedSharding``
    parallel to ``init_state``'s."""
    rules = shd.scheme_rules(scheme, rules)
    axes = model.param_axes()
    shapes = _params(model)
    if scheme == "dp":
        axes = shd.fsdp_axes(axes, shapes, mesh)
    if fsdp_params:  # giant models: params also sharded over (pod, data)
        axes = zero_lib.zero_axes(axes, shapes, mesh, rules)
        rules = zero_lib.zero_rules(rules)
    p_sh = shd.tree_shardings(mesh, axes, shapes, rules)
    if zero:
        zrules = zero_lib.zero_rules(rules)
        zaxes = zero_lib.zero_axes(axes, shapes, mesh, rules)
        z_sh = shd.tree_shardings(mesh, zaxes, shapes, zrules)
    else:
        z_sh = p_sh
    repl = shd.replicated(mesh)
    master = dict(z_sh) if _has_master(model, opt_cfg) else {}
    return {
        "params": p_sh,
        "opt": {"m": z_sh, "v": dict(z_sh), "count": repl, "master": master},
        "step": repl,
    }


def batch_shardings(mesh, batch_shapes, rules: Optional[shd.ShardingRules] = None):
    """Each batch leaf sharded on its leading (batch) dim."""
    rules = rules or shd.ShardingRules()

    def leaf(x):
        shape = tuple(x.shape)
        axes = ("batch",) + (None,) * (len(shape) - 1)
        return shd.NamedSharding(mesh, shd.resolve_spec(axes, shape, mesh, rules))

    return {k: leaf(v) for k, v in batch_shapes.items()}


def metric_shardings(mesh, metrics_shape):
    repl = shd.replicated(mesh)
    return {k: repl for k in metrics_shape}


def distribute_state(state, shardings):
    """``state`` (whole tensors, alike on every rank) as DTensors laid out by
    ``shardings`` (``state_shardings``); each rank keeps a view of its part."""
    if isinstance(state, dict):
        return {k: distribute_state(v, shardings[k]) for k, v in state.items()}
    return shd.distribute(state, shardings)
