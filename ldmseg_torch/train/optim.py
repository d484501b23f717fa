"""Optimizers and learning-rate schedules (counterpart of
``ldmseg_tpu/train/optim.py``, whose optax chain this mirrors):

    clip_by_global_norm -> adam / sgd momentum -> decoupled weight decay
    (per-parameter values for norm and bias parameters) -> per-parameter lr
    factor -> the scheduled learning rate.

The schedule is read at the optimizer's step count before the increment, as
optax's ``scale_by_schedule`` does, so the first update uses ``schedule(0)``.
Adam and AdamW are ``torch.optim.AdamW`` (``scale_by_adam``'s arithmetic,
eps 1e-8) with one parameter group per (lr factor, weight decay); SGD is
``torch.optim.SGD`` with the decay applied beside it, decoupled from the
momentum as optax adds it after ``trace``. Adafactor is
:class:`FactoredRMS`, optax's ``scale_by_factored_rms`` at its defaults
(the JAX chain's :143-146), followed by the same decoupled decay.
Parameter names are the port's ``named_parameters`` keys (the diffusers
names).

ZeRO-1 (``zero1`` on a mesh of more than one data rank, or of one rank in
an initialised group): each data rank keeps the optimizer state of the
parameters it owns (``parallel/mesh.py:zero1_partition``, whole parameters)
and steps only those; then each owner broadcasts its updated parameters,
so every rank holds the same masters. Clipping reads every gradient, which
every rank holds after the reduction. :meth:`Optimizer.state_dict` is then
collective and returns the one-rank layout on data rank 0 alone, and
:meth:`Optimizer.load_state_dict_` takes that layout for any partition.

Tensor parallelism (``sharded``, the names of the parameters that hold this
model rank's shard, ``parallel/tp.py``): the global norm of the clip adds
the sharded gradients' squares over the model group and counts each
replicated parameter once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..parallel.mesh import broadcast_tensors, zero1_partition

NORM_KEYS = ("norm", "group_norm", "layer_norm", "ln", "groupnorm")
Schedule = Callable[[int], float]


def is_norm_param(name: str) -> bool:
    """A parameter of a norm layer: some module on its path is named
    *norm* / *ln* (the JAX package's heuristic, on dotted names)."""
    parts = name.lower().split(".")
    return any(any(nk == p or p.endswith("_" + nk) or p.startswith(nk)
                   for nk in NORM_KEYS) for p in parts[:-1])


def norm_param_names(module: torch.nn.Module) -> set:
    """The names of ``module``'s norm layers' parameters, by the layers'
    types (the reference's ``isinstance(module, norm_types)``,
    optim.py:184-195), for models whose Sequential indices name a norm
    layer without *norm* (the seg VAE's; JAX names them ``norm``)."""
    from ..models.layers import GroupNorm, LayerNorm
    kinds = (GroupNorm, LayerNorm, torch.nn.GroupNorm, torch.nn.LayerNorm,
             torch.nn.modules.batchnorm._BatchNorm)
    return {f"{mn}.{pn}" if mn else pn
            for mn, m in module.named_modules() if isinstance(m, kinds)
            for pn, _ in m.named_parameters(recurse=False)}


def is_bias_param(name: str) -> bool:
    return name.lower().endswith("bias")


def freeze_filter(layers: Tuple[str, ...] = ("norm", "time_embedding")
                  ) -> Callable[[str], bool]:
    """Predicate on parameter names, the port's ``freeze_layers``
    (``ldmseg_tpu/models/unet.py:freeze_filter``): True where the update
    must be zero. The trainer gives those parameters lr factor 0. The
    ``conv_in`` and ``down_blocks`` entries select the image branch of
    ``separate_encoder``: ``conv_in_img`` and ``down_blocks_img``
    (unet.py:1113-1116)."""

    def fn(name: str) -> bool:
        return any((layer == "norm" and is_norm_param(name))
                   or (layer == "time_embedding"
                       and "time_embedding" in name.lower())
                   or (layer == "conv_in" and "conv_in_img" in name)
                   or (layer == "down_blocks" and "down_blocks_img" in name)
                   for layer in layers)

    return fn


def make_lr_schedule(name: Optional[str], base_lr: float, total_steps: int,
                     warmup_iters: int = 200, final_lr: float = 1e-6,
                     step_size: Optional[int] = None,
                     gamma: float = 0.1) -> Schedule:
    """``step -> lr``: 'warmup' (linear over ``warmup_iters``, then
    constant), 'cosine' (warmup, then cosine to ``final_lr``), 'step'
    (warmup, then x ``gamma`` every ``step_size``), 'none' (constant)."""

    def warm(step: int) -> float:
        return base_lr * min(step + 1, warmup_iters) / warmup_iters

    if name in (None, "none"):
        return lambda step: base_lr
    if name == "warmup":
        return lambda step: warm(step) if step < warmup_iters else base_lr
    if name == "cosine":
        def cosine(step: int) -> float:
            if step < warmup_iters:
                return warm(step)
            t = min(max((step - warmup_iters)
                        / max(total_steps - warmup_iters, 1), 0.0), 1.0)
            return final_lr + 0.5 * (base_lr - final_lr) * (
                1.0 + math.cos(math.pi * t))
        return cosine
    if name == "step":
        if step_size is None:
            raise ValueError("lr schedule 'step' needs step_size")
        return lambda step: (warm(step) if step < warmup_iters else
                             base_lr * gamma ** math.floor(step / step_size))
    raise NotImplementedError(f"lr schedule {name!r}")


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax ``_factored_dims``: the (second largest, largest) axes when the
    second largest has at least ``min_dim_size_to_factor`` entries, else
    None. The factored update is symmetric in the pair, so the port's
    layouts (``[out, in, kh, kw]``, ``[out, in]``) give the same update as
    JAX's (``[kh, kw, in, out]``, ``[in, out]``), which pick the same two
    axes."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class FactoredRMS:
    """optax ``scale_by_factored_rms()`` at its defaults (Adafactor's
    second moments, no first moment, no update clipping): decay
    ``1 - (t + 1)^-0.8`` at step count t, epsilon 1e-30 added to the
    squared gradient, row and column moments for a parameter whose second
    largest axis has 128 entries or more, the full moment below. Its state
    (``v_row``, ``v_col``, ``v`` per parameter) is made at the first
    step, for the parameters of ``owned`` (their indices; all when
    None)."""

    def __init__(self, params: List[torch.nn.Parameter],
                 decay_rate: float = 0.8, epsilon: float = 1e-30,
                 min_dim_size_to_factor: int = 128,
                 owned: Optional[set] = None):
        self.params = params
        self.owned = owned
        self.decay_rate = decay_rate
        self.epsilon = epsilon
        self.min_dim = min_dim_size_to_factor
        self.state: Dict[int, Dict[str, torch.Tensor]] = {}

    def _init(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        dims = factored_dims(p.shape, self.min_dim)
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        shape = list(p.shape)
        return {"v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
                "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:])}

    @torch.no_grad()
    def updates(self, count: int) -> List[Optional[torch.Tensor]]:
        """The scaled gradients at step ``count`` (a parameter without a
        gradient counts as a zero one, as optax sees it; None for one not
        owned)."""
        t = torch.tensor(count + 1, dtype=torch.float32)
        beta = float(1.0 - t ** (-self.decay_rate))
        out: List[Optional[torch.Tensor]] = []
        for i, p in enumerate(self.params):
            if self.owned is not None and i not in self.owned:
                out.append(None)
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            st = self.state.setdefault(i, self._init(p))
            gsq = g * g + self.epsilon
            dims = factored_dims(p.shape, self.min_dim)
            if dims is None:
                st["v"].mul_(beta).add_(gsq, alpha=1.0 - beta)
                out.append(g * st["v"].rsqrt())
                continue
            d1, d0 = dims
            st["v_row"].mul_(beta).add_(gsq.mean(d0), alpha=1.0 - beta)
            st["v_col"].mul_(beta).add_(gsq.mean(d1), alpha=1.0 - beta)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row = (st["v_row"] / st["v_row"].mean(reduced_d1, keepdim=True)
                   ).rsqrt()
            out.append(g * row.unsqueeze(d0)
                       * st["v_col"].rsqrt().unsqueeze(d1))
        return out


class Optimizer:
    """The JAX package's optimizer chain on a list of named parameters.
    :meth:`step` reads each parameter's ``.grad``. With ``zero1`` and a
    ``mesh`` (``parallel/mesh.py:Mesh``) whose data group is set, the state
    is partitioned over its data ranks (the module docstring).
    ``norm_names`` adds parameters that count as a norm layer's to those
    :func:`is_norm_param` finds by name (:func:`norm_param_names`).
    ``sharded`` names the parameters that hold a shard over the mesh's
    model axis (tensor parallelism)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 name: str = "adamw",
                 learning_rate: Union[float, Schedule] = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 weight_decay: float = 0.0,
                 weight_decay_norm: Optional[float] = None,
                 weight_decay_bias: Optional[float] = None,
                 clip_grad: float = 0.0,
                 lr_factor_fn: Optional[Callable[[str], float]] = None,
                 momentum: float = 0.9, mesh=None, zero1: bool = False,
                 norm_names: frozenset = frozenset(),
                 sharded: frozenset = frozenset()):
        if name not in ("adamw", "adam", "sgd", "adafactor"):
            raise NotImplementedError(f"optimizer {name!r}")
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda step: learning_rate))
        self.clip_grad = clip_grad
        self.count = 0
        self.model_group = (mesh.model_group if sharded and mesh is not None
                            else None)
        # adam takes no weight decay in the JAX chain; sgd only when asked
        decays = name in ("adamw", "adafactor") or (name == "sgd"
                                                   and weight_decay)

        def decay(n: str) -> float:
            if not decays:
                return 0.0
            if (n in norm_names or is_norm_param(n)) and \
                    weight_decay_norm is not None:
                return weight_decay_norm
            if is_bias_param(n) and weight_decay_bias is not None:
                return weight_decay_bias
            return weight_decay

        groups: Dict[Tuple[float, float], List[torch.nn.Parameter]] = {}
        self.params: List[torch.nn.Parameter] = []
        self.sharded: List[bool] = []
        for n, p in named_params:
            factor = 1.0 if lr_factor_fn is None else float(lr_factor_fn(n))
            groups.setdefault((factor, decay(n)), []).append(p)
            self.params.append(p)
            self.sharded.append(n in sharded)
        param_groups = [{"params": ps, "lr_factor": f, "weight_decay": wd}
                        for (f, wd), ps in groups.items()]
        # the one-rank state layout indexes this grouped order
        self.grouped = [p for g in param_groups for p in g["params"]]
        self.group_sizes = [len(g["params"]) for g in param_groups]
        self.zero_group, self.owner = None, None
        if zero1 and mesh is not None and mesh.data_group is not None:
            self.zero_group, self.zero_rank = mesh.data_group, mesh.data_rank
            self.owner = zero1_partition(self.grouped, mesh.data)
            mine = {id(p) for p, o in zip(self.grouped, self.owner)
                    if o == self.zero_rank}
            param_groups = [dict(g, params=[p for p in g["params"]
                                            if id(p) in mine])
                            for g in param_groups]
        self.momentum = momentum
        self.factored = None
        if name == "adafactor":
            self._sgd_decay = []
            self.torch_opt = None
            self.param_groups = param_groups
            self.factored = FactoredRMS(
                self.grouped, owned=None if self.owner is None else {
                    i for i, o in enumerate(self.owner)
                    if o == self.zero_rank})
        elif name == "sgd":
            self._sgd_decay = [(g["params"], g["lr_factor"], g["weight_decay"])
                               for g in param_groups
                               if g["weight_decay"] and g["params"]]
            for g in param_groups:
                g["weight_decay"] = 0.0
            self.torch_opt = torch.optim.SGD(param_groups, lr=0.0,
                                             momentum=momentum)
        else:
            self._sgd_decay = []
            self.torch_opt = torch.optim.AdamW(param_groups, lr=0.0,
                                               betas=tuple(betas), eps=1e-8)

    @torch.no_grad()
    def clip_(self) -> None:
        """optax ``clip_by_global_norm``: scale every gradient by
        ``clip / norm`` when the global norm reaches ``clip``."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.model_group is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        else:
            # a shard's squares summed over the model group, a replicated
            # gradient (the same on every model rank) counted once
            def squares(shard: bool) -> torch.Tensor:
                part = [p.grad for p, s in zip(self.params, self.sharded)
                        if s == shard and p.grad is not None]
                if not part:
                    return grads[0].new_zeros((), dtype=torch.float32)
                return torch.stack(torch._foreach_norm(part)).float() \
                    .square().sum()
            sharded = squares(True)
            dist.all_reduce(sharded, group=self.model_group)
            norm = (sharded + squares(False)).sqrt()
        factor = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                             self.clip_grad / norm)
        torch._foreach_mul_(grads, factor)

    @torch.no_grad()
    def step(self) -> None:
        lr = float(self.schedule(self.count))
        if self.clip_grad and self.clip_grad > 0:
            self.clip_()
        if self.factored is not None:
            self._factored_step(lr)
            self.count += 1
            return
        for params, factor, wd in self._sgd_decay:
            torch._foreach_mul_(params, 1.0 - lr * factor * wd)
        for g in self.torch_opt.param_groups:
            g["lr"] = lr * g["lr_factor"]
        self.torch_opt.step()
        self.count += 1
        self._share_owned()

    def _factored_step(self, lr: float) -> None:
        """Adafactor: ``p -= lr * factor * (u + wd * p)`` with ``u`` the
        factored-RMS update, in the JAX chain's order."""
        updates = dict(zip(map(id, self.grouped),
                           self.factored.updates(self.count)))
        for g in self.param_groups:
            for p in g["params"]:
                u = updates[id(p)]
                if g["weight_decay"]:
                    u = u + g["weight_decay"] * p
                p.sub_(u, alpha=lr * g["lr_factor"])
        self._share_owned()

    def _share_owned(self) -> None:
        """ZeRO-1: each owner's updated parameters to every data rank."""
        if self.owner is None:
            return
        for r in range(dist.get_world_size(self.zero_group)):
            broadcast_tensors(
                [p for p, o in zip(self.grouped, self.owner) if o == r],
                dist.get_global_rank(self.zero_group, r), self.zero_group)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_bytes(self) -> int:
        """Bytes of the optimizer state this rank holds."""
        states = (self.factored.state.values() if self.factored is not None
                  else self.torch_opt.state.values())
        return sum(v.numel() * v.element_size() for st in states
                   for v in st.values() if isinstance(v, torch.Tensor))

    def _local_state(self) -> Dict[int, dict]:
        """This rank's state by index in the grouped order."""
        if self.factored is not None:
            return dict(self.factored.state)
        index = {id(p): i for i, p in enumerate(self.grouped)}
        return {index[id(p)]: st for p, st in self.torch_opt.state.items()}

    def _gathered_state(self) -> Optional[Dict[int, dict]]:
        """ZeRO-1: every owner's state on data rank 0, owner by owner (its
        tensors in flat buckets, its host values with the layout), the
        tensors on the CPU. The other ranks join the broadcasts, keep
        nothing of them and return None."""
        from ..parallel.multihost import broadcast_host
        local, out = self._local_state(), {}
        keep = self.zero_rank == 0
        dev = self.grouped[0].device
        for r in range(dist.get_world_size(self.zero_group)):
            src = dist.get_global_rank(self.zero_group, r)
            layout = None
            if r == self.zero_rank:
                layout = {i: {k: (("t", tuple(v.shape), v.dtype)
                                  if isinstance(v, torch.Tensor)
                                  and v.device == dev else ("v", v))
                              for k, v in st.items()}
                          for i, st in local.items()}
            layout = broadcast_host(layout, src, self.zero_group)
            slots = [(i, k, local[i][k] if r == self.zero_rank
                      else torch.empty(d[1], dtype=d[2], device=dev))
                     for i, st in sorted(layout.items())
                     for k, d in st.items() if d[0] == "t"]
            broadcast_tensors([t for _, _, t in slots], src,
                              self.zero_group)
            if not keep:
                continue
            for i, st in layout.items():
                out[i] = {k: d[1] for k, d in st.items() if d[0] == "v"}
            for i, k, t in slots:
                out[i][k] = t.detach().cpu()
        return {i: out[i] for i in sorted(out)} if keep else None

    def state_dict(self) -> Optional[dict]:
        """``{"count", "torch"}``: the step count and the torch optimizer's
        state dict in its own layout (state by index in the grouped order,
        param_groups with index lists), its tensors copied to the CPU
        (Adafactor: ``{"count", "factored"}``, its moments by parameter
        index). Under ZeRO-1 it is collective: data rank 0 (the main
        process, which writes checkpoints) returns the one-rank dict, every
        other rank None."""
        if self.owner is not None:
            state = self._gathered_state()
            if state is None:
                return None
        else:
            state = {i: {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                             else v) for k, v in st.items()}
                     for i, st in sorted(self._local_state().items())}
        if self.factored is not None:
            return {"count": self.count, "factored": state}
        groups, start = [], 0
        for g, n in zip(self.torch_opt.param_groups, self.group_sizes):
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": list(range(start, start + n))})
            start += n
        return {"count": self.count,
                "torch": {"state": state, "param_groups": groups}}

    @torch.no_grad()
    def load_state_dict_(self, sd: dict) -> None:
        """Restore :meth:`state_dict` in place: each tensor the optimizer
        already holds is ``copy_``'d into, one it lacks is made on its
        parameter's device (``step`` where torch keeps it, on the CPU), so
        the state is never held twice on the device. Under ZeRO-1 each rank
        takes the entries of the parameters it owns, whatever partition
        wrote them."""
        def mine(i: int) -> bool:
            return self.owner is None or self.owner[i] == self.zero_rank

        if self.factored is not None:
            for i, st in sd["factored"].items():
                if not mine(int(i)):
                    continue
                p = self.factored.params[int(i)]
                live = self.factored.state.setdefault(
                    int(i), self.factored._init(p))
                for k, v in st.items():
                    live[k].copy_(v)
            self.count = int(sd["count"])
            return
        saved = sd["torch"]
        if [len(g["params"]) for g in saved["param_groups"]] != \
                self.group_sizes:
            raise ValueError("optimizer state of another parameter grouping")
        for i, p in enumerate(self.grouped):
            if not mine(i):
                continue
            live = self.torch_opt.state[p]
            for k, v in saved["state"].get(i, {}).items():
                cur = live.get(k)
                if not isinstance(v, torch.Tensor):
                    live[k] = v
                elif isinstance(cur, torch.Tensor) and cur.shape == v.shape:
                    cur.copy_(v)
                else:
                    live[k] = v.clone() if k == "step" else v.to(p.device)
        self.count = int(sd["count"])
