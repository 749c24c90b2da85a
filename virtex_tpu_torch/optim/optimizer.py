r"""
The optimizer chain, over a model's named parameters.

Counterpart of ``virtex_tpu/optim/optimizer.py``: one update applies, in
order,

    clip by global norm → SGD (decay coupled before momentum, no nesterov)
    or AdamW (decay after the adaptive scaling), decay masked by the
    NO_DECAY regex → −LR × schedule(step), with CNN_LR for parameters whose
    name holds "cnn" → zero for ``frozen_pattern`` → Lookahead

as the JAX package's optax chain does. Lookahead keeps the slow weights in
the optimizer's state: every ``k``-th update lands the parameters on
``slow + α·(fast_next − slow)`` and refreshes the slow copy, so the model
holds plain parameters throughout.

Names: the NO_DECAY regex, the "cnn" group and ``frozen_pattern`` match
each parameter's name in the JAX package's dotted form
(:func:`virtex_tpu_torch.utils.weights.flax_name_map`), so the masks are the
JAX package's, parameter for parameter. Each tied or shared parameter is
one entry (``named_parameters()`` yields it once), so it is clipped,
decayed and stepped once. The schedule and the Lookahead sync depend only
on the step count, a host integer, so an update makes no device round
trip; it updates the parameters in place under ``no_grad``.

Under tensor parallelism (a ``mesh`` with ``model`` > 1) the split
parameters are this rank's shards: every step but the clip is elementwise
and runs on them as they are; the clip's global norm sums the split
parameters' squares over the model group and counts the replicated ones
once, so it is the whole model's norm, and :meth:`Optimizer.state_dict`
gathers the split state to full tensors.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from virtex_tpu_torch.config import OptimSpec
from virtex_tpu_torch.optim.lr_schedules import Schedule, make_schedule
from virtex_tpu_torch.parallel.mesh import (
    Mesh,
    gather_tensor,
    shard_tensor,
    tp_split,
)
from virtex_tpu_torch.utils.distributed import all_reduce_sum
from virtex_tpu_torch.utils.tracing import span
from virtex_tpu_torch.utils.weights import flax_name_map

NO_DECAY = r".*textual.(embedding|transformer).*(norm.*|bias)"
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam


def _match(names: List[str], test) -> bool:
    """``test`` on a parameter's JAX name(s); the three names of a packed
    projection must agree."""
    hits = {bool(test(n)) for n in names}
    if len(hits) != 1:
        raise ValueError(f"a pattern splits the packed parameter {names}")
    return hits.pop()


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]],
               no_decay_pattern: str = NO_DECAY) -> Dict[str, bool]:
    """True where weight decay applies: the JAX name does not match
    ``no_decay_pattern`` (``re.match``)."""
    return {name: not _match(jax_names,
                             lambda n: re.match(no_decay_pattern, n))
            for name, jax_names in flax_name_map(
                n for n, _ in named_params).items()}


def cnn_mask(named_params: Iterable[Tuple[str, torch.Tensor]]
             ) -> Dict[str, bool]:
    """True for the visual backbone's parameters (name holds "cnn")."""
    return {name: _match(jax_names, lambda n: "cnn" in n)
            for name, jax_names in flax_name_map(
                n for n, _ in named_params).items()}


class Optimizer:
    """The chain above. :meth:`step` reads each parameter's ``.grad`` (None
    counts as zeros), updates the parameters and returns the global norm of
    the gradients before clipping."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 optimizer_name: str = "sgd",
                 schedule: Optional[Schedule] = None, lr: float = 0.001,
                 cnn_lr: float = 0.2, weight_decay: float = 1e-4,
                 no_decay_pattern: str = NO_DECAY, momentum: float = 0.9,
                 clip_norm: float = 10.0, use_lookahead: bool = True,
                 lookahead_k: int = 5, lookahead_alpha: float = 0.5,
                 frozen_pattern: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        if optimizer_name not in ("sgd", "adamw"):
            raise ValueError(f"Unknown optimizer {optimizer_name!r}")
        named = list(named_params)
        if len({id(p) for _, p in named}) != len(named):
            raise ValueError("a parameter appears twice: pass "
                             "model.named_parameters(), which yields each "
                             "tied parameter once")
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optimizer_name = optimizer_name
        self.schedule = schedule or (lambda step: 1.0)
        self.weight_decay, self.momentum = weight_decay, momentum
        self.clip_norm = clip_norm
        self.lookahead_k, self.lookahead_alpha = lookahead_k, lookahead_alpha
        decay = decay_mask(named, no_decay_pattern)
        cnn = cnn_mask(named)
        jax_names = flax_name_map(self.names)
        frozen = {n: frozen_pattern is not None and _match(
            jax_names[n], lambda m: re.search(frozen_pattern, m))
            for n in self.names}
        self._decay = [i for i, n in enumerate(self.names) if decay[n]]
        self._frozen = [i for i, n in enumerate(self.names) if frozen[n]]
        self._lrs = [cnn_lr if cnn[n] else lr for n in self.names]
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        if self.mesh is not None:  # the clip's index sets, on the device
            split = [tp_split(n) is not None for n in self.names]
            self._split, self._whole = (torch.tensor(
                [i for i, s in enumerate(split) if s == want],
                dtype=torch.long, device=self.params[0].device)
                for want in (True, False))
        # State: the step count of the LR scale, the momentum trace or the
        # Adam moments, and the Lookahead slow weights and count.
        self.step_count = 0
        zeros = [torch.zeros_like(p, memory_format=torch.preserve_format)
                 for p in self.params]
        if optimizer_name == "sgd":
            self.trace = zeros
        else:
            self.mu = zeros
            self.nu = [torch.zeros_like(z) for z in zeros]
            self.adam_count = 0
        self.slow = ([p.detach().clone() for p in self.params]
                     if use_lookahead else None)
        self.lookahead_count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        with span("optimizer", self.params[0]):
            return self._step()

    def _step(self) -> torch.Tensor:
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norms = torch.stack(torch._foreach_norm(grads))
        if self.mesh is None:
            norm = torch.linalg.vector_norm(norms)
        else:  # the split parameters' squares summed over the shards
            squares = norms.square()
            split = all_reduce_sum(squares[self._split].sum(), "grad_norm",
                                   self.mesh.model_group)
            norm = torch.sqrt(split + squares[self._whole].sum())
        coef = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
        u = torch._foreach_mul(grads, coef)
        pick = lambda xs, idx: [xs[i] for i in idx]  # noqa: E731
        if self.optimizer_name == "sgd":
            if self._decay:  # decay coupled into the gradient
                torch._foreach_add_(pick(u, self._decay),
                                    pick(params, self._decay),
                                    alpha=self.weight_decay)
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, u)
            u = self.trace
        else:
            self.adam_count += 1
            t = self.adam_count
            torch._foreach_mul_(self.mu, ADAM_B1)
            torch._foreach_add_(self.mu, u, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(self.nu, ADAM_B2)
            torch._foreach_addcmul_(self.nu, u, u, value=1.0 - ADAM_B2)
            mu_hat = torch._foreach_div(self.mu, 1.0 - ADAM_B1 ** t)
            nu_hat = torch._foreach_div(self.nu, 1.0 - ADAM_B2 ** t)
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, ADAM_EPS)
            u = torch._foreach_div(mu_hat, nu_hat)
            if self._decay:  # decoupled decay, after the adaptive scaling
                torch._foreach_add_(pick(u, self._decay),
                                    pick(params, self._decay),
                                    alpha=self.weight_decay)
        mult = self.schedule(self.step_count)
        self.step_count += 1
        # The LR scale makes new tensors, so the trace is never rewritten.
        u = torch._foreach_mul(u, [-lr * mult for lr in self._lrs])
        for i in self._frozen:
            u[i].zero_()
        if self.slow is not None:
            self.lookahead_count += 1
            if self.lookahead_count % self.lookahead_k == 0:
                # target = slow + α·((p + u) − slow); the update lands p on
                # it, and it becomes the new slow copy.
                fast = torch._foreach_add(params, u)
                torch._foreach_lerp_(self.slow, fast, self.lookahead_alpha)
                u = torch._foreach_sub(self.slow, params)
        torch._foreach_add_(params, u)
        return norm

    # -- state -----------------------------------------------------------------
    def lookahead_slow_params(self) -> Dict[str, torch.Tensor]:
        """The Lookahead slow weights by parameter name, or the parameters
        themselves when the chain has no Lookahead (the counterpart of
        ``virtex_tpu.optim.optimizer.lookahead_slow_params``; downstream
        evaluation reads the slow weights)."""
        return dict(zip(self.names, self.slow if self.slow is not None
                        else self.params))

    def _buffers(self) -> Dict[str, List[torch.Tensor]]:
        out = {"trace": self.trace} if self.optimizer_name == "sgd" else {
            "mu": self.mu, "nu": self.nu}
        if self.slow is not None:
            out["slow"] = self.slow
        return out

    def state_dict(self) -> Dict[str, object]:
        """The step count, the momentum trace or the Adam moments and
        count, and the Lookahead slow weights and count, each tensor keyed
        by its parameter's name. The tensors are the live state, not
        copies; under tensor parallelism the split ones are gathered to
        full tensors (every rank of the model group calls this)."""
        state: Dict[str, object] = {
            "optimizer_name": self.optimizer_name,
            "step_count": self.step_count,
            "lookahead_count": self.lookahead_count}
        if self.optimizer_name == "adamw":
            state["adam_count"] = self.adam_count
        for key, tensors in self._buffers().items():
            if self.mesh is not None:
                tensors = [gather_tensor(n, t, self.mesh)
                           for n, t in zip(self.names, tensors)]
            state[key] = dict(zip(self.names, tensors))
        return state

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy a :meth:`state_dict` into this optimizer's state in place.
        The optimizer, the Lookahead choice and the parameter names must
        match. Under tensor parallelism the state holds full tensors and
        this rank keeps its shards."""
        if state["optimizer_name"] != self.optimizer_name:
            raise ValueError(f"state of {state['optimizer_name']!r}, "
                             f"optimizer is {self.optimizer_name!r}")
        buffers = self._buffers()
        keys = {k for k in state if isinstance(state[k], dict)}
        if keys != set(buffers):
            raise ValueError(f"state holds {sorted(keys)}, optimizer "
                             f"needs {sorted(buffers)}")
        for key, tensors in buffers.items():
            saved = state[key]
            if set(saved) != set(self.names):
                missing = sorted(set(self.names) - set(saved))[:3]
                extra = sorted(set(saved) - set(self.names))[:3]
                raise ValueError(f"{key}: parameter names differ (missing "
                                 f"{missing}, unexpected {extra})")
            for name, t in zip(self.names, tensors):
                t.copy_(saved[name] if self.mesh is None
                        else shard_tensor(name, saved[name], self.mesh))
        self.step_count = int(state["step_count"])
        self.lookahead_count = int(state["lookahead_count"])
        if self.optimizer_name == "adamw":
            self.adam_count = int(state["adam_count"])


def build_optimizer(named_params, spec: OptimSpec,
                    visual_frozen: bool = False,
                    mesh: Optional[Mesh] = None) -> Optimizer:
    """The chain that ``OPTIM.*`` describes, as the JAX package's
    ``OptimizerFactory.from_config`` builds it: the LR schedule from
    ``LR_DECAY_NAME`` and a frozen visual backbone stepped by zero;
    ``mesh`` for a model sharded by ``parallel.shard_module_``."""
    schedule = make_schedule(spec.lr_decay_name, spec.num_iterations,
                             spec.warmup_steps, spec.lr_steps, spec.lr_gamma)
    return Optimizer(
        named_params, spec.optimizer_name, schedule, lr=spec.lr,
        cnn_lr=spec.cnn_lr, weight_decay=spec.weight_decay,
        no_decay_pattern=spec.no_decay, momentum=spec.sgd_momentum,
        clip_norm=spec.clip_grad_norm, use_lookahead=spec.lookahead_use,
        lookahead_k=spec.lookahead_steps,
        lookahead_alpha=spec.lookahead_alpha,
        frozen_pattern="cnn" if visual_frozen else None, mesh=mesh)
