"""Optimizers with optax's semantics, where ``torch.optim`` has none.

``make_optimizer`` (solvers/base.py) resolves a config name to optax's
transform with optax's defaults, as the JAX package does
(``intro_tc_vae_tpu/solvers/base.py:68-86``). Where a ``torch.optim``
class computes the same update with the same defaults once its arguments
are set (adam, adamw, adadelta, sgd), it is used; the four here differ
from torch's in their arithmetic or do not exist there:

* ``Adagrad`` (``optax.adagrad``, ``scale_by_rss``): the accumulator
  starts at 0.1 and eps 1e-7 sits inside the square root,
  g / sqrt(Σg² + eps); torch starts at 0 and adds eps 1e-10 outside.
* ``RMSprop`` (``optax.rmsprop``, ``scale_by_rms``): decay 0.9, eps 1e-8
  inside the square root, no bias correction; torch decays with 0.99 and
  adds eps outside.
* ``Lamb`` (``optax.lamb``): Adam's update (eps 1e-6; optax's weight
  decay is 0, so none is added), scaled per parameter tensor by the trust
  ratio ||p|| / ||u|| (1 where either norm is 0); the norms of a
  parameter sharded over the model axis are the whole tensor's, its
  slices' squares summed over the model group.
* ``Lion`` (``optax.lion``): sign((1 - b1) g + b1 m) plus decayed weights
  (1e-3), then m = (1 - b2) g + b2 m, b2 0.99.

Every update is p + (-lr) u, optax's ``scale_by_learning_rate`` and
``apply_updates``, with the terms in optax's order. The state is plain
tensors per parameter (and an int step), so ``state_dict`` and
``load_state_dict`` carry it through a checkpoint as they do torch's.
The learning rate is the only argument: nothing sets another of optax's
hyperparameters, which are the constants below.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8
LAMB_B1, LAMB_B2, LAMB_EPS = 0.9, 0.999, 1e-6
LION_B1, LION_B2, LION_WEIGHT_DECAY = 0.9, 0.99, 1e-3


class _Optax(torch.optim.Optimizer):
    """One update rule applied to every parameter with a gradient."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    def _update(self, p, g, state) -> torch.Tensor:
        raise NotImplementedError

    def _init(self, p) -> dict:
        return {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init(p))
                p.add_(self._update(p, p.grad, state), alpha=-group["lr"])
        return loss


class Adagrad(_Optax):
    def _init(self, p):
        return {"sum_of_squares": torch.full_like(p, ADAGRAD_INIT,
                                                  memory_format=torch.preserve_format)}

    def _update(self, p, g, state):
        s = state["sum_of_squares"]
        s.copy_(g * g + s)
        return torch.where(s > 0, torch.rsqrt(s + ADAGRAD_EPS), 0.0) * g


class RMSprop(_Optax):
    def _init(self, p):
        return {"nu": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, p, g, state):
        nu = state["nu"]
        nu.copy_((1.0 - RMSPROP_DECAY) * (g * g) + RMSPROP_DECAY * nu)
        return torch.rsqrt(nu + RMSPROP_EPS) * g


class Lamb(_Optax):
    def _init(self, p):
        zeros = torch.zeros_like(p, memory_format=torch.preserve_format)
        return {"step": 0, "mu": zeros, "nu": zeros.clone()}

    def _update(self, p, g, state):
        mu, nu = state["mu"], state["nu"]
        mu.copy_((1.0 - LAMB_B1) * g + LAMB_B1 * mu)
        nu.copy_((1.0 - LAMB_B2) * (g * g) + LAMB_B2 * nu)
        state["step"] += 1
        t = state["step"]
        mu_hat = mu / (1.0 - LAMB_B1 ** t)
        nu_hat = nu / (1.0 - LAMB_B2 ** t)
        u = mu_hat / (torch.sqrt(nu_hat) + LAMB_EPS)
        shard = getattr(p, "tp", None)
        if shard is None:
            p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        else:
            sq = torch.stack([torch.sum(p * p), torch.sum(u * u)])
            dist.all_reduce(sq, group=shard.group.group)
            p_norm, u_norm = torch.sqrt(sq).unbind()
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
        return u * ratio


class Lion(_Optax):
    def _init(self, p):
        return {"step": 0, "mu": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, p, g, state):
        mu = state["mu"]
        u = torch.sign((1.0 - LION_B1) * g + LION_B1 * mu)
        mu.copy_((1.0 - LION_B2) * g + LION_B2 * mu)
        state["step"] += 1
        return u + LION_WEIGHT_DECAY * p
