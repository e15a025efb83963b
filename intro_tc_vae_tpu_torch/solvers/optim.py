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
tensors per parameter, so ``state_dict`` and ``load_state_dict`` carry it
through a checkpoint as they do torch's. The learning rate is the only
argument: nothing sets another of optax's hyperparameters, which are the
constants below.

Step counts live on the parameters' device (``place_steps``): a float32
0-d tensor that the update adds to there, and Lamb's bias corrections
computed from it there in the parameters' dtype, as optax computes them
from its int32 count on the device. So an update reads no number of the
host's, and a captured CUDA graph of it (``solvers/graph.py``) counts on
when it is replayed. On CUDA torch's Adam, AdamW and Adadelta run with
``capturable=True`` for the same reason; an eager CUDA run does so too, so
eager and graphed runs compute the same bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from intro_tc_vae_tpu_torch.parallel import comm_counts

ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8
LAMB_B1, LAMB_B2, LAMB_EPS = 0.9, 0.999, 1e-6
LION_B1, LION_B2, LION_WEIGHT_DECAY = 0.9, 0.99, 1e-3
# torch's classes that keep a step (Adam's and AdamW's bias corrections
# read it; Adadelta counts it): capturable on CUDA
CAPTURABLE = (torch.optim.Adam, torch.optim.AdamW, torch.optim.Adadelta)


def _device_step(step, device: torch.device) -> torch.Tensor:
    """A step count (a tensor, or an int of an older checkpoint) as a
    float32 0-d tensor on ``device``."""
    if not torch.is_tensor(step):
        step = torch.tensor(float(step))
    return step.to(dtype=torch.float32, device=device)


def place_steps(optimizer: torch.optim.Optimizer,
                capturable: bool | None = None) -> torch.optim.Optimizer:
    """Put ``optimizer``'s step counts where its updates read them, in
    place; returns it. torch's ``CAPTURABLE`` classes: ``capturable`` (by
    default whether the parameters are on CUDA) is set on every group and
    the steps follow it, float32 on the parameters' device or kept on the
    host; the port's classes: float32 on the parameters' device. Called
    on a new optimizer, and after ``load_state_dict``, which would take
    the saved groups' flags and places (``load_state_dict`` below)."""
    groups = optimizer.param_groups
    if isinstance(optimizer, CAPTURABLE):
        if capturable is None:
            capturable = any(p.is_cuda for g in groups for p in g["params"])
        for g in groups:
            g["capturable"] = capturable
    for g in groups:
        for p in g["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:  # the port's classes: no flag, on the device
                state["step"] = (_device_step(state["step"], p.device)
                                 if g.get("capturable", True) else state["step"].cpu())
    return optimizer


def load_state_dict(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict`` keeping the optimizer's own step
    placement: a checkpoint written by a capturable CUDA run loads into a
    CPU run, and an older one (host steps) into a capturable run."""
    capturable = optimizer.param_groups[0].get("capturable")
    optimizer.load_state_dict(state_dict)
    place_steps(optimizer, capturable)


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
        return {"step": _device_step(0, p.device), "mu": zeros, "nu": zeros.clone()}

    def _update(self, p, g, state):
        mu, nu = state["mu"], state["nu"]
        mu.copy_((1.0 - LAMB_B1) * g + LAMB_B1 * mu)
        nu.copy_((1.0 - LAMB_B2) * (g * g) + LAMB_B2 * nu)
        t = state["step"].add_(1.0).to(mu.dtype)
        mu_hat = mu / (1.0 - torch.pow(LAMB_B1, t))
        nu_hat = nu / (1.0 - torch.pow(LAMB_B2, t))
        u = mu_hat / (torch.sqrt(nu_hat) + LAMB_EPS)
        shard = getattr(p, "tp", None)
        if shard is None:
            p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        else:
            sq = torch.stack([torch.sum(p * p), torch.sum(u * u)])
            dist.all_reduce(sq, group=shard.group.group)
            comm_counts.count("all-reduce", "lamb trust ratio", sq)
            p_norm, u_norm = torch.sqrt(sq).unbind()
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
        return u * ratio


class Lion(_Optax):
    def _init(self, p):
        return {"step": _device_step(0, p.device),
                "mu": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, p, g, state):
        mu = state["mu"]
        u = torch.sign((1.0 - LION_B1) * g + LION_B1 * mu)
        mu.copy_((1.0 - LION_B2) * g + LION_B2 * mu)
        state["step"].add_(1.0)
        return u + LION_WEIGHT_DECAY * p
