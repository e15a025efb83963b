"""PyTorch port: ``make_optimizer`` against optax.

Each of the eight names the JAX package resolves (``solvers/base.py:68-86``)
takes three steps on the same parameters and the same gradients in both
packages, float64 (JAX in x64 mode); the parameters after every step agree
to rtol 1e-10. optax's defaults differ from torch's for most of these
(solvers/optim.py), so a torch default would miss by far more: a wrong eps
or decay shows at 1e-7 to 1e-2 of the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_tc_vae_tpu.solvers import make_optimizer as jmake_optimizer
from intro_tc_vae_tpu_torch.solvers import make_optimizer
from tests._torch_threads import one_thread  # noqa: F401  (autouse)

NAMES = ("adam", "adamw", "adagrad", "adadelta", "sgd", "rmsprop", "lamb", "lion")
SHAPES = ((4, 3, 3, 3), (7,), (5, 6))
LR = 1e-2
RTOL = 1e-10


def _params_and_grads(seed: int = 0, steps: int = 3):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s) for s in SHAPES]
    params[1][2] = 0.0  # a zero entry: lamb's norms and lion's sign see it
    grads = [[rng.standard_normal(s) for s in SHAPES] for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("name", NAMES)
def test_three_steps_match_optax(name):
    params, grads = _params_and_grads()
    with jax.enable_x64(True):
        tx = jmake_optimizer(name, LR)
        jparams = [jnp.asarray(p) for p in params]
        opt_state = tx.init(jparams)
        want = []
        for g in grads:
            updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jparams)
            jparams = [p + u for p, u in zip(jparams, updates)]
            want.append([np.asarray(p) for p in jparams])

    tparams = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    opt = make_optimizer(name, LR)(tparams)
    for k, g in enumerate(grads):
        for p, x in zip(tparams, g):
            p.grad = torch.tensor(x)
        opt.step()
        for i, (p, w) in enumerate(zip(tparams, want[k])):
            assert p.dtype == torch.float64
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=RTOL, atol=0,
                                       err_msg=f"{name} step {k + 1} param {i}")
    # the update moved every parameter tensor
    for p, p0 in zip(tparams, params):
        assert not np.array_equal(p.detach().numpy(), p0)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer 'adamax'"):
        make_optimizer("adamax", LR)


@pytest.mark.parametrize("name", ["Adam", "LAMB", "Lion"])
def test_names_are_case_insensitive(name):
    opt = make_optimizer(name, LR)([torch.nn.Parameter(torch.zeros(2))])
    assert opt.param_groups[0]["lr"] == LR
