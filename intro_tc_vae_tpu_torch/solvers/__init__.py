"""Solvers: the Soft-Intro two-phase step with Gaussian or β-TC KL."""

from intro_tc_vae_tpu_torch.solvers.base import (
    NOISE_KEYS,
    SolverHyper,
    TrainState,
    VAESolver,
    make_optimizer,
    make_solver,
)
from intro_tc_vae_tpu_torch.solvers.intro import IntroSolver, build_intro_step
from intro_tc_vae_tpu_torch.solvers.intro_tc import IntroTCSolver

__all__ = [
    "NOISE_KEYS",
    "SolverHyper",
    "TrainState",
    "VAESolver",
    "make_optimizer",
    "make_solver",
    "IntroSolver",
    "build_intro_step",
    "IntroTCSolver",
]
