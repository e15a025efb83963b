"""Solvers: the single-phase ELBO step (vae, tc) and the Soft-Intro
two-phase step (intro, intro_tc), with Gaussian or β-TC KL."""

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
from intro_tc_vae_tpu_torch.solvers.tc import TCSolver, TCSovler
from intro_tc_vae_tpu_torch.solvers.vae import build_vae_step

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
    "TCSolver",
    "TCSovler",
    "build_vae_step",
]
