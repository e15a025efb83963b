"""intro_tc_vae_tpu_torch — the PyTorch/CUDA port of ``intro_tc_vae_tpu``.

The JAX package beside it is the reference; this package mirrors its
module tree and names (``ops``, ``models``, ``solvers``, ``data``,
``config``, ``train``, ``main``) so each counterpart is easy to find.
It imports torch, numpy, PIL (image decode) and the standard library
only. The TPU's Pallas kernels on the main path are hand-written CUDA
kernels under ``csrc/``, built at first use (``ops/cuda_build.py``), and the
host's data core is C++ (``runtime/``), built at first use too; neither
at import.

Options the port does not carry yet raise ``NotImplementedError`` naming
the ROADMAP item that ports them (``not_ported``).
"""

__version__ = "0.1.0"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for an option this port does not carry yet."""
    return NotImplementedError(
        f"{what} is not ported to intro_tc_vae_tpu_torch yet (ROADMAP {item})"
    )
