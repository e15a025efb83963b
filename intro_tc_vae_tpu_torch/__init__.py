"""intro_tc_vae_tpu_torch — the PyTorch/CUDA port of ``intro_tc_vae_tpu``.

The JAX package beside it is the reference; this package mirrors its
module tree and names (``ops``, ``models``, ``solvers``, ``data``,
``evaluation``, ``utils``, ``config``, ``train``, ``main``, ``sample``,
``evaluate``) so each counterpart is easy to find. It imports torch,
numpy, PIL (image decode) and the standard library; scikit-learn,
matplotlib, pandas and a TensorBoard package only inside the functions
that use them. The TPU's Pallas kernels on the main path are hand-written CUDA
kernels under ``csrc/``, built at first use (``ops/cuda_build.py``), and the
host's data core is C++ (``runtime/``), built at first use too; neither
at import.
"""

__version__ = "0.1.0"
