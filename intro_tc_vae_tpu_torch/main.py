"""CLI entry: ``python -m intro_tc_vae_tpu_torch.main -f config.json -u '{...}'``.

The contract of ``intro_tc_vae_tpu/main.py`` (-f/--config JSON path,
-u/--update inline-JSON override dict). Trains on cuda:0 and raises when
CUDA is absent. Data parallel: start R processes, e.g.

    torchrun --nproc_per_node 2 -m intro_tc_vae_tpu_torch.main -f configs/intro_tc_128_dp8.json \
        -u '{"data_parallel": 2, ...}'

(or set ITCVAE_COORDINATOR_ADDRESS, RANK, WORLD_SIZE and LOCAL_RANK for
each process); each rank then trains on its own card, or ranks share one
(``parallel/distributed.py``). Tensor parallel: the same start with
``"model_parallel": M`` and ``"data_parallel"`` the total number of ranks,
e.g. ``torchrun --nproc_per_node 4 ... -u '{"data_parallel": 4,
"model_parallel": 2, ...}'`` (a grid of 2 data by 2 model ranks).
"""

from __future__ import annotations

import argparse
import json

from intro_tc_vae_tpu_torch.config import load_config
from intro_tc_vae_tpu_torch.parallel import shutdown_distributed
from intro_tc_vae_tpu_torch.train import train_soft_intro_vae


def cli(argv=None):
    parser = argparse.ArgumentParser(description="train Soft-Intro-TC-VAE (PyTorch/CUDA)")
    parser.add_argument("-f", "--config", type=str, default=None,
                        help="Path to the JSON config file")
    parser.add_argument("-u", "--update", type=json.loads, default="{}",
                        help="Inline JSON dict overriding config values")
    args = parser.parse_args(argv)
    config = load_config(args.config, update_dict=args.update)
    return train_soft_intro_vae(config=config)


if __name__ == "__main__":
    cli()
    shutdown_distributed()
