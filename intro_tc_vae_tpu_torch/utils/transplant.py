"""Weight bridge: JAX package params/batch_stats -> this port's state_dict,
and the reference's own PyTorch checkpoints -> this port's model.

The inverse of ``intro_tc_vae_tpu/utils/transplant.py::torch_state_dict_to_flax``
(which reads this port's ``state_dict()`` as it is):

* conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in];
* the encoder-fc input / decoder-fc output features are permuted from the
  JAX package's NHWC flatten order to the port's NCHW order;
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

Takes plain numpy arrays (or anything ``np.asarray`` accepts), so it
needs no jax. Used by the parity tests to give both packages the same
weights, and for the Adam moments, which have the params' tree shape.
Both directions carry whole tensors: a tensor-parallel model takes
``flax_to_port``'s dict through ``parallel.shard_state_dict`` (or is
loaded whole and then cut by ``parallel.shard_state``), and gives
``torch_state_dict_to_flax`` its ``parallel.gather_state``.

``load_torch_checkpoint`` reads a checkpoint the reference wrote
(reference utils.py:26-36, ``{'epoch', 'model'}``): the port keeps the
reference's module names and NCHW layouts, so its state_dict loads as it
is once two kinds of key the port has no slot for are dropped.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the JAX inception block's names for the reference's nn.Sequential branch
BRANCH_1 = {"branch_1_0": "branch_1.0", "branch_1_1": "branch_1.1"}


def _nchw_to_nhwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """perm[j] = NCHW flat index of NHWC flat index j."""
    idx_t = np.arange(c * h * w).reshape(c, h, w)
    return np.transpose(idx_t, (1, 2, 0)).reshape(-1)


def flax_to_port(
    params: dict,
    batch_stats: Optional[dict],
    arch: str,
    conv_output_size: Tuple[int, int, int],
) -> Dict[str, torch.Tensor]:
    """JAX ({'encoder', 'decoder'} params, batch_stats) -> port state_dict
    with ``encoder.*`` / ``decoder.*`` keys (load it into a
    ``models.SoftIntroVAE``). ``batch_stats=None`` leaves out the running
    statistics (for optimizer moments). conv_output_size: the JAX
    package's NHWC (h, w, c) encoder output shape. The 'res' and
    'inception' archs' 1x1 ``conv_expand`` is a plain conv leaf; the
    inception block's ``branch_1_0`` / ``branch_1_1`` are the port's
    ``branch_1.0`` / ``branch_1.1`` (the reference's nn.Sequential)."""
    if arch not in ("conv", "res", "inception"):
        raise ValueError(f"unknown arch '{arch}'")
    sd: Dict[str, np.ndarray] = {}
    h, w, c = conv_output_size
    perm = _nchw_to_nhwc_perm(c, h, w)

    def put_conv(key: str, node: dict):
        sd[f"{key}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))
        if "bias" in node:
            sd[f"{key}.bias"] = np.asarray(node["bias"])

    def put_bn(key: str, node: dict, stats: Optional[dict]):
        sd[f"{key}.weight"] = np.asarray(node["scale"])
        sd[f"{key}.bias"] = np.asarray(node["bias"])
        if stats is not None:
            sd[f"{key}.running_mean"] = np.asarray(stats["mean"])
            sd[f"{key}.running_var"] = np.asarray(stats["var"])

    def put_block(key: str, node: dict, stats: Optional[dict]):
        for sub, leaf in node.items():
            path = f"{key}.{BRANCH_1.get(sub, sub)}"
            if "kernel" in leaf:
                put_conv(path, leaf)
                continue
            sub_stats = None if stats is None else stats[sub]
            if "scale" in leaf:
                put_bn(path, leaf, sub_stats)
            else:  # an inception branch: {conv, batch_norm}
                put_block(path, leaf, sub_stats)

    def side_stats(side: str) -> Optional[dict]:
        return None if batch_stats is None else batch_stats[side]

    enc, enc_s = params["encoder"], side_stats("encoder")
    put_conv("encoder.main.0", enc["stem_conv"])
    put_bn("encoder.main.1", enc["stem_bn"], None if enc_s is None else enc_s["stem_bn"])
    for name, node in enc.items():
        if name.startswith("res_in_"):
            put_block(f"encoder.main.{name}", node,
                      None if enc_s is None else enc_s[name])
    w_t = np.empty_like(np.asarray(enc["fc"]["kernel"]))  # [F, 2z], NCHW rows
    w_t[perm] = np.asarray(enc["fc"]["kernel"])
    sd["encoder.fc.weight"] = w_t.T
    sd["encoder.fc.bias"] = np.asarray(enc["fc"]["bias"])

    dec, dec_s = params["decoder"], side_stats("decoder")
    w_t = np.empty_like(np.asarray(dec["fc"]["kernel"]))  # [z, F], NCHW columns
    w_t[:, perm] = np.asarray(dec["fc"]["kernel"])
    sd["decoder.fc.0.weight"] = w_t.T
    b = np.empty_like(np.asarray(dec["fc"]["bias"]))
    b[perm] = np.asarray(dec["fc"]["bias"])
    sd["decoder.fc.0.bias"] = b
    for name, node in dec.items():
        if name.startswith("res_in_"):
            put_block(f"decoder.main.{name}", node,
                      None if dec_s is None else dec_s[name])
    put_conv("decoder.main.predict", dec["predict"])

    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def _dead_keys(model: torch.nn.Module):
    """What a reference state_dict holds that ``model`` has no slot for:
    every BatchNorm's ``num_batches_tracked`` (``GroupedBatchNorm`` keeps
    no count), and the ``conv_expand`` the reference's ConvolutionalBlock
    allocates and its forward never uses (JAX transplant.py:101-104 skips
    it too)."""
    from intro_tc_vae_tpu_torch.models.blocks import ConvolutionalBlock

    conv_blocks = tuple(f"{name}.conv_expand." for name, m in model.named_modules()
                        if isinstance(m, ConvolutionalBlock))
    return lambda key: key.endswith(".num_batches_tracked") or key.startswith(conv_blocks)


def load_torch_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.pth`` checkpoint (``payload["model"]``, or the
    payload itself when it has no ``"model"``) into the port's
    ``SoftIntroVAE`` ``model``, on the model's device; returns ``model``.
    The counterpart of JAX ``utils/transplant.py::load_torch_checkpoint``.
    Only the keys ``_dead_keys`` names are dropped; the load is otherwise
    strict, so a missing key, any other unknown key or a shape that differs
    raises and names the key."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload["model"] if isinstance(payload, dict) and "model" in payload else payload
    dead = _dead_keys(model)
    model.load_state_dict({k: v for k, v in sd.items() if not dead(k)}, strict=True)
    return model
