"""Elementwise-accumulating loss dict for epoch averaging.

A copy of ``intro_tc_vae_tpu/utils/lossdict.py`` (reference utils.py:48-60,
LossDict with + and /); the port cannot import the JAX package.
"""

from __future__ import annotations

from typing import Union


class LossDict(dict):
    def __add__(self, other: "LossDict") -> "LossDict":
        new = LossDict()
        for k in sorted(set(self.keys()) | set(other.keys())):
            new[k] = self.get(k, 0) + other.get(k, 0)
        return new

    def __truediv__(self, value: Union[int, float]) -> "LossDict":
        return LossDict({k: v / value for k, v in self.items()})
