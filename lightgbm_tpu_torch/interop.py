"""Carry state across from the JAX package, given as numpy arrays.

The parity tests feed both packages identical state through these:

- ``tree_arrays_from_numpy``: a JAX ``TreeArrays`` as
  ``jax.device_get(tree)._asdict()`` -> the port's ``TreeArrays``;
- ``bin_mappers_from_state``: ``BinMapper.to_state()`` dicts -> the port's
  ``BinMapper`` objects;
- ``booster_from_model_string``: a model text written by either package ->
  the port's ``Booster``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .basic import Booster
from .device import resolve_device
from .io.bin import BinMapper
from .ops.grower import TreeArrays


def tree_arrays_from_numpy(arrays: Dict[str, np.ndarray],
                           device=None) -> TreeArrays:
    dev = resolve_device(device)
    return TreeArrays(**{name: torch.as_tensor(np.array(arrays[name])).to(dev)
                         for name in TreeArrays._fields})


def tree_arrays_to_numpy(tree: TreeArrays) -> Dict[str, np.ndarray]:
    return {name: getattr(tree, name).cpu().numpy() for name in TreeArrays._fields}


def bin_mappers_from_state(states: List[dict]) -> List[BinMapper]:
    return [BinMapper.from_state(st) for st in states]


def booster_from_model_string(text: str, device=None) -> Booster:
    return Booster(model_str=text, device=device)
