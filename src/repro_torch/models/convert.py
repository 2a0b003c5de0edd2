"""Parameter trees (the reference's layout) -> the port's state dict.

The reference stacks every decoder weight over scan groups
(``decoder.blocks.sub{i}.<...>`` with a leading group axis); the port has
one module per layer. Layer ``g * period + i`` takes
``blocks["sub{i}"][...][g]``; encoder layer ``i`` takes
``encoder.blocks[...][i]`` as ``encoder.layers.{i}.<...>``; the other
leaves keep their paths, joined with dots.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import tree_map, unstack_leaves


def unstack(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A stacked tree of tensors -> ``{state_dict key: tensor}``
    (``params.unstack_leaves``); each layer's tensor is a view of the
    stacked one, not a copy."""
    return unstack_leaves(tree, cfg, lambda t, j: t[j])


def _to_tensor(a: Any, device: Optional[Union[str, torch.device]]
               ) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: numpy has no bf16 of its own
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device=device)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The reference's ``init_params`` tree, its leaves as numpy arrays
    (bf16 leaves as ``ml_dtypes.bfloat16``), -> the port's state dict on
    ``device``, values and dtypes unchanged."""
    return unstack(tree_map(lambda a: _to_tensor(a, device), tree), cfg)
