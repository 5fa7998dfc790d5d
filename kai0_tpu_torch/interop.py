"""Load a ``PI0Pytorch``-layout state dict of numpy arrays into the port.

The state is what ``kai0_tpu.interop.torch_safetensors.jax_to_torch_state``
returns for a JAX parameter tree: torch key names and ``[out, in]`` layouts,
values as numpy arrays. bfloat16 values (ml_dtypes arrays, which numpy knows
only as a 2-byte type) cross through a ``uint16`` view, bit for bit.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _to_tensor(x: np.ndarray) -> torch.Tensor:
    x = np.array(x, copy=True, order="C")  # writable and owned by the tensor
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def load_jax_state(model: nn.Module, state: Mapping[str, np.ndarray]) -> nn.Module:
    """``model.load_state_dict`` with ``strict=True`` from a numpy state dict.

    Values are copied into the model's parameters (and cast to their dtype);
    a missing or unexpected key raises.
    """
    model.load_state_dict({k: _to_tensor(v) for k, v in state.items()}, strict=True)
    return model
