"""ARX X5 (dual arms, 3 cams) policy transforms.

Counterpart of ``kai0_tpu/policies/arx_policy.py``, without JAX.
Parity: reference ``src/openpi/policies/arx_policy.py`` — identical to Agilex except
the [−π, π] state filter is absent.
"""

from __future__ import annotations

import dataclasses

from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.policies import bimanual as _bimanual


@dataclasses.dataclass(frozen=True)
class ARXInputs(_bimanual.BimanualInputs):
    model_type: _model.ModelType = _model.ModelType.PI0
    clip_to_pi: bool = False


@dataclasses.dataclass(frozen=True)
class ARXOutputs(_bimanual.BimanualOutputs):
    pass
