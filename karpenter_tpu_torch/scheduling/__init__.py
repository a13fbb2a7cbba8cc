"""Host-side scheduling primitives with exact reference semantics: the
oracles the tensor encoding in karpenter_tpu_torch/ops is tested against."""

from karpenter_tpu_torch.scheduling.requirements import (  # noqa: F401
    Operator,
    Requirement,
    Requirements,
    node_selector_requirement,
)
from karpenter_tpu_torch.scheduling.taints import tolerates, tolerates_all  # noqa: F401
