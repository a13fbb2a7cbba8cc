"""Instance types, offerings and the synthetic catalog."""

from karpenter_tpu_torch.cloudprovider.instancetype import (  # noqa: F401
    InstanceType,
    InstanceTypeOverhead,
    Offering,
)
