"""API object model: the subset of the JAX package's models the solve
path reads (labels, taints, pods, node pools)."""

from karpenter_tpu_torch.models.labels import *  # noqa: F401,F403
from karpenter_tpu_torch.models.objects import ObjectMeta  # noqa: F401
from karpenter_tpu_torch.models.taints import Taint, Toleration  # noqa: F401
from karpenter_tpu_torch.models.pod import Pod, PodSpec, TopologySpreadConstraint  # noqa: F401
from karpenter_tpu_torch.models.nodepool import NodePool, NodePoolSpec, Limits  # noqa: F401
