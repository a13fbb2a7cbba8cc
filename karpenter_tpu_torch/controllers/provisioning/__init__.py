"""Provisioning: claim templates and the fill-path scheduler."""

from karpenter_tpu_torch.controllers.provisioning.nodeclaimtemplate import (  # noqa: F401
    ClaimTemplate,
    build_template,
    build_templates,
)
from karpenter_tpu_torch.controllers.provisioning.scheduler import (  # noqa: F401
    TorchScheduler,
    UnsupportedProblem,
)
