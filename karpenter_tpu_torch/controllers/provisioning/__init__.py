"""Provisioning: claim templates, the scheduler and its resident session."""

from karpenter_tpu_torch.controllers.provisioning.nodeclaimtemplate import (  # noqa: F401
    ClaimTemplate,
    build_template,
    build_templates,
)
from karpenter_tpu_torch.controllers.provisioning.scheduler import (  # noqa: F401
    TorchScheduler,
    UnsupportedProblem,
)
from karpenter_tpu_torch.controllers.provisioning.resident import ResidentSession  # noqa: F401,E402
