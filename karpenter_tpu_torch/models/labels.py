"""Well-known labels, taint keys, annotations and value constants.

Counterpart of reference pkg/apis/v1/labels.go:34-154 and taints.go:27-40.
We keep the upstream karpenter.sh group and the standard kubernetes.io label
keys so existing pod specs, nodepool manifests and tooling carry over
verbatim (this framework is a drop-in replacement, not a side-by-side
install).
"""

from __future__ import annotations

GROUP = "karpenter.sh"

# kubernetes.io standard labels
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_TOPOLOGY_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_WINDOWS_BUILD = "node.kubernetes.io/windows-build"

# deprecated aliases (normalized away; reference labels.go:138-146)
LABEL_ZONE_BETA = "failure-domain.beta.kubernetes.io/zone"
LABEL_REGION_BETA = "failure-domain.beta.kubernetes.io/region"
LABEL_ARCH_BETA = "beta.kubernetes.io/arch"
LABEL_OS_BETA = "beta.kubernetes.io/os"
LABEL_INSTANCE_TYPE_LEGACY = "beta.kubernetes.io/instance-type"

# our labels
NODEPOOL_LABEL_KEY = GROUP + "/nodepool"
NODE_INITIALIZED_LABEL_KEY = GROUP + "/initialized"
NODE_REGISTERED_LABEL_KEY = GROUP + "/registered"
CAPACITY_TYPE_LABEL_KEY = GROUP + "/capacity-type"
DO_NOT_SYNC_TAINTS_LABEL_KEY = GROUP + "/do-not-sync-taints"

# annotations
DO_NOT_DISRUPT_ANNOTATION_KEY = GROUP + "/do-not-disrupt"
# comma-separated DRA driver names whose device pools must publish before
# the claim initializes (labels.go:56-59)
DRA_DRIVERS_ANNOTATION_KEY = GROUP + "/requested-dra-drivers"
NODEPOOL_HASH_ANNOTATION_KEY = GROUP + "/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION_KEY = GROUP + "/nodepool-hash-version"
NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY = GROUP + "/nodeclaim-termination-timestamp"
NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY = GROUP + "/nodeclaim-min-values-relaxed"

# finalizers
TERMINATION_FINALIZER = GROUP + "/termination"

# taint keys (reference taints.go:27-40)
DISRUPTED_TAINT_KEY = GROUP + "/disrupted"
UNREGISTERED_TAINT_KEY = GROUP + "/unregistered"

# capacity types
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"

# reservation id injected into reserved offerings' requirements
# (cloudprovider/types.go:50-53 ReservationIDLabel; providers register it
# as well-known so claims without the key stay compatible)
RESERVATION_ID_LABEL_KEY = GROUP + "/reservation-id"

ARCH_AMD64 = "amd64"
ARCH_ARM64 = "arm64"

WELL_KNOWN_LABELS = frozenset(
    {
        NODEPOOL_LABEL_KEY,
        LABEL_TOPOLOGY_ZONE,
        LABEL_TOPOLOGY_REGION,
        LABEL_INSTANCE_TYPE,
        LABEL_ARCH,
        LABEL_OS,
        CAPACITY_TYPE_LABEL_KEY,
        LABEL_WINDOWS_BUILD,
        RESERVATION_ID_LABEL_KEY,
    }
)

RESTRICTED_LABELS = frozenset({LABEL_HOSTNAME})
RESTRICTED_LABEL_DOMAINS = frozenset({GROUP})

# alias -> canonical (reference labels.go:138-146)
NORMALIZED_LABELS: dict[str, str] = {
    LABEL_ZONE_BETA: LABEL_TOPOLOGY_ZONE,
    LABEL_ARCH_BETA: LABEL_ARCH,
    LABEL_OS_BETA: LABEL_OS,
    LABEL_INSTANCE_TYPE_LEGACY: LABEL_INSTANCE_TYPE,
    LABEL_REGION_BETA: LABEL_TOPOLOGY_REGION,
}

# normalized-key -> {original value -> normalized value}
NORMALIZED_LABEL_VALUES: dict[str, dict[str, str]] = {}

WELL_KNOWN_VALUES_FOR_REQUIREMENTS: dict[str, frozenset[str]] = {
    CAPACITY_TYPE_LABEL_KEY: frozenset({CAPACITY_TYPE_ON_DEMAND, CAPACITY_TYPE_SPOT, CAPACITY_TYPE_RESERVED}),
}

WELL_KNOWN_LABELS_FOR_OFFERINGS = frozenset({LABEL_TOPOLOGY_ZONE, CAPACITY_TYPE_LABEL_KEY})


def get_label_domain(key: str) -> str:
    return key.split("/", 1)[0] if "/" in key else ""


def is_restricted_label(key: str) -> bool:
    """True if the label may interfere with provisioning (labels.go:141-154)."""
    if key in WELL_KNOWN_LABELS:
        return False
    domain = get_label_domain(key)
    for restricted in RESTRICTED_LABEL_DOMAINS:
        if domain == restricted or domain.endswith("." + restricted):
            return True
    return key in RESTRICTED_LABELS
