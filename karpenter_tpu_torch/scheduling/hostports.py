"""Host-port keys (a copy of the JAX package's scheduling/hostports.py, cut
to what the encode and decode read): two pods exposing the same (hostIP,
port, protocol) cannot share a node, and "0.0.0.0" conflicts with every IP
(hostportusage.go:35-97)."""

from __future__ import annotations

from karpenter_tpu_torch.models.pod import HostPort

WILDCARD_IP = "0.0.0.0"


def port_key(hp: HostPort) -> tuple[str, int, str]:
    """(host IP, port, protocol), an unset IP read as the wildcard."""
    return (hp.host_ip or WILDCARD_IP, hp.port, hp.protocol)
