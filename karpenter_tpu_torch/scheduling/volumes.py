"""CSI attach-limit tracking (a copy of the JAX package's
scheduling/volumes.py, cut to what the encode and decode read): per node,
the distinct PVCs of each CSI driver its pods mount, against the per-driver
limits the node's CSINode publishes (volumeusage.go:187-229). Two pods
mounting one PVC use one attachment; drivers without a limit are
unconstrained."""

from __future__ import annotations

from typing import Optional

# driver name -> set of PVC ids (volumeusage.go:45)
Volumes = dict


def vol_union(a: Volumes, b: Volumes) -> Volumes:
    """Union of two driver -> PVC-set maps (volumeusage.go:56-70)."""
    out = {k: set(v) for k, v in a.items()}
    for k, v in b.items():
        out.setdefault(k, set()).update(v)
    return out


class VolumeUsage:
    """One node's attachments: the union of its pods' volumes, each pod's
    volumes, and the per-driver limits."""

    def __init__(self):
        self.volumes: Volumes = {}
        self.pod_volumes: dict[str, Volumes] = {}
        self.limits: dict[str, int] = {}

    def add_limit(self, driver: str, count: int) -> None:
        self.limits[driver] = count

    def exceeds_limits(self, vols: Volumes) -> Optional[str]:
        """Why adding vols would push a limited driver over its cap
        (volumeusage.go:201-208), else None."""
        for driver, pvcs in vol_union(self.volumes, vols).items():
            limit = self.limits.get(driver)
            if limit is not None and len(pvcs) > limit:
                return (
                    f"would exceed volume limit, provisioner={driver} "
                    f"volume-count={len(pvcs)} volume-limit={limit}"
                )
        return None

    def add(self, pod_uid: str, vols: Volumes) -> None:
        self.pod_volumes[pod_uid] = {k: set(v) for k, v in vols.items()}
        self.volumes = vol_union(self.volumes, vols)

    def copy(self) -> "VolumeUsage":
        out = VolumeUsage()
        out.volumes = {k: set(v) for k, v in self.volumes.items()}
        out.pod_volumes = {uid: {k: set(v) for k, v in vols.items()} for uid, vols in self.pod_volumes.items()}
        out.limits = dict(self.limits)
        return out
