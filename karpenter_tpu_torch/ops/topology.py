"""Topology tensors (port of the container in the JAX package's
ops/topology.py). The fill path of this package solves topology-free
problems only, so the encoder here builds the no-groups tensors: one
invalid padding row per family. The fill step still reads the hostname
family (hg_skew/hg_type/hg_valid/hg_counts0), so a populated container
from the reference (via ops.solver.from_numpy) runs through the same code."""

from __future__ import annotations

from typing import NamedTuple

import torch

TYPE_SPREAD = 0
TYPE_AFFINITY = 1
TYPE_ANTI = 2


class TopologyTensors(NamedTuple):
    # vocab-key groups
    vg_key: torch.Tensor  # [NGv] i32
    vg_type: torch.Tensor  # [NGv] i32
    vg_skew: torch.Tensor  # [NGv] i32
    vg_min_domains: torch.Tensor  # [NGv] i32 (0 = unset)
    vg_domains: torch.Tensor  # [NGv, V] bool
    vg_counts0: torch.Tensor  # [NGv, V] i32
    vg_rank: torch.Tensor  # [NGv, V] i32
    vg_valid: torch.Tensor  # [NGv] bool
    # hostname groups
    hg_type: torch.Tensor  # [NGh] i32
    hg_skew: torch.Tensor  # [NGh] i32
    hg_counts0: torch.Tensor  # [NGh, S] i32 — S = E existing + claim slots + 1
    hg_extra_nonempty: torch.Tensor  # [NGh] bool
    hg_valid: torch.Tensor  # [NGh] bool


def empty_topology_tensors(v_pad: int, s_slots: int, device) -> TopologyTensors:
    """The no-groups TopologyTensors, field for field what the reference's
    encode_topology builds for an empty group list (skews 1, valid bits
    False, vg ranks 2^30)."""
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return TopologyTensors(
        vg_key=torch.zeros(1, **i32),
        vg_type=torch.zeros(1, **i32),
        vg_skew=torch.ones(1, **i32),
        vg_min_domains=torch.zeros(1, **i32),
        vg_domains=torch.zeros((1, v_pad), **b),
        vg_counts0=torch.zeros((1, v_pad), **i32),
        vg_rank=torch.full((1, v_pad), 2**30, **i32),
        vg_valid=torch.zeros(1, **b),
        hg_type=torch.zeros(1, **i32),
        hg_skew=torch.ones(1, **i32),
        hg_counts0=torch.zeros((1, s_slots), **i32),
        hg_extra_nonempty=torch.zeros(1, **b),
        hg_valid=torch.zeros(1, **b),
    )
