"""Object metadata: the part of the JAX package's models/objects.py the
solve path reads (names, namespaces, uids, labels)."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "obj") -> str:
    return f"{prefix}-{next(_uid_counter):08d}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid())
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    owner_uid: Optional[str] = None
