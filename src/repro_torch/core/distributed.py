"""The distributed protocol's public names, re-exported from
``core.protomath`` (the per-parameter exchange over a ``torch.distributed``
data group), as the reference's ``core/distributed.py`` re-exports them."""
from __future__ import annotations

from repro_torch.core.protomath import (  # noqa: F401  (public re-exports)
    BlockedProtocol,
    pbias,
    plookup,
    pmm,
    protocol_context,
    pscale,
    robust_combine,
)

__all__ = ["BlockedProtocol", "pbias", "plookup", "pmm", "protocol_context", "pscale", "robust_combine"]
