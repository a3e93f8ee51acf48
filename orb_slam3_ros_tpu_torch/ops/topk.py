"""Top-k with ``lax.top_k``'s tie order.

``lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order among ties. Several stages take the
top-k of integer scores (histogram bins, covisibility counts, grid-cell
responses), where ties are common and the index that wins a tie changes
what follows, so every such site goes through this stable sort.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values [..., k], indices [..., k] int64) of the k largest entries
    along the last axis of ``x``, in descending order, lower index first
    among ties."""
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]
