"""ZeRO-1 optimizer-state partitioning over the data(+pod) axes.

Port of ``repro.distributed.zero``. Parameters are tensor-parallel over
``model`` only; their optimizer moments and fp32 master copies are
*additionally* sharded over the data axes: each data shard owns a slice of
the optimizer state, which is the ZeRO-1 memory split (state bytes /
(data x pod)). DTensor materializes the reduce-scatter/all-gather pattern
implied by the placement difference where the optimizer combines a moment
with its gradient and parameter.

``zero_axes`` rewrites a logical-axes tree: for each tensor it finds the
first dim that is not already sharded and whose size divides the combined
data-axis extent, and assigns it the pseudo-logical name ``"zero"``
(ruled to ``("pod", "data")``).
"""

from __future__ import annotations

import math
from typing import Tuple

from repro_torch.distributed.sharding import (ShardingRules, _axis_sizes, _shape,
                                              tree_map_axes)


def zero_rules(rules: ShardingRules) -> ShardingRules:
    return rules.replace(zero=("pod", "data"))


def zero_axes(axes_tree, shape_tree, mesh, rules: ShardingRules):
    """Rewrite logical axes so optimizer state also shards over data axes."""
    sizes = _axis_sizes(mesh)
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))

    def leaf(axes: Tuple, shp):
        shape = _shape(shp)
        if dp <= 1:
            return axes
        best = None
        for i, (name, dim) in enumerate(zip(axes, shape)):
            sharded = bool(name and rules.rules.get(name))
            if sharded:
                continue
            if dim % dp == 0:
                best = i
                break
        if best is None:
            return axes
        new = list(axes)
        new[best] = "zero"
        return tuple(new)

    return tree_map_axes(leaf, axes_tree, shape_tree)
