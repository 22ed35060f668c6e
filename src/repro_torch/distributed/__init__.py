"""Distribution substrate: sharding context, partition-spec rules, collectives."""

from .ctx import MeshAxes, set_axes, shard, current_axes, axes_context
