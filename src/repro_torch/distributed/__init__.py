"""Distribution layer of the PyTorch port: logical-axis sharding rules over
a ``torch.distributed`` device mesh (``sharding``), the EF-int8 gradient
exchange and the wire codec (``compression``), the multi-pod train step
(``multipod``), and the simulated inter-shard transport and heartbeat /
straggler health that the sharded segment store rides (``transport``,
``fault``).

``repro.distributed.compat`` (a shim between jax's two ``shard_map`` APIs)
has no counterpart: the port exchanges over process groups by hand.
"""
from .sharding import ShardingRules, constrain, make_rules, param_pspecs, use_rules

__all__ = ["ShardingRules", "constrain", "make_rules", "param_pspecs", "use_rules"]
