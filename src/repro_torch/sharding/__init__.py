"""Logical-axis sharding (a port of ``repro.sharding``): the policy that
maps a tensor's logical axes to a mesh's axes."""
from repro_torch.sharding.policy import (DEFAULT_RULES, NamedSharding, P,
                                         ShardingPolicy, constrain,
                                         current_policy, make_policy,
                                         param_pspec, set_policy)

__all__ = ["DEFAULT_RULES", "NamedSharding", "P", "ShardingPolicy",
           "constrain", "current_policy", "make_policy", "param_pspec",
           "set_policy"]
