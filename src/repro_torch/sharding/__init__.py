"""Logical-axis sharding rules of the port (``rules.py``)."""
from repro_torch.sharding.rules import (DEFAULT_RULES, FSDP_RULES,
                                        active_rules, attn_strategy,
                                        axis_size, logical_to_spec,
                                        use_rules)

__all__ = ["DEFAULT_RULES", "FSDP_RULES", "active_rules", "attn_strategy",
           "axis_size", "logical_to_spec", "use_rules"]
