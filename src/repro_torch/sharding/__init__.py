"""Logical-axis sharding rules and parameter placements (``api.py``)."""
from .api import (DEFAULT_RULES, axis_rules, current_rules,
                  logical_constraint, param_specs, spec_for_path)

__all__ = ["DEFAULT_RULES", "axis_rules", "current_rules",
           "logical_constraint", "param_specs", "spec_for_path"]
