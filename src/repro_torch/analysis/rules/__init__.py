"""repro-lint rules of the port. Each module exposes RULE (name) and
check(ctx)."""
from repro_torch.analysis.rules import host_sync, retrace_hazard

RULE_CHECKS = {
    host_sync.RULE: host_sync.check,
    retrace_hazard.RULE: retrace_hazard.check,
}

__all__ = ["RULE_CHECKS", "host_sync", "retrace_hazard"]
