"""ElasticConfig: the frozen elastic-membership half of a RunSpec (copy
of ``repro.elastic.config``, so a JAX spec's ``elastic`` object parses
here).  Field checks raise ValueError from ``__post_init__``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elastic-membership runtime knobs.

    ``enabled`` makes world size a runtime property (a membership
    registry at ``dir``, "" = ``<ckpt.dir>/members``; a member is dead
    after ``timeout_s`` without a heartbeat, 0 = 3 x ``heartbeat_s``).
    ``allow_reshard`` permits ``--resume`` onto a different peer count.
    ``evict_after`` arms the straggler watchdog's escalation to the
    registry (0 = observe only).  Of these the port runs only
    ``allow_reshard``; ``RunSpec.validate`` refuses the others.
    """
    enabled: bool = False
    dir: str = ""             # membership registry ("" = <ckpt.dir>/members)
    heartbeat_s: float = 1.0  # beat period; liveness poll granularity
    timeout_s: float = 0.0    # declare-dead threshold (0 = 3 x heartbeat_s)
    allow_reshard: bool = False
    evict_after: int = 0      # watchdog flags before suspect-report (0 = off)

    def __post_init__(self):
        if self.heartbeat_s <= 0:
            raise ValueError(f"elastic.heartbeat_s must be > 0, "
                             f"got {self.heartbeat_s}")
        if self.timeout_s < 0:
            raise ValueError(f"elastic.timeout_s must be >= 0, "
                             f"got {self.timeout_s}")
        if self.evict_after < 0:
            raise ValueError(f"elastic.evict_after must be >= 0, "
                             f"got {self.evict_after}")
