"""The work router's shared straggler rule.

Copy of ``update_straggler_flags`` from
``deeplearning4j_tpu/parallel/workrouter.py``, the outlier rule the
training master and the serve fleet's controller share. The router's
dispatch policies and the aggregators are not ported yet (ROADMAP A14.3).
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from deeplearning4j_tpu_torch.monitor import record_counter, tracer

__all__ = ["update_straggler_flags"]


def update_straggler_flags(samples: Dict[str, float], flagged: set,
                           ratio: float, *, id_label: str,
                           value_key: str, counter_name: str,
                           event_name: str,
                           min_reporting: int = 3) -> Optional[float]:
    """A member whose sample exceeds ``ratio`` x the fleet median gets
    flagged, with the evidence (value, median, ratio) on the timeline, and
    is un-flagged on recovery. Needs at least ``min_reporting`` members so
    that one slow pair cannot nominate each other. Mutates ``flagged`` in
    place; returns the median used (None below the reporting floor)."""
    if len(samples) < min_reporting:
        return None
    median = statistics.median(samples.values())
    for member, value in samples.items():
        slow = median > 0 and value > ratio * median
        if slow and member not in flagged:
            flagged.add(member)
            record_counter(counter_name, **{id_label: member})
            tracer().event(event_name,
                           **{id_label: member,
                              value_key: round(value, 4),
                              "median_s": round(median, 4),
                              "ratio": ratio})
        elif not slow:
            flagged.discard(member)
    return median
