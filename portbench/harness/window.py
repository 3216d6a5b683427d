"""What a driver hands back from the measured window."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    seconds: float                   # the window's length, host clock
    attempted: int                   # queries sent
    completed: int                   # queries answered within the window
    answers: list                    # [(query ids [R], ids [R, k], scores [R, k])]
    setup_end: float                 # perf_counter when the window opened
    units: list = dataclasses.field(default_factory=list)   # pool batch of each unit
    trace: dict | None = None        # busy_s, window_s, breakdown (traced runs)
    pace: dict | None = None         # how the host kept pace (harness/pace.py)
