"""Counter-based recompile gate for the port's benches.

The twin of ``benchmarks/obs_util.py`` over ``repro_torch.obs``.
``CompileWatch`` reads the ``runtime.executable.compile`` counter that the
``CodedMatmul`` facade itself increments - one watch per bench, ``mark()``
after prewarm, ``assert_no_recompiles`` at the end - so the gate measures
the same signal that observability exports.  In the port a "compile" is a
pipeline-closure build (nothing is jit-compiled), under the same name.

The watch ENABLES observability (the counter is dead while obs is off -
an assertion against a dead counter would pass vacuously) and reads
totals across all label sets, so per-kind splits don't hide a rebuild.
"""
from __future__ import annotations

from repro_torch import obs

__all__ = ["CompileWatch", "assert_no_recompiles"]


class CompileWatch:
    """Delta-reader over the ``runtime.executable.compile`` counter.

    Construction turns observability on (accumulating into the existing
    session unless ``fresh=True``) and marks the current count; ``mark``
    re-baselines (call it right after a prewarm) and ``delta`` is the
    compiles since the last mark.
    """

    COUNTER = "runtime.executable.compile"

    def __init__(self, fresh: bool = False):
        obs.enable(fresh=fresh)
        self._mark = self.compiles()

    def compiles(self) -> int:
        """Total pipeline builds so far (all kinds)."""
        return int(obs.session().registry.total(self.COUNTER))

    def mark(self) -> int:
        """Re-baseline: subsequent ``delta`` counts from this point."""
        self._mark = self.compiles()
        return self._mark

    def delta(self) -> int:
        """Pipeline builds since the last ``mark``."""
        return self.compiles() - self._mark


def assert_no_recompiles(count: int, label: str = "") -> None:
    """Assert a recorded post-prewarm compile delta is zero.

    Takes the plain count (``watch.delta()`` at run time, or a persisted
    bench row's ``"recompiles"`` field) so the gate works on stored results
    too.  A violation raises ``AssertionError`` naming the label and the
    count.
    """
    where = f" during {label}" if label else ""
    assert count == 0, (
        f"{count} executable recompile(s){where} - serving after prewarm "
        f"must be recompile-free ({CompileWatch.COUNTER})")
