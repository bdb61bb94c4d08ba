"""The paper's own experimental configuration (Sec. V).

AWS r3.large cluster, 10 workers; A, B random integer 8000x8000 matrices
with entries in {0..50}; 2x2x2 block decomposition (m=n=p=2); evaluation
points: 10 equally spaced reals in [-1, 1]; stragglers simulated by doubled
local computation.  BEC threshold tau=4 vs polynomial-code tau=9.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperMatmulConfig:
    name: str = "paper-matmul"
    v: int = 8000
    r: int = 8000
    t: int = 8000
    p: int = 2
    m: int = 2
    n: int = 2
    K: int = 10
    entry_max: int = 50
    points: str = "equispaced"
    straggler_slowdown: float = 2.0

    @property
    def L(self) -> int:
        return self.v * self.entry_max * self.entry_max + 1


CONFIG = PaperMatmulConfig()
# Reduced-size variant for CPU benches/tests (same geometry, smaller dims).
SMOKE = PaperMatmulConfig(name="paper-matmul-smoke", v=512, r=512, t=512)
