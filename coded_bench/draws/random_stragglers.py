"""Partial stragglers: each request draws ``stragglers`` new slow workers
(``slowdown`` times as long, the paper's shifted-exponential model with
``jitter``), and each worker runs ``sub_tasks`` row chunks in a cyclic
schedule (worker k runs chunk (k + j) % Q as its j-th).  A request's
progress is each worker's completed chunk prefix at the first moment every
chunk has tau finishers."""
import numpy as np

from coded_bench.traffic import sample_times


def chunk_counts(times: np.ndarray, Q: int, tau: int) -> np.ndarray:
    """Completed chunks per worker at the first moment every one of the Q
    chunks has tau finishers under the cyclic schedule."""
    K = times.shape[0]
    when = np.sort((times[:, None] * np.arange(1, Q + 1) / Q).ravel())
    counts = np.minimum(np.floor(Q * when[:, None] / times[None, :] + 1e-9), Q)
    holds = (np.arange(Q)[:, None] - np.arange(K)[None, :]) % Q    # (Q, K)
    cover = (holds[None, :, :] < counts[:, None, :]).sum(axis=2)    # (E, Q)
    first = int(np.argmax(np.all(cover >= tau, axis=1)))
    return counts[first].astype(np.int64)


def draw(rng: np.random.Generator, n: int, K: int, tau: int, params: dict) -> list:
    """n requests' ``{"progress": (K,) completed share of the Q chunks}``."""
    Q = int(params["sub_tasks"])
    out = []
    for _ in range(n):
        slow = rng.choice(K, size=int(params["stragglers"]), replace=False)
        t = sample_times(rng, K, slow, float(params["slowdown"]),
                         np.full(K, float(params["jitter"])))
        out.append({"progress": chunk_counts(t, Q, tau) / Q})
    return out
