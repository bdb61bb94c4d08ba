"""The serving CLI's default time feed (``launch/coded_serve.py --adaptive``,
copied): a slow set of ``round(fail_rate * K)`` workers, drawn anew every
``resample_every`` steps, ``slowdown`` times as long, with exponential
jitter of scale ``jitter`` (``slow_jitter`` on the slow workers)."""
import numpy as np

from coded_bench.traffic import sample_times, seed_words


def feed(params: dict, K: int, seed: int):
    """``feed(step, rng) -> (K,)`` worker times of one step."""
    n_slow = int(round(params["fail_rate"] * K))
    init = np.random.default_rng(seed_words(seed, 2))
    state = {"slow": init.choice(K, size=n_slow, replace=False)}
    every = int(params["resample_every"])

    def times(step, rng):
        if step and step % every == 0:
            state["slow"] = rng.choice(K, size=n_slow, replace=False)
        jit = np.full(K, float(params["jitter"]))
        jit[state["slow"]] = float(params["slow_jitter"])
        return sample_times(rng, K, state["slow"], float(params["slowdown"]), jit)

    return times
