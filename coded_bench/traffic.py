"""The one generator of every traffic mix; a mix is a JSON file of parameters.

``mixes/<name>.json`` holds data only.  Its keys name the files that act on
it, so that a later mix with a new shape of traffic adds files and edits
none:

* ``entry``: ``entries/<entry>.py``, what a request calls;
* ``loop`` and ``in_flight``: ``loops/<loop>.py``, how requests are offered
  (a loop refuses an ``in_flight`` it does not implement);
* ``operand_pool``: request i uses the problem's operand set
  ``i % operand_pool``;
* ``erasures``: ``{"model": <name>, ...}``, ``draws/<name>.py`` whose
  ``draw(rng, n, K, tau, params)`` gives the next n requests' erasure
  arguments (a survivor mask, a progress vector) from the run's seed; a mix
  without it sends operands alone;
* ``worker_times``: ``{"model": <name>, ...}``, ``draws/<name>.py`` whose
  ``feed(params, K, seed)`` times the workers of each step, for an entry
  that draws its erasures itself (the adaptive control plane).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from coded_bench import spec

_CHUNK = 1024   # requests drawn at a time; the stream does not depend on it


def seed_words(seed: int, *key: int) -> np.random.SeedSequence:
    """A seed sequence for one purpose of one run (any whole seed)."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *key])


@dataclass
class Request:
    """One request: its index, its operand set and its erasure arguments."""

    index: int
    pair: int
    erasure: dict = field(default_factory=dict)


def sample_times(rng: np.random.Generator, K: int, slow, slowdown: float,
                 jitter: np.ndarray) -> np.ndarray:
    """(K,) finish times: base 1, ``slow`` workers ``slowdown`` times longer,
    plus an exponential of scale ``jitter * time`` (the port's
    ``LatencyModel.sample``, copied)."""
    t = np.ones(K)
    t[list(slow)] *= slowdown
    if np.any(jitter > 0):
        t = t + rng.exponential(jitter * t)
    return t


def model(params: dict):
    """The module of ``draws/`` that a mix's ``{"model": ...}`` names."""
    return spec.module("draws", params["model"])


def requests(mix: dict, K: int, tau: int, seed: int) -> Iterator[Request]:
    """The endless request stream of a mix."""
    rng = np.random.default_rng(seed_words(seed, 3))
    pool = int(mix["operand_pool"])
    params = mix.get("erasures")
    draw = model(params).draw if params else None
    i = 0
    while True:
        kinds = draw(rng, _CHUNK, K, tau, params) if draw else [{}] * _CHUNK
        yield from (Request(i + j, (i + j) % pool, kinds[j]) for j in range(_CHUNK))
        i += _CHUNK
