"""The one general traffic generator; a mix is a JSON file of parameters
under ``port_bench/traffic/``.

Two kinds of mix:

* ``closed_loop``: ``clients`` clients, each sending its next request as
  soon as its last one finished.  Prompt and output lengths come from
  the mix's distributions (``lognormal`` by median and sigma, or
  ``uniform``, each clipped to [min, max]).  So that every seed serves
  the same amount of work, the sizes are fixed: requests come in blocks
  of ``strata``, and a block holds the distribution's ``strata``
  quantiles at (i + 1/2) / strata of each length.  The order of a
  block's prompts and the pairing with its outputs are drawn from the
  run's seed, block by block, and so are the token ids, uniform over the
  vocabulary.
* ``image_stream``: a pool of ``pool`` images drawn from the seed (the
  standard normal, NHWC float32), served in batches of ``batch`` in pool
  order, round and round; a calibration batch of ``calib`` images is
  drawn apart.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

#: streams of one seed's generator
_PROMPTS, _CALIB, _POOL, _ORDER = 1, 2, 3, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of a seed (any whole number >= 0)."""
    return np.random.default_rng([int(seed), stream])


def quantiles(dist: dict, strata: int) -> list[int]:
    """The ``strata`` quantiles at (i + 1/2) / strata of a length
    distribution, rounded and clipped."""
    out = []
    for i in range(strata):
        p = (i + 0.5) / strata
        if dist["dist"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(p)
            v = dist["median"] * math.exp(dist["sigma"] * z)
        elif dist["dist"] == "uniform":
            v = dist["min"] + p * (dist["max"] - dist["min"])
        else:
            raise ValueError(f"unknown length distribution {dist['dist']!r}")
        out.append(int(min(max(round(v), dist["min"]), dist["max"])))
    return out


def requests(mix: dict, seed: int, vocab: int):
    """Endless (prompt token ids, output tokens) of a closed-loop mix."""
    g, order = rng(seed, _PROMPTS), rng(seed, _ORDER)
    n = mix["strata"]
    plens = quantiles(mix["prompt_tokens"], n)
    olens = quantiles(mix["output_tokens"], n)
    while True:
        for i, j in zip(order.permutation(n), order.permutation(n)):
            yield (g.integers(0, vocab, plens[i]).tolist(), olens[j])


def images(mix: dict, seed: int, side: int, channels: int
           ) -> tuple[np.ndarray, np.ndarray]:
    """(calibration batch, pool) of an image-stream mix, NHWC float32."""
    shape = (side, side, channels)
    calib = rng(seed, _CALIB).standard_normal(
        (mix["calib"],) + shape, dtype=np.float32)
    pool = rng(seed, _POOL).standard_normal(
        (mix["pool"],) + shape, dtype=np.float32)
    return calib, pool
