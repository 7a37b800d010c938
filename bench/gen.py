"""The benchmark's one traffic generator. A mix is a data file
(``traffic/<name>.json``) of parameters; this module turns it and a seed
into requests.

Every seed gets the same work in another order. Requests come in blocks
of ``block`` requests. Within a block each drawn quantity (document rank,
question length, output length, gap before the arrival) takes ``block``
stratified quantiles of its distribution, offset by an amount that
depends on the block's index alone, and the quantities are paired into
requests by permutations that depend on the block's index alone. The
seed orders the block's requests (``"order": "seed"``, the default), and
draws the tokens. So every seed offers the same multiset of sizes and
gaps, in an order of its own: where a block spans the window, the
arrivals within it bunch and thin out as a Poisson (or gamma) process
does, while the count over the whole window stays the block's. With
``"order": "block"`` the order too depends on the block's index (and the
stream) alone, and the seed draws only the tokens: every seed offers the
same requests in the same order. A backlog wants that, since its window
serves only part of a block, and which part the order would decide.

Parameters of a mix (keys of its JSON object):

* ``arrival``: ``{"kind": "poisson", "rate_per_s": r}`` (open loop:
  exponential gaps at rate r), ``{"kind": "gamma", "rate_per_s": r,
  "cv": c}`` (open loop with bursts: gamma gaps of mean 1/r and
  coefficient of variation c), or ``{"kind": "backlog",
  "waiting_per_slot": k, "warmup_per_slot": w}`` (work dispatched
  ahead: the harness keeps k requests a slot waiting, arrival is the
  moment of submission, and the warm-up ends once w requests a slot have
  finished).
* ``documents``: null, or ``{"count": n, "tokens": [lo, hi], "zipf_s":
  s}``: n shared documents whose lengths are the n-point grid over [lo,
  hi] in a fixed order, each request's document chosen by Zipf(s)
  popularity over the ranks. A prompt is its document followed by a
  unique question.
* ``question_tokens`` and ``output_tokens``: ``[lo, hi]`` (uniform
  integers) or ``{"lognormal": {"median": m, "sigma": s}, "min": lo,
  "max": hi}`` (a lognormal truncated to [lo, hi]).
* ``block``: requests a block.
* ``order``: ``"seed"`` (default) or ``"block"``, as above.

``Traffic(spec, vocab, seed).requests(stream)`` yields ``Request``s;
streams ``"warmup"`` and ``"window"`` are disjoint (own questions, own
order) and share the documents. A mix that needs another generator names
it in ``traffic/<name>.py`` (see ``harness.resolve_cell``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List, Optional

import numpy as np

_PHI = (math.sqrt(5.0) - 1.0) / 2.0     # block offsets: a low-discrepancy walk
_STREAMS = {"docs": 0, "warmup": 1, "window": 2}
_FIRST_TOKEN = 3                          # ids below are left unused
_ARRIVALS = ("poisson", "gamma", "backlog")
_ORDERS = ("seed", "block")


@dataclass
class Request:
    arrival_s: Optional[float]            # None: arrives when submitted
    prompt: List[int]
    max_new: int
    doc: int                              # document rank, -1 without one


def _offset(block: int, salt: float) -> float:
    return (block * _PHI + salt) % 1.0


def _quantiles(block: int, size: int, salt: float) -> np.ndarray:
    """``size`` stratified points in (0, 1): (k + u_b) / size."""
    return (np.arange(size) + _offset(block, salt)) / size


def lengths(q: np.ndarray, dist) -> np.ndarray:
    """Integer lengths at the quantiles ``q`` of a length distribution:
    ``[lo, hi]`` uniform, or a lognormal truncated to [min, max]."""
    if isinstance(dist, (list, tuple)):
        lo, hi = (int(x) for x in dist)
        return lo + np.minimum((q * (hi - lo + 1)).astype(np.int64), hi - lo)
    ln = dist["lognormal"]
    mu, sigma = math.log(float(ln["median"])), float(ln["sigma"])
    lo, hi = int(dist["min"]), int(dist["max"])
    z = NormalDist()
    f_lo = z.cdf((math.log(lo) - mu) / sigma)
    f_hi = z.cdf((math.log(hi + 1) - mu) / sigma)
    qq = f_lo + np.asarray(q) * (f_hi - f_lo)
    x = np.exp(mu + sigma * np.array([z.inv_cdf(min(max(v, 1e-12),
                                                    1 - 1e-12))
                                      for v in qq]))
    return np.clip(np.floor(x).astype(np.int64), lo, hi)


def gaps(q: np.ndarray, rate: float, cv: float = 1.0) -> np.ndarray:
    """Gaps between arrivals at the quantiles ``q``: exponential (cv 1)
    or gamma of shape 1/cv^2, mean 1/rate."""
    if cv == 1.0:
        return -np.log1p(-q) / rate
    from scipy.special import gammaincinv
    k = 1.0 / (cv * cv)
    return gammaincinv(k, q) / (k * rate)


def zipf_cdf(count: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, count + 1) ** s
    return np.cumsum(w) / w.sum()


def document_lengths(count: int, lo: int, hi: int) -> np.ndarray:
    """The n-point grid over [lo, hi], laid over the ranks in a fixed
    order (the golden-ratio walk), so that popular documents are neither
    all short nor all long, and the same for every seed."""
    grid = np.round(np.linspace(lo, hi, count)).astype(np.int64)
    order = np.argsort((np.arange(count) * _PHI) % 1.0, kind="stable")
    out = np.empty(count, np.int64)
    out[order] = grid
    return out


class Traffic:
    def __init__(self, spec: dict, vocab: int, seed: int,
                 salt: int = 0) -> None:
        self.spec = spec
        self.vocab = int(vocab)
        self.seed = int(seed)
        self.salt = int(salt)       # > 0: other requests, same documents
        self.block = int(spec.get("block", 64))
        arrival = spec["arrival"]
        self.kind = arrival["kind"]
        if self.kind not in _ARRIVALS:
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        self.open_loop = self.kind != "backlog"
        self.rate = float(arrival.get("rate_per_s", 0.0))
        self.cv = float(arrival.get("cv", 1.0))
        if self.open_loop and (self.rate <= 0 or self.cv <= 0):
            raise ValueError("an open-loop mix needs rate_per_s > 0 "
                             "and cv > 0")
        self.waiting_per_slot = int(arrival.get("waiting_per_slot", 0))
        self.warmup_per_slot = float(arrival.get("warmup_per_slot", 0.0))
        if not self.open_loop and self.warmup_per_slot <= 0:
            raise ValueError("a backlog mix needs warmup_per_slot > 0")
        self.order = spec.get("order", "seed")
        if self.order not in _ORDERS:
            raise ValueError(f"unknown order {self.order!r}")
        self.documents: List[np.ndarray] = []
        docs = spec.get("documents")
        if docs:
            rng = self._rng("docs")
            doc_lengths = document_lengths(int(docs["count"]),
                                           *docs["tokens"])
            self.documents = [self._tokens(rng, int(n)) for n in doc_lengths]
            self._doc_cdf = zipf_cdf(len(self.documents),
                                     float(docs["zipf_s"]))

    def _rng(self, stream: str, *more: int) -> np.random.Generator:
        key = [self.seed, _STREAMS[stream], *more]
        if self.salt and stream != "docs":
            key.append(self.salt)
        return np.random.default_rng(np.random.SeedSequence(key))

    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.integers(_FIRST_TOKEN, self.vocab, size=n, dtype=np.int64)

    def with_rate(self, rate: float, salt: int = 0) -> "Traffic":
        """The same mix at another arrival rate (the rate sweep); a
        ``salt`` gives other requests over the same documents."""
        spec = dict(self.spec, arrival=dict(self.spec["arrival"],
                                            rate_per_s=float(rate)))
        return Traffic(spec, self.vocab, self.seed, salt)

    def requests(self, stream: str) -> Iterator[Request]:
        """An endless stream of requests, block by block."""
        if stream not in ("warmup", "window"):
            raise ValueError(f"unknown stream {stream!r}")
        rng = self._rng(stream)
        M = self.block
        t, b = 0.0, 0
        while True:
            if self.order == "seed":
                order = self._rng(stream, 1 << 20, b).permutation(M)
            else:
                order = np.random.default_rng(np.random.SeedSequence(
                    [b, 4, _STREAMS[stream], self.salt])).permutation(M)
            qlen, olen, ranks, gap = (x[order] for x in self.sizes(b))
            for k in range(M):
                question = self._tokens(rng, int(qlen[k]))
                doc = int(ranks[k])
                prompt = (np.concatenate([self.documents[doc], question])
                          if doc >= 0 else question)
                arrival = None
                if self.open_loop:
                    t += float(gap[k])
                    arrival = t
                yield Request(arrival, prompt.tolist(), int(olen[k]), doc)
            b += 1

    def sizes(self, b: int):
        """Block b's requests as (question length, output length, document,
        gap before it) arrays: each quantity's stratified quantiles, paired
        across quantities by permutations that depend on b alone."""
        M = self.block

        def paired(x, salt):
            fixed = np.random.default_rng(np.random.SeedSequence([b, salt]))
            return x[fixed.permutation(M)]

        qlen = lengths(_quantiles(b, M, 0.11), self.spec["question_tokens"])
        olen = paired(lengths(_quantiles(b, M, 0.37),
                              self.spec["output_tokens"]), 1)
        if self.documents:
            ranks = np.searchsorted(self._doc_cdf, _quantiles(b, M, 0.59),
                                    side="right")
            ranks = paired(np.minimum(ranks, len(self.documents) - 1), 2)
        else:
            ranks = np.full(M, -1)
        gap = (paired(gaps(_quantiles(b, M, 0.83), self.rate, self.cv), 3)
               if self.open_loop else np.zeros(M))
        return qlen, olen, ranks, gap
