"""Traffic from a mix file and a seed: the one generator every mix goes
through.

Every size is drawn by stratified sampling: ``n`` draws take the
quantiles ``(i + 0.5) / n`` of the stated distribution, in a shuffled
order. Sizes, gaps and their order come from one fixed stream
(``SIZES``), the same for every seed; the token ids and documents come
from the run's seed. So every seed sends the same work with other data,
and two runs differ by the program's timing alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

#: independent streams of one seed
_PROMPT, _OUTPUT, _RESIDUAL, _GAPS, _DOCS, _PICK, _SUFFIX, _IDS, _SAMPLE = \
    range(9)
#: the seed of the sizes' stream
SIZES = 0


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream, *more])


def strata(n: int, gen: np.random.Generator) -> np.ndarray:
    """The ``n`` quantile levels ``(i + 0.5) / n`` in a shuffled order."""
    return (gen.permutation(n) + 0.5) / n


def uniform_int(lo: int, hi: int, u: np.ndarray) -> np.ndarray:
    """Integers uniform on ``[lo, hi]`` at quantile levels ``u``."""
    return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)


def exponential(rate: float, u: np.ndarray) -> np.ndarray:
    """Exponential gaps of mean ``1 / rate`` at quantile levels ``u``."""
    return -np.log1p(-u) / rate


def settled_lives(lo: int, hi: int, u: np.ndarray, v: np.ndarray
                  ) -> tuple:
    """Requests in mid-life, as a closed loop of output lengths uniform
    on ``[lo, hi]`` holds them once it has settled: a slot observed at
    a random round holds a request of length ``L`` with probability
    proportional to ``L`` (longer requests hold their slot longer), at
    an age uniform on ``[0, L - 1]`` tokens served. Drawn by the
    residual ``L - age`` at quantile levels ``u`` (so completions are
    spread evenly over the rounds ahead), then ``L`` given the residual
    at levels ``v``. Returns ``(lengths, ages)``."""
    r = np.arange(1, hi + 1)
    # pairs (L, age) with residual r: one for each length L >= r
    w = hi - np.maximum(lo, r) + 1
    cdf = np.cumsum(w) / w.sum()
    res = r[np.minimum(np.searchsorted(cdf, u, side="right"), r.size - 1)]
    length = uniform_int(np.maximum(lo, res), hi, v)
    return length, length - res


def zipf_ranks(n_items: int, s: float, u: np.ndarray) -> np.ndarray:
    """0-based ranks drawn with probability proportional to
    ``(rank + 1) ** -s``, at quantile levels ``u``."""
    w = np.arange(1, n_items + 1, dtype=np.float64) ** -s
    cdf = np.cumsum(w / w.sum())
    return np.minimum(np.searchsorted(cdf, u, side="right"), n_items - 1)


@dataclasses.dataclass
class Request:
    """One request as the generator makes it: its index in the seed's
    sequence, prompt ids and output length; ``doc`` is the document an
    open-loop request asks about (-1: none), ``due_s`` its due time from
    the start of the schedule."""
    index: int
    prompt: np.ndarray
    max_new_tokens: int
    doc: int = -1
    due_s: float = 0.0


class ClosedTraffic:
    """``clients`` callers, each sending its next request when the last
    one ends. Request ``k`` of the sequence is the same for a seed
    whichever client sends it. The loop starts settled: the first
    ``engine.capacity`` requests are in mid-life (:func:`settled_lives`),
    their ``age`` tokens already served and part of the prompt they are
    submitted with, so set-up prefills the contexts a settled loop
    holds and the window decodes over them; the other clients queue."""

    def __init__(self, mix: Dict[str, Any], vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        n = int(mix["requests_pool"])
        self.clients = int(mix["clients"])
        self.live = min(self.clients, int(mix["engine"]["capacity"]))
        self.prompt_len = uniform_int(*mix["prompt_tokens"],
                                      strata(n, rng(SIZES, _PROMPT)))
        self.out_len = uniform_int(*mix["output_tokens"],
                                   strata(n, rng(SIZES, _OUTPUT)))
        self.age = np.zeros(n, np.int64)
        self.out_len[:self.live], self.age[:self.live] = settled_lives(
            *mix["output_tokens"], strata(self.live, rng(SIZES, _RESIDUAL)),
            strata(self.live, rng(SIZES, _RESIDUAL, 1)))
        self.issued = 0

    def request(self, k: int) -> Request:
        """Request ``k``: its prompt and the ``age`` tokens it has
        served as ids from the seed, and the tokens it has left."""
        if k >= self.prompt_len.size:
            raise RuntimeError(f"the mix's pool of {self.prompt_len.size} "
                               f"requests is used up")
        ids = rng(self.seed, _IDS, k).integers(
            0, self.vocab, int(self.prompt_len[k] + self.age[k]),
            dtype=np.int64)
        return Request(k, ids.astype(np.int32),
                       int(self.out_len[k] - self.age[k]))

    def next(self) -> Request:
        req = self.request(self.issued)
        self.issued += 1
        return req


class OpenTraffic:
    """Poisson arrivals at ``rate_per_s`` over the whole run (warm-up,
    window and the tail that waits for the window's last requests);
    each request is one of ``documents`` shared documents, picked with
    Zipf exponent ``zipf_s``, plus a question suffix of its own."""

    def __init__(self, mix: Dict[str, Any], vocab: int, seed: int,
                 rate_per_s: float, horizon_s: float):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        n = max(int(math.ceil(rate_per_s * horizon_s)), 1)
        gaps = exponential(rate_per_s, strata(n, rng(SIZES, _GAPS)))
        self.due_s = np.cumsum(gaps)
        n_docs = int(mix["documents"])
        ranks = zipf_ranks(n_docs, float(mix["zipf_s"]),
                           strata(n, rng(SIZES, _PICK)))
        # which document holds each popularity rank
        self.doc = rng(SIZES, _DOCS).permutation(n_docs)[ranks]
        self.suffix_len = uniform_int(*mix["suffix_tokens"],
                                      strata(n, rng(SIZES, _SUFFIX)))
        self.out_len = uniform_int(*mix["output_tokens"],
                                   strata(n, rng(SIZES, _OUTPUT)))
        self._docs: Optional[np.ndarray] = None

    @property
    def documents(self) -> np.ndarray:
        """``[documents, document_tokens]`` int32 ids, made in memory."""
        if self._docs is None:
            self._docs = rng(self.seed, _DOCS, 1).integers(
                0, self.vocab, (int(self.mix["documents"]),
                                int(self.mix["document_tokens"])),
                dtype=np.int64).astype(np.int32)
        return self._docs

    def __len__(self) -> int:
        return int(self.due_s.size)

    def request(self, k: int) -> Request:
        suffix = rng(self.seed, _IDS, k).integers(
            0, self.vocab, int(self.suffix_len[k]), dtype=np.int64)
        prompt = np.concatenate([self.documents[self.doc[k]],
                                 suffix.astype(np.int32)])
        return Request(k, prompt, int(self.out_len[k]), int(self.doc[k]),
                       float(self.due_s[k]))


def sample_requests(lengths: List[int], budget_tokens: int, seed: int,
                    count: int) -> List[int]:
    """Indices into ``lengths`` (served tokens of finished requests) to
    hold to the reference: the longest, then others in an order drawn
    from the seed, up to ``count`` requests or ``budget_tokens`` served
    tokens, whichever is first."""
    if not lengths:
        return []
    order = list(np.argsort(-np.asarray(lengths), kind="stable")[:1])
    rest = [int(i) for i in rng(seed, _SAMPLE).permutation(len(lengths))
            if int(i) != int(order[0])]
    picked, total = [int(order[0])], int(lengths[order[0]])
    for i in rest:
        if len(picked) >= count or total >= budget_tokens:
            break
        picked.append(i)
        total += int(lengths[i])
    return picked
