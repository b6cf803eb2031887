"""Self-speculation for the serving engine: n-gram prompt-lookup proposal,
a copy of ``ray_lightning_tpu/serving/speculative.py`` (pure host logic).

The draft is the request's own token history: the proposer finds the
longest suffix of the prompt and the delivered tokens that occurred before
and proposes what followed it. The engine scores the proposals in one
``decode_step_verify`` pass and greedily accepts only the prefix the model
itself would have emitted, so a wrong proposal costs compute, never
output: the accepted stream is token-identical to one-token decoding.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["ngram_propose"]


def ngram_propose(
    history: Sequence[int],
    max_propose: int,
    *,
    max_ngram: int = 3,
    min_ngram: int = 1,
) -> List[int]:
    """Propose up to ``max_propose`` continuation tokens for ``history``
    (prompt + every delivered token, oldest first) by prompt lookup.

    Tries suffix lengths ``max_ngram`` down to ``min_ngram``: for each,
    finds the MOST RECENT earlier occurrence of the current suffix and
    proposes the tokens that followed it. Longer suffixes are stronger
    evidence, so they are preferred; recency wins ties because local
    repetition (the current paragraph, the current code block) predicts
    better than distant repetition.

    Returns a possibly-empty list, never longer than ``max_propose``.
    The proposal may be SHORTER than ``max_propose`` when the matched
    continuation runs into the end of the history.
    """
    if max_propose <= 0:
        return []
    if min_ngram < 1:
        raise ValueError(f"min_ngram must be >= 1, got {min_ngram}")
    if max_ngram < min_ngram:
        raise ValueError(
            f"max_ngram ({max_ngram}) must be >= min_ngram ({min_ngram})"
        )
    hist = list(history)
    n = len(hist)
    for ng in range(min(max_ngram, n - 1), min_ngram - 1, -1):
        suffix = hist[n - ng:]
        # scan candidate match ends right-to-left (most recent first);
        # the match must end strictly before the suffix starts so the
        # continuation contains at least one token
        for end in range(n - 1, ng - 1, -1):
            if hist[end - ng:end] == suffix:
                # end < n, so the continuation has >= 1 token
                return hist[end:end + max_propose]
    return []
