"""GF active matching: interleaved select-then-match by marginal logDet gain.

Reference: Observability::runActiveMapMatching (src/Observability.cc:1249-1818)
— the signature GF behavior: instead of matching every visible landmark and
then selecting, repeatedly pick the landmark with the highest *marginal*
logdet gain given the information accumulated so far, spend matching effort on
it, and only add its block if the match succeeds (failed matches consume
budget — the anytime property). The reference does this one landmark at a
time under a wall-clock cap with OnePoint projection searches.

Device redesign: match outcomes for all candidates are batch-precomputed (one
dense masked Hamming program — cheaper than lazy per-point search on an
accelerator), then the sequential gain-greedy runs as a lax.scan over rounds of
`chunk` attempts: per round, batched Cholesky logdets give every remaining
candidate's marginal gain, the top-chunk are "attempted", successful ones
contribute their info blocks, failures are struck from the pool. Budget =
n_rounds × chunk attempts — the static-compute equivalent of the reference's
time cap.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry import linalg
from gf_orb_slam_tpu.gf.selection import PRIOR_EPS, normalize_blocks


class ActiveMatchResult(NamedTuple):
    matched: jnp.ndarray     # (P,) bool — candidates matched during the run
    kp_of_point: jnp.ndarray  # (P,) int32 — keypoint slot each matched to
    info_total: jnp.ndarray  # (D, D)
    n_attempted: jnp.ndarray
    n_matched: jnp.ndarray


@partial(jax.jit, static_argnames=("budget", "chunk"))
def active_match(
    blocks: jnp.ndarray,       # (P, D, D) candidate info blocks
    candidate: jnp.ndarray,    # (P,) bool — visible, unmatched candidates
    match_ok: jnp.ndarray,     # (P,) bool — precomputed: would the match succeed
    match_kp: jnp.ndarray,     # (P,) int32 — the keypoint it would match to
    info_init: jnp.ndarray,    # (D, D) info from already-matched features
    budget: int = 100,
    chunk: int = 8,
) -> ActiveMatchResult:
    P, D, _ = blocks.shape
    n_rounds = -(-budget // chunk)
    # Same float32 conditioning discipline as selection.py: normalize blocks
    # (and the init info, by the same factor) so Cholesky survives the
    # early rounds; gains/ordering are scale-invariant.
    blocks, s = normalize_blocks(blocks, candidate)
    M0 = info_init / s + PRIOR_EPS * jnp.eye(D, dtype=blocks.dtype)

    def round_fn(carry, _):
        M, matched, struck, attempts = carry
        avail = candidate & ~matched & ~struck
        gains = linalg.logdet_psd(M[None] + blocks)
        gains = jnp.where(avail, gains, -jnp.inf)
        top_g, top_i = jax.lax.top_k(gains, chunk)
        ok_pick = jnp.isfinite(top_g)

        # Attempt the chunk: successes add blocks, failures get struck.
        success = ok_pick & match_ok[top_i]
        add = jnp.sum(
            jnp.where(success[:, None, None], blocks[top_i], 0.0), axis=0
        )
        M = M + add
        matched = matched.at[jnp.where(success, top_i, P)].set(True, mode="drop")
        struck = struck.at[jnp.where(ok_pick & ~success, top_i, P)].set(
            True, mode="drop"
        )
        attempts = attempts + jnp.sum(ok_pick.astype(jnp.int32))
        return (M, matched, struck, attempts), None

    init = (
        M0,
        jnp.zeros(P, bool),
        jnp.zeros(P, bool),
        jnp.asarray(0, jnp.int32),
    )
    (M, matched, _, attempts), _ = jax.lax.scan(round_fn, init, None, length=n_rounds)
    return ActiveMatchResult(
        matched=matched,
        kp_of_point=jnp.where(matched, match_kp, -1),
        info_total=M * s,
        n_attempted=attempts,
        n_matched=jnp.sum(matched.astype(jnp.int32)),
    )
