"""Keyframe database: BoW-scored retrieval for loop closing & relocalization.

Replaces src/KeyFrameDatabase.cc (310 LoC): the inverted file
(word → list<KeyFrame*>) becomes a SPARSE-BY-KEYFRAME tf-idf table —
each keyframe stores its ≤N (word id, value) pairs, so memory is
O(K·N) at ANY vocabulary size (the packaged 1M-word tree would cost
256×10⁶×4 B ≈ 1 GB as a dense (K, n_words) matrix; sparse it is 3 MB).
Scoring a query against every keyframe is one (K·N)-element gather of the
query's dense vector + an elementwise min — the same Σ min(q, d) L1 score
DBoW2 computes walking the inverted file. Covisibility-group aggregation
uses the covisibility matrix already derived from MapState.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.retrieval import vocabulary as vocab_mod


class BowDatabase(NamedTuple):
    """Per-keyframe sparse BoW state, capacity-aligned with MapState keyframes.

    bow_ids[k] holds the distinct word ids of keyframe k in keypoint order
    (duplicate occurrences and invalid slots padded with n_words, which every
    gather/scatter treats as out-of-range); bow_vals holds the L1-normalized
    tf-idf value of each id (0 at padding)."""

    bow_ids: jnp.ndarray    # (K, N) int32 word ids (n_words = padding)
    bow_vals: jnp.ndarray   # (K, N) float32 tf-idf values (0 at padding)
    words: jnp.ndarray      # (K, N) leaf word id per keypoint (−1 invalid)
    mid_nodes: jnp.ndarray  # (K, N) mid-level node id per keypoint
    valid: jnp.ndarray      # (K,) registered keyframes


def empty_db(max_keyframes: int, max_kps: int, n_words: int) -> BowDatabase:
    return BowDatabase(
        bow_ids=jnp.full((max_keyframes, max_kps), n_words, jnp.int32),
        bow_vals=jnp.zeros((max_keyframes, max_kps), jnp.float32),
        words=jnp.full((max_keyframes, max_kps), -1, jnp.int32),
        mid_nodes=jnp.full((max_keyframes, max_kps), -1, jnp.int32),
        valid=jnp.zeros(max_keyframes, bool),
    )


def add_keyframe(
    db: BowDatabase, voc: vocab_mod.Vocabulary, kf_id, desc, kp_valid
) -> BowDatabase:
    """Register a keyframe: quantize descriptors + store its sparse BoW row
    (ref KeyFrameDatabase::add + KeyFrame::ComputeBoW)."""
    words, mid = vocab_mod.quantize(voc, desc, kp_valid)
    v = vocab_mod.bow_vector(voc, words)        # dense (n_words,), transient
    n_words = voc.n_words
    N = words.shape[0]
    w = jnp.where(words >= 0, words, n_words)
    # First-occurrence mask: each distinct word contributes its full tf-idf
    # value exactly once (later duplicates pad to 0).
    order = jnp.argsort(w)
    sw = w[order]
    first_sorted = jnp.concatenate([jnp.ones(1, bool), sw[1:] != sw[:-1]])
    first = jnp.zeros(N, bool).at[order].set(first_sorted)
    ids = jnp.where(first & (w < n_words), w, n_words)
    vals = jnp.where(ids < n_words, jnp.take(v, jnp.minimum(ids, n_words - 1)), 0.0)
    return db._replace(
        bow_ids=db.bow_ids.at[kf_id].set(ids),
        bow_vals=db.bow_vals.at[kf_id].set(vals),
        words=db.words.at[kf_id].set(words),
        mid_nodes=db.mid_nodes.at[kf_id].set(mid),
        valid=db.valid.at[kf_id].set(True),
    )


def erase_keyframe(db: BowDatabase, kf_id) -> BowDatabase:
    return db._replace(valid=db.valid.at[kf_id].set(False))


def permute(db: BowDatabase, perm: jnp.ndarray) -> BowDatabase:
    """Apply a keyframe renumbering (from map_state.compact_keyframes) so the
    database rows stay aligned with the map's keyframe slots."""
    return BowDatabase(
        bow_ids=db.bow_ids[perm],
        bow_vals=db.bow_vals[perm],
        words=db.words[perm],
        mid_nodes=db.mid_nodes[perm],
        valid=db.valid[perm],
    )


def _scores_vs_dense(db: BowDatabase, v: jnp.ndarray) -> jnp.ndarray:
    """(K,) Σ min(q, d) against a dense (n_words,) query — one gather of the
    query at every keyframe's word ids (padding ids gather 0 via fill)."""
    q = jnp.take(v, db.bow_ids, mode="fill", fill_value=0.0)   # (K, N)
    return jnp.sum(jnp.minimum(q, db.bow_vals), axis=1)


@jax.jit
def query_scores(db: BowDatabase, v: jnp.ndarray) -> jnp.ndarray:
    """(n_words,) query vs all keyframes → (K,) L1 scores; invalid → −1."""
    return jnp.where(db.valid, _scores_vs_dense(db, v), -1.0)


@partial(jax.jit, static_argnames=("max_candidates", "n_words"))
def detect_loop_candidates(
    db: BowDatabase,
    covis: jnp.ndarray,        # (K, K) covisibility weights from MapState
    query_kf: jnp.ndarray,     # () int32
    max_candidates: int = 8,
    exclude_kf: jnp.ndarray | int = -1,  # e.g. a keyframe culled this round
                                         # whose BoW row is not yet tombstoned
    *,
    n_words: int,              # vocabulary size (static; densifies the query
                               # row transiently — 4 MB at 1M words). Required:
                               # a zero default would silently densify to a
                               # zero-length query and return no candidates.
):
    if n_words <= 0:
        raise ValueError("detect_loop_candidates needs n_words > 0")
    """ref KeyFrameDatabase::DetectLoopCandidates (cc:75-196):
    - minScore = worst BoW score between the query and its covisible KFs;
    - candidates: non-connected keyframes scoring ≥ minScore;
    - group scoring: each candidate's score is accumulated over its own top
      covisible neighbors; accept ≥ 0.75 × best group score.
    Returns (cand_ids (max_candidates,), cand_ok (max_candidates,)).
    """
    K = db.bow_ids.shape[0]
    v = jnp.zeros((n_words,), jnp.float32).at[db.bow_ids[query_kf]].add(
        db.bow_vals[query_kf], mode="drop"
    )
    scores = _scores_vs_dense(db, v)                         # (K,)
    # The reference excludes only covisibility-GRAPH neighbors (edges require
    # ≥15 shared points, KeyFrame.cc:372-383); a stray shared point or two
    # must not disqualify a genuine loop candidate.
    connected = covis[query_kf] >= 15
    is_self = jnp.arange(K) == query_kf

    # minScore over covisible neighbors (ref: loop candidates must beat the
    # worst covisible similarity).
    covis_scores = jnp.where(connected & db.valid, scores, jnp.inf)
    has_covis = jnp.isfinite(covis_scores).any()
    min_score = jnp.where(has_covis, jnp.min(covis_scores), 0.1)
    min_score = jnp.maximum(min_score, 0.0)

    eligible = (
        db.valid & ~connected & ~is_self & (scores >= min_score)
        & (jnp.arange(K) != exclude_kf)
    )

    # Group score: candidate + its top-10 covisible neighbors' scores summed
    # over eligible-or-not neighbors that share enough covisibility.
    neigh = covis > 15  # (K, K) boolean adjacency
    grp = scores[None, :] * (neigh & db.valid[None, :] & eligible[None, :])
    group_score = scores + jnp.sum(
        jnp.where(grp > 0, grp, 0.0), axis=1
    )
    group_score = jnp.where(eligible, group_score, -1.0)

    best = jnp.max(group_score)
    keep = eligible & (group_score >= 0.75 * best) & (best > 0)
    ranked = jnp.where(keep, group_score, -1.0)
    top_vals, top_ids = jax.lax.top_k(ranked, max_candidates)
    return top_ids.astype(jnp.int32), top_vals > 0


@partial(jax.jit, static_argnames=("max_candidates",))
def detect_reloc_candidates(
    db: BowDatabase,
    covis: jnp.ndarray,
    v_query: jnp.ndarray,      # (n_words,) BoW of the lost frame
    max_candidates: int = 8,
):
    """ref DetectRelocalisationCandidates (cc:198-310): same group-scoring
    scheme without the covisibility exclusion (the query is not in the map)."""
    K = db.bow_ids.shape[0]
    scores = jnp.where(db.valid, _scores_vs_dense(db, v_query), -1.0)
    neigh = covis > 15
    grp = scores[None, :] * (neigh & db.valid[None, :] & (scores > 0)[None, :])
    group_score = scores + jnp.sum(jnp.where(grp > 0, grp, 0.0), axis=1)
    group_score = jnp.where(db.valid & (scores > 0), group_score, -1.0)
    best = jnp.max(group_score)
    keep = (group_score >= 0.75 * best) & (best > 0)
    ranked = jnp.where(keep, group_score, -1.0)
    top_vals, top_ids = jax.lax.top_k(ranked, max_candidates)
    return top_ids.astype(jnp.int32), top_vals > 0


@partial(
    jax.jit,
    static_argnames=("k", "L", "n_words", "max_candidates", "do_detect"),
    donate_argnums=(0,),
)
def register_and_detect(
    db: BowDatabase,
    centers: jnp.ndarray,
    weights: jnp.ndarray,
    children: jnp.ndarray | None,
    word_of_node: jnp.ndarray | None,
    m,                         # mapping.map_state.MapState (read-only here)
    kf_id: jnp.ndarray,
    exclude_kf: jnp.ndarray,
    *,
    k: int,
    L: int,
    n_words: int,
    max_candidates: int = 6,
    do_detect: bool = True,
):
    """Post-insertion place-recognition work as ONE device program: quantize
    the new keyframe's descriptors, register its sparse BoW row, build the
    covisibility matrix, and rank loop candidates. Previously this ran as
    eager host calls (add_keyframe ≈10 dispatches incl. a dense (n_words,)
    bow_vector build, covisibility ≈4, detect 1) — ~15 host round trips per
    keyframe insertion; now it is one dispatch. Returns (db', covis, cand,
    ok); covis/cand/ok are None when do_detect=False (early map)."""
    from gf_orb_slam_tpu.mapping import map_state as _ms

    voc = vocab_mod.Vocabulary(
        centers=centers, weights=weights, k=k, L=L,
        children=children, word_of_node=word_of_node,
    )
    db = add_keyframe(db, voc, kf_id, m.kf_kp_desc[kf_id], m.kf_kp_valid[kf_id])
    if not do_detect:
        return db, None, None, None, None, None
    covis = _ms.covisibility(m)
    cand, ok = detect_loop_candidates(
        db, covis, kf_id, max_candidates=max_candidates,
        exclude_kf=exclude_kf, n_words=n_words,
    )
    # The host's consistency/GT logic needs only the query row and the
    # candidates' rows of the covisibility matrix — returning them separately
    # lets the host fetch ~8 KB instead of the full (K,K) 262 KB per
    # insertion (the full matrix stays on device for correct_loop).
    return db, covis, covis[kf_id], covis[cand], cand, ok


def bow_match_mask(
    words_q: jnp.ndarray, words_t: jnp.ndarray,
    valid_q: jnp.ndarray, valid_t: jnp.ndarray,
) -> jnp.ndarray:
    """BoW-accelerated matching gate (ref ORBmatcher::SearchByBoW, cc:724):
    only descriptor pairs quantized to the same vocabulary node are candidates
    — the FeatureVector node-grouping as a dense equality mask."""
    return (
        (words_q[:, None] == words_t[None, :])
        & (words_q >= 0)[:, None]
        & (words_t >= 0)[None, :]
        & valid_q[:, None]
        & valid_t[None, :]
    )
