"""Vocabulary stress test at map scale.

The reference ships a 1M-leaf DBoW2 tree (main.cc:92-97) and its retrieval
quality is what loop detection and relocalization live on. This tool measures
retrieval precision/recall of candidate vocabularies on a ≥200-keyframe map —
far beyond the few-dozen-KF regime the unit tests cover — with ground truth
from the synthetic renderer's exact poses.

Protocol:
  * Build a keyframe corpus: K views on a 2-revolution room circuit with
    varied height/radius rings (revisits guaranteed, viewpoints overlap but
    differ), extracted with the production ORB front-end.
  * Queries: held-out poses between keyframe stations with small pose noise.
  * Ground truth: a keyframe is relevant to a query iff their viewing
    directions agree within `gt_angle_deg` AND positions within `gt_dist`
    (frustum-overlap proxy — same gate the loop-recall eval uses).
  * Score every (query, keyframe) pair with the DBoW2 L1 tf-idf score
    (s = Σ min(q_w, d_w), the dense form of KeyFrameDatabase scoring) and
    report P@1 / R@5 / MRR, plus per-frame quantization wall time.

Scoring here is sparse-by-keyframe (per-KF word-id/value lists, query dense),
so vocabularies up to 10^6 words cost O(K·N) not O(K·n_words).

Usage:
  python tools/vocab_stress.py --cpu --kfs 240 --queries 80 \
      --vocab packaged --vocab tiny --out docs/vocab_stress.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_views(n_kf: int, n_q: int, seed: int = 0, revs: float = 2.0,
                rings: int = 2, varied: bool = False):
    """Render keyframe + query views with GT camera centers/directions.

    `varied=True` swaps the wall textures for held-out instances of the
    widened texture family (seed range disjoint from every training corpus:
    the packaged 100k tree trained on default textures, the 1M candidate on
    varied seeds 1000+s) — retrieval is then measured out-of-domain for all
    candidate trees."""
    import jax.numpy as jnp
    import numpy as np

    from gf_orb_slam_tpu.geometry import quat, se3
    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu.io_utils import synthetic

    scene = synthetic.make_room_scene(seed=seed)
    if varied:
        trng = np.random.default_rng(5000 + seed)
        tex = np.stack([
            synthetic.varied_texture(trng, scene.tex_size)
            for _ in range(scene.textures.shape[0])
        ])
        scene = scene._replace(textures=jnp.asarray(tex))
    rng = np.random.default_rng(seed + 1)

    def pose_at(th, radius, bob):
        pos = jnp.asarray(
            [radius * np.sin(th), bob, radius * np.cos(th)], jnp.float32
        )
        q_wc = quat.v2q(jnp.asarray([0.0, th, 0.0], jnp.float32))
        return se3.inverse(se3.make_pose(q_wc, pos))

    # Keyframe stations: `revs` revolutions over `rings` rings (radius/height
    # vary), so revisited directions exist at many distinct viewpoints and a
    # query's near-misses (same wall, station a few degrees over) are visually
    # near-identical — the retrieval task hardens with station density.
    kf_poses, kf_meta = [], []
    for i in range(n_kf):
        th = 2.0 * np.pi * revs * i / n_kf
        ring = i % max(rings, 1)
        radius = 4.0 - 0.4 * ring
        bob = 0.12 * (ring - (rings - 1) / 2.0)
        kf_poses.append(pose_at(th, radius, bob))
        kf_meta.append((th, radius, bob))

    # Queries: halfway between stations, jittered.
    q_poses, q_meta = [], []
    for j in range(n_q):
        i = (j * n_kf) // n_q
        th = 2.0 * np.pi * revs * (i + 0.5) / n_kf + rng.normal(0, 0.01)
        radius = 3.75 + rng.normal(0, 0.1)
        bob = rng.normal(0, 0.1)
        q_poses.append(pose_at(th, radius, bob))
        q_meta.append((th, radius, bob))

    def centers_dirs(poses):
        cs, ds = [], []
        for p in poses:
            p_wc = se3.inverse(p)
            cs.append(np.asarray(se3.pose_t(p_wc)))
            # camera looks along +z of the camera frame in world coords
            R = np.asarray(quat.q2r(se3.pose_q(p_wc)))
            ds.append(R[:, 2])
        return np.stack(cs), np.stack(ds)

    return scene, EUROC_CAM, kf_poses, q_poses, centers_dirs(kf_poses), centers_dirs(q_poses)


def extract_all(scene, cam, poses, n_features=800):
    import jax.numpy as jnp

    from gf_orb_slam_tpu.io_utils import synthetic
    from gf_orb_slam_tpu.ops import orb

    cfg = orb.OrbConfig(n_features=n_features)
    out = []
    for p in poses:
        img = synthetic.render_general(scene, cam, jnp.asarray(p))
        kp = orb.extract_orb(img, cfg)
        out.append((kp.desc, kp.valid))
    return out


def sparse_bow(voc, desc, valid):
    """Per-frame (word_ids, tfidf_values) with L1 normalization — the sparse
    form of vocabulary.bow_vector, O(N) memory at any vocabulary size."""
    import numpy as np

    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod

    words, _ = voc_mod.quantize(voc, desc, valid)
    w = np.asarray(words)
    w = w[w >= 0]
    ids, tf = np.unique(w, return_counts=True)
    vals = tf.astype(np.float64) * np.asarray(voc.weights)[ids]
    s = vals.sum()
    if s > 0:
        vals = vals / s
    return ids, vals.astype(np.float32)


def l1_score_sparse(q_ids, q_vals, d_ids, d_vals):
    import numpy as np

    qi = {int(i): float(v) for i, v in zip(q_ids, q_vals)}
    s = 0.0
    for i, v in zip(d_ids, d_vals):
        qv = qi.get(int(i))
        if qv is not None:
            s += min(qv, float(v))
    # Σ min(q, d) — same scale as retrieval.vocabulary.l1_score
    # (1 − 0.5·L1 for normalized vectors), so absolute scores here are
    # directly comparable to the loop detector's score gates.
    return s


def evaluate(voc, kf_feats, q_feats, gt_mat, far_mat):
    """P@1 / R@5 / MRR plus the metric loop detection actually lives on:
    the score MARGIN best-relevant / best-far-irrelevant (far = outside 2×
    the GT gates — same-texture different-place distractors). The reference's
    DetectLoopCandidates gates on score vs the min covisible score
    (KeyFrameDatabase.cc:75-196); a vocabulary with a larger margin admits
    fewer false candidates at any gate."""
    import numpy as np

    t0 = time.perf_counter()
    kf_bows = [sparse_bow(voc, d, v) for d, v in kf_feats]
    q_bows = [sparse_bow(voc, d, v) for d, v in q_feats]
    quant_ms = (time.perf_counter() - t0) * 1000.0 / (len(kf_feats) + len(q_feats))

    p1 = r5 = mrr = 0.0
    margins = []
    margins_near = []
    n_q = len(q_bows)
    for qi, (qid, qv) in enumerate(q_bows):
        scores = np.asarray(
            [l1_score_sparse(qid, qv, did, dv) for did, dv in kf_bows]
        )
        order = np.argsort(-scores)
        rel = gt_mat[qi]
        far = far_mat[qi]
        near = ~rel & ~far  # same-wall near-misses just outside the GT gate
        if not rel.any():
            n_q -= 1
            continue
        p1 += float(rel[order[0]])
        r5 += float(rel[order[:5]].any())
        rank = 1 + int(np.argmax(rel[order]))
        mrr += 1.0 / rank
        if far.any():
            margins.append(scores[rel].max() / max(scores[far].max(), 1e-9))
        if near.any():
            margins_near.append(scores[rel].max() / max(scores[near].max(), 1e-9))
    n_q = max(n_q, 1)

    def _stats(xs):
        return (
            (round(float(np.mean(xs)), 3), round(float(np.percentile(xs, 10)), 3))
            if xs else (None, None)
        )

    m_mean, m_p10 = _stats(margins)
    mn_mean, mn_p10 = _stats(margins_near)
    return {
        "p_at_1": round(p1 / n_q, 4),
        "r_at_5": round(r5 / n_q, 4),
        "mrr": round(mrr / n_q, 4),
        "margin_mean": m_mean,
        "margin_p10": m_p10,
        # Margin over NEAR distractors (same wall, a few stations over) — the
        # value the reference's min-covisible-score gate actually discriminates
        # on: near-misses are covisible in a real map, so a tree that cannot
        # rank the true station above them admits wrong-station candidates.
        "margin_near_mean": mn_mean,
        "margin_near_p10": mn_p10,
        "quantize_ms_per_frame": round(quant_ms, 2),
        "n_words": int(voc.n_words),
        "depth_L": int(voc.L),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=240)
    ap.add_argument("--queries", type=int, default=80)
    ap.add_argument("--revs", type=float, default=2.0)
    ap.add_argument("--rings", type=int, default=2)
    ap.add_argument("--varied", action="store_true",
                    help="held-out widened-texture walls (out-of-domain for "
                         "every candidate tree)")
    ap.add_argument("--vocab", action="append", default=[],
                    help="'packaged', 'tiny', or a path (.npz/.txt); repeatable")
    ap.add_argument("--gt-angle-deg", type=float, default=25.0)
    ap.add_argument("--gt-dist", type=float, default=1.2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="docs/vocab_stress.json")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod

    scene, cam, kf_poses, q_poses, (kc, kd), (qc, qd) = build_views(
        args.kfs, args.queries, args.seed,
        revs=args.revs, rings=args.rings, varied=args.varied,
    )
    print(f"extracting {args.kfs} keyframes + {args.queries} queries ...",
          file=sys.stderr)
    kf_feats = extract_all(scene, cam, kf_poses)
    q_feats = extract_all(scene, cam, q_poses)

    cos_gate = np.cos(np.deg2rad(args.gt_angle_deg))
    dist = np.linalg.norm(qc[:, None] - kc[None, :], axis=-1)
    gt = ((qd @ kd.T) > cos_gate) & (dist < args.gt_dist)
    far = ((qd @ kd.T) < np.cos(np.deg2rad(2.0 * args.gt_angle_deg))) | (
        dist > 2.0 * args.gt_dist
    )
    print(f"GT relevant per query: mean {gt.sum(1).mean():.1f}; "
          f"far distractors: mean {far.sum(1).mean():.1f}", file=sys.stderr)

    results = {}
    for spec in args.vocab or ["packaged", "tiny"]:
        if spec == "packaged":
            voc = voc_mod.load_default_vocabulary()
            if voc is None:
                print("packaged vocabulary missing; skipping", file=sys.stderr)
                continue
        elif spec == "tiny":
            # The on-the-fly fallback: trained from the first keyframes' own
            # descriptors (what run_slam does without a vocabulary file).
            descs = np.concatenate([
                np.asarray(d)[np.asarray(v)] for d, v in kf_feats[:20]
            ])
            voc = voc_mod.train_vocabulary(descs, k=10, L=3, seed=0)
        else:
            voc = voc_mod.load_vocabulary(spec)
        results[spec] = evaluate(voc, kf_feats, q_feats, gt, far)
        print(spec, results[spec], file=sys.stderr)

    payload = {
        "protocol": {
            "keyframes": args.kfs, "queries": args.queries,
            "gt_angle_deg": args.gt_angle_deg, "gt_dist_m": args.gt_dist,
            "gt_mean_relevant": float(gt.sum(1).mean()),
            "seed": args.seed,
        },
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
