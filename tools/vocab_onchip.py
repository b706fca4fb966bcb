#!/usr/bin/env python
"""Device cost of the 1M-word vocabulary in the production loop-closing path:
quantize + sparse inverted-file scoring at a FULL K=256 keyframe database,
measured as chained dispatches on the accelerator (same discipline as
tools/profile_stages.py — a per-link dispatch floor, min of 3 reps;
differences between programs are the signal).

Programs measured:
  quantize         descriptor → leaf walk, N=1600 through k=10 L=6 (1M leaves)
  bow+register     quantize + tf-idf row build + db row write
  detect (K full)  query densify (1M,) + Σ min(q,d) over 256 sparse rows +
                   group scoring + top-k
  register_and_detect  the production fused per-insertion program

Usage:  python tools/vocab_onchip.py            # accelerator
        python tools/vocab_onchip.py --cpu      # functional check only
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--kfs", type=int, default=256)
    ap.add_argument("--n-kps", type=int, default=1600)
    ap.add_argument("--chain", type=int, default=6)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gf_orb_slam_tpu.mapping import map_state as ms
    from gf_orb_slam_tpu.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod

    voc = voc_mod.load_default_vocabulary()
    if voc is None:
        print("no packaged vocabulary found", file=sys.stderr)
        sys.exit(1)
    K, N = args.kfs, args.n_kps
    rng = np.random.default_rng(0)

    # A full database: K keyframes of random descriptors (word statistics of
    # random 256-bit strings differ from real ORB, but the COST of every
    # program here is shape-bound: gathers/scatters sized by (K, N) and
    # n_words, not by the values).
    descs = jnp.asarray(rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32))
    valid = jnp.ones((K, N), bool)
    db = kdb.empty_db(K, N, voc.n_words)
    for k in range(K):
        db = kdb.add_keyframe(db, voc, jnp.asarray(k), descs[k], valid[k])
        if k % 64 == 63:
            jax.block_until_ready(db.bow_ids)
    jax.block_until_ready(db.bow_ids)
    print(f"db ready: K={K} N={N} n_words={voc.n_words}", flush=True)

    # A small real-ish map for the fused program (covisibility needs obs).
    m = ms.empty_map(max_keyframes=K, max_points=16384, max_kps=N)
    obs = jnp.where(
        jnp.asarray(rng.random((K, N)) < 0.3),
        jnp.asarray(rng.integers(0, 16384, (K, N)), jnp.int32), ms.NO_POINT
    )
    m = m._replace(
        kf_valid=jnp.ones(K, bool), kf_obs_point=obs, kf_kp_desc=descs,
        kf_kp_valid=valid, pt_valid=jnp.ones(16384, bool),
    )

    covis = ms.covisibility(m)
    jax.block_until_ready(covis)

    def timed(name, fn, out_of):
        # Warm.
        s = fn(jnp.float32(0))
        jax.block_until_ready(s)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            acc = jnp.float32(0)
            for _ in range(args.chain):
                acc = fn(acc * 1e-12)
            jax.block_until_ready(acc)
            best = min(best, (time.perf_counter() - t0) / args.chain)
        print(f"{name:>24} {best * 1e3:9.2f} ms", flush=True)
        out_of[name] = best * 1e3
        return best

    results = {}

    @jax.jit
    def p_quantize(eps):
        w, _ = voc_mod.quantize(voc, descs[0] + eps.astype(jnp.uint32), valid[0])
        return jnp.sum(w).astype(jnp.float32)

    @jax.jit
    def p_register(eps):
        db2 = kdb.add_keyframe(db, voc, jnp.asarray(0),
                               descs[0] + eps.astype(jnp.uint32), valid[0])
        return jnp.sum(db2.bow_vals[0])

    @jax.jit
    def p_detect(eps):
        cand, ok = kdb.detect_loop_candidates(
            db, covis + eps.astype(jnp.int32), jnp.asarray(K - 1),
            max_candidates=6, exclude_kf=jnp.asarray(-1, jnp.int32),
            n_words=voc.n_words,
        )
        return jnp.sum(cand).astype(jnp.float32)

    def p_fused(eps):
        db2, _, _, _, cand, ok = kdb.register_and_detect(
            jax.tree.map(jnp.copy, db), voc.centers, voc.weights,
            voc.children, voc.word_of_node,
            m._replace(pt_pos=m.pt_pos + eps), jnp.asarray(K - 1),
            jnp.asarray(-1, jnp.int32),
            k=voc.k, L=voc.L, n_words=voc.n_words,
            max_candidates=6, do_detect=True,
        )
        return jnp.sum(cand).astype(jnp.float32)

    timed("quantize (N=1600)", p_quantize, results)
    timed("quantize+register row", p_register, results)
    timed("detect @ K full", p_detect, results)
    timed("register_and_detect", p_fused, results)

    payload = {
        "K": K, "N": N, "n_words": voc.n_words,
        "chain": args.chain,
        "programs_ms": results,
        "note": ("chained dispatches; a per-link floor applies to each "
                 "number — deltas between programs are the signal. "
                 "register_and_detect includes a db copy per link (the "
                 "production call donates instead)"),
    }
    print(json.dumps(payload))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)


if __name__ == "__main__":
    main()
