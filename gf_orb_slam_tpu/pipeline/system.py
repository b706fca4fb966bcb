"""Full SLAM system orchestration (reference src/main.cc + Tracking::Run +
LocalMapping::Run wiring).

The reference's three mutex-synchronized threads become host-sequenced calls
into jitted device programs sharing one functional MapState. The host holds
only scalars (state machine enum, counters); all geometry lives on device.
XLA's async dispatch gives tracker/mapper overlap for free on one chip; the
multi-chip version shards the mapper (parallel/global_ba.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam_tpu.geometry import se3
from gf_orb_slam_tpu.geometry.camera import CameraModel
from gf_orb_slam_tpu.loop import loop_closing
from gf_orb_slam_tpu.mapping import frame as frame_mod
from gf_orb_slam_tpu.mapping import map_state as ms
from gf_orb_slam_tpu.ops import matching, orb
from gf_orb_slam_tpu.pipeline import track_view as tv
from gf_orb_slam_tpu.pipeline import tracking
from gf_orb_slam_tpu.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod
from gf_orb_slam_tpu.solvers import initializer, local_ba


class State(enum.Enum):
    """ref Tracking.h:163-170 eTrackingState."""

    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    INITIALIZING = 2
    WORKING = 3
    LOST = 4


@dataclass
class SlamConfig:
    n_features: int = 800
    n_levels: int = 8
    scale: float = 1.2
    fast_threshold: float = 20.0
    max_keyframes: int = 256
    max_points: int = 16384
    use_motion_model: bool = True
    use_gf: bool = False            # Good-Feature selection in local-map tracking
    gf_mode: str = "subset"         # "subset" | "hybrid" | "lazier" | "auto" |
                                    # "active" | "random" | "longlive"
    gf_budget: int = 100
    gf_batch: int = 10              # picks per greedy round: rounds = k/batch,
                                    # and each round of the scan is a serial
                                    # step whatever its math costs.
                                    # Joint top-10 commits measure <0.01 logdet
                                    # degradation vs pick-at-a-time exact
                                    # greedy (tests/test_gf.py)
    gf_warmup_frames: int = 40      # ref: GF off for ~5s after init (Tracking.h:104)
    max_frames_between_kf: int = 12  # ref mMaxFrames = 18*fps/30, scaled down
    ba_window: int = 8              # local BA camera window
    ba_fixed: int = 2               # fixed boundary cameras in the window
    ba_points: int = 2048           # compacted local-point capacity for BA
                                    # (local windows carry ≤~2k live points on
                                    # the bench/circuit scenes; the Schur
                                    # tensors scale linearly in this)
    ba_iters: tuple = (5, 10)       # windowed-BA LM iterations per stage (ref
                                    # LocalBundleAdjustment's 5-then-10,
                                    # Optimizer.cc:1672-1723). Round 5 tried
                                    # (4,6) — ATE matched (5,10) on two
                                    # GF-100 circuit seeds — but scene seed 2
                                    # at budget 0 (pipelined) decayed to
                                    # tracking LOSS by
                                    # frame ~50: the young map built during
                                    # cadence-floor insertion never refines
                                    # enough. Early-map quality needs the
                                    # full schedule; do not trim this without
                                    # a full budget×scene sweep.
    min_init_matches: int = 80
    init_min_points: int = 0        # >0: POST-init quality gate — reject a
                                    # two-view bootstrap whose map holds
                                    # fewer surviving points after the
                                    # initial BA (the reference resets when
                                    # the post-init map tracks <100 points,
                                    # Tracking.cc CreateInitialMap). Scene
                                    # seed 1's init is a numerics knife edge:
                                    # ulp-level reordering can leave a weak
                                    # retry map that drifts by decimetres.
                                    # Default 0 (off) because the accuracy
                                    # sweep was measured without it; turning
                                    # it on (~100) needs a re-sweep.
    triangulate_neighbors: int = 3
    # place recognition / loop closing
    enable_loop_closing: bool = True
    enable_relocalization: bool = True
    vocab_k: int = 10
    vocab_L: int = 3
    vocab_train_kfs: int = 4        # train the vocabulary once this many KFs exist
    loop_min_kf_gap: int = 10       # don't try loops against recent keyframes
    loop_probe_floor: int = 0       # >0: instrumentation mode — lower the
                                    # Sim3-RANSAC gate floor to this so
                                    # borderline candidates still flow through
                                    # rematch+OptimizeSim3 and their per-gate
                                    # funnel counts land in loop_gate_events
                                    # (the accept decision keeps the shipped
                                    # ≥20/≥20 thresholds either way)
    view_size: int = 4096           # local-map tracking view capacity
    max_lost_frames: int = 100      # give up after this many LOST frames (ref 5s rule)
    pipelined: bool = False         # late readback (overlaps the fetch with
                                    # the next frames' dispatch)
    pipeline_depth: int = 4         # frames in flight when pipelined (deeper =
                                    # keyframe/loss decisions may lag further
                                    # behind the camera)
    eager_finalize: bool = True     # finalize as soon as is_ready() — cuts the
                                    # keyframe-decision lag to true device
                                    # latency


@dataclass
class FrameLog:
    timestamp: float
    state: str
    pose_cw: np.ndarray | None
    n_inliers: int
    timing_ms: dict = field(default_factory=dict)


class SlamSystem:
    def __init__(self, cam: CameraModel, cfg: SlamConfig | None = None):
        self.cam = cam
        self.cfg = cfg or SlamConfig()
        self.orb_cfg = orb.OrbConfig(
            n_features=self.cfg.n_features,
            n_levels=self.cfg.n_levels,
            scale=self.cfg.scale,
            fast_threshold=self.cfg.fast_threshold,
        )
        # Dedicated initialization extractor with 2x features (ref
        # mpIniORBextractor, Tracking.cc:520-525).
        self.init_orb_cfg = self.orb_cfg._replace(n_features=2 * self.cfg.n_features)
        self.state = State.NO_IMAGES_YET
        # Keypoint capacity sized for the 2x initialization extractor, whose
        # frames become the first two keyframes.
        self.map = ms.empty_map(
            max_keyframes=self.cfg.max_keyframes,
            max_points=self.cfg.max_points,
            max_kps=2 * self.cfg.n_features,
        )
        self.frame_id = 0
        self.last_kf_frame = 0
        self.last_reloc_frame = -(10**9)
        self.init_frame = None
        self.init_ts = None
        self.last_frame = None
        self.last_obs = None
        self.last_pose = None
        self.last_ts = None
        self.velocity = None         # (7,) relative pose T_cur_last
        self.n_ref_tracked = 0
        self.n_kf = 0
        self.trajectory: list[tuple[float, np.ndarray]] = []
        self.logs: list[FrameLog] = []
        self._seed = 0
        self._key = jax.random.PRNGKey(self._seed)
        self._rolling_key = None     # device copy, advanced by the fused program
        self._dt_cache: dict = {}
        self.frames_since_init = 0
        # place recognition state
        self.voc: voc_mod.Vocabulary | None = None
        self.bow_db: kdb.BowDatabase | None = None
        self.loop_detector = loop_closing.LoopDetector()
        self.n_loops_closed = 0
        self.n_compactions = 0   # keyframe-slab compactions (endurance metric)
        # Loop-recall evaluation hook (synthetic GT only): a callable
        # (frame_id_query, frame_id_old) -> bool "GT frusta overlap". When
        # set, every loop-detection round appends an event to loop_events
        # recording whether a genuine revisit OPPORTUNITY existed (an old,
        # covisibility-disconnected keyframe viewing the same GT region) and
        # whether a closure fired — the numerator/denominator of loop recall
        # (tools/loop_recall.py).
        self.loop_gt_overlap = None
        self.loop_events: list[dict] = []
        # Per-candidate verify-gate funnel records (loop_probe_floor > 0):
        # {kf, cand, n_bow, n_ransac, n_guided, n_opt, accepted, gt_true}.
        self.loop_gate_events: list[dict] = []
        self.lost_frames = 0
        self._inflight = []  # deque of dispatched-but-unfinalized frames
        self._pending_kf = []  # deferred keyframe-insertion finalizations
        self.track_view = tv.empty_view(self.cfg.view_size, self.cfg.max_points)
        from gf_orb_slam_tpu.io_utils.timing import TimeLog

        self.time_log = TimeLog()

    # ------------------------------------------------------------------
    def set_vocabulary(self, voc: voc_mod.Vocabulary):
        """Use a pretrained vocabulary (ref main.cc:92-97 loads ORBvoc at
        startup) instead of the on-the-fly trained one; survives reset()."""
        self.voc = voc
        self._preset_voc = voc
        self.bow_db = kdb.empty_db(
            self.map.kf_capacity, self.map.kp_capacity, voc.n_words
        )

    # ------------------------------------------------------------------
    def load_map_state(self, m: ms.MapState, voc=None, db=None):
        """Resume from a saved map (io_utils/snapshot.py): the system starts
        LOST and relocalizes against the loaded map on the first frames — the
        localization-resume capability the reference lacks (map is in-memory
        only there, SURVEY §5). The map's capacities must match this config
        (same n_features/max_keyframes/max_points)."""
        if m.kp_capacity != self.map.kp_capacity:
            raise ValueError(
                f"snapshot keypoint capacity {m.kp_capacity} != configured "
                f"{self.map.kp_capacity} (2*n_features) — load with the same config"
            )
        self.map = m
        self.n_kf = int(np.asarray(m.kf_valid).sum())
        if voc is not None:
            self.voc = voc
            self._preset_voc = voc
        if db is not None:
            self.bow_db = db
        self.state = State.LOST
        self.lost_frames = 0

    # ------------------------------------------------------------------
    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _frame_key(self):
        """Per-frame PRNG key: a raw threefry uint32 pair (seed word, frame
        counter) — jax.random.split here would be one extra device dispatch
        per tracked frame. The first WORKING frame
        transfers it once; afterwards the fused program increments it ON
        DEVICE (FusedTrackResult.next_key), so steady-state frames pay no h2d
        for the key at all."""
        if self._rolling_key is None:
            self._rolling_key = jnp.asarray(
                np.asarray([0x9E3779B9 ^ self._seed, self.frame_id], np.uint32)
            )
        return self._rolling_key

    def _dt_const(self, dt: float):
        """Device scalar for the frame interval, cached by value: sequences
        run at fixed fps, so this is one transfer per unique dt instead of
        one per frame."""
        k = round(float(dt), 6)
        v = self._dt_cache.get(k)
        if v is None:
            if len(self._dt_cache) > 16:
                self._dt_cache.clear()
            v = self._dt_cache[k] = jnp.asarray(k, jnp.float32)
        return v

    def process(self, img: jnp.ndarray, timestamp: float) -> FrameLog:
        cfg_now = (
            self.init_orb_cfg
            if self.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED, State.INITIALIZING)
            else self.orb_cfg
        )
        self.time_log.start_frame(timestamp)
        log = FrameLog(timestamp=timestamp, state=self.state.name, pose_cw=None, n_inliers=0)

        if self.state == State.WORKING:
            # Extraction happens inside the fused tracking program.
            self._track(jnp.asarray(img, jnp.float32), timestamp, log)
        else:
            self.time_log.begin("extraction")
            frame = frame_mod.make_frame(jnp.asarray(img, jnp.float32), self.cam, cfg_now)
            self.time_log.end()
            if self.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED):
                self._first_initialization(frame, timestamp)
            elif self.state == State.INITIALIZING:
                self._initialize(frame, timestamp)
            elif self.state == State.LOST:
                self._relocalize(frame, timestamp, log)

        log.state = self.state.name
        self.frame_id += 1
        self.time_log.end_frame(lmk_inlier=log.n_inliers)
        log.timing_ms = dict(self.time_log.frames[-1].stages_ms)
        self.logs.append(log)
        return log

    # ------------------------------------------------------------------
    def _first_initialization(self, frame, timestamp):
        """ref Tracking::FirstInitialization (cc:920-985)."""
        if int(frame.valid.sum()) > 100:
            self.init_frame = frame
            self.init_ts = timestamp
            self.state = State.INITIALIZING

    def _initialize(self, frame, timestamp):
        """ref Tracking::Initialize (cc:988-1195) + CreateInitialMap (cc:1199)."""
        if int(frame.valid.sum()) <= 100:
            self.state = State.NOT_INITIALIZED
            return
        f0 = self.init_frame
        mask = matching.window_mask(f0.uv, frame.uv, 100.0, f0.valid, frame.valid)
        # level-0 only, as the reference's SearchForInitialization
        lvl0 = (f0.octave == 0)[:, None] & (frame.octave == 0)[None, :]
        res = matching.match(
            f0.desc, frame.desc, mask & lvl0, max_dist=matching.TH_LOW, ratio=0.9,
            angle_q=f0.angle, angle_t=frame.angle, mutual=True,
        )
        n_matches = int(res.matched.sum())
        if n_matches < self.cfg.min_init_matches:
            self.state = State.NOT_INITIALIZED
            return

        uv2 = frame.uv[res.idx]
        two = initializer.initialize_two_view(
            self.cam, f0.uv, uv2, res.matched, self._next_key()
        )
        if not bool(two.success):
            return  # keep trying against the same init frame

        # --- create initial map (2 keyframes + triangulated points) ---
        tri = np.asarray(two.is_triangulated)
        X = np.asarray(two.points3d)
        # Scale normalization by median depth (ref CreateInitialMap's
        # ComputeSceneMedianDepth scaling, cc:1248-1263).
        med_depth = float(np.median(X[tri][:, 2]))
        X = X / med_depth
        pose1 = se3.identity_pose()
        pose21 = two.pose21
        pose2 = se3.make_pose(
            se3.pose_q(pose21), se3.pose_t(pose21) / med_depth
        )

        N = frame.capacity
        m = self.map
        slots = jnp.arange(N, dtype=jnp.int32)  # first N point slots
        use = jnp.asarray(tri)
        obs0 = jnp.where(use, slots, ms.NO_POINT)
        obs1_scatter = jnp.full((N,), ms.NO_POINT, jnp.int32).at[
            jnp.where(use, res.idx, N)
        ].set(jnp.where(use, slots, 0), mode="drop")

        m = ms.add_points(
            m, slots, jnp.asarray(X, jnp.float32), f0.desc,
            jnp.zeros((N, 3)), jnp.full((N,), 0.05), jnp.full((N,), 100.0),
            first_kf=jnp.asarray(0), first_frame=jnp.asarray(self.frame_id),
            use=use,
        )
        m, kf0 = ms.add_keyframe(
            m, pose1, jnp.asarray(self.frame_id - 1), jnp.asarray(self.init_ts, jnp.float32),
            f0.uv, f0.octave, f0.angle, f0.desc, f0.valid, obs0,
        )
        m, kf1 = ms.add_keyframe(
            m, pose2, jnp.asarray(self.frame_id), jnp.asarray(timestamp, jnp.float32),
            frame.uv, frame.octave, frame.angle, frame.desc, frame.valid, obs1_scatter,
        )

        # Global BA on the initial two views (ref GlobalBundleAdjustemnt 20 it).
        m = self._run_local_ba(m, [0, 1], fixed_ids=[0], iters=(8, 12))
        m = ms.refresh_point_stats(m, scale=self.cfg.scale, n_levels=self.cfg.n_levels)
        if self.cfg.init_min_points > 0:
            # Post-init quality gate (ref: "Wrong initialization" reset when
            # the bootstrap map is too thin): count observations that
            # SURVIVED the initial BA's outlier classification in the second
            # keyframe — a marginal H/F model loses most of them even when
            # triangulation accepted many pairs.
            n_surv = int(jax.device_get(jnp.sum(m.kf_obs_point[1] >= 0)))
            if n_surv < self.cfg.init_min_points:
                self.state = State.NOT_INITIALIZED  # retry from a later frame
                return
        self.map = m

        self.track_view = tv.compute_track_view(m, jnp.asarray(1), view_size=self.cfg.view_size)
        self.last_pose = m.kf_pose[1]
        self.last_obs = m.kf_obs_point[1]
        self.last_frame = frame
        self.last_ts = timestamp
        self.velocity = se3.identity_pose()
        self.n_ref_tracked = int((m.kf_obs_point[1] >= 0).sum())
        self.n_kf = 2
        self.last_kf_frame = self.frame_id
        self.frames_since_init = 0
        self.state = State.WORKING
        self.trajectory.append((timestamp, np.asarray(self.last_pose)))

    # ------------------------------------------------------------------
    def _track(self, img, timestamp, log):
        """WORKING-state frame: ONE fused device program (extraction + motion
        tracking with built-in wide retry + local-map tracking + GF selection
        + velocity); scalar readback either immediately (pipelined=False) or
        one frame late (pipelined=True), which hides the host↔device round
        trip under the next frame's dispatch — the device analogue of the
        reference's tracker/mapper thread overlap."""
        cfg = self.cfg
        dt = max(timestamp - self.last_ts, 1e-6)
        use_gf = cfg.use_gf and self.frames_since_init > cfg.gf_warmup_frames

        self.time_log.begin("local_map_track")
        res = tracking.track_frame_fused(
            self.cam, self.orb_cfg, self.map, self.track_view, img,
            self.last_pose, self.last_obs, self.last_frame.uv,
            self.velocity if cfg.use_motion_model else se3.identity_pose(),
            self._dt_const(dt), self._frame_key(),
            scale=cfg.scale, n_levels=cfg.n_levels,
            gf_budget=cfg.gf_budget, use_gf=use_gf, gf_mode=cfg.gf_mode,
            gf_batch=cfg.gf_batch,
        )
        frame_now = frame_mod.FrameData(
            # uv_raw approximated by undistorted uv here: the fused program
            # returns only undistorted coords (raw ones are viz-only).
            uv=res.frame_uv, uv_raw=res.frame_uv, octave=res.frame_octave,
            angle=res.frame_angle, desc=res.frame_desc,
            response=jnp.zeros_like(res.frame_angle), valid=res.frame_valid,
        )
        # Advance rolling device state without any host sync.
        self._rolling_key = res.next_key
        self.map = self.map._replace(pt_visible=res.pt_visible, pt_found=res.pt_found)
        self.velocity = res.velocity
        self.last_pose = res.pose
        self.last_obs = res.obs_point
        self.last_frame = frame_now
        self.last_ts = timestamp
        self.frames_since_init += 1

        # Start the host copies NOW so the fetch RTT overlaps with the next
        # frames' dispatch/compute instead of blocking at finalize time.
        for a in (res.ok, res.n_inliers, res.pose, res.n_total):
            try:
                a.copy_to_host_async()
            except AttributeError:
                break
        self._inflight.append((res, frame_now, timestamp, self.frame_id, log))
        # Dispatch-side cost ends here; everything below that blocks on device
        # results charges the explicit pipeline_wait stage instead, so this
        # column stays attributable to tracking work.
        self.time_log.end("local_map_track")
        # Deferred keyframe-insertion bookkeeping first: its async copies have
        # had a full frame to cross the link, so this is normally free.
        self._finalize_insertions()
        depth = cfg.pipeline_depth if cfg.pipelined else 1
        while self._inflight:
            # Finalize as soon as a frame's scalars are actually computed
            # (non-blocking is_ready probe): pipeline_depth is only
            # BACKPRESSURE, not added latency. Keyframe decisions then lag by
            # the true device latency instead of a fixed `depth` frames —
            # pipelined-mode drift on turning trajectories comes from exactly
            # that decision lag.
            if len(self._inflight) < depth and cfg.pipelined:
                if not cfg.eager_finalize:
                    break
                head = self._inflight[0][0].ok
                try:
                    if not head.is_ready():
                        break
                except AttributeError:
                    break
            if not self._finalize_tracked(*self._inflight.pop(0)):
                break

    def reset(self):
        """Full system reset (ref Tracking::Reset, src/Tracking.cc:4057):
        clear the map, BoW state, and return to NOT_INITIALIZED. The
        trajectory so far is kept for evaluation."""
        self.map = ms.empty_map(
            max_keyframes=self.cfg.max_keyframes,
            max_points=self.cfg.max_points,
            max_kps=2 * self.cfg.n_features,
        )
        self.state = State.NOT_INITIALIZED
        self.n_kf = 0
        self.n_ref_tracked = 0
        self.velocity = None
        self.init_frame = None
        self.last_obs = None
        self.bow_db = None
        self.voc = None
        self.loop_detector.reset()
        if getattr(self, "_preset_voc", None) is not None:
            self.set_vocabulary(self._preset_voc)
        self.lost_frames = 0
        self._inflight = []
        self._pending_kf = []
        self._rolling_key = None
        self.track_view = tv.empty_view(self.cfg.view_size, self.cfg.max_points)

    def warmup_compile(self):
        """Pre-trace cold-path device programs whose first invocation would
        otherwise stall a tracked frame mid-sequence (XLA compiles at first
        call): loop-candidate detection fires only once n_kf exceeds
        loop_min_kf_gap, which can be minutes into a run. Call after the map
        has a few keyframes (vocabulary trained). Results are discarded."""
        if self.bow_db is None or self.voc is None or self.n_kf == 0:
            return
        # register_and_detect donates the db argument — warm on a copy so the
        # live database rows are untouched and its buffers stay valid.
        db_copy = jax.tree.map(jnp.copy, self.bow_db)
        _, _, _, _, cand, ok = kdb.register_and_detect(
            db_copy, self.voc.centers, self.voc.weights,
            self.voc.children, self.voc.word_of_node, self.map,
            jnp.asarray(max(self.n_kf - 1, 0)),
            jnp.asarray(-1, jnp.int32),
            k=self.voc.k, L=self.voc.L, n_words=self.voc.n_words,
            max_candidates=6, do_detect=True,
        )
        jax.block_until_ready((cand, ok))

    def flush(self):
        """Finalize all in-flight frames (pipelined mode) and deferred
        keyframe insertions; call at sequence end before reading results."""
        while self._inflight:
            entry = self._inflight.pop(0)
            if not self._finalize_tracked(*entry):
                break
        self._finalize_insertions()

    def _finalize_tracked(self, res, frame_now, timestamp, frame_id, log):
        cfg = self.cfg
        self.time_log.begin("pipeline_wait")
        ok_np, n_inl_np, pose_np, n_tot_np = jax.device_get(
            (res.ok, res.n_inliers, res.pose, res.n_total)
        )
        self.time_log.end("pipeline_wait")
        if not bool(ok_np):
            self._inflight = []  # anything dispatched after the failure is garbage
            self._finalize_insertions()  # keep BoW/loop state consistent
            if self.n_kf <= 5:
                # ref: reset the whole map when lost early (Tracking.cc:719-726).
                self.reset()
            else:
                self.state = State.LOST
                self.last_frame = frame_now  # reloc can reuse this extraction
                self._rolling_key = None
            return False

        n_inliers = int(n_inl_np)
        log.pose_cw = np.asarray(pose_np)
        log.n_inliers = n_inliers
        self.trajectory.append((timestamp, np.asarray(pose_np)))

        # Reference gate: NeedNewKeyFrame only inserts when LocalMapping is
        # idle (Tracking.cc:3035-3077) — here, when no insertion is pending
        # finalize. Pipelined mode additionally needs a min gap covering the
        # dispatch lag: frames already in flight were tracked against the map
        # WITHOUT the new keyframe's points, so the low-inlier trigger (c2)
        # would re-fire every frame of the lag window and burst-insert
        # near-co-located keyframes.
        mapper_busy = bool(self._pending_kf)
        # Adaptive: the lag is however many later frames are in flight right
        # now.
        lag_gap = min(len(self._inflight), 4) if cfg.pipelined else 0
        # The low-inlier trigger (c2) compares FULL tracked density (LM
        # inliers + deferred matches, = the reference's mnMatchesInliers
        # with DELAYED_MAP_MATCHING) against n_ref_tracked, which counts the
        # same statistic at the last insertion. Comparing the GF-budgeted LM
        # inlier count (≤ budget) against full-density n_ref_tracked kept c2
        # permanently true under GF and drove insertion at the cadence floor
        # (20 KFs in 96 frames).
        if not mapper_busy and tracking.need_new_keyframe(
            int(n_tot_np), self.n_ref_tracked,
            frame_id - self.last_kf_frame,
            frame_id - self.last_reloc_frame if self.last_reloc_frame > 0 else 10**9,
            cfg.max_frames_between_kf,
            min_frames=lag_gap,
        ):
            if self.n_kf >= self.cfg.max_keyframes - 2:
                # Keyframe ids are slab slots; culling tombstones them but
                # only compaction makes them reusable (bounded memory on
                # arbitrarily long sequences).
                self._compact_keyframes()
            if self.n_kf < self.cfg.max_keyframes - 1:
                self.time_log.begin("keyframe_insert")
                self._insert_keyframe(
                    frame_now, res.pose, res.obs_point, timestamp,
                    frame_id=frame_id,
                )
                self.time_log.end("keyframe_insert")
        return True

    def _compact_keyframes(self):
        """Renumber live keyframes to the front, apply the same permutation to
        the BoW database, and reset host-side id-keyed loop state."""
        self._finalize_insertions()
        self.n_compactions += 1
        m2, perm, n_valid = ms.compact_keyframes(self.map)
        self.map = m2
        if self.bow_db is not None:
            self.bow_db = kdb.permute(self.bow_db, perm)
        self.loop_detector.reset()
        self.n_kf = int(n_valid)
        if self.n_kf > 0:
            self.track_view = tv.compute_track_view(
                self.map, jnp.asarray(self.n_kf - 1), view_size=self.cfg.view_size
            )

    # ------------------------------------------------------------------
    def _relocalize(self, frame, timestamp, log):
        """ref Tracking::Relocalisation (cc:3854-4032): BoW candidates → BoW-
        gated matching of candidate keyframes' map points → PnP RANSAC →
        local-map densification."""
        self._finalize_insertions()
        self.lost_frames += 1
        if not (
            self.cfg.enable_relocalization
            and self.voc is not None
            and self.lost_frames <= self.cfg.max_lost_frames
        ):
            return
        m = self.map
        words, _ = voc_mod.quantize(self.voc, frame.desc, frame.valid)
        v = voc_mod.bow_vector(self.voc, words)
        covis = ms.covisibility(m)
        cand, ok = kdb.detect_reloc_candidates(self.bow_db, covis, v, max_candidates=4)
        # One fused device program covers every candidate's matching + PnP
        # RANSAC + the winner's local-map densification: one dispatch and one
        # scalar fetch per lost frame instead of ~4 round trips per candidate.
        res, reloc_view = tracking.relocalize_fused(
            self.cam, m, self.bow_db.words, frame, words, cand, ok,
            self._next_key(), scale=self.cfg.scale, n_levels=self.cfg.n_levels,
            view_size=self.cfg.view_size,
        )
        if bool(res.ok):
            self.track_view = reloc_view
            self.state = State.WORKING
            self.lost_frames = 0
            self.last_reloc_frame = self.frame_id
            self.velocity = se3.identity_pose()
            self.last_pose = res.pose
            self.last_obs = res.obs_point
            self.last_frame = frame
            self.last_ts = timestamp
            log.pose_cw = np.asarray(res.pose)
            log.n_inliers = int(res.n_inliers)
            self.trajectory.append((timestamp, np.asarray(res.pose)))
            return

    # ------------------------------------------------------------------
    def _maybe_train_vocabulary(self):
        if self.voc is not None or self.n_kf < self.cfg.vocab_train_kfs:
            return
        m = self.map
        kf_ids = np.nonzero(np.asarray(m.kf_valid))[0]
        descs = []
        for k in kf_ids:
            vmask = np.asarray(m.kf_kp_valid[k])
            descs.append(np.asarray(m.kf_kp_desc[k])[vmask])
        corpus = np.concatenate(descs, axis=0)
        self.voc = voc_mod.train_vocabulary(
            corpus, k=self.cfg.vocab_k, L=self.cfg.vocab_L
        )
        self.bow_db = kdb.empty_db(
            self.map.kf_capacity, self.map.kp_capacity, self.voc.n_words
        )
        for k in kf_ids:
            self.bow_db = kdb.add_keyframe(
                self.bow_db, self.voc, jnp.asarray(int(k)),
                m.kf_kp_desc[int(k)], m.kf_kp_valid[int(k)],
            )

    # ------------------------------------------------------------------
    def _try_close_loop(self, kf_int: int, pending: dict):
        """DetectLoop + ComputeSim3 + CorrectLoop for the (just-finalized)
        keyframe; candidates/covisibility were dispatched at insertion time."""
        m = self.map
        covis = pending["covis"]  # device-resident (K,K), used by correct_loop
        # One combined fetch of the SMALL host-side pieces (candidate ids +
        # the query/candidate covisibility rows, ~8 KB) — normally already
        # resident via copy_to_host_async; the full matrix never crosses.
        cand_np, ok_np, covq_np, covc_np = jax.device_get(
            (pending["cand"], pending["ok"], pending["covis_q"],
             pending["covis_c"])
        )
        # Exclude recent keyframes (temporal gap).
        ok_np = ok_np & (cand_np < kf_int - self.cfg.loop_min_kf_gap)
        row_by_cand = {int(c): covc_np[i] for i, c in enumerate(cand_np)}

        def covis_row_of(c):
            return np.nonzero(row_by_cand[int(c)] > 15)[0].tolist()

        event = None
        if self.loop_gt_overlap is not None:
            # Revisit opportunity: an old keyframe with NO direct covisibility
            # to the query whose GT frustum overlaps the query's (loops only
            # matter when the tracker cannot re-match old points directly —
            # SLAM-behavior note, CLAUDE.md round 2).
            fid = np.asarray(self.map.kf_frame_id)
            kfv = np.asarray(self.map.kf_valid)
            q_fid = int(fid[kf_int])
            opp = any(
                covq_np[k] <= 0
                and self.loop_gt_overlap(q_fid, int(fid[k]))
                for k in np.nonzero(kfv)[0]
                if k < kf_int - self.cfg.loop_min_kf_gap
            )
            event = {"kf": kf_int, "frame": q_fid, "opportunity": bool(opp),
                     "closed": False, "matched_kf": None}
            self.loop_events.append(event)

        probe = self.cfg.loop_probe_floor
        pairs = self.loop_detector.update_streaks(cand_np, ok_np, covis_row_of)
        th = self.loop_detector.consistency_threshold
        # Probe mode shadow-verifies streak-2 candidates too (for the offline
        # consistency-threshold sweep); acceptance keeps the shipped rule.
        verify_list = [(c, s) for c, s in pairs if s >= (2 if probe > 0 else th)]
        if probe > 0:
            self.loop_gate_events.append({
                "round": True, "kf": kf_int,
                "n_bow_eligible": int(ok_np.sum()),
                "n_consistent": sum(1 for _, s in pairs if s >= th),
            })
        for c, streak in verify_list:
            lm = loop_closing.verify_candidate(
                self.cam, m, self.bow_db, jnp.asarray(kf_int), jnp.asarray(c),
                self._next_key(), scale=self.cfg.scale, n_levels=self.cfg.n_levels,
                ransac_floor=(probe if probe > 0 else 20),
            )
            if probe > 0:
                ok_v, nb, nr, ng, no = jax.device_get(
                    (lm.ok, lm.n_bow, lm.n_ransac, lm.n_guided, lm.n_inliers)
                )
                fid = np.asarray(self.map.kf_frame_id)
                gt = (
                    bool(self.loop_gt_overlap(int(fid[kf_int]), int(fid[c])))
                    if self.loop_gt_overlap is not None else None
                )
                self.loop_gate_events.append({
                    "kf": kf_int, "cand": int(c), "streak": streak,
                    "n_bow": int(nb), "n_ransac": int(nr),
                    "n_guided": int(ng), "n_opt": int(no),
                    "accepted": bool(ok_v) and streak >= th, "gt_true": gt,
                })
            if not (bool(lm.ok) and streak >= th):
                continue
            old_q_pose = m.kf_pose[kf_int]
            self.map = loop_closing.correct_loop(
                m, jnp.asarray(kf_int), jnp.asarray(c), lm.S12, covis,
                cam=self.cam, scale=self.cfg.scale, n_levels=self.cfg.n_levels,
            )
            # Transport the tracker's rolling pose into the corrected gauge
            # via the query keyframe (the reference updates Tracking's pose
            # through the corrected current KF, LoopClosing.cc:429-470):
            # T_cw' = (T_cw ∘ T_qw_old⁻¹) ∘ T_qw_new. Velocity is relative and
            # gauge-invariant.
            if self.last_pose is not None:
                rel = se3.compose(self.last_pose, se3.inverse(old_q_pose))
                self.last_pose = se3.compose(rel, self.map.kf_pose[kf_int])
            self.n_loops_closed += 1
            self.loop_detector.reset()
            self.track_view = tv.compute_track_view(
                self.map, jnp.asarray(kf_int), view_size=self.cfg.view_size
            )
            if event is not None:
                event["closed"] = True
                event["matched_kf"] = int(c)
            return True
        return False

    # ------------------------------------------------------------------
    def _insert_keyframe(self, frame, pose, obs_point, timestamp, frame_id=None):
        """ref CreateNewKeyFrame + the LocalMapping::Run pipeline, fused into
        ONE device program (pipeline/local_mapping.py) — a single dispatch
        covers triangulation, culling, stat refresh, descriptors, windowed
        Schur BA, and keyframe culling.

        Everything here is dispatch-only: the insertion scalars and loop
        candidates are async-copied and consumed one frame later
        (_finalize_insertions) — the device analogue of the reference's
        LocalMapping/LoopClosing threads lagging Tracking. Both fetches then
        overlap the next frames' dispatches."""
        cfg = self.cfg
        from gf_orb_slam_tpu.pipeline import local_mapping

        # Pad tracking frames (capacity n_features) to the map's keypoint
        # capacity (2x, sized for the init extractor).
        Nm = self.map.kp_capacity
        pad = Nm - frame.capacity

        def pz(a, fill=0):
            if pad == 0:
                return a
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, widths, constant_values=fill)

        if frame_id is None:
            frame_id = self.frame_id
        res = local_mapping.insert_keyframe_fused(
            self.cam, self.map, pose, jnp.asarray(frame_id),
            jnp.asarray(timestamp, jnp.float32),
            pz(frame.uv), pz(frame.octave), pz(frame.angle), pz(frame.desc),
            pz(frame.valid, False), pz(obs_point, ms.NO_POINT),
            scale=cfg.scale, n_levels=cfg.n_levels,
            ba_window=cfg.ba_window, ba_fixed=cfg.ba_fixed,
            n_tri_neighbors=cfg.triangulate_neighbors,
            ba_points=cfg.ba_points, ba_iters=tuple(cfg.ba_iters),
            view_size=cfg.view_size,
        )
        self.map = res.m
        self.n_kf += 1
        self.last_kf_frame = frame_id
        # Compact tracking view computed inside the insertion program.
        self.track_view = res.view

        # --- place recognition: vocabulary, BoW registration, loop dispatch ---
        self._maybe_train_vocabulary()
        pending = {
            "kf_id": res.kf_id,
            "culled": res.culled_kf,
            "ref": res.n_ref,
        }
        covis_dev = None
        if self.voc is not None:
            # A keyframe culled inside this same insertion program is already
            # tombstoned in the map (covis row zero) but still valid in the
            # BoW DB until finalize — excluded inside or it pollutes
            # candidate group scoring. One fused dispatch covers quantize +
            # BoW row + covisibility + candidate ranking.
            do_detect = bool(
                cfg.enable_loop_closing and self.n_kf > cfg.loop_min_kf_gap
            )
            self.bow_db, covis, covis_q, covis_c, cand, ok = (
                kdb.register_and_detect(
                    self.bow_db, self.voc.centers, self.voc.weights,
                    self.voc.children, self.voc.word_of_node, self.map,
                    res.kf_id, res.culled_kf,
                    k=self.voc.k, L=self.voc.L, n_words=self.voc.n_words,
                    max_candidates=6, do_detect=do_detect,
                )
            )
            if do_detect:
                # The full (K,K) matrix stays ON DEVICE for correct_loop;
                # the host consistency/GT logic only needs the query row and
                # the candidates' rows.
                covis_dev = covis
                pending.update(covis_q=covis_q, covis_c=covis_c, cand=cand, ok=ok)
        for a in pending.values():
            try:
                a.copy_to_host_async()
            except AttributeError:
                break
        if covis_dev is not None:
            pending["covis"] = covis_dev
        self._pending_kf.append(pending)

    def _finalize_insertions(self):
        """Consume deferred keyframe-insertion results: scalar bookkeeping,
        BoW tombstoning of culled keyframes, and the loop-closing check."""
        while self._pending_kf:
            p = self._pending_kf.pop(0)
            self.time_log.begin("pipeline_wait")
            kf_np, culled_np, ref_np = jax.device_get(
                (p["kf_id"], p["culled"], p["ref"])
            )
            self.time_log.end("pipeline_wait")
            self.n_ref_tracked = int(ref_np)
            culled = int(culled_np)
            if culled >= 0 and self.bow_db is not None:
                self.bow_db = kdb.erase_keyframe(self.bow_db, jnp.asarray(culled))
            if "cand" in p:
                self.time_log.begin("loop_closing")
                self._try_close_loop(int(kf_np), p)
                self.time_log.end("loop_closing")

    # ------------------------------------------------------------------
    def _run_local_ba(self, m, kf_ids, fixed_ids, iters=(5, 10), row_active=None):
        """Build a BAProblem over the chosen keyframes and write results back.

        kf_ids may contain duplicate padding entries (row_active=False) so the
        window shape — and therefore the compiled program — stays constant.
        """
        if row_active is None:
            row_active = [True] * len(kf_ids)
        ids = jnp.asarray(kf_ids, jnp.int32)
        act = jnp.asarray(row_active)
        obs_point = jnp.where(act[:, None], m.kf_obs_point[ids], ms.NO_POINT)
        local_pts = jnp.zeros(m.pt_capacity, bool).at[
            jnp.maximum(obs_point.reshape(-1), 0)
        ].max(obs_point.reshape(-1) >= 0)
        local_pts = local_pts & m.pt_valid
        sigma2 = jnp.asarray(
            [self.cfg.scale ** (2 * i) for i in range(self.cfg.n_levels)]
        )[m.kf_kp_octave[ids]]
        fixed_mask = jnp.asarray(
            [k in fixed_ids or not a for k, a in zip(kf_ids, row_active)]
        )
        prob = local_ba.BAProblem(
            poses=m.kf_pose[ids],
            points=m.pt_pos,
            fixed=fixed_mask,
            point_valid=local_pts,
            obs_uv=m.kf_kp_uv[ids],
            obs_point=obs_point,
            obs_w=jnp.where(obs_point >= 0, 1.0 / sigma2, 0.0),
        )
        res = local_ba.bundle_adjust(
            self.cam, prob, iters_stage1=iters[0], iters_stage2=iters[1]
        )
        new_points = jnp.where(local_pts[:, None], res.points, m.pt_pos)
        safe_ids = jnp.where(act, ids, m.kf_capacity)  # padded rows dropped
        m = m._replace(
            kf_pose=m.kf_pose.at[safe_ids].set(res.poses, mode="drop"),
            pt_pos=new_points,
        )
        # Drop observations BA classified as outliers (active rows only).
        obs_new = jnp.where(res.obs_active, obs_point, ms.NO_POINT)
        m = m._replace(
            kf_obs_point=m.kf_obs_point.at[safe_ids].set(obs_new, mode="drop")
        )
        return m

    # ------------------------------------------------------------------
    def get_trajectory(self):
        ts = np.asarray([t for t, _ in self.trajectory])
        poses = np.stack([p for _, p in self.trajectory]) if self.trajectory else np.zeros((0, 7))
        return ts, poses
