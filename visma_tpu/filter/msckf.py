"""MSCKF orchestration: per-frame step and full-sequence scan.

The per-frame step (propagate -> clone -> ingest tracks -> update) is one
jitted function over fixed-shape inputs; `run` lax.scans it over a packed
sequence, so an entire VIO pass is a single XLA computation.
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from visma_tpu.filter.config import FilterConfig
from visma_tpu.filter.imu import propagate, propagate_cv
from visma_tpu.filter.state import FilterState, TrackTable, init_state
from visma_tpu.filter.update import msckf_update
from visma_tpu.proto import FeatureStatus
from visma_tpu.utils.misc import DivergenceError, finite_tree


def check_health(outs: Dict[str, jnp.ndarray]) -> None:
    """Host-side gate on Msckf.run / VioPipeline.run outputs: raise a
    structured DivergenceError naming the FIRST non-finite frame instead
    of silently exporting NaN poses (SURVEY §5)."""
    import numpy as np

    healthy = np.asarray(outs.get("healthy", np.asarray(True)))
    if healthy.all():
        return
    first = int(np.argmin(healthy))  # first False
    raise DivergenceError(first)


def _frame_outputs(cfg: FilterConfig, s: FilterState) -> Dict[str, jnp.ndarray]:
    """Per-frame export record shared by Msckf.run and VioPipeline.run:
    pose, track-table snapshot, and the jitted health flag.

    feat_xp is each track's LAST observed pixel (newest masked window
    slot) so exported Features carry a real observation — the reference's
    GrabSparseDepth pairs Feature.xp with camera-frame depth
    (dataloader.cpp:166-194), which degenerate xp=0 would break.
    Tracks never observed in-window export zeros
    (their mask is all-False; such slots are EMPTY anyway)."""
    tracks = s.tracks
    M = tracks.obs.shape[1]
    K = tracks.ids.shape[0]
    last = M - 1 - jnp.argmax(tracks.mask[:, ::-1], axis=1)
    seen = jnp.any(tracks.mask, axis=1)
    xp_last = jnp.where(seen[:, None],
                        tracks.obs[jnp.arange(K), last], 0.0)
    out = {
        "R": s.R, "p": s.p, "v": s.v,
        "feat_status": tracks.status,
        "feat_ids": tracks.ids,
        "feat_xw": tracks.xw,
        "feat_xp": xp_last,
        # jitted health gate (SURVEY §5 sanitizer row): an all-finite
        # reduction over the core state rides along per frame; hosts gate
        # on it via check_health()
        "healthy": finite_tree((s.R, s.p, s.v, s.bg, s.ba, s.P)),
    }
    if cfg.num_slam:
        out["lm_ids"] = s.lm_ids
        out["lm_xw"] = s.lm_xw
    return out


def _augment(cfg: FilterConfig, state: FilterState,
             omega=None) -> FilterState:
    """Roll the clone window left and clone the current CAMERA pose into
    slot M-1 (G_wc = G_wb(t+td) * T_bc, first-order in td). Covariance
    rows/cols permute; the new clone's attitude error aliases the IMU
    attitude error (world-frame error convention), plus calibration
    couplings when those errors are in the state:

      dθ_c = dθ_b + R_wc dθ_bc + (R_wb ω_b) dtd
      dp_c = dp_b - hat(R_wb p_bc) dθ_b + R_wb dp_bc
             + (v_w + R_wb (ω_b × p_bc)) dtd

    omega: (3,) body angular rate at the frame (bias-corrected last gyro
    sample); None/zeros in vision-only mode (td attitude column vanishes).
    """
    from visma_tpu.geom.rotations import hat, mm, rodrigues

    M, D = cfg.window, cfg.dim
    R_bc, p_bc, td = state.R_bc, state.p_bc, state.td
    if omega is None:
        omega = jnp.zeros(3, jnp.float32)

    # nominal first-order time-offset correction: pose at t + td
    R_b = mm(rodrigues(state.R @ omega * td), state.R)
    p_b = state.p + state.v * td

    cam_R = R_b @ R_bc
    cam_p = p_b + R_b @ p_bc
    win_R = jnp.concatenate([state.win_R[1:], cam_R[None]], axis=0)
    win_p = jnp.concatenate([state.win_p[1:], cam_p[None]], axis=0)
    win_valid = jnp.concatenate([state.win_valid[1:],
                                 jnp.ones(1, bool)], axis=0)

    # permutation-with-duplication: new index -> old index
    # IMU block unchanged [0:15); clones shift: new clone m <- old clone
    # m+1; calibration tail (if any) stays put
    clone_src = jnp.concatenate([
        15 + 6 + jnp.arange(6 * (M - 1)),     # clones 0..M-2 <- old 1..M-1
        jnp.arange(0, 6),                      # new clone <- IMU att/pos
    ])
    perm = jnp.concatenate([jnp.arange(15), clone_src,
                            jnp.arange(15 + 6 * M, D)])
    P = state.P[perm][:, perm]

    needs_J = (cfg.has_extrinsics or cfg.estimate_extrinsics
               or cfg.estimate_td)
    if needs_J:
        ra = 15 + 6 * (M - 1)       # new clone attitude rows
        rp = ra + 3                 # new clone position rows
        J = jnp.eye(D, dtype=jnp.float32)
        J = J.at[rp : rp + 3, ra : ra + 3].set(-hat(state.R @ p_bc))
        if cfg.estimate_extrinsics:
            c = cfg.ext_idx
            J = J.at[ra : ra + 3, c : c + 3].set(cam_R)
            J = J.at[rp : rp + 3, c + 3 : c + 6].set(state.R)
        if cfg.estimate_td:
            c = cfg.td_idx
            J = J.at[ra : ra + 3, c].set(state.R @ omega)
            J = J.at[rp : rp + 3, c].set(
                state.v + state.R @ jnp.cross(omega, p_bc))
        P = mm(mm(J, P), J.T)
    P = 0.5 * (P + P.T)
    return state.replace(win_R=win_R, win_p=win_p, win_valid=win_valid, P=P)


def _ingest(cfg: FilterConfig, tracks: TrackTable, ids, xp, valid):
    """Roll track observations with the window and ingest this frame's
    feature observations (ids (F,), xp (F,2), valid (F,)).

    Returns (tracks, lost (K,) bool) where lost marks slots whose feature
    was not observed this frame.
    """
    K, M = tracks.obs.shape[0], tracks.obs.shape[1]
    F = ids.shape[0]

    obs = jnp.concatenate([tracks.obs[:, 1:], jnp.zeros((K, 1, 2))], axis=1)
    mask = jnp.concatenate([tracks.mask[:, 1:], jnp.zeros((K, 1), bool)],
                           axis=1)

    # match incoming ids to slots
    slot_live = tracks.ids >= 0
    eq = (tracks.ids[:, None] == ids[None, :]) & valid[None, :] & slot_live[:, None]
    has_match = jnp.any(eq, axis=1)
    match_idx = jnp.argmax(eq, axis=1)
    matched_xp = xp[match_idx]
    obs = obs.at[:, M - 1].set(jnp.where(has_match[:, None], matched_xp, 0.0))
    mask = mask.at[:, M - 1].set(has_match)

    # new features: ids not present in the table -> fill empty slots
    known = jnp.any(eq, axis=0)
    is_new = valid & ~known
    # rank new features and empty slots, pair them up
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1          # (F,)
    empty = ~slot_live
    empty_rank = jnp.cumsum(empty.astype(jnp.int32)) - 1         # (K,)
    n_new = jnp.sum(is_new)

    # slot k takes the empty_rank[k]-th new feature if empty and in range
    take = empty & (empty_rank < n_new)
    # invert: for each empty slot rank e, find feature index with new_rank==e
    feat_for_rank = jnp.zeros(F, jnp.int32).at[
        jnp.where(is_new, new_rank, F - 1)
    ].max(jnp.arange(F, dtype=jnp.int32) * is_new)
    src = feat_for_rank[jnp.clip(empty_rank, 0, F - 1)]          # (K,)

    ids_new = jnp.where(take, ids[src], tracks.ids)
    obs = jnp.where(take[:, None, None],
                    jnp.zeros_like(obs).at[:, M - 1].set(xp[src]), obs)
    mask = jnp.where(take[:, None],
                     jnp.zeros_like(mask).at[:, M - 1].set(True), mask)
    # recycled slots must not inherit the previous occupant's absorbed
    # world point (has_xw below keys the INSTATE status)
    xw = jnp.where(take[:, None], 0.0, tracks.xw)

    # status transitions (vlslam lifecycle). Lost tracks split by
    # maturity: mature ones are about to be absorbed by the update
    # (GOODDROP — "retired in good standing", the tracks GrabPointCloud
    # keeps, dataloader.cpp:136-164); immature ones are dropped WITHOUT
    # absorption (REJECT), so their zero xw never pollutes INSTATE|
    # GOODDROP-filtered point clouds.
    nobs = jnp.sum(mask, axis=1)
    live = ids_new >= 0
    lost = live & ~mask[:, M - 1] & (nobs > 0)
    drop_status = jnp.where(nobs >= cfg.min_track_obs,
                            int(FeatureStatus.GOODDROP),
                            int(FeatureStatus.REJECT))
    # INSTATE additionally requires an absorbed world point (xw set by a
    # previous update; the track continues via the KEEP path) so that
    # INSTATE never exports a zero xw; tracked-but-not-yet-absorbed
    # features stay READY however long their window grows.
    has_xw = jnp.any(xw != 0.0, axis=1)
    status = jnp.where(
        ~live, int(FeatureStatus.EMPTY),
        jnp.where(lost, drop_status,
                  jnp.where(nobs <= 1, int(FeatureStatus.INITIALIZING),
                            jnp.where(has_xw, int(FeatureStatus.INSTATE),
                                      int(FeatureStatus.READY))))
    ).astype(jnp.int32)

    # fully-expired tracks (no obs left in window) free their slot
    expired = live & (nobs == 0)
    ids_new = jnp.where(expired, -1, ids_new)
    status = jnp.where(expired, int(FeatureStatus.EMPTY), status)

    return TrackTable(ids=ids_new, status=status, obs=obs, mask=mask,
                      xw=xw), lost


def _select_for_update(cfg: FilterConfig, tracks: TrackTable, lost):
    """Pick up to max_updates mature features: lost tracks first, then
    full-window tracks. Returns (sel (U,) slot indices, sel_valid (U,))."""
    K, M = tracks.obs.shape[0], tracks.obs.shape[1]
    nobs = jnp.sum(tracks.mask, axis=1)
    live = tracks.ids >= 0
    mature = live & (nobs >= cfg.min_track_obs)
    full = mature & (nobs >= M)
    eligible = mature & (lost | full)
    score = eligible.astype(jnp.int32) * (1000 + nobs + 1000 * lost)
    top, sel = jax.lax.top_k(score, cfg.max_updates)
    return sel, top > 0


class Msckf:
    """Facade: jitted per-frame step + sequence runner."""

    def __init__(self, cfg: FilterConfig):
        self.cfg = cfg
        self._step = jax.jit(functools.partial(_frame_step, cfg))
        self._run_jit = None  # built lazily in run(); MUST be cached on
        # the instance: a jit closure rebuilt per call is a fresh cache
        # key, so every rep pays persistent-cache executable
        # deserialization (~2.5 s for the 240-frame scan — measured; the
        # in-memory executable replays in ~0.16 s)
        self._run_batched_jit = None

    def init(self, **kw) -> FilterState:
        return init_state(self.cfg, **kw)

    def step(self, state: FilterState, frame: Dict[str, jnp.ndarray]
             ) -> FilterState:
        """frame: {gyro (S,3), accel (S,3), dts (S,), ids (F,), xp (F,2),
        valid (F,)}."""
        return self._step(state, frame)

    def run(self, state: FilterState, frames: Dict[str, jnp.ndarray],
            unroll: int = 1):
        """Scan over a whole packed sequence (leading axis = frames).

        Returns (final_state, outputs) with per-frame pose estimates:
        {R (N,3,3), p (N,3), feat_status (N,K), feat_ids (N,K)}.
        unroll: lax.scan unroll factor.
        """
        cfg = self.cfg

        if self._run_jit is None:
            def scan_fn(s, frame):
                s = _frame_step(cfg, s, frame)
                return s, _frame_outputs(cfg, s)

            @functools.partial(jax.jit, static_argnames=("u",))
            def run_jit(state, frames, u):
                return jax.lax.scan(scan_fn, state, frames, unroll=u)

            self._run_jit = run_jit

        return self._run_jit(state, frames, unroll)

    def run_batched(self, states: FilterState, frames: Dict[str, jnp.ndarray]):
        """Throughput/serving mode: B independent streams, vmapped per
        frame step (multi-camera rigs, fleet reprocessing). The tiny
        per-stream linear algebra batches onto the device instead of
        latency-bounding it.

        states: stacked FilterState with leading batch axis B (e.g.
        jax.tree.map over init); frames: {key: (B, N, ...)}.
        Returns (final states (B,...), outputs {R (B,N,3,3), p (B,N,3)}).
        """
        cfg = self.cfg

        if self._run_batched_jit is None:
            def scan_fn(s, frame):
                s = jax.vmap(lambda si, fi: _frame_step(cfg, si, fi))(s, frame)
                return s, {"R": s.R, "p": s.p}

            @jax.jit
            def run_jit(states, frames):
                frames_t = {k: jnp.swapaxes(v, 0, 1)
                            for k, v in frames.items()}      # (N, B, ...)
                final, outs = jax.lax.scan(scan_fn, states, frames_t)
                return final, {k: jnp.swapaxes(v, 0, 1)
                               for k, v in outs.items()}     # (B, N, ...)

            self._run_batched_jit = run_jit

        return self._run_batched_jit(states, frames)


def _frame_step(cfg: FilterConfig, state: FilterState,
                frame: Dict[str, jnp.ndarray]) -> FilterState:
    # Filter algebra must run at full f32 precision: TPU's default bf16
    # matmul passes destroy EKF covariance conditioning (verified: the
    # 240-frame synthetic run diverges to meters without this, cm with it).
    with jax.default_matmul_precision("highest"):
        return _frame_step_inner(cfg, state, frame)


def _frame_step_inner(cfg: FilterConfig, state: FilterState,
                      frame: Dict[str, jnp.ndarray]) -> FilterState:
    # 1. propagation to the frame time: IMU mechanization, or the
    # constant-velocity prior in vision-only mode (static config branch)
    if cfg.use_imu:
        state = propagate(cfg, state, frame["gyro"], frame["accel"],
                          frame["dts"])
        # body rate at the frame (bias-corrected last unmasked sample),
        # for the time-offset clone Jacobian / nominal td correction
        n = jnp.sum(frame["dts"] > 0)
        idx = jnp.clip(n - 1, 0, frame["gyro"].shape[0] - 1)
        omega = (frame["gyro"][idx] - state.bg) * (n > 0)
    else:
        state = propagate_cv(cfg, state, jnp.sum(frame["dts"]))
        omega = None
    # 2. clone the camera pose into the window
    state = _augment(cfg, state, omega)
    # 2b. SLAM landmark update from this frame's observations of in-state
    # landmarks (newest clone is the measuring camera); in-state ids are
    # then hidden from the track table so their observations are never
    # consumed twice.
    valid_tab = frame["valid"]
    if cfg.num_slam:
        from visma_tpu.filter.slam import in_state, slam_update

        state = slam_update(cfg, state, frame["ids"], frame["xp"],
                            frame["valid"])
        valid_tab = frame["valid"] & ~in_state(state.lm_ids, frame["ids"])
    # 3. ingest feature observations
    tracks, lost = _ingest(cfg, state.tracks, frame["ids"], frame["xp"],
                           valid_tab)
    state = state.replace(tracks=tracks)
    # 4. MSCKF update on mature tracks
    sel, sel_valid = _select_for_update(cfg, tracks, lost)
    sel_obs = tracks.obs[sel]
    sel_mask = tracks.mask[sel]
    state, used, rejected, X = msckf_update(cfg, state, sel_obs, sel_mask,
                                            sel_valid)
    # record triangulated points; retire consumed observations.
    # Tracks that are still being observed (used because the window filled)
    # keep ONLY their newest observation, so they re-mature in
    # min_track_obs-1 frames instead of restarting from scratch
    # (OpenVINS-style feature continuation); fully lost tracks free their
    # slot. Update candidates that FAILED the chi2/finite gate export as
    # REJECT for this frame (vlslam.proto:11-19) with their window
    # history cleared: an outlier track restarts from its next
    # observation (or expires unseen), instead of silently keeping its
    # pre-gate status.
    M = cfg.window
    xw = state.tracks.xw.at[sel].set(
        jnp.where(used[:, None], X, state.tracks.xw[sel]))
    sel_mask_now = state.tracks.mask[sel]
    still_seen = sel_mask_now[:, M - 1]
    keep = used & still_seen
    drop = used & ~still_seen

    # promote the best still-tracked consumed features into SLAM landmark
    # slots (delayed init uses the Q1 rows the nullspace update discarded;
    # see filter/slam.py). Promoted features leave the track table — their
    # future observations feed slam_update directly.
    if cfg.num_slam and cfg.max_promote:
        from visma_tpu.filter.slam import slam_promote

        sel_mask_v = sel_mask & state.win_valid[None, :]
        nobs_sel = jnp.sum(sel_mask_v, axis=1)
        score = keep.astype(jnp.int32) * (1 + nobs_sel)
        topv, topi = jax.lax.top_k(score, cfg.max_promote)
        state, prom_done = slam_promote(
            cfg, state, X[topi], sel_obs[topi], sel_mask_v[topi],
            tracks.ids[sel][topi], topv > 0)
        prom_sel = jnp.zeros(keep.shape[0], bool).at[topi].set(prom_done)
        keep = keep & ~prom_sel
        drop = drop | prom_sel
    else:
        prom_sel = jnp.zeros(keep.shape[0], bool)

    newest_only = jnp.zeros_like(sel_mask_now).at[:, M - 1].set(True)
    new_sel_mask = jnp.where(
        keep[:, None], sel_mask_now & newest_only,
        jnp.where((drop | rejected)[:, None], jnp.zeros_like(sel_mask_now),
                  sel_mask_now))

    # dropped/rejected slots keep their id for THIS frame's export (so
    # consumers see the GOODDROP/REJECT outcome, like Corvis emitted it)
    # and expire naturally next frame via the cleared mask — unless the
    # frontend re-finds the id, in which case the track continues
    # (absorbed xw intact -> INSTATE once re-mature)
    freed_ids = state.tracks.ids
    freed_status = state.tracks.status.at[sel].set(
        jnp.where(prom_sel, int(FeatureStatus.INSTATE),
                  jnp.where(drop, int(FeatureStatus.GOODDROP),
                            jnp.where(rejected, int(FeatureStatus.REJECT),
                                      jnp.where(keep,
                                                int(FeatureStatus.KEEP),
                                                state.tracks.status[sel])))))
    freed_mask = state.tracks.mask.at[sel].set(new_sel_mask)
    tracks = TrackTable(ids=freed_ids, status=freed_status,
                        obs=state.tracks.obs, mask=freed_mask, xw=xw)
    return state.replace(tracks=tracks)
