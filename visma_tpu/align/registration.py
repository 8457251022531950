"""Object-level scene registration (reference parity: evaluation.cpp:17-112).

`register_scenes` proposes a transform from every same-shape object pair
and keeps the proposal with maximal correspondence support (the reference's
RANSAC-like loop, evaluation.cpp:79-112); `optimize_alignment` is the IRLS
SE(3) averaging the reference left as a stub-that-throws
(evaluation.cpp:43-77) — host-numpy SE(3) log/exp (a handful of 4x4s,
where a device dispatch per op would cost more than the math).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np



def find_correspondences(tgt: Dict[int, np.ndarray],
                         src: Dict[int, np.ndarray],
                         T_tgt_src: np.ndarray,
                         threshold: float = 0.5) -> List[Tuple[int, int]]:
    """Greedy NN matching of object poses under a proposed transform
    (evaluation.cpp:17-41). tgt/src map object id -> 4x4 model_to_scene.
    Returns [(src_id, tgt_id)]."""
    matches = []
    for sid, m1 in src.items():
        best, best_d = -1, threshold
        for tid, m2 in tgt.items():
            T_scene_model = T_tgt_src @ m1
            dT = np.linalg.inv(T_scene_model) @ m2
            d = float(np.linalg.norm(dT[:3, 3]))
            if d < best_d:
                best_d, best = d, tid
        if best >= 0:
            matches.append((sid, best))
    return matches


def register_scenes(tgt: Dict[int, dict], src: Dict[int, dict],
                    threshold: float = 0.5, refine: bool = True):
    """tgt/src: id -> {"name": str, "pose": 4x4 model_to_scene}.

    Returns (T_tgt_src 4x4, matches). Proposals come from same-name object
    pairs (evaluation.cpp:86-105); optional IRLS refinement over the final
    match set replaces the reference's stubbed OptimizeAlignment.
    """
    tgt_poses = {k: v["pose"] for k, v in tgt.items()}
    src_poses = {k: v["pose"] for k, v in src.items()}

    best_matches: List[Tuple[int, int]] = []
    best_T = np.eye(4)
    for sid, s in src.items():
        for tid, t in tgt.items():
            if s["name"] != t["name"]:
                continue
            T = t["pose"] @ np.linalg.inv(s["pose"])
            matches = find_correspondences(tgt_poses, src_poses, T, threshold)
            if len(matches) > len(best_matches):
                best_matches, best_T = matches, T

    if refine and len(best_matches) >= 2:
        best_T = optimize_alignment(tgt_poses, src_poses, best_matches,
                                    init=best_T)
    return best_T, best_matches


def _hat(w):
    return np.array([[0.0, -w[2], w[1]],
                     [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def _log_se3_np(T):
    """(4,4) -> (6,) [rho, w]. Host numpy: this runs inside an IRLS loop
    over a handful of 4x4s, where one device dispatch per op would cost
    more than the math."""
    from scipy.spatial.transform import Rotation

    w = Rotation.from_matrix(T[:3, :3]).as_rotvec()
    th = np.linalg.norm(w)
    K = _hat(w)
    if th < 1e-8:
        Vinv = np.eye(3) - 0.5 * K
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th**2
        Vinv = (np.eye(3) - 0.5 * K
                + (1.0 / th**2) * (1 - A / (2 * B)) * (K @ K))
    return np.concatenate([Vinv @ T[:3, 3], w])


def _exp_se3_np(xi):
    """(6,) [rho, w] -> (4,4). Host numpy twin of geom SE3.exp."""
    rho, w = np.asarray(xi[:3]), np.asarray(xi[3:])
    th = np.linalg.norm(w)
    K = _hat(w)
    if th < 1e-8:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th**2
        C = (th - np.sin(th)) / th**3
        R = np.eye(3) + A * K + B * (K @ K)
        V = np.eye(3) + B * K + C * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def optimize_alignment(tgt: Dict[int, np.ndarray], src: Dict[int, np.ndarray],
                       matches: List[Tuple[int, int]],
                       init: np.ndarray = None, iters: int = 50) -> np.ndarray:
    """IRLS SE(3) averaging of per-match alignments (the algorithm sketched
    in the reference's commented-out body, evaluation.cpp:49-76, made
    convergent: iterate T <- exp(sum w_k log(T_k T^-1)) T with weights
    1/max(eps, ||log||)). Pure host numpy: a few 4x4s per iteration."""
    if not matches:
        return np.eye(4) if init is None else init
    Ts = [np.asarray(tgt[t] @ np.linalg.inv(src[s]), np.float64)
          for s, t in matches]
    T = np.asarray(init if init is not None else Ts[0], np.float64)

    for _ in range(iters):
        logs = np.stack([_log_se3_np(Tk @ np.linalg.inv(T)) for Tk in Ts])
        ws = 1.0 / np.maximum(1e-4, np.linalg.norm(logs, axis=1))
        ws = ws / ws.sum()
        step = (logs * ws[:, None]).sum(0)
        if np.linalg.norm(step) < 1e-7:
            break
        T = _exp_se3_np(step) @ T
    return T
