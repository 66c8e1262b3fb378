"""Faithful CPU oracle of the reference KSS-ICP pipeline, numpy + scipy
(port of kss_icp_tpu/oracle.py, line for line).

The reference's Windows EXE cannot run here, so this module re-implements
the reference algorithm *step for step* (same data structures, same loop
semantics, same constants) in numpy + scipy.spatial.cKDTree. It is the one
registration in the repo that shares no code with either package's
pipeline: it imports nothing of kss_icp_torch's ops, models, kernels or
parallel modules, takes no device and never touches the card. Its answers
on float64 inputs are JAX's oracle's bits (tests/test_torch_oracle.py), so
it is the plain reference of the port where jax is absent; chip_smoke.py's
phase 4m runs it on the card machine's host beside the port's answers.

Faithfulness notes (every quirk reproduced, with reference citations):

  * AIVS resampling (Method_AIVS_SimPro.hpp): per-box quotas with the 0.2
    round-up (:776-794), 8-color box schedule (:587-643), per-box farthest-
    point sampling with boundary label-2 seeding and the center-point seed
    when no boundary samples exist (:222-376), exact-N accurate-cut with the
    STATIC (never-updated) 3-NN table (:848-957).
  * BallRegion grid (ballRegionCompute.hpp): box-count ladder (:1194-1214),
    1-based box indexing with the boundary ceil rule (:632-688), the
    x_num==0 reconstruction bug in BallRegion_ReturnBoxCenter_Center
    (:1150-1172 — the last box of each z-layer gets a wrong center) and its
    ABSENCE in BallRegion_ReturnNeiborBox_Box (:975-1060), 12-NN max radius
    (:477-530).
  * Coarse search (initRegistrationKSS.hpp): mean-radius pre-shape align
    (:144-220), the [0, 6.3) step-6.3/8 Euler grid scanned with cumulative
    per-axis rotations (:222-296), mean-1-NN error (:430-450), clamped
    radius-2 local-minima cube (:481-522).
  * ICP with PCL 1.8 semantics (KSS_ICP.hpp:133-356): 1-NN correspondences
    rejected over maxCorrDist=1, SVD/Umeyama rigid estimation, and
    DefaultConvergenceCriteria — per-iteration delta-transform thresholds
    (translation^2 <= 1e-10, cos(angle) >= 1 - 1e-10), RELATIVE
    correspondence-MSE delta < 0.001 (PCL 1.8 icp.hpp wires
    setEuclideanFitnessEpsilon to setRelativeMSE), absolute MSE delta
    < 1e-12, max 1000 iterations. getFitnessScore = mean squared 1-NN
    distance over all source points.
  * Orchestration (KSS_ICP.hpp:53-131): pNumber = min(|S|,|T|)//2 capped at
    2000, judge-ICP fitness gate 0.0005, multi-start over every local
    minimum, final ICP on the winning resampled alignment applied to the
    full-resolution source.
  * Metric (registrationMeasure.hpp:31-98): MSE/MAE over 1-NN distances of
    the aligned full-res source against the full-res target, RMSE=sqrt(MSE).

Known benign divergences (documented, not fixable without the EXE):
  - distances are f64 end to end (PCL/FLANN returns f32 squared distances);
  - per-box FPS runs serially in box order (the reference's OpenMP schedule
    makes cross-box labelG visibility nondeterministic within a color
    group); results differ only through boundary-seed visibility;
  - wall time is a numpy/scipy proxy for MSVC C++: k-d queries and matmuls
    are C-speed, the per-box FPS and multistart loops are Python-driven, so
    measured time is the right order but not cycle-faithful.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

# ---------------------------------------------------------------------------
# BallRegion (ballRegionCompute.hpp) — voxel grid over a cloud
# ---------------------------------------------------------------------------


def estimate_box_scale(n: int) -> int:
    """Boxes-per-longest-axis ladder (ballRegionCompute.hpp:1194-1214)."""
    if n < 10_000:
        return 10
    if n < 50_000:
        return 20
    if n < 100_000:
        return 30
    if n < 500_000:
        return 40
    if n < 1_000_000:
        return 50
    return int((n / 8.0) ** (1.0 / 3.0))


@dataclass
class OracleBallRegion:
    """The subset of BallRegion state AIVS consumes, built exactly like
    BallRegion_init_withoutNormal (ballRegionCompute.hpp:114-147)."""

    points: np.ndarray                       # (N, 3) f64
    min_xyz: np.ndarray = field(init=False)  # (3,)
    unit_size: float = field(init=False)
    xyz_number: Tuple[int, int, int] = field(init=False)
    boxes: List[List[int]] = field(init=False)        # squareBoxes (index 0 unused)
    box_centers: np.ndarray = field(init=False)        # squareBoxesCReal
    box_center_local: List[int] = field(init=False)    # squareBoxesCenter (LOCAL idx)
    radius: float = field(init=False)

    def __post_init__(self):
        pts = self.points
        box_num = estimate_box_scale(len(pts))
        # BallRegion_AchieveXYZ (:690-758): AABB, unit = longest_edge/boxNum,
        # per-axis counts = ceil(extent/unit) via the int-truncate + bump.
        mins = pts.min(axis=0)
        maxs = pts.max(axis=0)
        self.min_xyz = mins
        extent = np.abs(maxs - mins)
        self.unit_size = float(extent.max() / box_num)
        nums = []
        for d in extent:
            q = d / self.unit_size
            qi = int(q)
            if q > float(qi):
                qi += 1
            nums.append(qi)
        self.xyz_number = (nums[0], nums[1], nums[2])
        nx, ny, nz = self.xyz_number
        total = nx * ny * nz
        self.boxes = [[] for _ in range(total + 1)]

        # BallRegion_BoxInput (:632-688): 1-based per-axis index with the
        # "on-boundary stays low, ==0 bumps" rule; per-box nearest-to-center
        # tracked by LOCAL index within the box's list.
        self.box_centers = np.stack(
            [self._box_center(i) for i in range(total + 1)]
        )
        center_min = np.full(total + 1, 9999.0)
        self.box_center_local = [-1] * (total + 1)
        for i, p in enumerate(pts):
            axn = []
            for a in range(3):
                q = (p[a] - mins[a]) / self.unit_size
                qi = int(q)
                if qi < q or qi == 0:
                    qi += 1
                axn.append(qi)
            idx = axn[0] + nx * (axn[1] - 1) + nx * ny * (axn[2] - 1)
            d = float(np.linalg.norm(self.box_centers[idx] - p))
            self.boxes[idx].append(i)
            if center_min[idx] > d:
                center_min[idx] = d
                self.box_center_local[idx] = len(self.boxes[idx]) - 1

        # BallRegion_EstimateRadius_KDTree (:477-530): global radius = max
        # 12-NN distance (kept for wall-time fidelity; AIVS itself only
        # consumes unit_size/boxes/centers).
        tree = cKDTree(pts)
        k = min(13, len(pts))
        d, _ = tree.query(pts, k=k)
        self.radius = float(d[:, -1].max())

    def _box_center(self, idx: int) -> np.ndarray:
        """BallRegion_ReturnBoxCenter_Center (:1150-1172) — verbatim,
        including the x_num==0 wrong-center reconstruction for the last box
        of each z-layer."""
        nx, ny, _ = self.xyz_number
        z_num = idx // (nx * ny) + 1
        leve_z = idx % (nx * ny)
        y_num = leve_z // nx + 1
        x_num = leve_z % nx
        if x_num == 0:
            x_num = nx
            y_num = y_num - 1
        m, u = self.min_xyz, self.unit_size
        return np.array(
            [
                (m[0] + (x_num - 1) * u + m[0] + x_num * u) / 2,
                (m[1] + (y_num - 1) * u + m[1] + y_num * u) / 2,
                (m[2] + (z_num - 1) * u + m[2] + z_num * u) / 2,
            ]
        )

    def neighbor_boxes(self, idx: int) -> List[int]:
        """BallRegion_ReturnNeiborBox_Box (:975-1060) — verbatim, WITHOUT the
        x_num==0 fixup the 2-argument variant has."""
        nx, ny, nz = self.xyz_number
        z_num = idx // (nx * ny) + 1
        leve_z = idx % (nx * ny)
        y_num = leve_z // nx + 1
        x_num = leve_z % nx
        xs = ([x_num - 1] if x_num > 1 else []) + [x_num] + (
            [x_num + 1] if x_num < nx else [])
        ys = ([y_num - 1] if y_num > 1 else []) + [y_num] + (
            [y_num + 1] if y_num < ny else [])
        zs = ([z_num - 1] if z_num > 1 else []) + [z_num] + (
            [z_num + 1] if z_num < nz else [])
        out = []
        nboxes = len(self.boxes)
        for xi in xs:
            for yj in ys:
                for zk in zs:
                    if xi == x_num and yj == y_num and zk == z_num:
                        continue
                    c = xi + (yj - 1) * nx + (zk - 1) * nx * ny
                    if c < nboxes:
                        out.append(c)
        return out


# ---------------------------------------------------------------------------
# AIVS simplification (Method_AIVS_SimPro.hpp)
# ---------------------------------------------------------------------------


def _color_schedule(br: OracleBallRegion) -> List[List[int]]:
    """AIVS_initBoxIndexNumber (:587-643): non-empty boxes bucketed into 8
    parity groups, collected in (i, j, k) loop order."""
    nx, ny, nz = br.xyz_number
    groups: List[List[int]] = [[] for _ in range(8)]
    parity_slot = {
        (1, 1, 1): 0, (0, 1, 1): 1, (0, 0, 1): 2, (1, 0, 1): 3,
        (1, 1, 0): 4, (0, 1, 0): 5, (0, 0, 0): 6, (1, 0, 0): 7,
    }
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            for k in range(1, nz + 1):
                idx = i + nx * (j - 1) + nx * ny * (k - 1)
                if not br.boxes[idx]:
                    continue
                groups[parity_slot[(i % 2, j % 2, k % 2)]].append(idx)
    return groups


def _box_quotas(br: OracleBallRegion, point_num: int) -> List[int]:
    """AIVS_BoxSimplification_Points (:776-794): quota = floor(pop*rate),
    +1 when the fraction exceeds 0.2."""
    rate = point_num / len(br.points)
    quotas = []
    for members in br.boxes:
        q = len(members) * rate
        qi = int(q)
        quotas.append(qi + 1 if q - qi > 0.2 else qi)
    return quotas


def aivs_simplify(points: np.ndarray, point_num: int) -> np.ndarray:
    """AIVS_simplification (:94-154): quota'd per-box FPS under the 8-color
    schedule, then accurate-cut to exactly `point_num` (when over)."""
    pts = np.asarray(points, np.float64)
    br = OracleBallRegion(pts)
    groups = _color_schedule(br)
    quotas = _box_quotas(br, point_num)
    search_r = br.unit_size * 3.0 / 4.0
    label_g = np.ones(len(pts), np.int8)  # 1 = unsampled, 0 = sampled
    simi: List[List[int]] = [[] for _ in br.boxes]

    for group in groups:
        for box_idx in group:
            sim_num = quotas[box_idx]
            if sim_num == 0:
                continue
            center = br.box_centers[box_idx]
            local = list(br.boxes[box_idx])
            label = [1] * len(local)
            # Boundary seeding: already-sampled neighbor-box points within
            # the searchBoxRadius cube join as label-2 context (:257-270).
            add_j = True
            for nb in br.neighbor_boxes(box_idx):
                for gidx in br.boxes[nb]:
                    p = pts[gidx]
                    if (
                        abs(p[0] - center[0]) <= search_r
                        and abs(p[1] - center[1]) <= search_r
                        and abs(p[2] - center[2]) <= search_r
                        and label_g[gidx] == 0
                    ):
                        local.append(gidx)
                        label.append(2)
                        add_j = False
            sample_count = 0
            ctr_local = br.box_center_local[box_idx]
            if add_j and -1 <= ctr_local < len(local):
                # Seed: the box's nearest-to-center point (:271-275). The
                # reference indexes -1 into the vector when the box is empty;
                # empty boxes never reach here (quota 0).
                label[ctr_local] = 0
            coords = pts[np.asarray(local)]
            label_arr = np.asarray(label)
            seeds = label_arr != 1
            if seeds.any():
                d = np.linalg.norm(
                    coords[:, None, :] - coords[None, seeds, :], axis=-1
                ).min(axis=1)
                mind = np.where(label_arr == 1, d, 0.0)
            else:
                mind = np.full(len(local), 9999.0)
            for li in np.nonzero(label_arr == 0)[0]:
                simi[box_idx].append(local[li])
                label_g[local[li]] = 0
                sample_count += 1
            # FPS rounds: pick the unsampled local point farthest from the
            # sampled/context set (:328-371; strict > keeps the first max).
            free = label_arr == 1
            while sample_count < sim_num:
                cand = np.where(free, mind, -1.0)
                best = int(np.argmax(cand))
                if cand[best] <= 0.0:
                    break
                mind[best] = 0.0
                gbest = local[best]
                label_g[gbest] = 0
                simi[box_idx].append(gbest)
                sample_count += 1
                d_new = np.linalg.norm(coords - coords[best], axis=-1)
                upd = free & (d_new < mind)
                mind[upd] = d_new[upd]
    sample = [g for box in simi for g in box]
    return _accurate_cut(pts, sample, point_num)


def _accurate_cut(
    pts: np.ndarray, sample: List[int], point_num: int
) -> np.ndarray:
    """AIVS_AccurateCut_Optimization (:848-957): while over target, delete
    one member of the closest surviving 1-NN pair — the one whose 2nd-NN is
    nearer — using a STATIC 3-NN table (the reference never updates it)."""
    d_tiff = len(sample) - point_num
    coords = pts[np.asarray(sample)]
    if d_tiff <= 0 or len(sample) < 3:
        return coords
    tree = cKDTree(coords)
    dist, idx = tree.query(coords, k=3)
    alive = np.ones(len(sample), bool)
    while d_tiff > 0:
        mask = alive & alive[idx[:, 1]]
        if not mask.any():
            break
        cand = np.where(mask, dist[:, 1], 9999.0)
        b1 = int(np.argmin(cand))
        if cand[b1] >= 9999.0:
            break
        b2 = int(idx[b1, 1])
        drop = b2 if dist[b1, 2] > dist[b2, 2] else b1
        alive[drop] = False
        d_tiff -= 1
    return coords[alive]


# ---------------------------------------------------------------------------
# Coarse rotation search (initRegistrationKSS.hpp)
# ---------------------------------------------------------------------------

_AXIS_ORDER = (1, 2, 3)


def _axis_rotate(axis: int, angle: float, pts: np.ndarray) -> np.ndarray:
    """initRegistration_Transfer (:365-404): single-axis rotation."""
    c, s = np.cos(angle), np.sin(angle)
    out = pts.copy()
    if axis == 1:
        out[:, 1] = pts[:, 1] * c - pts[:, 2] * s
        out[:, 2] = pts[:, 1] * s + pts[:, 2] * c
    elif axis == 2:
        out[:, 0] = pts[:, 2] * s + pts[:, 0] * c
        out[:, 2] = pts[:, 2] * c - pts[:, 0] * s
    else:
        out[:, 0] = pts[:, 0] * c - pts[:, 1] * s
        out[:, 1] = pts[:, 0] * s + pts[:, 1] * c
    return out


@dataclass
class OracleInitRegistration:
    """initRegistration_KSS (:28-524): pre-shape align + exhaustive Euler
    grid + local-minima candidate list."""

    source: np.ndarray
    target: np.ndarray
    step: float = 8.0

    def __post_init__(self):
        src = np.asarray(self.source, np.float64)
        tgt = np.asarray(self.target, np.float64)
        # initRegistration_MiddleAlign (:144-220).
        c_s = src.mean(axis=0)
        c_t = tgt.mean(axis=0)
        self.middle_s = c_t
        self.middle = c_t - c_s
        avg_s = np.linalg.norm(src - c_s, axis=1).mean()
        avg_t = np.linalg.norm(tgt - c_t, axis=1).mean()
        self.scale = avg_t / avg_s
        moved = src + self.middle
        self.point_source = c_t + (moved - c_t) * self.scale
        self.point_target = tgt
        self._scan()

    def _error_ave(self, pts: np.ndarray) -> float:
        """initRegistration_Error_Ave (:430-450): mean 1-NN distance."""
        d, _ = self._tree.query(pts, k=1)
        return float(d.mean())

    def _scan(self):
        """initRegistration_Rotation (:222-296): cumulative-axis triple loop
        over [0, 6.3) in 6.3/step increments; record the full error field.

        NOTE the float-accumulation quirk reproduced below: at step=8 the
        loop visits NINE angles per axis (8 increments of 0.7875 accumulate
        to 6.2999... < 6.3), so the reference grid is really 9^3 = 729
        rotations with the 9th angle ~= 0.017 rad, a near-duplicate of 0.
        The pipelines' grids use exactly `rotation_steps` angles."""
        self._tree = cKDTree(self.point_target)
        inc = 6.3 / self.step
        angles = []
        a = 0.0
        while a < 6.3:
            angles.append(a)
            a += inc
        n = len(angles)
        value = np.empty((n, n, n))
        best = (0, 0, 0)
        best_err = 9999.0
        for ii, ai in enumerate(angles):
            ps_x = _axis_rotate(1, ai, self.point_source)
            for jj, aj in enumerate(angles):
                ps_xy = _axis_rotate(2, aj, ps_x)
                for kk, ak in enumerate(angles):
                    ps_xyz = _axis_rotate(3, ak, ps_xy)
                    e = self._error_ave(ps_xyz)
                    value[ii, jj, kk] = e
                    if e < best_err:
                        best_err = e
                        best = (ai, aj, ak)
        self.value = value
        self.angle = np.array(best)
        # Local minima over the clamped radius-2 cube (:481-522, :276-289);
        # the recorded angle is index * 6.3/step (:282-284).
        r = 2
        self.angle_list: List[np.ndarray] = []
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    lo_i, hi_i = max(i - r, 0), min(i + r, n - 1)
                    lo_j, hi_j = max(j - r, 0), min(j + r, n - 1)
                    lo_k, hi_k = max(k - r, 0), min(k + r, n - 1)
                    window = value[lo_i:hi_i + 1, lo_j:hi_j + 1, lo_k:hi_k + 1]
                    if value[i, j, k] <= window.min():
                        self.angle_list.append(
                            np.array([i * inc, j * inc, k * inc])
                        )

    def rotate(self, pts: np.ndarray, angle: Optional[Sequence[float]] = None
               ) -> np.ndarray:
        """initRegistration_Rotation[_Angle] (:75-109): translate, scale
        about the target centroid, then the three axis rotations."""
        ang = self.angle if angle is None else np.asarray(angle)
        p = np.asarray(pts, np.float64) + self.middle
        p = self.middle_s + (p - self.middle_s) * self.scale
        for axis, a in zip(_AXIS_ORDER, ang):
            p = _axis_rotate(axis, a, p)
        return p


# ---------------------------------------------------------------------------
# PCL-semantics ICP (KSS_ICP.hpp:133-356 / pcl::IterativeClosestPoint 1.8)
# ---------------------------------------------------------------------------


@dataclass
class OracleICPResult:
    transformation: np.ndarray  # final 4x4
    fitness: float              # getFitnessScore(): mean squared 1-NN dist
    iterations: int
    converged: bool


def pcl_icp(
    source: np.ndarray,
    target: np.ndarray,
    max_iterations: int = 1000,
    max_correspondence_distance: float = 1.0,
    transformation_epsilon: float = 1e-10,
    euclidean_fitness_epsilon: float = 0.001,
    tree: Optional[cKDTree] = None,
) -> OracleICPResult:
    """pcl::IterativeClosestPoint with the reference's settings
    (KSS_ICP.hpp:156-159): SVD rigid estimation on 1-NN correspondences
    rejected over maxCorrDist, DefaultConvergenceCriteria with
    translation^2/rotation deltas from `transformation_epsilon` and the
    euclidean fitness epsilon as the RELATIVE correspondence-MSE delta
    (PCL 1.8 icp.hpp: setRelativeMSE(euclidean_fitness_epsilon_))."""
    src = np.asarray(source, np.float64)
    tgt = np.asarray(target, np.float64)
    if tree is None:
        tree = cKDTree(tgt)
    final = np.eye(4)
    cur = src.copy()
    prev_mse = np.finfo(np.float64).max
    mse_abs = 1e-12           # DefaultConvergenceCriteria default
    rot_thresh = 1.0 - transformation_epsilon
    it = 0
    converged = False
    max_d2 = max_correspondence_distance * max_correspondence_distance
    while True:
        d, idx = tree.query(cur, k=1)
        d2 = d * d
        keep = d2 <= max_d2
        if keep.sum() < 3:  # min_number_correspondences_
            break
        p = cur[keep]
        q = tgt[idx[keep]]
        # TransformationEstimationSVD (Umeyama, no scale).
        mp, mq = p.mean(axis=0), q.mean(axis=0)
        h = (p - mp).T @ (q - mq)
        u, _, vt = np.linalg.svd(h)
        det = np.linalg.det(vt.T @ u.T)
        dmat = np.diag([1.0, 1.0, np.sign(det)])
        rot = vt.T @ dmat @ u.T
        t = mq - rot @ mp
        delta = np.eye(4)
        delta[:3, :3] = rot
        delta[:3, 3] = t
        cur = cur @ rot.T + t
        final = delta @ final
        it += 1
        # DefaultConvergenceCriteria::hasConverged on the per-iteration delta.
        if it >= max_iterations:
            converged = True
            break
        cos_angle = 0.5 * (rot[0, 0] + rot[1, 1] + rot[2, 2] - 1.0)
        translation_sqr = float(t @ t)
        if cos_angle >= rot_thresh and translation_sqr <= transformation_epsilon:
            converged = True
            break
        cur_mse = float(d2[keep].mean())   # MSE of this iteration's correspondences
        if abs(cur_mse - prev_mse) < mse_abs:
            converged = True
            break
        if abs(cur_mse - prev_mse) / prev_mse < euclidean_fitness_epsilon:
            converged = True
            break
        prev_mse = cur_mse
    # getFitnessScore(): mean squared 1-NN distance over ALL source points.
    d, _ = tree.query(src @ final[:3, :3].T + final[:3, 3], k=1)
    return OracleICPResult(final, float((d * d).mean()), it, converged)


# ---------------------------------------------------------------------------
# Orchestrator + metric (KSS_ICP.hpp / registrationMeasure.hpp)
# ---------------------------------------------------------------------------


def pcr_qm(aligned: np.ndarray, target: np.ndarray) -> dict:
    """PCR_QM (registrationMeasure.hpp:31-98): MSE/RMSE/MAE of 1-NN
    distances from the aligned cloud to the target."""
    d, _ = cKDTree(np.asarray(target, np.float64)).query(
        np.asarray(aligned, np.float64), k=1
    )
    mse = float((d * d).mean())
    return {"mse": mse, "rmse": float(np.sqrt(mse)), "mae": float(d.mean())}


@dataclass
class OracleRegistrationResult:
    aligned: np.ndarray          # full-resolution aligned source (pointAlign)
    fitness: float               # final ICP fitness
    judge_fitness: float
    used_multistart: bool
    num_candidates: int
    chosen_candidate: int        # index into angle_list (-1 = gate passed)
    seconds: float
    stage_seconds: dict


def register_pair_oracle(
    source: np.ndarray,
    target: np.ndarray,
    accurate: float = 8.0,
    max_iterations: int = 1000,
) -> OracleRegistrationResult:
    """KSSICP_init + KSSICP_Registration (KSS_ICP.hpp:53-131), end to end."""
    t_start = time.perf_counter()
    src = np.asarray(source, np.float64)
    tgt = np.asarray(target, np.float64)
    p_number = min(len(src), len(tgt)) // 2
    p_number = min(p_number, 2000)

    t0 = time.perf_counter()
    cloud_t = aivs_simplify(tgt, p_number)
    cloud_s = aivs_simplify(src, p_number)
    t_resample = time.perf_counter() - t0

    t0 = time.perf_counter()
    ir = OracleInitRegistration(cloud_s, cloud_t, accurate)
    t_coarse = time.perf_counter() - t0

    t0 = time.perf_counter()
    tree_t = cKDTree(cloud_t)
    judge = pcl_icp(ir.rotate(cloud_s), cloud_t, max_iterations, tree=tree_t)
    chosen = -1
    if judge.fitness > 0.0005:  # the multi-start gate (KSS_ICP.hpp:99)
        best_q = 9999.0
        angle_index = 0
        for i, ang in enumerate(ir.angle_list):
            ri = pcl_icp(
                ir.rotate(cloud_s, ang), cloud_t, max_iterations, tree=tree_t
            ).fitness
            if ri < best_q and ri >= 0:
                best_q = ri
                angle_index = i
        chosen = angle_index
        aligned_sss = ir.rotate(cloud_s, ir.angle_list[angle_index])
        point_align = ir.rotate(src, ir.angle_list[angle_index])
    else:
        aligned_sss = ir.rotate(cloud_s)
        point_align = ir.rotate(src)
    t_multistart = time.perf_counter() - t0

    # Final ICP on the resampled alignment; its 4x4 applied to the
    # full-resolution source (KSS_ICP.hpp:130, :222-230).
    t0 = time.perf_counter()
    res = pcl_icp(aligned_sss, cloud_t, max_iterations, tree=tree_t)
    rt = res.transformation
    point_align = point_align @ rt[:3, :3].T + rt[:3, 3]
    t_final = time.perf_counter() - t0

    return OracleRegistrationResult(
        aligned=point_align,
        fitness=res.fitness,
        judge_fitness=judge.fitness,
        used_multistart=chosen >= 0,
        num_candidates=len(ir.angle_list),
        chosen_candidate=chosen,
        seconds=time.perf_counter() - t_start,
        stage_seconds={
            "resample": t_resample,
            "coarse": t_coarse,
            "multistart": t_multistart,
            "final_icp": t_final,
        },
    )
