"""Static configuration tree (the port's own copy of the JAX package's config.py).

Field for field the same dataclasses, defaults and YAML loader as the
JAX package, so a config file drives either package. The port keeps its
own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics. Defaults = EuRoC cam0
    (reference src/legacy/EuRoCReader.cpp:12-20)."""

    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    # radtan distortion (k1, k2, p1, p2)
    k1: float = -0.28340811
    k2: float = 0.07395907
    p1: float = 0.00019359
    p2: float = 1.76187114e-05

    @property
    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB front-end (parity: reference src/adapters/gpu/OrbCudaExtractor.cpp:35-45,
    src/euroc_eval.cpp:88 uses 2000 features)."""

    num_features: int = 2000
    scale_factor: float = 1.2
    num_levels: int = 8
    fast_threshold: float = 20.0
    harris_block_size: int = 7
    patch_size: int = 31  # orientation + descriptor patch
    edge_threshold: int = 31  # border where no keypoints are produced
    descriptor_bits: int = 256
    brief_seed: int = 2024  # deterministic rBRIEF sampling pattern


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Hamming kNN matcher (parity: reference src/main.cpp:158-175)."""

    ratio: float = 0.75  # Lowe ratio for tracking
    cross_check: bool = False
    max_distance: int = 256  # no gate by default
    # loose tier for feature tracks (chunk BA): ratio relaxed, precision
    # restored by a per-pair epipolar gate once the pose is estimated
    track_ratio: float = 0.92
    track_epipolar_px: float = 2.0


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC (parity: reference src/main.cpp:187-191,
    findEssentialMat(prob=0.999, thresh=1.0px) + recoverPose)."""

    num_hypotheses: int = 256
    sample_size: int = 8
    inlier_threshold_px: float = 1.0
    min_matches: int = 8
    min_inliers: int = 10  # euroc_eval requires >10 inliers (euroc_eval.cpp:191)
    refine: bool = True
    # Sampson Gauss-Newton polish iterations on the essential manifold
    # (epipolar.polish_pose_sampson); 0 disables. The linear 8-point
    # stage alone leaves several degrees of rotation error even on
    # sub-pixel correspondences.
    polish_iters: int = 8
    # dominant-plane degeneracy rescue (ops/homography.py): when the
    # homography consensus covers >= h_support_ratio of the E consensus,
    # the scene is plane-dominant and (R, t) is re-derived from the
    # homography decomposition. A degenerate E always out-votes H (the
    # compatible-E family has a spare dof to absorb near-plane points),
    # so the bar must sit below 1: 0.72 corresponds to ORB-SLAM's
    # S_H/(S_H+S_F) > 0.42 model-selection ratio.
    h_fallback: bool = True
    h_hypotheses: int = 64
    h_support_ratio: float = 0.72
    # rotation-only cheirality rescue (loop verification): cheirality
    # is a SIGN test on triangulated depths, and at a true ~0-baseline
    # revisit those signs follow the arbitrary estimated t direction —
    # a correct pose fails the front gate ~50% of the time (measured:
    # longrun recall 0.54, verify_fail_best_inliers_p50 = the full
    # feature count, R_err <= 0.03 deg on the failing pairs). When
    # rot_frac of the epipolar consensus is ALSO explained by rotation
    # alone (|angle(R p1, p2)| under the same pixel threshold — a
    # t-independent residual that is only small for everything when the
    # effective baseline/depth is tiny), the front gate is meaningless
    # and is bypassed. Self-gating: any real parallax breaks the
    # rotation-only fit on near points. Default OFF — the VO stack
    # handles its own low-parallax regime (gyro prior / H-rescue);
    # loop verification opts in (backend/loop_closure.verify_candidate).
    rot_only_rescue: bool = False
    rot_only_frac: float = 0.7
    seed: int = 7


@dataclasses.dataclass(frozen=True)
class EkfConfig:
    """15-state error-state EKF (parity: reference include/legacy/IMU.hpp:108-113,
    src/legacy/IMU.cpp:104-127)."""

    accel_noise: float = 0.1
    gyro_noise: float = 0.01
    accel_bias_walk: float = 0.001
    gyro_bias_walk: float = 0.0001
    pos_noise: float = 0.01
    rot_noise: float = 0.01
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    max_dt: float = 0.1  # dt gate (IMU.cpp:146-149)
    imu_window: int = 32  # max IMU samples per frame step (padded)


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """Loop-closure detector (parity: reference src/legacy/LoopClosure.cpp;
    euroc_eval.cpp:103 uses (min_frames_between=200, min_score=0.4wrong
    -> actually (200, 0.4, 50)): min gap 200, min score 0.4, min matches 50.
    DB capacity 500 keyframes (LoopClosure.cpp:29)."""

    max_keyframes: int = 512  # padded capacity (ref: 500)
    min_frames_between: int = 200
    min_score: float = 0.4
    min_matches: int = 50
    ratio: float = 0.7  # loop-closure ratio test (LoopClosure.cpp:92)
    candidate_score_floor: float = 0.1
    top_k_candidates: int = 5
    verify_threshold_px: float = 3.0  # FM_RANSAC reproj threshold
    # pose-guided re-matching (recall lever the reference lacks — its
    # verification re-matches only at the strict 0.7 ratio,
    # LoopClosure.cpp:86-98): after RANSAC verifies a candidate's
    # geometry on a reduced inlier bar (min_matches * guided_min_frac),
    # matches at the LOOSE ratio are re-admitted when Sampson-consistent
    # with the verified epipolar geometry, the pose is re-polished on
    # the bigger consensus, and the full min_matches bar applies to the
    # boosted count. guided_ratio = 0 disables.
    guided_ratio: float = 0.9
    guided_min_frac: float = 0.4


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """3D mapper filters (parity: reference include/legacy/Mapper.hpp:67-70)."""

    max_points: int = 200_000  # padded map capacity
    min_depth: float = 0.1
    max_depth: float = 50.0
    min_parallax_deg: float = 1.0
    max_reproj_error_px: float = 2.0
    outlier_sigma: float = 3.0  # statistical filter (Mapper.cpp:134-165)
    # chunked mode: triangulate frame i against frame i-pair_lag (wider
    # baseline than consecutive frames, which fall under the parallax
    # gate at 20 fps); poses are already known, so no extra RANSAC
    pair_lag: int = 4


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """YOLO-class object detector (parity: reference src/legacy/TRTInference.cpp,
    YOLO26s 640x640 [1,300,6] output)."""

    input_size: int = 640
    max_detections: int = 300
    conf_threshold: float = 0.5
    nms_iou_threshold: float = 0.45
    num_classes: int = 80
    width_mult: float = 0.50  # "s" scale
    depth_mult: float = 0.33


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """SE3 pose-graph optimizer (parity: reference src/legacy/LoopClosure.cpp:197-313,
    g2o LM; loop edges weighted 10x: LoopClosure.cpp:275-280)."""

    max_nodes: int = 4096
    max_edges: int = 8192
    loop_edge_weight: float = 10.0
    # wide-baseline backbone edges (chunked mode): every frame also gets
    # an edge to frame i-mapper.pair_lag from a RANSAC on the lag pair.
    # DEFAULT 0 (off) since r4: the backbone predates gyro chain
    # rotations and chunk BA, which now carry the wide-baseline
    # information through multi-frame tracks — and the backbone's
    # independent measurements disagree with the BA-refined chain, a
    # fight the pose-graph LM resolves by distorting the trajectory.
    # Measured on the low-res rotloop (lc_diag r4, final optimize with
    # 17 loops): backbone on -> Sim3 ATE 0.655 m / rot RPE 6.3 deg /
    # umeyama drift 0.73->0.94; backbone off -> 0.561 m / 0.15 deg /
    # scale exactly stable. Without loops the final optimize becomes an
    # exact no-op (chain edges are consistent by construction). >0
    # re-enables (see PipelineConfig.backbone_t_source for the
    # magnitude convention). Requires a metric vo_scale_mode.
    backbone_weight: float = 0.0
    # translation weight of the consecutive-frame chain edges when the
    # backbone is active. Their translations are low-parallax noise
    # (measured 1.5x |t| bias on the rotloop benchmark while backbone
    # lag pairs sat at 0.73x), but down-weighting them measured WORSE
    # (0.3 -> ATE 0.677 vs 1.0 -> 0.620 on rotloop-240): even biased,
    # the dense chain constrains the local trajectory shape. Keep 1.0.
    odom_t_weight: float = 1.0
    # rotation weight of chain edges when their rotations come from the
    # integrated gyro (fusion/gyro_prior.py): ~30x lower rotation error
    # than two-view VO, so these edges pin orientation against the
    # noisier backbone/loop rotation measurements
    gyro_rot_weight: float = 25.0
    lm_iterations: int = 10
    final_lm_iterations: int = 50
    cg_iterations: int = 64
    init_lambda: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ChunkBaConfig:
    """Chunk-local multiview bundle adjustment (backend/chunk_ba.py) —
    a refinement stage the reference does not have: per chunk, link
    RANSAC-inlier matches into feature tracks and alternate closed-form
    multiview triangulation with batched per-pose Gauss-Newton."""

    enabled: bool = True
    outer_iters: int = 8     # joint Schur GN steps (one triangulation each)
    pose_iters: int = 2      # (legacy alternation fallback only)
    damping: float = 1e-3    # trace-relative LM damping
    prior_weight: float = 1e-2  # twist prior to the initial chain poses
                                # (monocular scale-gauge anchor)
    huber_px: float = 2.0    # robust kernel width on the pixel residual
    gate_px: float = 12.0    # hard outlier gate
    min_depth: float = 0.05  # reject observations behind the camera


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level toggle set (parity: reference include/pipeline/SlamPipeline.hpp:16-25)."""

    camera: CameraConfig = CameraConfig()
    orb: OrbConfig = OrbConfig()
    matcher: MatcherConfig = MatcherConfig()
    ransac: RansacConfig = RansacConfig()
    ekf: EkfConfig = EkfConfig()
    loop: LoopClosureConfig = LoopClosureConfig()
    mapper: MapperConfig = MapperConfig()
    detector: DetectorConfig = DetectorConfig()
    pose_graph: PoseGraphConfig = PoseGraphConfig()
    chunk_ba: ChunkBaConfig = ChunkBaConfig()

    enable_loop_closure: bool = True
    enable_detection: bool = False  # detector weights are optional
    enable_mapping: bool = True
    enable_dynamic_filtering: bool = False
    enable_fusion: bool = True
    # .npz from models/convert_weights.py or yolo.save_weights; random
    # init when None (latency-correct, accuracy needs real weights)
    detector_weights: str | None = None

    # monocular translation scale: "unit" = |t| = 1 per frame (parity
    # with the reference's recoverPose accumulation), "median_depth" =
    # normalize each step so the median triangulated scene depth equals
    # vo_scene_depth — keeps the trajectory metrically consistent up to
    # ONE global scale instead of one per frame (better ATE/RPE/maps)
    vo_scale_mode: str = "median_depth"
    vo_scene_depth: float = 4.0
    # depth statistic feeding the scene-depth pin (ops/epipolar.py):
    # "triangulated" = unit-|t| two-view triangulation under the
    # estimated pose (pair_depths); "tfree_parallax" = t-direction-free
    # ranges sin(alpha)/beta with the rotation-compensated angular
    # displacement beta DEBIASED by the keypoint noise
    # (tfree_parallax_depths). The r4 probe on the 240-frame low-res
    # rotloop measured the triangulated pin's |t| geomean ratio 2.24
    # (direction noise inflates apparent parallax, a known gap of the
    # reference) vs 1.24 for tfree at the same log-std — but tfree's win
    # rides partial cancellation (estimated-direction sin(alpha) reads
    # ~0.46x low while the debiased beta reads ~2x high), so it stays
    # an opt-in lever until it wins end-to-end at full res too. Chain
    # RATIOS (shared-frame depth ratios) always use triangulated
    # depths — they are scale-free and unaffected by the pin bias.
    vo_pin_estimator: str = "triangulated"
    # keypoint angular noise for the tfree debias, in pixels (1-dof
    # tangent component). 0.55 px = the oracle-calibrated value from
    # the r4 probe (GT-epipolar-perpendicular displacement component,
    # median over 239 pairs).
    vo_pin_sigma_px: float = 0.55
    # Wide-baseline (lag-pair) scale pin: replace each consecutive
    # pin's magnitude with the gyro-fused lag-window pin's, allocated
    # within the window by the consecutive pins' relative sizes (their
    # shared direction-noise bias cancels in the allocation). r5
    # redesign — works WITHOUT backbone graph edges now, and the
    # correction is LOCAL per pair (the r4 global-EMA form could not
    # track the consecutive pin's 1-6x per-chunk bias swing). Evidence
    # (PIN_LAGS_r05.json + SCALE_PIN_r05.json): the gyro-fused lag-4
    # pin sits at the oracle floor at both resolutions (low-res 0.90
    # vs the consecutive pin's 2.24 — direction noise collapses ~lag^2)
    # and the low-res rotloop A/B improves every metric: raw ATE 2.72
    # -> 1.05 m, rigid 1.22 -> 0.80, Sim3 0.87 -> 0.71, |log umeyama|
    # 0.55 -> 0.34 (the residual is the shared vo_scene_depth-prior
    # definition floor every estimator shows, GT oracles included).
    # It also pays at full res: the on-chip flagship rotloop reads raw
    # ATE 0.74 -> 0.59, Sim3 0.34 -> 0.21, umeyama 1.008 with the pin
    # (SCALE_PIN_r05.json fullres row), and the excited scene halves
    # Sim3 ATE (0.44 -> 0.23). Composing with imu_metric_scale is
    # SAFE for the local form: on the low-excitation rotloop vi_init's
    # consensus correctly refuses to commit (imu scale 1.000 every
    # chunk, results bit-identical to the no-IMU run) — the earlier
    # mis-commit probe was the GLOBAL form shifting whole windows
    # coherently. The package default stays False so the flip is an
    # explicit per-deployment choice; the benchmark configs
    # (eval/accuracy_benchmark.benchmark_config) enable it and every
    # r5 accuracy artifact measures it.
    vo_backbone_scale: bool = False
    # pin the chain's metric on the chunk-BA landmark depths instead of
    # the two-view pair depths: landmarks triangulated from EVERY frame
    # of the chunk see up to a chunk-length baseline, so their geomean
    # depth carries far less of the two-view pin's multiplicative bias
    # The correction is an EMA'd multiplicative factor on the chain
    # metric (eval/chunked.py) — still a PRIOR pin (geomean landmark
    # depth == vo_scene_depth); the accelerometer (imu_metric_scale)
    # remains the absolute-scale source and composes on top. Needs
    # chunk_ba.enabled and a metric vo_scale_mode. DEFAULT OFF: measured
    # on the low-res rotloop the multi-view statistic reads depths ~13%
    # smaller than the two-view pin even with per-landmark ray-spread
    # conditioning gates (umeyama 0.58 -> 0.51) — the midpoint depths of
    # short low-parallax tracks bias small. Kept as an A/B lever; see
    # chunk_ba.refine for the statistic.
    ba_scale_pin: bool = False
    # backbone edge translation magnitude source: "chain" copies the
    # chain's displacement over the lag window — the backbone edge then
    # contributes its superior wide-baseline DIRECTION without fighting
    # the chain's metric. The r3 behavior ("pin": the lag pair's own
    # depth pin) made chain and backbone edges disagree by 30-50% in
    # scale, and the pose-graph LM "resolved" the fight by twisting the
    # trajectory: measured on the r4 edge audits, the final optimize
    # took full-res rot RPE 0.06 -> 1.14 deg and rigid-aligned ATE
    # 0.08 -> 0.29 m. "chain" removes the metric fight entirely.
    backbone_t_source: str = "chain"
    # replace per-pair VO rotations with integrated gyro rotations when
    # IMU data is present (fusion/gyro_prior.py; also fused inside the
    # online per-frame step) — the gyro is ~30x more accurate over one
    # frame interval and rescues pairs whose visual RANSAC failed
    gyro_chain_rotation: bool = True
    # accelerometer-derived METRIC scale (fusion/vi_init.py): a sliding-
    # window VINS-style linear alignment of preintegrated IMU against
    # the VO chain supplies the absolute scale the camera cannot
    # observe, correcting the vo_scene_depth prior (which is exactly
    # wrong on any scene whose depth differs from it). Applies in
    # chunked mode whenever IMU data is present and vo_scale_mode is
    # metric ("median_depth"/"propagate").
    imu_metric_scale: bool = True
    # camera-from-imu(body) rotation (rows as tuples — hashable for the
    # frozen config). Identity when the body frame IS the camera frame
    # (synthetic scenes); EuRoC needs cam0's T_BS (io/euroc.py parses it)
    imu_cam_rotation: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                               (0.0, 0.0, 1.0))

    @staticmethod
    def from_yaml(path: str) -> "PipelineConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return PipelineConfig.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "PipelineConfig":
        sub = {
            "camera": CameraConfig,
            "orb": OrbConfig,
            "matcher": MatcherConfig,
            "ransac": RansacConfig,
            "ekf": EkfConfig,
            "loop": LoopClosureConfig,
            "mapper": MapperConfig,
            "detector": DetectorConfig,
            "pose_graph": PoseGraphConfig,
            "chunk_ba": ChunkBaConfig,
        }
        kwargs = {}
        for key, val in raw.items():
            if key in sub:
                val = sub[key](**{k: tuple(v) if isinstance(v, list) else v for k, v in val.items()})
            kwargs[key] = val
        return PipelineConfig(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
