# Frozen copy of supersurfel_fusion_tpu_torch/config.py at commit 37bce59, with
# its imports renamed: part of the benchmark's plain reference, which
# imports nothing of the program under test.
"""Configuration dataclasses of the PyTorch port.

A copy of `supersurfel_fusion_tpu/config.py`: the same frozen dataclasses with
the same field names and defaults (held equal by
`tests/test_torch_config_geometry.py`), so one configuration drives both
packages. Parameter names/defaults follow the reference benchmark launch file
(`launch/supersurfel_fusion_rgbd_benchmark.launch:7-53`) and
`node/supersurfel_fusion_node.cpp:224-252`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera model (reference: `CamParam`, cam_param.hpp)."""

    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    width: int = 640
    height: int = 480

    @staticmethod
    def tum_fr1() -> "CameraIntrinsics":
        # reference: rgbd_benchmark/fr1_cam.yaml
        return CameraIntrinsics(525.0, 525.0, 319.5, 239.5, 640, 480)

    @staticmethod
    def tum_fr2() -> "CameraIntrinsics":
        # reference: rgbd_benchmark/fr2_cam.yaml
        return CameraIntrinsics(520.9, 521.0, 325.1, 249.7, 640, 480)

    @staticmethod
    def tum_fr3() -> "CameraIntrinsics":
        # reference: rgbd_benchmark/fr3_cam.yaml
        return CameraIntrinsics(535.4, 539.2, 320.1, 247.6, 640, 480)


@dataclass(frozen=True)
class TPSConfig:
    """Texture-, plane- and size-aware superpixel segmentation parameters.

    Reference: `TPS_RGBD` ctor args (`core/src/TPS_RGBD.cu:35-80`) with the
    benchmark launch values. `min_size` is derived as cell_size^2/4 at the
    call site (`TPS_RGBD.cu:198`).
    """

    cell_size: int = 16
    lambda_pos: float = 10.0
    lambda_bound: float = 1000.0
    lambda_size: float = 1000.0
    lambda_disp: float = 1.0e8
    thresh_disp: float = 1.0e-4
    nb_iters: int = 10           # total; first half RGB-only, second half RGBD
    use_ransac: bool = True
    nb_samples: int = 16         # RANSAC plane hypotheses per superpixel
    filter_iter: int = 3
    filter_alpha: float = 0.1
    filter_beta: float = 1.0
    filter_thresh: float = 0.05
    # Labels are constrained to a 3x3 cell neighbourhood
    # around each pixel's grid cell (gSLICr-style), which turns every
    # gather/scatter of the reference into static shifts + one einsum.
    cell_reach: int = 1
    # merge cadence: True refreshes superpixel stats after every checkerboard
    # phase (reference behaviour); False once per iteration (4 phases) — the
    # standard SLIC cadence, ~2x faster with near-identical segmentations.
    merge_every_phase: bool = False
    # Kept for parity with the JAX configuration. The port does not read it:
    # the device picks the path (a CUDA tensor goes through the hand-written
    # kernel in ops/tps_cuda.py, a CPU tensor through the plain ops/tps.py).
    use_pallas: bool = True


@dataclass(frozen=True)
class ICPConfig:
    """Dense symmetric point-to-plane ICP (reference: `DenseRegistration`,
    `core/src/dense_registration.cu:245-424`)."""

    nb_iters: int = 10
    cov_thresh: float = 0.05
    # correspondence gates (dense_registration_kernels.cuh:232-234)
    max_color_dist: float = 20.0
    max_dist: float = 0.1
    min_normal_dot: float = 0.8
    min_inliers: float = 100.0
    max_translation: float = 0.2
    # early-exit when error stops improving (dense_registration.cu:388)
    rel_error_break: float = 0.9995
    # Tikhonov anchor toward the VO initialization: each GN step solves
    # (JtJ + lambda I) x = Jtr, so directions the scene geometry does not
    # constrain (planar-scene tx/wz degeneracy) stay at the VO pose instead
    # of being rejected outright by the covariance gate; the gate covariance
    # is the damped estimator's inv(JtJ + lambda I). 0 = reference behaviour
    # (undamped solve + binary gate on inv(JtJ) — measured on fr1/xyz this
    # rejects ~48% of frames and drifts to 0.0349 m vs 0.0195 m with 80).
    solve_damping: float = 80.0
    # NOTE a Huber IRLS weight on the point-to-plane residual was tried
    # (round 4 knob, round 5 experiment) and removed with evidence: it
    # down-weights true inliers while the alignment is still converging —
    # fr3/walking_halfsphere full-sequence ATE 0.5370 -> 0.6216 m and
    # window 0.1297 -> 0.2963 m at delta=0.05 (artifacts/exp3_cues.log).
    # The reference's binary gates (dense_registration_kernels.cuh:232-234)
    # are the right robustifier here.


@dataclass(frozen=True)
class FusionConfig:
    """Model fusion/maintenance (reference: `supersurfel_fusion.cu:350-483`
    and `supersurfel_fusion_kernels.cu:522-682, 397-467`)."""

    # Capacity bound. The reference launches with 50k-100k
    # (`launch/*.launch`); its stale/free-space eviction (delta_t=20) keeps
    # the realised fill of TUM-class scenes at a few thousand surfels, so
    # 65536 gives >10x headroom while halving per-frame maintenance work.
    nb_supersurfels_max: int = 1 << 16
    # static prefix bound on the per-frame *active* (visible) set: compaction
    # sorts active surfels first, so ICP and projective association only ever
    # read the first `visible_cap` slots instead of the full capacity —
    # 4-8x less gather/matmul work with identical results while
    # nb_visible <= visible_cap (measured fr1/xyz peak: ~1.7k).
    visible_cap: int = 16384
    delta_t: int = 20
    conf_thresh_scale: float = 10.0
    range_min: float = 0.2
    range_max: float = 5.0
    # match gates (findBestMatches, supersurfel_fusion_kernels.cu:586)
    match_max_color_dist: float = 15.0
    match_min_normal_dot: float = 0.8
    match_max_dist: float = 0.05
    # free-space violation: remove model surfel if p.z < 0.8 * observed depth
    # (filterModel, supersurfel_fusion_kernels.cu:449)
    free_space_ratio: float = 0.8
    # Deviation from the reference (which fuses every frame,
    # supersurfel_fusion.cu:373-420): when dense ICP is gate-rejected the
    # pose is VO-only and may be drifting — the round-5 fr3 anatomy
    # (artifacts/ANALYSIS_r5.md §5) measured 40-106 surfels/frame inserted
    # from drifting poses during mover occlusion, permanently displacing the
    # map. With this flag the model update is skipped on ICP-invalid frames
    # (bootstrap is unaffected). MEASURED AND REJECTED (exp12,
    # artifacts/ANALYSIS_r5.md §10): freezing visibility maintenance goes
    # into a stale-ICP-target death spiral (icp_valid 71.5 -> 1.5%). Kept
    # as the documented experiment record; default must stay False.
    freeze_on_tracking_loss: bool = False
    # The corrected granularity: skip only the INSERT step on ICP-invalid
    # frames while fusion / visibility / filtering stay live (ops/fusion.py
    # update_model allow_insert). Flag-gated pending the measured A/B
    # (tools/ate_exp.py --insert-gate).
    insert_requires_icp: bool = False


@dataclass(frozen=True)
class GenerationConfig:
    """Supersurfel generation gates (computeSupersurfels,
    `supersurfel_fusion_kernels.cu:169-224`)."""

    min_pixels: float = 100.0
    max_elongation: float = 50.0


@dataclass(frozen=True)
class VOConfig:
    """Sparse visual odometry front-end (reference: `SparseVO`,
    `core/src/sparse_vo.cpp`, `pnp_solver.cpp:37-38`, `local_map.cpp`)."""

    nb_features: int = 500
    scale_factor: float = 1.2
    nb_levels: int = 8
    ini_th_fast: int = 15
    min_th_fast: int = 5
    untracked_threshold: int = 10
    nb_passes: int = 2
    nb_gn_iters: int = 5
    chi2_threshold: float = 5.991
    min_matches: int = 20
    min_inlier_ratio: float = 0.2
    max_translation_jump: float = 0.5
    match_max_px_dist: float = 100.0
    local_map_capacity: int = 2048
    # Detection NMS cell (px) for the per-cell argmax keypoint spread.
    # 32 is the round-3 fr1-parity value; 16 quadruples the candidate cells
    # (denser detections) which helped the fr3 dynamic window but knocked
    # 7.4% of fr1 frames out of the ICP gates (round-4 verdict table) —
    # so it is a per-sequence profile knob, not a global constant.
    detect_cell: int = 32
    # rank keypoints inside/across cells by Harris response instead of the
    # FAST arc score (ORB_HARRIS_SCORE, `ORBextractor.cpp` keeps
    # best-Harris corners). Costs one Harris pass per pyramid level.
    harris_rank: bool = True


@dataclass(frozen=True)
class MODConfig:
    """Moving object detection (reference: `MotionDetection`,
    `core/src/motion_detection.cu`)."""

    enabled: bool = False
    # combined person-detector + clustering path (detectMotionCombined,
    # motion_detection.cu:680-1121). Requires `weights_path` to point at an
    # .npz checkpoint for models/person_detector.py; with no weights the
    # simple geometric+flow path runs (same graceful fallback as the
    # reference, whose darknet weights blob is likewise absent).
    use_yolo: bool = False
    weights_path: str = ""
    person_depth_gate: float = 0.3    # flood-fill depth window (m)
    person_score_thresh: float = 0.3
    max_person_boxes: int = 8
    convexity_thresh: float = 0.2     # motion_detection.cu:219-226
    cc_iters: int = 64                # label-propagation iterations
    # adaptive flow-threshold base: 2.5 px on the simple path
    # (motion_detection.cu:552), 4.0 px on the combined person path (:1055)
    flow_thresh_simple: float = 2.5
    flow_thresh_combined: float = 4.0
    # Per-cluster DEPTH-residual cue: |warp(prev_depth) - surfel z| at the
    # superpixel centroid, cluster-averaged, against a Kinect-noise-model
    # threshold scale*(0.0012 + 0.0019 (z-0.4)^2). The reference computes
    # exactly this but ships it disabled (motion_detection.cu:566-571, the
    # commented `|| clusters_depth_diff > depth_thresh` at :571/:1057 with
    # scales 12/20); we enable it because 2D residual flow alone misses
    # slow/low-texture movers (measured fr3 w126: 0.170 m vs ref 0.054 m)
    # while metre-scale depth residuals against the slanted-plane depth are
    # unambiguous. Set 0 to disable (strict reference behaviour).
    depth_cue_scale_simple: float = 12.0
    depth_cue_scale_combined: float = 20.0
    # Direct per-superpixel depth-residual marking with hysteresis (ours; no
    # reference equivalent). The geometric clustering fragments moving
    # people (motion blur + cloth break the convexity edges), so the
    # reference's cluster-mean statistics dilute or drop the strongest
    # evidence — measured on fr3/walking_halfsphere f55-100: 50-240
    # superpixels/frame with mean newly-closer residual > 0.15 m, only
    # ~half inside any cluster. Superpixels above resid_hot_thresh are
    # marked dynamic outright and expanded Canny-style over the adjacency
    # into neighbours above resid_low_thresh. Only the POSITIVE (newly-
    # closer) residual marks: negative residual is background the mover
    # just revealed, which is static.
    resid_direct: bool = True
    resid_hot_thresh: float = 0.2
    resid_low_thresh: float = 0.06
    resid_hyst_iters: int = 8
    # Temporal persistence of the dynamic mask ("heat", ours; no reference
    # equivalent needed: the reference's COCO-pretrained tiny-YOLOv4
    # (motion_detection.cu:156-178) keeps PAUSED walkers excluded because a
    # person is a person whether or not they currently move, while every
    # motion cue above goes quiet the moment a walker pauses — measured on
    # fr3/walking_halfsphere, the w126 drift event is mover surface marked
    # static at exactly such frames (artifacts/ANALYSIS_r5.md §5). Heat is a
    # per-superpixel-cell scalar, carried across frames by warping with the
    # inverse camera-motion similarity and decaying by heat_decay; cells
    # above heat_thresh stay dynamic (~ log(thresh)/log(decay) frames of
    # persistence after the last fresh evidence).
    temporal_heat: bool = False
    heat_decay: float = 0.85
    heat_thresh: float = 0.3


@dataclass(frozen=True)
class FernsConfig:
    """Randomized ferns loop-closure detector (reference: `Ferns`,
    `core/src/ferns.cu:45-195`)."""

    enabled: bool = False
    nb_ferns: int = 500
    pyramid_level: int = 4            # 640x480 -> 40x30
    new_frame_thresh: float = 0.3095
    max_keyframes: int = 512
    min_frame_gap: int = 100


@dataclass(frozen=True)
class PipelineConfig:
    cam: CameraIntrinsics = dataclasses.field(default_factory=CameraIntrinsics.tum_fr1)
    tps: TPSConfig = dataclasses.field(default_factory=TPSConfig)
    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    generation: GenerationConfig = dataclasses.field(default_factory=GenerationConfig)
    vo: VOConfig = dataclasses.field(default_factory=VOConfig)
    mod: MODConfig = dataclasses.field(default_factory=MODConfig)
    ferns: FernsConfig = dataclasses.field(default_factory=FernsConfig)
    enable_loop_closure: bool = False
    enable_sparse_vo: bool = True
    enable_icp: bool = True
    # trajectory ring capacity: per-frame poses are written into ONE
    # preallocated (max_frames, 12) device buffer inside the donated state
    # and materialized once post-run. Retaining a separate device buffer per
    # frame instead makes per-dispatch cost grow with the live-buffer count
    # on remote backends (measured fr3+MOD: 36.7 -> 9.6 fps over 300 frames
    # retained vs ~64 fps steady with this buffer). The reference streams
    # poses to disk per frame (rgbd_benchmark_node.cpp:727-729).
    max_frames: int = 2048
    depth_scale: float = 1.0 / 5000.0  # TUM 16-bit PNG -> metres
    # bilateral depth prefilter (reference uses sigma_value=0.03,
    # sigma_space=4.5, supersurfel_fusion.cu:180)
    bilateral_sigma_value: float = 0.03
    bilateral_sigma_space: float = 4.5
    bilateral_radius: int = 6

    @property
    def grid_w(self) -> int:
        return (self.cam.width + self.tps.cell_size - 1) // self.tps.cell_size

    @property
    def grid_h(self) -> int:
        return (self.cam.height + self.tps.cell_size - 1) // self.tps.cell_size

    @property
    def nb_superpixels(self) -> int:
        return self.grid_w * self.grid_h

    @property
    def conf_thresh(self) -> float:
        # supersurfel_fusion_node.cpp:254
        return self.tps.cell_size**2 * self.fusion.conf_thresh_scale
