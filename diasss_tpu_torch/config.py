"""Typed configuration tree of the pipeline — the port's own copy of
:mod:`diasss_tpu.config`.

Every dataclass, field and default is the JAX package's (a test holds the two
field by field); the field comments there carry the measurements behind each
default.  Here they say what each field selects and which port module reads
it.  Options whose code is not ported yet raise ``NotImplementedError`` naming
their ROADMAP item where the pipeline reaches them.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """ORB-style detector parameters (frame.cpp:180; ORBextractor ctor)."""

    n_features: int = 2000  # frame.cpp:180
    scale_factor: float = 1.2  # frame.cpp:180
    n_levels: int = 6  # frame.cpp:180
    ini_fast_threshold: int = 12  # frame.cpp:180
    min_fast_threshold: int = 7  # frame.cpp:180
    cell_size: int = 30  # ORBextractor.cpp:784 (grid cell width ~30 px)
    edge_threshold: int = 19  # ORBextractor.h EDGE_THRESHOLD used for borders
    blur_ksize: int = 13  # GaussianBlur 13x13 (ORBextractor.cpp:1092)
    blur_sigma: float = 2.0  # ORBextractor.cpp:1092
    # "sift" = the reference's live path (128-d float); "orb" = binary
    # steered BRIEF; "geo_patch" = world-aligned NCC patches.  With the dense
    # matcher, geo_patch keypoints carry a (K, 1) zero descriptor and the
    # patches come from the world raster (matching/dense.py).
    descriptor: str = "sift"
    geopatch_half: int = 8  # patch half-extent in world grid cells
    geopatch_res: float = 0.5  # world grid resolution (m)
    # Descriptor window multiplier: 1.0 = reference parity (kp.size = 31 *
    # scale^level, ORBextractor.cpp:847); < 1 shrinks the SIFT window.
    desc_size_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Filter-mask parameters (frame.cpp:83-124)."""

    bright_factor: float = 2.5  # kill pixels > 2.5 * mean (frame.cpp:86,98)
    bright_radius: int = 6  # +-6 px box suppression (frame.cpp:86)
    center_width: int = 10  # +-10 cols around nadir (frame.cpp:86,105)
    side_pings: int = 150  # first/last pings removed (frame.cpp:86,108)
    side_cols_frac: float = 0.6  # side * 0.6 = 90 left/right cols (frame.cpp:111)


@dataclasses.dataclass(frozen=True)
class NormalizeConfig:
    """Image normalization (frame.cpp:57-81)."""

    mean_factor: float = 2.5  # max_used = mean * 2.5 (frame.cpp:59-63)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Robust matcher parameters (FEAmatcher.cpp)."""

    # "kp" = reference-parity keypoint-to-keypoint search (geosearch.py);
    # "dense" = dense world-correlation search (dense.py)
    mode: str = "kp"
    dense: "DenseMatchConfig" = dataclasses.field(
        default_factory=lambda: DenseMatchConfig()
    )
    geo_radius: float = 8.0  # geo search radius in meters (FEAmatcher.cpp:67)
    sift_dist_bound: float = 350.0  # L2 descriptor bound (FEAmatcher.cpp:108)
    ratio_test: float = 0.35  # first/second NN ratio (FEAmatcher.cpp:110)
    # "l2" (SIFT) | "hamming" (ORB) | "ncc" (geo-patch descriptors)
    desc_metric: str = "l2"
    ncc_min: float = 0.35  # minimum NCC to accept (ncc metric only)
    ncc_ratio: float = 1.0  # first/second ratio on (1 - ncc); 1.0 disables
    orb_dist_bound: float = 88.0  # Hamming bound (FEAmatcher.cpp:143)
    orb_dist_bound_cross: float = 80.0  # opposite-parity bound (FEAmatcher.cpp:145)
    scc_max_iters: int = 1000  # RANSAC hypotheses (FEAmatcher.cpp:189)
    scc_samples: int = 2  # samples per hypothesis (FEAmatcher.cpp:189)
    scc_pix_error: float = 2.5  # inlier tolerance in pings (FEAmatcher.cpp:190)
    # "x" = the reference's single-axis check; "xy" = its disabled two-axis
    # variant (FEAmatcher.cpp:250-317), needed for crossing-line pairs
    scc_mode: str = "x"
    scc_pix_error_y: float = 15.0  # FEAmatcher.cpp:255
    consistency_thres: float = 2.5  # cross-direction model gap (FEAmatcher.cpp:329)
    rng_seed: int = 1  # cv::setRNGSeed(1) (FEAmatcher.cpp:60)
    # mutual nearest-neighbour cross-check (FEAmatcher.cpp:407-422, disabled
    # in the reference)
    cross_check: bool = False
    # > 0: the ratio test's second-best candidate must lie at least this many
    # meters from the best one
    ratio_excl_radius: float = 0.0
    # multi-device ring-pass NN search threshold (not ported: ROADMAP A14)
    ring_min_kps: int = 4096


@dataclasses.dataclass(frozen=True)
class DenseMatchConfig:
    """Dense world-correlation matcher (matching/dense.py): a sliding NCC
    search of each source geo-patch over the target frame's world raster.
    Select with ``MatcherConfig.mode="dense"``."""

    search_radius: float = 10.0  # candidate offsets within this many meters
    step_cells: int = 2  # candidate stride in raster cells
    ncc_min: float = 0.35  # minimum correlation to accept
    ncc_ratio: float = 1.0  # (1-best) <= ratio * (1-second); 1.0 disables
    min_cover: float = 0.6  # fraction of patch cells with raster data
    # local displacement-field consistency filter
    smooth_radius: float = 20.0  # neighborhood radius (m)
    smooth_min_neighbors: int = 2
    smooth_tol: float = 1.5  # max deviation from the local median (m)


@dataclasses.dataclass(frozen=True)
class KeypointNoiseConfig:
    """Sonar measurement noise (optimizer.cpp:685)."""

    sigma_r: float = 0.1  # range sigma (m)
    alpha_bw_deg: float = 0.1  # beam-width angular sigma (deg), scaled by range


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """Per-correspondence mini-graph solve (optimizer.cpp:641-982)."""

    nadir_threshold: int = 20  # discard kps near nadir (optimizer.cpp:602)
    compass_flip_yaw: float = 2.0 * math.pi / 3.0  # optimizer.cpp:700-703
    prior_sigma: float = 1e-6  # source-pose prior (optimizer.cpp:773)
    odo_sigma_ro_deg: float = 0.1  # optimizer.cpp:778
    odo_sigma_pi_deg: float = 0.1
    odo_sigma_ya_deg: float = 0.5
    odo_x_scale: float = 2.0  # x sigma = 2 * |dx|
    odo_y_scale: float = 0.1  # y sigma = |dy| / 10
    odo_sigma_z: float = 0.1
    quality_threshold: float = 2.0  # accept if ini/fnl dist ratio > 2 (opt.cpp:884,896)
    max_lm_iters: int = 40
    tria_xy_sigma: float = 10.0  # point-prior xy sigma (optimizer.cpp:1006)
    tria_z_baseline_div: float = 100.0  # z sigma = baseline / 100 (optimizer.cpp:1005)


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Global trajectory optimization (optimizer.cpp:21-317)."""

    # odometry noise (optimizer.cpp:24-28): wgt1_=0.001, wgt_2=10
    odo_sigma_ro_deg: float = 0.001
    odo_sigma_pi_deg: float = 0.001
    odo_sigma_ya_deg: float = 0.001 * 10 * 0.1  # ya1_ = 0.1*wgt1_*wgt_2 deg
    odo_sigma_x: float = 0.01  # wgt1_*wgt_2
    odo_sigma_y: float = 0.01
    odo_sigma_z: float = 0.001
    prior_sigma: float = 1e-6  # first-ping prior (optimizer.cpp:166)
    init_noise_xyz: float = 0.5  # injected initial-value noise (optimizer.cpp:24,32)
    init_noise_rpy_deg: float = 0.5
    use_anno: bool = True  # USE_ANNO (optimizer.cpp:26)
    add_loop_closures: bool = True  # ADD_LC (optimizer.cpp:26)
    max_gn_iters: int = 30  # outer LM iterations of the batch solver
    cg_tol: float = 1e-6
    cg_max_iters: int = 250
    # Linear solve per LM trial.  The port runs "direct" (the exact damped
    # step: multi-RHS chain cyclic reduction + Woodbury over the loop-closure
    # columns) and resolves "auto" to it on every device; the PCG family
    # ("jacobi", "tridiag", "dense_seg", "chain") is ROADMAP A7.
    preconditioner: str = "auto"
    # damping sweep of the direct step; the port runs only (1.0,)
    lam_sweep_factors: tuple = (1.0,)
    # coarse-to-fine initialization stride; 0/1 = off
    coarse_init_stride: int = 0
    tridiag_segment: int = 256  # segment length of the segment-parallel solve
    seed: int = 0  # initial-noise PRNG seed
    # exact per-pose marginals of the global two-stage solve (ROADMAP A9)
    marginals: bool = False


@dataclasses.dataclass(frozen=True)
class FullBAConfig:
    """Joint pose+landmark bundle adjustment (solvers/full_ba.py).  Landmark
    priors are the flat-floor depth regularization; xy is nearly free."""

    lm_prior_xy_sigma: float = 50.0
    lm_prior_z_sigma: float = 1.5
    # correspondences whose two DR geo projections disagree by more than this
    # (meters) are dropped at problem build; 0 = off
    max_geo_discrepancy: float = 0.0
    # Huber robust loss on the whitened sonar residual norm (0 disables)
    huber_delta: float = 3.0
    max_iters: int = 40
    cg_tol: float = 1e-6
    cg_max_iters: int = 250
    # Linear solve per LM trial: "direct" (multi-RHS chain cyclic reduction +
    # Woodbury over 3 landmark-coupling columns per correspondence) is what
    # the port runs, and "auto" resolves to it under the size guard of
    # full_ba.resolve_ba_solver_kind; the PCG family is ROADMAP A7.
    preconditioner: str = "auto"
    tridiag_segment: int = 256
    # exact per-pose marginals at the solution (ROADMAP A9)
    marginals: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    min_overlap: float = 0.4  # pair gate (diasss2.cpp:28)
    # "two_stage" = reference-parity estimation (per-correspondence LC solves +
    # pose graph); "full_ba" = joint pose+landmark bundle adjustment
    estimator: str = "two_stage"
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    mask: MaskConfig = dataclasses.field(default_factory=MaskConfig)
    normalize: NormalizeConfig = dataclasses.field(default_factory=NormalizeConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    kp_noise: KeypointNoiseConfig = dataclasses.field(default_factory=KeypointNoiseConfig)
    loop_closure: LoopClosureConfig = dataclasses.field(default_factory=LoopClosureConfig)
    pose_graph: PoseGraphConfig = dataclasses.field(default_factory=PoseGraphConfig)
    full_ba: FullBAConfig = dataclasses.field(default_factory=FullBAConfig)
    # Drift-compensated re-matching (detected path only): after each solve
    # the frames' geo images are recomputed from the estimated poses and
    # matching re-runs with a tighter gate, warm-started.
    rematch_iters: int = 0
    rematch_geo_radius: float = 3.0  # tighter gate once drift is compensated
    rematch_geo_discrepancy: float = 2.0  # full-BA gate on re-iterations
    # adaptive re-match extent: next radius = q95 residual * margin + 2 cells,
    # bucketed and capped at rematch_geo_radius (pipeline._rematch_plan)
    rematch_adaptive: bool = True
    rematch_margin: float = 1.5
    # stop re-matching once the residual q95 is at this many raster cells
    # (both match endpoints are cell centers: the quantization floor)
    rematch_stop_resid_cells: float = 2.0
    # multi-device solves and matching (ROADMAP A14)
    mesh_devices: int | None = None


DEFAULT = PipelineConfig()


def pair_mode_config() -> PipelineConfig:
    """The pairwise-variant constants of ``Optimizer::TrajOptimizationPair``
    (optimizer.cpp:321-334): USE_ANNO=0, looser odometry noise
    (0.01deg/0.05deg, 0.05 m xy, 0.01 m z) and 5 m / 5 deg injected initial
    noise."""
    return PipelineConfig(
        pose_graph=PoseGraphConfig(
            odo_sigma_ro_deg=0.01,
            odo_sigma_pi_deg=0.01,
            odo_sigma_ya_deg=0.05,
            odo_sigma_x=0.05,
            odo_sigma_y=0.05,
            odo_sigma_z=0.01,
            init_noise_xyz=5.0,
            init_noise_rpy_deg=5.0,
            use_anno=False,
        )
    )


def detected_config(cfg: PipelineConfig, descriptor: str = "sift") -> PipelineConfig:
    """``cfg`` with the CLI's ``--detected`` settings (``diasss_tpu/cli.py:118-134``)."""
    return dataclasses.replace(
        cfg,
        detector=DetectorConfig(descriptor=descriptor, desc_size_scale=8.0 / 31.0),
        matcher=MatcherConfig(ratio_excl_radius=2.0, ratio_test=0.6, sift_dist_bound=450.0,
                              cross_check=True, scc_mode="xy"),
        pose_graph=PoseGraphConfig(use_anno=False),
    )


def automatic_config(drift_budget: float = 4.0) -> PipelineConfig:
    """Fully automatic SLAM profile: no annotations.  Dense world-correlation
    matching of geo-patches, joint full-BA estimation with the DR
    geo-discrepancy gate, and drift-compensated re-matching.

    ``drift_budget``: largest credible DR drift between overlapping lines (m).
    It sets the first-pass geo-discrepancy gate and, through the search
    radius, how far the dense matcher looks.  A mission whose drift exceeds
    it shows up in the ``rematch_saturated_rounds`` counter."""
    return PipelineConfig(
        min_overlap=0.1,  # admit tie-line crossings (main-vs-tie IoU ~0.2)
        estimator="full_ba",
        detector=DetectorConfig(descriptor="geo_patch"),
        matcher=MatcherConfig(
            mode="dense",
            dense=DenseMatchConfig(search_radius=max(10.0, 1.5 * drift_budget)),
            # kp-mode fields kept sane in case the caller flips mode back
            desc_metric="ncc",
            geo_radius=10.0,
            cross_check=True,
            scc_mode="xy",
        ),
        pose_graph=PoseGraphConfig(use_anno=False),
        full_ba=FullBAConfig(max_geo_discrepancy=drift_budget),
        rematch_iters=2,
        rematch_geo_radius=6.0,
        rematch_geo_discrepancy=4.0,
    )
