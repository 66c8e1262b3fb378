"""Typed configuration for the PyTorch port of the registration pipeline.

The same knobs, names and defaults as `kss_icp_tpu/config.py` (which needs
jax to import), kept as the port's own frozen dataclass so that the port
imports on a machine without jax. tests/test_torch_import.py pins the two
field lists and defaults to each other.

Knobs that only pick a TPU backend or a matmul precision are accepted and
ignored, because the port computes every distance in exact float32:
`fps_backend`, `icp_nn_backend`, `refine_nn_backend`, `coarse_backend`,
`rotation_chunk`, `nn_query_chunk`, `screen_precision` and `icp_precision`.
(The plain versions bound their memory by chunking the query axis on their
own, ops/nn.py.) `coarse_method` picks the field kernel ("vpu": `field_ave`,
exact differences; "dot": `field_dot`, the augmented dot product) and
`coarse_precision` the dot's precision, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class KSSICPConfig:
    """All pipeline knobs (see kss_icp_tpu/config.py for each one's history)."""

    # Rotation-grid coarse search (initRegistrationKSS.hpp:35,245-252).
    rotation_steps: int = 8
    angle_span: float = 6.3
    kernel_radius: int = 2
    max_candidates: int = 32
    coarse_error_metric: str = "ave"

    # Resampling (KSS_ICP.hpp:57-66).
    max_resample_points: int = 2000
    resample_pad: int = 2048
    fps_backend: str = "auto"
    resampler: str = "fps"
    aivs_boxes_per_axis: int = 0
    aivs_max_rounds: int = 128
    aivs_max_cuts: int = 256

    # ICP refinement (KSS_ICP.hpp:156-159, Main_KSS_ICP.cpp:81).
    max_icp_iterations: int = 1000
    max_correspondence_distance: float = 1.0
    transformation_epsilon: float = 1e-10
    rotation_epsilon: float = 1e-10
    euclidean_fitness_epsilon: float = 0.001
    fitness_epsilon_mode: str = "relative"
    multistart_fitness_gate: float = 0.0005

    # Two-phase multi-start and two-tier refine.
    multistart_mode: str = "two_phase"
    screen_iterations: int = 20
    screen_points: int = 512
    refine_candidates: int = 4
    refine_tier_iterations: int = 0
    refine_tier_target_points: int = 0
    refine_max_iterations: int = 0
    refine_polish_iterations: int = 0
    screen_precision: str = "high"
    icp_precision: str = "high"
    icp_variant: str = "point_to_point"
    icp_nn_backend: str = "auto"
    refine_nn_backend: str = "auto"

    # Auto-escalation.
    auto_escalate: bool = True
    escalate_threshold: float = 1.55e-3
    overlap_threshold: float = 1.55e-3
    escalate_rotation_steps: int = 16
    escalate_max_candidates: int = 16
    escalate_coarse_points: int = 512
    escalate_coarse_target_points: int = 512
    escalate_screen_target_points: int = 0
    escalate_refine_tier_iterations: int = 0
    escalate_pad: int = 8

    # Overlap-robust mode.
    overlap_mode: bool = False
    overlap_trim_fraction: float = 0.7
    overlap_iterations: int = 3
    icp_trim_fraction: float = 0.0
    coarse_trim_fraction: float = 0.7
    icp_estimate_scale: bool = False
    overlap_escalate: bool = True
    overlap_adopt_margin: float = 0.7
    overlap_screen_rung: bool = True
    overlap_screen_steps: int = 8
    overlap_screen_iters: int = 8
    overlap_screen_topk: int = 3
    overlap_screen_batch: int = 16
    overlap_gate_ratio: float = 1.05

    # Winner-neighborhood polish and symmetric-pose tie-break.
    neighborhood_fracs: tuple = ()
    pose_tiebreak_margin: float = 0.0
    pose_tiebreak_quantile: float = 0.95
    escalate_pose_tiebreak: float = 0.12

    # Numerics and memory.
    dtype: str = "float32"
    rotation_chunk: int = 64
    coarse_precision: str = "high"
    coarse_backend: str = "auto"
    coarse_method: str = "vpu"
    coarse_points: int = 0
    coarse_target_points: int = 0
    screen_target_points: int = 0
    nn_query_chunk: int = 4096

    @property
    def num_rotations(self) -> int:
        return self.rotation_steps ** 3

    def resample_count(self, n_source: int, n_target: int) -> int:
        """Working point count: min(|S|,|T|)//2 clamped (KSS_ICP.hpp:57-66)."""
        n = min(n_source, n_target) // 2
        return max(1, min(n, self.max_resample_points))

    def padded_size(self, n: int, multiple: int = 256) -> int:
        return _round_up(max(n, multiple), multiple)

    def overlap_config(self) -> "KSSICPConfig":
        """The overlap-robust solve config: trimmed field and ICP, every
        ranking-only shortcut off, rotation grid unchanged."""
        return dataclasses.replace(
            self,
            overlap_mode=True,
            coarse_error_metric="trim",
            coarse_trim_fraction=self.overlap_trim_fraction,
            icp_trim_fraction=self.overlap_trim_fraction,
            icp_estimate_scale=True,
            coarse_points=0,
            coarse_target_points=0,
            screen_target_points=0,
            refine_tier_iterations=0,
            refine_tier_target_points=0,
            refine_max_iterations=0,
            refine_polish_iterations=0,
            auto_escalate=False,
            rotation_chunk=min(self.rotation_chunk, 16),
        )

    def escalation_config(self) -> "KSSICPConfig":
        """The finer-grid config of the fitness-flagged second pass."""
        return dataclasses.replace(
            self,
            rotation_steps=self.escalate_rotation_steps,
            max_candidates=self.escalate_max_candidates,
            refine_candidates=max(self.refine_candidates, 3),
            pose_tiebreak_margin=self.escalate_pose_tiebreak,
            coarse_points=self.escalate_coarse_points,
            coarse_target_points=self.escalate_coarse_target_points,
            screen_target_points=self.escalate_screen_target_points,
            refine_tier_iterations=self.escalate_refine_tier_iterations,
            refine_tier_target_points=0,
            refine_max_iterations=64,
            refine_polish_iterations=0,
            auto_escalate=False,
        )


DEFAULT_CONFIG = KSSICPConfig()


def from_reference(cfg_or_dict: Any) -> KSSICPConfig:
    """The port's config from a JAX `KSSICPConfig` or its `dataclasses.asdict`.

    Raises TypeError on a field the port does not know, so a knob added to
    the reference cannot be dropped silently."""
    if dataclasses.is_dataclass(cfg_or_dict) and not isinstance(cfg_or_dict, type):
        cfg_or_dict = dataclasses.asdict(cfg_or_dict)
    if not isinstance(cfg_or_dict, Mapping):
        raise TypeError(f"expected a config dataclass or a mapping, got {type(cfg_or_dict)!r}")
    return KSSICPConfig(**cfg_or_dict)
