"""Visualization stack (port of kss_icp_tpu/viz; numpy only, headless): SGI-style quaternion trackball +
z-buffer point-splat PNG renderer — the capability surface of the
reference's View.h / trackball.{h,cpp} / GLM draw path without a GL
context."""

from kss_icp_torch.viz.render import (
    render_clouds,
    render_registration,
    write_png,
)
from kss_icp_torch.viz.trackball import (
    Trackball,
    add_quaternions,
    axis_angle_quaternion,
    drag_quaternion,
    quaternion_matrix,
)

__all__ = [
    "render_clouds",
    "render_registration",
    "write_png",
    "Trackball",
    "add_quaternions",
    "axis_angle_quaternion",
    "drag_quaternion",
    "quaternion_matrix",
]
