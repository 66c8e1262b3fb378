"""Small versions of the cells, for the CPU tests: the same files, the same
code paths, sizes and settings a test run can hold."""

from __future__ import annotations

from regbench import harness

# A registration config small enough for the plain CPU versions of the kernels.
SMALL_KSS = dict(rotation_steps=6, max_candidates=8, max_resample_points=256, resample_pad=256, max_icp_iterations=30,
                 rotation_chunk=16, screen_points=64, refine_candidates=2, escalate_rotation_steps=5,
                 escalate_max_candidates=5, escalate_coarse_points=64, escalate_coarse_target_points=64,
                 overlap_screen_steps=4, overlap_screen_iters=4, overlap_iterations=2)


def small_spec(workload: str, bench=None) -> dict:
    """load_cell(workload) cut to a few small pairs a call."""
    spec = harness.load_cell(workload, bench)
    spec["config"]["kss_config"] = dict(SMALL_KSS)
    mix = spec["mix"]
    if mix["source"] == "partial":
        mix.update(batch=8, calls=2, points=600, trace_calls=1)
        spec["config"]["full_pad"] = 1024
    elif mix["source"] == "remesh":
        mix.update(batch=4, calls=2, trace_calls=1)
        # The cut settings miss the bar on more of these hard poses than the
        # shipped ones do (a sound run reads 0 of the window's pairs and 1 of
        # the 4 fresh ones at the tests' seed); the faults read 0.5-0.75.
        mix["limits"].update(over_bar=0.2, fresh_over_bar=0.4)
    else:
        mix.update(calls=2, warm_calls=1, trace_calls=2, check_calls=2, fresh_calls=2)
        spec["config"].update(points=12000, pre_downsample=3000)
    return spec
