"""Host milliseconds a call in rank 0's own slice of a register_many call
over the "pairs" mesh: the "kss.mesh.slice" spans of the sub-window traced
with the host (its resample, coarse field, ICP, ladder and metric), a
span's mean. None without mesh spans."""

from regbench.mesh_spans import SLICE, spans


def read(ctx):
    slices = spans(ctx, SLICE)
    return sum(z - a for a, z in slices) / 1e3 / len(slices) if slices else None
