"""NCCL kernels a call that rank 0 launched inside "kss.mesh.gather": the
collectives of a register_many call's result, one all_gather a tensor leaf.
None without mesh spans or without NCCL kernels (a run on the CPU)."""

from regbench.mesh_spans import nccl_in_gathers


def read(ctx):
    found = nccl_in_gathers(ctx)
    if found is None:
        return None
    kernels, calls = found
    return len(kernels) / calls
