from kss_icp_torch.parallel.batch import overlap_batch, register_batch, register_many

__all__ = ["overlap_batch", "register_batch", "register_many"]
