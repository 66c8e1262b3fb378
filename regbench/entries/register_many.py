"""Entry: `kss_icp_torch.parallel.batch.register_many`, one call a batch of
pairs: resample, pre-shape and coarse field, screen and refine ICP, the
two-stage converge, the escalation ladder with its overlap tier, then every
transform applied to its full-resolution source and measured (one `nn1`
launch). Answers come back to the host as numpy.
"""

from __future__ import annotations

import dataclasses

from regbench.entries import Answer


def prepare(config, mix, device):
    """The call (pairs, timer) -> [Answer] at the configuration's settings."""
    from kss_icp_torch.config import KSSICPConfig
    from kss_icp_torch.parallel import batch

    cfg = dataclasses.replace(KSSICPConfig(), **config["kss_config"])
    full_pad = config["full_pad"]

    def call(pairs, timer):
        res, m = batch.register_many([(p.src, p.tgt) for p in pairs], cfg, full_pad=full_pad, device=device,
                                     timer=timer)
        tr = res.transform
        scale, rot, trans = (x.cpu().numpy() for x in (tr.scale, tr.rotation, tr.translation))
        return [Answer(float(scale[b]), rot[b], trans[b], float(m["rmse"][b]), float(m["mae"][b]))
                for b in range(len(pairs))]

    return call


def metric_rows(config, pair):
    """The valid rows of the pair's metric: the source's and the target's
    points, as many as the full-resolution pad holds."""
    return min(len(pair.src), config["full_pad"]), min(len(pair.tgt), config["full_pad"])

