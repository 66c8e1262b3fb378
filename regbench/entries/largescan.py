"""Entry: the large-scan protocol of kss_icp_torch/largescan.py, one scan
pair a call, through the program's own parts in run_largescan's order (the
program has no function that takes the scans as arrays):

  ingest normalization into the unit cube by the target's centre and largest
  extent, on the host in float32, padded to a multiple of 4096 rows;
  "octree": octree_simplify of both scans to about the configuration's
  pre-downsample count, and compaction of the survivors;
  "resample": resample_pairs, one `fps` launch over both clouds;
  "register": register_resampled, solved once more at escalation_config()
  where its fitness is above escalate_threshold, the lower fitness kept;
  "metric": apply_similarity to the full-resolution source and
  registration_measure_padded against the full-resolution target.

The spans are the benchmark's own, around those calls. The answers' metric is
in the unit cube.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from regbench.entries import Answer, stage


def _padded(pts: np.ndarray, pad: int):
    out = np.zeros((pad, 3), np.float32)
    out[:len(pts)] = pts
    mask = np.zeros((pad,), bool)
    mask[:len(pts)] = True
    return out, mask


def prepare(config, mix, device):
    import torch

    from kss_icp_torch import largescan, metrics
    from kss_icp_torch.config import KSSICPConfig
    from kss_icp_torch.core import transforms
    from kss_icp_torch.models import kss_icp
    from kss_icp_torch.ops import simplify

    cfg = dataclasses.replace(KSSICPConfig(), **config["kss_config"])
    pre, quantum = config["pre_downsample"], config["pad_multiple"]

    def one(p, timer):
        center = p.tgt.mean(axis=0)
        nscale = float(np.abs(p.tgt - center).max())
        pad = -(-max(len(p.src), len(p.tgt)) // quantum) * quantum
        (sp, sm), (tp, tm) = (tuple(torch.as_tensor(x).to(device) for x in
                                    _padded(((c - center) / nscale).astype(np.float32), pad)) for c in (p.src, p.tgt))
        with stage(timer, "octree"):
            s_ds, skeep = simplify.octree_simplify(sp, sm, pre)
            t_ds, tkeep = simplify.octree_simplify(tp, tm, pre)
            n_s, n_t = int(skeep.sum()), int(tkeep.sum())
            ds_pad = largescan.compacted_pad(n_s, n_t)
            s_c, sk_c = largescan.compact(s_ds, skeep, ds_pad)
            t_c, tk_c = largescan.compact(t_ds, tkeep, ds_pad)
        pnumber = cfg.resample_count(n_s, n_t)
        with stage(timer, "resample"):
            (rs, rsm), (rt, rtm) = kss_icp.resample_pairs(s_c[None], sk_c[None], t_c[None], tk_c[None],
                                                          torch.tensor([pnumber], device=device), cfg, steps=pnumber)
        with stage(timer, "register"):
            res = kss_icp.register_resampled(rs[0], rsm[0], rt[0], rtm[0], cfg)
            if cfg.auto_escalate and float(res.fitness) > cfg.escalate_threshold:
                res2 = kss_icp.register_resampled(rs[0], rsm[0], rt[0], rtm[0], cfg.escalation_config())
                if float(res2.fitness) < float(res.fitness):
                    res = res2
        with stage(timer, "metric"):
            aligned = transforms.apply_similarity(res.transform, sp)
            m = metrics.registration_measure_padded(aligned, sm, tp, tm)
            rmse, mae = float(m["rmse"]), float(m["mae"])
        tr = res.transform
        return Answer(float(tr.scale), tr.rotation.cpu().numpy(), tr.translation.cpu().numpy(), rmse, mae)

    return lambda pairs, timer: [one(p, timer) for p in pairs]


def metric_rows(config, pair):
    return len(pair.src), len(pair.tgt)

