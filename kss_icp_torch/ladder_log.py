"""Recorders of the escalation ladder: which pairs escalated, won and were
finished, and which overlap rungs each pair reached, ran and adopted.

They wrap the functions of a module while entered, so they record either
package alike: `RungLog` the single-pair ladder of JAX's
`models/kss_icp.register_pair` (and of the port's, which offers the same
hooks), `LadderLog` every ladder that goes through the `escalate` module's
escalate_rerun, polish_rerun and overlap_rerun (both packages'
register_many, and the port's register_pair). chip_smoke.py,
scripts/torch_port_expected.py and the tests use them. numpy only.
"""

from __future__ import annotations

import numpy as np

RUNGS = ("overlap8", "overlap16", "overlap_screen")


class RungLog:
    """Records the overlap rungs that `module.register_pair` reaches, in
    either package (kss_icp_torch.models.kss_icp, or kss_icp_tpu's in the
    tests and scripts/torch_port_expected.py): a trimmed fitness computed
    outside the solvers opens a rung (the incumbent's tf_old), a solver call
    marks it run (tf_new); a rung is adopted when tf_new < margin x tf_old.
    Wraps the module's functions while entered; `rungs` is reset by the
    caller between pairs."""

    def __init__(self, module, margin: float):
        self.module, self.margin, self.depth, self.rungs = module, margin, 0, []
        self.orig = {n: getattr(module, n) for n in ("trimmed_fitness", "register_overlap_resampled",
                                                      "register_overlap_screen_resampled")}

    def __enter__(self):
        def fitness(*a, **kw):
            out = self.orig["trimmed_fitness"](*a, **kw)
            if not self.depth:
                self.rungs.append({"rung": RUNGS[len(self.rungs)], "tf_old": float(out), "skipped": True,
                                   "ran": False, "adopted": False, "tf_new": None})
            return out

        def solver(name):
            def run(*a, **kw):
                self.depth += 1
                try:
                    res = self.orig[name](*a, **kw)
                finally:
                    self.depth -= 1
                if self.rungs:  # overlap_mode=True calls the solver with no rung open
                    r = self.rungs[-1]
                    r.update(skipped=False, ran=True, tf_new=float(res.fitness))
                    r["adopted"] = r["tf_new"] < self.margin * r["tf_old"]
                return res
            return run

        self.module.trimmed_fitness = fitness
        for n in ("register_overlap_resampled", "register_overlap_screen_resampled"):
            setattr(self.module, n, solver(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)

    def outcomes(self) -> list:
        """'skipped', 'ran' or 'adopted' for each rung reached."""
        return [rung_state(r) for r in self.rungs]


class LadderLog:
    """Records the escalation ladder of one call over n pairs (register_many,
    or the port's register_pair with n=1), in either package's `escalate`
    module, by wrapping its escalate_rerun, polish_rerun and overlap_rerun
    while entered (the ladders look them up at call time). Per row:
    `continued` (the two-stage converge continued it: a polish_rerun before
    the ladder's first escalate_rerun), `escalated` (flagged for the 16^3
    re-solve), `won` (the re-solve kept), `finisher` (the uncapped finisher
    ran) and `rungs`, one entry per
    overlap rung the row reached (its fitness above the rung's threshold) in
    the RungLog format: skipped by the crop gate, run, adopted, with the
    trimmed fitnesses tf_old and tf_new of a rung that ran."""

    def __init__(self, escalate, n: int):
        self.escalate = escalate
        self.continued, self.escalated, self.won, self.finisher = (np.zeros(n, bool) for _ in range(4))
        self.rungs = [[] for _ in range(n)]
        self.in_polish, self.n_rungs, self.n_escalations = False, 0, 0
        self.orig = {k: getattr(escalate, k) for k in ("escalate_rerun", "polish_rerun", "overlap_rerun")}

    def __enter__(self):
        def rerun(resolve, fitness, threshold, pad_multiple, result=None, cap=None, chunk=None, flags=None, **kw):
            out = self.orig["escalate_rerun"](resolve, fitness, threshold, pad_multiple, result=result, cap=cap,
                                              chunk=chunk, flags=flags, **kw)
            if not self.in_polish:  # polish_rerun runs through escalate_rerun
                self.n_escalations += 1
                self.escalated |= np.asarray(flags, bool) if flags is not None else np.asarray(fitness) > threshold
                self.won[[gi for gi, _, _ in out[2]]] = True
            return out

        def polish(resolve, hit_cap, fitness, pad_multiple, result=None, cap=None, chunk=None):
            if self.n_escalations:
                self.finisher |= np.asarray(hit_cap, bool)
            else:
                self.continued |= np.asarray(hit_cap, bool)
            self.in_polish = True
            try:
                return self.orig["polish_rerun"](resolve, hit_cap, fitness, pad_multiple, result=result, cap=cap,
                                                 chunk=chunk)
            finally:
                self.in_polish = False

        def overlap(resolve, fitness, threshold, pad_multiple, margin, result=None, cap=None, chunk=None, flags=None):
            rung, seen = RUNGS[self.n_rungs], {}
            self.n_rungs += 1

            def resolve_seen(sel):
                out = resolve(sel)
                for j, gi in enumerate(np.asarray(sel)):
                    seen.setdefault(int(gi), (float(out[2][j]), float(out[3][j])))
                return out

            out = self.orig["overlap_rerun"](resolve_seen, fitness, threshold, pad_multiple, margin, result=result,
                                             cap=cap, chunk=chunk, flags=flags)
            adopted = {gi for gi, _, _ in out[2]}
            for gi in np.nonzero(np.asarray(fitness) > threshold)[0]:
                tf_new, tf_old = seen.get(int(gi), (None, None))
                self.rungs[gi].append({"rung": rung, "tf_old": tf_old, "skipped": int(gi) not in seen,
                                       "ran": int(gi) in seen, "adopted": int(gi) in adopted, "tf_new": tf_new})
            return out

        self.escalate.escalate_rerun, self.escalate.polish_rerun, self.escalate.overlap_rerun = rerun, polish, overlap
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.escalate, k, fn)


def rung_state(r: dict) -> str:
    return "adopted" if r["adopted"] else "ran" if r["ran"] else "skipped"


def rung_outcome(rungs) -> str:
    """'8:adopted 16:ran screen:skipped' for a pair's rungs; '-' where none ran."""
    short = {"overlap8": "8", "overlap16": "16", "overlap_screen": "screen"}
    return " ".join(f"{short[r['rung']]}:{rung_state(r)}" for r in rungs) or "-"
