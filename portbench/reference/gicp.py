"""The plain reference of a configuration that refines by GICP (`icp_mode`
"gicp"): `env.Reference`'s host logic with `gicp_scorer.score_batch` in
place of the point-to-plane scorer, at the configuration's own iteration
count (no cap) and GICP settings, each block padded to the batch's slots."""

from __future__ import annotations

from portbench.reference import env
from portbench.reference.gicp_scorer import score_batch


class Reference(env.Reference):
    score_batch = staticmethod(score_batch)

    def scorer_config(self, do_icp: bool) -> dict:
        cfg = super().scorer_config(do_icp)
        # GICP's step thresholds are a tenth of the point-to-plane ones.
        cfg.update(icp_max_iterations=self.perch["max_icp_iterations"],
                   icp_rotation_epsilon=cfg["icp_rotation_epsilon"] * 0.1,
                   icp_transformation_epsilon=(
                       cfg["icp_transformation_epsilon"] * 0.1),
                   icp_gicp_epsilon=self.envc["icp_gicp_epsilon"],
                   slots=self.batch)
        return cfg
