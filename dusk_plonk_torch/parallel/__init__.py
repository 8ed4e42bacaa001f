"""The multi-device layer: a one-process device mesh (mesh.py), the
distributed NTT (ntt.py), the sharded scans and point-partitioned MSMs
(prover_step.py, msm.py) and the scaling model (model.py); the sharded
engine is proving/sharded_engine.py."""

from .prover_step import msm_point_partitioned, sharded_prover_step

__all__ = ["msm_point_partitioned", "sharded_prover_step"]
