"""Runtime configuration of the port.

Only the knobs that still apply on a GPU are kept from
dusk_plonk_tpu/utils/config.py, with its names: the MSM's window width,
chunk length and working-set cap, the element-major scan, the four-step
NTT and the name of the mesh axis.  The cap (`msm_group_slots`) keeps the
JAX name and its role, with a default sized for an 80 GB card.  Its tile
sizes, 14-bit switches, stacked twiddle limit and quotient chunking are
rules of the TPU build and have no counterpart here, nor its off-TPU
`ntt_mxu_force` (the route depends on the config alone; on CPU tensors
every kernel runs its plain version).  Of its mesh settings the axis name
stays: the port's mesh (parallel/mesh.py) is one axis over a list of
devices.  One process-global config, read when a plan is built.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class TorchPlonkConfig:
    msm_window_bits: int | None = None  # Pippenger window width override
                                        # (None = size-adaptive, ops/msm.py)
    msm_chunk_len: int = 256            # sequential depth of the chunk scan
                                        # (kernel K11a's step count)
    msm_group_slots: int = 1 << 25      # (row, point) slots one pass of
                                        # the MSM holds at once: the rows
                                        # of a commit batch (commits x
                                        # windows) go in balanced groups of
                                        # at most slots // n_pad rows, ~640
                                        # bytes of device memory a slot
                                        # (ops/msm.py::MsmPlan._row_groups)
    ec_scan_em: bool = False            # chunk scan with element-major
                                        # output (kernel K12, ops/msm.py)
    ntt_mxu_min_k: int | None = None    # four-step int8 tensor-core NTT
                                        # (ops/mxu_ntt.py, kernel K13) for
                                        # domains 2^k with k >= this;
                                        # None = the K2 butterfly ladder
    mesh_axis: str = "shard"            # the device mesh's one axis
                                        # (parallel/mesh.py)


_config = TorchPlonkConfig()


def get_config() -> TorchPlonkConfig:
    return _config


def set_config(**overrides) -> TorchPlonkConfig:
    """Replace fields of the global config (affects plans built after the
    call).  Returns the new config."""
    global _config
    _config = replace(_config, **overrides)
    return _config
