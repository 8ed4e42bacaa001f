"""PLONK Fiat-Shamir transcript protocol over merlin.

Mirrors `zksnarks::plonk::{Transcript, TranscriptProtocol}` as used by the
reference (labels enumerated at src/prover.rs:99-449, src/prover/proof.rs:87-369):
  append_scalar(label, s)      -> append 32-byte LE canonical encoding
  append_commitment(label, c)  -> append 48-byte compressed G1
  challenge_scalar(label)      -> 64 challenge bytes reduced wide mod r

`Transcript::base(label, verifier_key, constraints)` lives in the unmounted
crate; our seeding (documented assumption, SURVEY.md §7 risk #1): merlin
transcript with the user label, a circuit-size domain separator, then every
verifier-key commitment appended in declaration order
(q_m q_l q_r q_o q_c q_4 q_arith q_range q_logic q_fixed_group_add
 q_variable_group_add s_sigma_1..4).
"""

from __future__ import annotations

from .merlin import MerlinTranscript
from .host import fr_to_bytes, fr_from_bytes_wide
from .bls import g1_to_bytes

VK_COMMITMENT_ORDER = (
    "q_m", "q_l", "q_r", "q_o", "q_c", "q_4", "q_arith", "q_range",
    "q_logic", "q_fixed_group_add", "q_variable_group_add",
    "s_sigma_1", "s_sigma_2", "s_sigma_3", "s_sigma_4",
)


class PlonkTranscript:
    __slots__ = ("t",)

    def __init__(self, label: bytes | None, merlin: MerlinTranscript | None = None):
        self.t = merlin if merlin is not None else MerlinTranscript(label)

    @classmethod
    def base(cls, label: bytes, vk_commitments: dict, constraints: int
             ) -> "PlonkTranscript":
        tr = cls(label)
        tr.t.append_message(b"dom-sep", b"circuit_size")
        tr.t.append_u64(b"n", constraints)
        for name in VK_COMMITMENT_ORDER:
            tr.append_commitment(name.encode(), vk_commitments[name])
        return tr

    def clone(self) -> "PlonkTranscript":
        return PlonkTranscript(None, merlin=self.t.clone())

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.t.append_message(label, fr_to_bytes(scalar))

    def append_commitment(self, label: bytes, commitment) -> None:
        self.t.append_message(label, g1_to_bytes(commitment))

    def challenge_scalar(self, label: bytes) -> int:
        return fr_from_bytes_wide(self.t.challenge_bytes(label, 64))
