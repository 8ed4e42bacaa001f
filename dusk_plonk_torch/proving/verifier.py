"""Verifier front-end (behavioral port of reference src/verifier.rs):
public-input length check, transcript clone + PI absorption, delegate to
Proof.verify."""

from __future__ import annotations

from ..composer.composer import InconsistentPublicInputsLen
from ..transcript.plonk_transcript import PlonkTranscript


class Verifier:
    def __init__(self, label, verifier_key, opening_key,
                 public_input_indexes, size, constraints):
        self.verifier_key = verifier_key
        self.opening_key = opening_key
        self.public_input_indexes = public_input_indexes
        self.size = size
        self.transcript = PlonkTranscript.base(
            label, verifier_key.commitments, constraints)

    def verify(self, proof, public_inputs) -> None:
        if len(public_inputs) != len(self.public_input_indexes):
            raise InconsistentPublicInputsLen(
                f"expected {len(self.public_input_indexes)}, "
                f"provided {len(public_inputs)}")

        transcript = self.transcript.clone()
        for pi in public_inputs:
            transcript.append_scalar(b"pi", pi)

        # sparse (index, value) pairs: the reference densifies then
        # rayon-filters the n-vector (src/verifier.rs:58-73,
        # proof.rs:550-560); a Python O(n) walk cost ~6 ms at 2^16 and
        # ~60 ms at 2^20 per verify — the barycentric sum only ever
        # touches the nonzero entries, which we know by index
        sparse = list(zip(self.public_input_indexes, public_inputs))
        proof.verify(self.verifier_key, transcript, self.opening_key,
                     sparse)
