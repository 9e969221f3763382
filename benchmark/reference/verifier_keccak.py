"""The reference's proof check for proofs of the EVM path (Keccak
transcript, uncompressed points): ``verifier.verify`` with its transcript
the Keccak one (``transcript_keccak``) in place of Blake2b.

``verifier.verify`` names its transcript by the module-level name
``Blake2bTranscript``. This module runs the same code object under a copy
of that module's namespace in which the name is the Keccak transcript, so
no line of the verifier is copied or changed: the replay, the quotient
identity, the SHPLONK combination and the final check with the setup's
known secret are the reference's own, and ``check`` sums the results as it
sums Blake2b ones.
"""

from __future__ import annotations

import types

from . import verifier as _V
from .transcript_keccak import KeccakTranscript

verify = types.FunctionType(_V.verify.__code__,
                            {**vars(_V), "Blake2bTranscript": KeccakTranscript}, "verify")
verify.__doc__ = """Replay the transcript of a Keccak proof and return its final check
    as ``(terms, generator_scalar)`` (``verifier.verify``'s result)."""
check = _V.check
