"""Cross-user batched proving (``circuits_halo2_tpu/models/prover_batch.py``).

An exchange makes one MstInclusion proof per user, and the proofs are
independent, so the device work batches: ``prove_batch`` proves U users in
one pass of the single prover's code (``models/prover.prove_users``, which
``prove`` runs with U = 1), with a user axis after the limb axis on every
per-user tensor -- columns (16, U, B, n), scalars (16, U, k). Each torch
op then carries U users' work. The columns every user shares (fixed,
sigma and the Lagrange specials) enter as size-1 views of the per-key
cache and broadcast; they are never copied per user. Each commitment
batch is one Pippenger call over every user's columns (``ops/msm``, K3 in
chunks of at most 2^17 lanes). The sequential per-user work -- the
Fiat-Shamir transcript, the lookup sort, the blinding draws, the small
r_j interpolations -- stays on the host in a loop over users, in the
single prover's order.

The user axis is threaded explicitly rather than by ``torch.func.vmap``:
the field product (``ops/field_torch.mont_mul``) accumulates into a buffer
in place, which vmap refuses for batched operands.

Measured on one H100 80GB HBM3 at 700 W (``chip_smoke.py``, the criterion
config at k=13, users 0-7, warm): one at a time 7.6 proofs per minute,
U=4 22.1 (2.9x), U=8 30.0 (3.9x), the U=8 call peaking 4.0 GB above what
was allocated before it. A k=13 proof is bound by the host's launches of
small field-op kernels, and a batch shares each launch among its users;
the per-user host work (synthesis, transcripts, lookup sort, blinding)
is what remains.

Byte compatibility: ``prove_batch(params, pk, [c], ...)[0]`` equals
``prove(params, pk, c, ...)`` with the same ``BlindingRng`` -- the same
draw order per user and the same transcript framing.

A batch runs on one device: the rank mesh (``parallel/auto``) is suspended
for the call and restored after it, as in the JAX package.
"""

from __future__ import annotations

from ..parallel import auto
from ..utils.srs import ParamsKZG
from ..utils.transcript import KeccakTranscript
from .keygen import ProvingKey
from .prover import BlindingRng, prove_users


def prove_batch(
    params: ParamsKZG,
    pk: ProvingKey,
    circuits: list,
    config,
    instances_list: list[list[list[int]]],
    rngs: list[BlindingRng] | None = None,
    transcript_cls=KeccakTranscript,
    vk_digest: int | None = None,
    device="cuda:0",
) -> list[bytes]:
    """Prove U independent circuits in one batched device pass on
    ``device`` (the card unless the caller asks for the CPU).

    Returns one proof per circuit, each byte-identical to what
    ``prover.prove`` makes for that circuit with the same rng."""
    nusers = len(circuits)
    rngs = rngs or [BlindingRng() for _ in range(nusers)]
    if nusers == 0 or not nusers == len(instances_list) == len(rngs):
        raise ValueError("prove_batch needs a circuit, and one instance list and rng for each")
    with auto.suspended():
        return prove_users(params, pk, circuits, config, instances_list, rngs, transcript_cls,
                           vk_digest, device)
