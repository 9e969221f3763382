"""Carry state from the JAX package into the port.

The inputs are the JAX package's numpy arrays (``np.asarray`` of its device
arrays) or its host objects; nothing here imports JAX. Used by the tests so
both packages prove from the same key and compare the same tree.
"""

from __future__ import annotations

import numpy as np
import torch

from .merkle.device_tree import DeviceMst
from .models import incremental as INC
from .models import nova_fold as NF
from .models.cs import ConstraintSystem
from .models.keygen import ProvingKey, VerifyingKey
from .ops import field as F
from .ops import field_torch as FT

# the JAX tree kernels' redundant limbs: 18 x 15 bits, Montgomery R = 2^255
_LB15 = 15
_R15_INV = pow(1 << (15 * 17), -1, F.FR_MOD)


def limbs16_from_jax(arr, device) -> torch.Tensor:
    """(16, ...) uint32 exact 16-bit limbs -> int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(arr).astype(np.int64), device=device)


def _ints15(arr) -> list[int]:
    """(18, N) possibly unnormalised 15-bit limbs -> N exact integers."""
    a = np.asarray(arr).astype(object)
    vals = a[0].copy()
    for i in range(1, a.shape[0]):
        vals = vals + (a[i] << (_LB15 * i))
    return [int(v) for v in vals]


def _mont16(vals15, device) -> torch.Tensor:
    """R15-Montgomery (non-canonical) ints -> the port's R256 Montgomery limbs."""
    p = F.FR_MOD
    return torch.as_tensor(FT.to_mont_limbs([v * _R15_INV % p for v in vals15]), device=device)


def device_mst_from_jax(tree, device) -> DeviceMst:
    """The JAX ``DeviceMst`` (18 x 15-bit fat hash / raw balance levels) as
    the port's tree: hashes and usernames in R256 Montgomery form, balance
    sums as exact 16-bit limbs."""
    hashes = [_mont16(_ints15(h), device) for h in tree.level_hashes]
    balances = [
        torch.stack([torch.as_tensor(FT.ints_to_limbs(_ints15(b[c])), device=device)
                     for c in range(tree.n_currencies)])
        for b in tree.level_balances
    ]
    user = _mont16(_ints15(tree.user_limbs), device)
    return DeviceMst(hashes, balances, tree.depth, tree.n_currencies, user)


def proving_key_from_jax(pk, cs: ConstraintSystem) -> ProvingKey:
    """The JAX ``ProvingKey`` (and its ``VerifyingKey``) as the port's. Both
    hold host ints, which are copied; ``cs`` is the port's own constraint
    system of the same circuit (from the port's ``compile_circuit``,
    ``compile_incremental_circuit`` or ``compile_chained_circuit``), so the
    key shares no object with the JAX package."""
    jvk = pk.vk
    vk = VerifyingKey(
        jvk.k, cs, list(jvk.fixed_commitments), list(jvk.permutation_commitments),
        [list(c) for c in jvk.fixed_values], [list(c) for c in jvk.sigma_values], jvk.omega,
        jvk.transcript_repr,
    )
    return ProvingKey(vk, [list(c) for c in pk.fixed_polys], [list(c) for c in pk.sigma_polys],
                      list(pk.l0), list(pk.l_last), list(pk.l_active_row))


def _point(p):
    return None if p is None else (int(p[0]), int(p[1]))


def _instances(instances) -> list[list[int]]:
    return [[int(v) for v in col] for col in instances]


def incremental_chain_from_jax(chain) -> INC.IncrementalChainProof:
    """The JAX ``IncrementalChainProof`` (its ``IncrementalStep``s) as the
    port's."""
    steps = [INC.IncrementalStep(bytes(s.proof), _instances(s.instances)) for s in chain.steps]
    return INC.IncrementalChainProof(steps, [int(v) for v in chain.user_states],
                                     [int(v) for v in chain.liab_states])


def relaxed_instance_from_jax(inst) -> NF.RelaxedInstance:
    return NF.RelaxedInstance(_point(inst.com_w), _point(inst.com_e), int(inst.u),
                              [int(v) for v in inst.x])


def relaxed_witness_from_jax(wit) -> NF.RelaxedWitness:
    return NF.RelaxedWitness([int(v) for v in wit.w], [int(v) for v in wit.e])


def nifs_steps_from_jax(steps) -> list:
    """The JAX ``fold_chain``'s step records, ``(RelaxedInstance, com_T)``
    pairs, as the port's."""
    return [(relaxed_instance_from_jax(inst), _point(com_t)) for inst, com_t in steps]
