"""The benchmark reference's Keccak side on the CPU: its Keccak verifier
(the reference's ``verify`` under a frozen copy of the port's Keccak
transcript) accepts the JAX package's Keccak proof of the criterion
configuration's synthetic witness (k=13, the unsafe setup;
tests/fixtures_torch_criterion.json) and refuses it against a changed root
balance; its plain-Python keccak256 equals the port's native one; and no
reference module imports the port or JAX. The port's bulk calldata itself
is held to the JAX package's bytes and verifier in test_torch_backend.py.
Exact."""

import ast
import json
import random
from pathlib import Path

import pytest

from benchmark.reference import keccak as RKK
from benchmark.reference import keygen as RK
from benchmark.reference import verifier_keccak as RVK
from circuits_halo2_tpu_torch.ops.keccak import keccak256

ROOT = Path(__file__).resolve().parent.parent
FIX = json.loads((ROOT / "tests/fixtures_torch_criterion.json").read_text())["criterion"]


def test_reference_keccak_verifier_takes_the_jax_keccak_proof():
    vk = RK.verifying_key(FIX["levels"], FIX["n_currencies"], FIX["n_bytes"], FIX["k"])
    proof = bytes.fromhex(FIX["keccak_proof"])
    instances = [[int(v, 16) for v in FIX["instances"][0]]]
    assert RVK.check([RVK.verify(vk, instances, proof)], random.Random(1))
    other = [instances[0][:2] + [instances[0][2] + 1]]
    assert not RVK.check([RVK.verify(vk, other, proof)], random.Random(2))
    with pytest.raises(ValueError):
        RVK.verify(vk, instances, proof[:-1])


@pytest.mark.parametrize("n", [0, 3, 135, 136, 137, 272, 1024])
def test_reference_keccak256_equals_the_native_one(n):
    """Lengths around the 136-byte rate: a block's last byte, a whole
    block, one byte over, two blocks."""
    data = bytes((7 * i + n) % 256 for i in range(n))
    assert RKK.keccak256(data) == keccak256(data)
    if not data:
        assert RKK.keccak256(data).hex() == (
            "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        (ROOT / "benchmark/reference").glob("*.py")))
def test_the_reference_imports_no_port_and_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in
           ("jax", "jaxlib", "circuits_halo2_tpu", "circuits_halo2_tpu_torch")]
    assert not bad, bad
