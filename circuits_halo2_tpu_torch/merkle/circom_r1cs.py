"""R1CS compiler + witness calculator for the circom IVC step circuit.

The reference ships `zk_prover/src/circom/incremental_mst_inclusion.circom`
(compiled by circom to a `.r1cs` + witness-generator `.wasm`, consumed by
the Nova example via circom-scotia — `nova_incremental_verifier.rs:150-166`).
This module is the artifact-level equivalent: it synthesizes the SAME
constraint system shape from the same template structure —

  - circomlib ``Poseidon(n)``: 3 rank-1 constraints per S-box (x², x⁴, x⁵),
    ark/MDS layers stay linear and are carried symbolically (exactly what
    circom's o1 optimizer does to linear substitutions);
  - ``Num2Bits(8·N_BYTES)`` range checks: one b·(b−1)=0 per bit plus the
    recomposition equality;
  - ``Swapper``: s·(1−s)=0 plus one MultiMux1 constraint per muxed signal;
  - ``Summer``: pure linear, no constraints (circom substitutes these);
  - public outputs pinned by equality constraints (public signals are never
    substituted away by circom)

— evaluates the full witness from a ``CircomMerkleProof`` (replacing the
wasm witness calculator), and reads/writes the iden3 binary ``.r1cs`` /
``.wtns`` formats so the artifacts interoperate with snarkjs-family
tooling. Main component parameters mirror the reference's
``component main = IncrementalMstInclusion(4, 2, 14)``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..ops import poseidon_circom as PC
from ..ops.field import FR_MOD
from . import circom_mst as CM

P = FR_MOD

# A linear combination is {wire_index: coeff}; wire 0 is the constant 1.
LC = dict


def _lc_add(a: LC, b: LC) -> LC:
    out = dict(a)
    for w, c in b.items():
        v = (out.get(w, 0) + c) % P
        if v:
            out[w] = v
        else:
            out.pop(w, None)
    return out


def _lc_scale(a: LC, k: int) -> LC:
    k %= P
    if k == 0:
        return {}
    return {w: (c * k) % P for w, c in a.items()}


def _lc_sub(a: LC, b: LC) -> LC:
    return _lc_add(a, _lc_scale(b, P - 1))


def _lc_const(v: int) -> LC:
    v %= P
    return {0: v} if v else {}


@dataclass
class R1CS:
    """Constraint system: (A·w)·(B·w) = C·w per row, circom wire layout
    [1, public outputs, public inputs, private inputs, internals]."""

    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    constraints: list = field(default_factory=list)  # [(A, B, C), ...]

    def check(self, witness: list[int]) -> bool:
        def ev(lc):
            return sum(witness[w] * c for w, c in lc.items()) % P

        return all(
            ev(a) * ev(b) % P == ev(c) for a, b, c in self.constraints
        )


class _Builder:
    def __init__(self):
        self.values: list[int] = [1]
        self.constraints: list[tuple[LC, LC, LC]] = []

    def new_wire(self, value: int) -> int:
        self.values.append(value % P)
        return len(self.values) - 1

    def eval(self, lc: LC) -> int:
        return sum(self.values[w] * c for w, c in lc.items()) % P

    def mul(self, a: LC, b: LC) -> LC:
        out = self.new_wire(self.eval(a) * self.eval(b) % P)
        self.constraints.append((a, b, {out: 1}))
        return {out: 1}

    def assert_eq(self, a: LC, b: LC):
        # circom lowers `lc1 === lc2` to the linear row (lc1−lc2)·1 = 0
        self.constraints.append((_lc_sub(a, b), {0: 1}, {}))

    def assert_bool(self, s: LC):
        # s · (1 − s) === 0
        self.constraints.append((s, _lc_sub(_lc_const(1), s), {}))


def _poseidon(b: _Builder, inputs: list[LC]) -> LC:
    """circomlib Poseidon(nInputs): state [0, inputs...], returns out LC."""
    t = len(inputs) + 1
    rc, mds = PC.params(t)
    r_p = PC.N_ROUNDS_P[t - 2]

    def ark(state, r):
        return [_lc_add(s, _lc_const(rc[r][i])) for i, s in enumerate(state)]

    def mix(state):
        return [
            _reduce_add([_lc_scale(state[j], mds[i][j]) for j in range(t)])
            for i in range(t)
        ]

    def sbox(x):
        x2 = b.mul(x, x)
        x4 = b.mul(x2, x2)
        return b.mul(x4, x)

    state: list[LC] = [_lc_const(0)] + list(inputs)
    ri = 0
    for _ in range(PC.R_F // 2):
        state = mix([sbox(s) for s in ark(state, ri)])
        ri += 1
    for _ in range(r_p):
        s = ark(state, ri)
        state = mix([sbox(s[0])] + s[1:])
        ri += 1
    for _ in range(PC.R_F // 2):
        state = mix([sbox(s) for s in ark(state, ri)])
        ri += 1
    return state[0]


def _reduce_add(lcs: list[LC]) -> LC:
    out: LC = {}
    for lc in lcs:
        out = _lc_add(out, lc)
    return out


def _num2bits(b: _Builder, lc: LC, nbits: int):
    """circomlib Num2Bits: bit wires + booleanity + recomposition."""
    v = b.eval(lc)
    assert v < (1 << nbits), f"range check would fail: {v} >= 2^{nbits}"
    acc: LC = {}
    for i in range(nbits):
        bit = {b.new_wire((v >> i) & 1): 1}
        b.assert_bool(bit)
        acc = _lc_add(acc, _lc_scale(bit, 1 << i))
    b.assert_eq(acc, lc)


def _mux1(b: _Builder, c0: LC, c1: LC, s: LC) -> LC:
    """MultiMux1 row: out = (c1 − c0)·s + c0 (one constraint)."""
    return _lc_add(b.mul(_lc_sub(c1, c0), s), c0)


def build_incremental_mst_inclusion(
    proof: CM.CircomMerkleProof,
    step_in: tuple[int, int],
    n_bytes: int = 14,
) -> tuple[R1CS, list[int]]:
    """Synthesize IncrementalMstInclusion(LEVELS, N_CURRENCIES, N_BYTES)
    with the witness evaluated from ``proof`` and the IVC state pair.
    Returns (r1cs, witness); witness[1:3] are step_out, witness[3:5] step_in.
    """
    levels = len(proof.path_indices)
    ncur = len(proof.user_balances)
    b = _Builder()

    # wire layout: outputs first (values patched once computed)
    out_wires = [b.new_wire(0), b.new_wire(0)]
    step_in_lc = [{b.new_wire(v): 1} for v in step_in]
    username_lc = {b.new_wire(CM.big_intify_username(proof.username)): 1}
    user_bal_lc = [{b.new_wire(v): 1} for v in proof.user_balances]
    path_hash_lc = [{b.new_wire(v): 1} for v in proof.path_element_hashes]
    path_bal_lc = [
        [{b.new_wire(v): 1} for v in row] for row in proof.path_element_balances
    ]
    path_idx_lc = [{b.new_wire(v): 1} for v in proof.path_indices]
    n_prv_in = 1 + ncur + levels + levels * ncur + levels

    # 1. leaf hash   2. user state chain step
    leaf_hash = _poseidon(b, [username_lc] + user_bal_lc)
    user_state_cur = _poseidon(b, [step_in_lc[0], leaf_hash])

    # 3. MerkleSumTreeInclusion
    cur_hash, cur_bals = leaf_hash, list(user_bal_lc)
    for i in range(levels):
        # Summer (range checks + linear sums; sums substitute, no wires)
        summed = []
        for j in range(ncur):
            _num2bits(b, cur_bals[j], 8 * n_bytes)
            _num2bits(b, path_bal_lc[i][j], 8 * n_bytes)
            summed.append(_lc_add(cur_bals[j], path_bal_lc[i][j]))
        # Swapper
        s = path_idx_lc[i]
        b.assert_bool(s)
        left_hash = _mux1(b, cur_hash, path_hash_lc[i], s)
        right_hash = _mux1(b, path_hash_lc[i], cur_hash, s)
        left_bals = [
            _mux1(b, cur_bals[j], path_bal_lc[i][j], s) for j in range(ncur)
        ]
        right_bals = [
            _mux1(b, path_bal_lc[i][j], cur_bals[j], s) for j in range(ncur)
        ]
        # Hasher
        cur_hash = _poseidon(
            b, [left_hash] + left_bals + [right_hash] + right_bals
        )
        cur_bals = summed
    for j in range(ncur):
        _num2bits(b, cur_bals[j], 8 * n_bytes)

    # 4. liabilities state chain step; pin public outputs
    liab_state_cur = _poseidon(b, [step_in_lc[1], cur_hash])
    b.values[out_wires[0]] = b.eval(user_state_cur)
    b.values[out_wires[1]] = b.eval(liab_state_cur)
    b.assert_eq({out_wires[0]: 1}, user_state_cur)
    b.assert_eq({out_wires[1]: 1}, liab_state_cur)

    r1cs = R1CS(
        n_wires=len(b.values),
        n_pub_out=2,
        n_pub_in=2,
        n_prv_in=n_prv_in,
        constraints=b.constraints,
    )
    return r1cs, list(b.values)


# ---------------------------------------------------------------------------
# iden3 binary formats (.r1cs spec v1, .wtns v2)
# ---------------------------------------------------------------------------

def _fe(v: int) -> bytes:
    return (v % P).to_bytes(32, "little")


def write_r1cs(r1cs: R1CS, path: str):
    def lc_bytes(lc: LC) -> bytes:
        out = struct.pack("<I", len(lc))
        for w in sorted(lc):
            out += struct.pack("<I", w) + _fe(lc[w])
        return out

    cons = b"".join(
        lc_bytes(a) + lc_bytes(bb) + lc_bytes(c) for a, bb, c in r1cs.constraints
    )
    header = (
        struct.pack("<I", 32)
        + P.to_bytes(32, "little")
        + struct.pack(
            "<IIIIQI",
            r1cs.n_wires,
            r1cs.n_pub_out,
            r1cs.n_pub_in,
            r1cs.n_prv_in,
            r1cs.n_wires,
            len(r1cs.constraints),
        )
    )
    labels = b"".join(struct.pack("<Q", i) for i in range(r1cs.n_wires))
    with open(path, "wb") as f:
        f.write(b"r1cs" + struct.pack("<II", 1, 3))
        for sect_type, payload in ((1, header), (2, cons), (3, labels)):
            f.write(struct.pack("<IQ", sect_type, len(payload)) + payload)


def read_r1cs(path: str) -> R1CS:
    data = open(path, "rb").read()
    assert data[:4] == b"r1cs"
    _, nsect = struct.unpack_from("<II", data, 4)
    pos, sections = 12, {}
    for _ in range(nsect):
        st, size = struct.unpack_from("<IQ", data, pos)
        sections[st] = data[pos + 12 : pos + 12 + size]
        pos += 12 + size
    h = sections[1]
    fs = struct.unpack_from("<I", h)[0]
    prime = int.from_bytes(h[4 : 4 + fs], "little")
    assert prime == P
    nw, npo, npi, npr, _nl, m = struct.unpack_from("<IIIIQI", h, 4 + fs)
    body, pos = sections[2], 0
    constraints = []
    for _ in range(m):
        row = []
        for _ in range(3):
            (nt,) = struct.unpack_from("<I", body, pos)
            pos += 4
            lc = {}
            for _ in range(nt):
                (w,) = struct.unpack_from("<I", body, pos)
                lc[w] = int.from_bytes(body[pos + 4 : pos + 36], "little")
                pos += 36
            row.append(lc)
        constraints.append(tuple(row))
    return R1CS(nw, npo, npi, npr, constraints)


def write_wtns(witness: list[int], path: str):
    header = (
        struct.pack("<I", 32)
        + P.to_bytes(32, "little")
        + struct.pack("<I", len(witness))
    )
    vals = b"".join(_fe(v) for v in witness)
    with open(path, "wb") as f:
        f.write(b"wtns" + struct.pack("<II", 2, 2))
        f.write(struct.pack("<IQ", 1, len(header)) + header)
        f.write(struct.pack("<IQ", 2, len(vals)) + vals)


def read_wtns(path: str) -> list[int]:
    data = open(path, "rb").read()
    assert data[:4] == b"wtns"
    _, nsect = struct.unpack_from("<II", data, 4)
    pos, out = 12, []
    for _ in range(nsect):
        st, size = struct.unpack_from("<IQ", data, pos)
        payload = data[pos + 12 : pos + 12 + size]
        pos += 12 + size
        if st == 2:
            out = [
                int.from_bytes(payload[i : i + 32], "little")
                for i in range(0, len(payload), 32)
            ]
    return out
