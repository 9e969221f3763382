"""Frozen copy of ``circuits_halo2_tpu_torch/models/verifier.py`` for the benchmark's
reference (it imports nothing of the port; later changes to the port do
not move it).

Port copy of ``circuits_halo2_tpu/models/verifier.py`` (host-only; the
original reaches JAX through its keygen import).

PLONKish proof verifier (KZG + SHPLONK/BDFG21).

Replaces halo2's ``verify_proof`` + ``VerifierSHPLONK`` (reference use:
`zk_prover/src/circuits/utils.rs:110-131`). The verification algorithm is a
host-side replay of the transcript, the quotient identity at x, and the
BDFG21 multiopen pairing check — the exact procedure encoded in the
reference's generated verifier (`contracts/src/InclusionVerifier.sol`),
implemented generically over the compiled ConstraintSystem.

Changed from the port's module: the final pairing check
e(acc, G2) == e(W', s·G2) holds exactly when acc - s·W' is the point at
infinity (G1 has prime order and the pairing is non-degenerate), and the
benchmark's SRS secret s is known (``keygen.srs_secret``). So ``verify``
returns that combination as a list of (point, scalar) terms plus a scalar
of the generator (every VK commitment enters through its discrete log), and
``check`` sums any number of them, each weighted by a random scalar, in one
host Pippenger: no pairing. A proof that does not parse, or has bytes left
over, raises ``ValueError``.
"""

from __future__ import annotations

import random

from . import curve as C
from . import field as F
from .cs import ConstraintSystem
from .keygen import DELTA, VerifyingKey, srs_secret
from .transcript import Blake2bTranscript

P = F.FR_MOD


def perm_chunk_len(cs: ConstraintSystem) -> int:
    return cs.degree() - 2


def num_perm_sets(cs: ConstraintSystem) -> int:
    chunk = perm_chunk_len(cs)
    cols = len(cs.permutation_columns)
    return (cols + chunk - 1) // chunk


def multiopen_queries(cs: ConstraintSystem):
    """The multiopen query list [(poly_id, rotation)] in halo2 order."""
    last_rot = -(cs.blinding_factors() + 1)
    nperm = num_perm_sets(cs)
    queries: list[tuple[tuple, int]] = []
    for col, rot in cs.advice_queries:
        queries.append((("advice", col), rot))
    for s in range(nperm):
        queries.append((("perm_z", s), 0))
        queries.append((("perm_z", s), 1))
    for s in range(nperm - 2, -1, -1):
        queries.append((("perm_z", s), last_rot))
    for li in range(len(cs.lookups)):
        queries.append((("lookup_z", li), 0))
        queries.append((("lookup_a", li), 0))
        queries.append((("lookup_s", li), 0))
        queries.append((("lookup_a", li), -1))
        queries.append((("lookup_z", li), 1))
    for col, rot in cs.fixed_queries:
        queries.append((("fixed", col), rot))
    for i in range(len(cs.permutation_columns)):
        queries.append((("sigma", i), 0))
    queries.append((("quotient",), 0))
    queries.append((("random",), 0))
    return queries


def rotation_sets(cs: ConstraintSystem):
    """Group polys by identical rotation sets, halo2 shplonk-style.

    Returns a list of (sorted_rotations, [poly_ids in first-appearance
    order]); sets ordered by first appearance of the set."""
    queries = multiopen_queries(cs)
    poly_rots: dict[tuple, set] = {}
    poly_order: list[tuple] = []
    for poly, rot in queries:
        if poly not in poly_rots:
            poly_rots[poly] = set()
            poly_order.append(poly)
        poly_rots[poly].add(rot)
    sets: list[tuple[tuple, list]] = []
    index: dict[frozenset, int] = {}
    for poly in poly_order:
        key = frozenset(poly_rots[poly])
        if key not in index:
            index[key] = len(sets)
            sets.append((tuple(sorted(poly_rots[poly])), []))
        sets[index[key]][1].append(poly)
    return sets


def verify(vk: VerifyingKey, instances: list[list[int]], proof: bytes):
    """Replay the transcript of a Blake2b proof and return its final check
    as ``(terms, generator_scalar)``: the proof is valid iff
    sum(c·P for P, c in terms) + generator_scalar·G1 is the point at
    infinity."""
    cs = vk.cs
    n = 1 << vk.k
    omega = vk.omega
    blinders = cs.blinding_factors()
    last_rot = -(blinders + 1)
    nperm = num_perm_sets(cs)
    chunk = perm_chunk_len(cs)
    num_h = cs.degree() - 1

    t = Blake2bTranscript(proof)
    t.common_scalar(vk.transcript_repr)
    for col in instances:
        for v in col:
            t.common_scalar(v)

    advice_comms = [t.read_point() for _ in range(cs.num_advice)]
    theta = t.squeeze_challenge()
    lookup_comms = []
    for _ in cs.lookups:
        a_prime = t.read_point()
        s_prime = t.read_point()
        lookup_comms.append((a_prime, s_prime))
    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    perm_z_comms = [t.read_point() for _ in range(nperm)]
    lookup_z_comms = [t.read_point() for _ in cs.lookups]
    random_comm = t.read_point()
    y = t.squeeze_challenge()
    h_comms = [t.read_point() for _ in range(num_h)]
    x = t.squeeze_challenge()

    advice_evals = [t.read_scalar() for _ in cs.advice_queries]
    fixed_evals = [t.read_scalar() for _ in cs.fixed_queries]
    random_eval = t.read_scalar()
    sigma_evals = [t.read_scalar() for _ in cs.permutation_columns]
    perm_z_evals = []  # per set: (z_x, z_wx, z_last or None)
    for s in range(nperm):
        z_x = t.read_scalar()
        z_wx = t.read_scalar()
        z_last = t.read_scalar() if s < nperm - 1 else None
        perm_z_evals.append((z_x, z_wx, z_last))
    lookup_evals = []  # per lookup: (z_x, z_wx, a_x, a_prev, s_x)
    for _ in cs.lookups:
        lookup_evals.append(tuple(t.read_scalar() for _ in range(5)))

    zeta = t.squeeze_challenge()
    nu = t.squeeze_challenge()
    w_comm = t.read_point()
    mu = t.squeeze_challenge()
    w_prime_comm = t.read_point()

    # ---- Lagrange evaluations at x ---------------------------------------
    x_n = F.fr_pow(x, n)
    max_inst = max((len(col) for col in instances), default=0)
    # l_j(x) for j in [-(blinders+1), max(num_instances, 1))
    js = list(range(last_rot, max(max_inst, 1)))
    omega_pows = {j: F.fr_pow(omega, j % n) for j in js}
    denoms = F.batch_inv([(x - omega_pows[j]) % P for j in js])
    common = (x_n - 1) * F.fr_inv(n) % P
    l_evals = {
        j: common * omega_pows[j] % P * d % P for j, d in zip(js, denoms)
    }
    l_last = l_evals[last_rot]
    l_blind = sum(l_evals[j] for j in range(last_rot + 1, 0)) % P
    l_0 = l_evals[0]
    instance_evals = [
        sum(v * l_evals[i] for i, v in enumerate(col)) % P for col in instances
    ]

    # ---- quotient evaluation ---------------------------------------------
    def eval_expr(expr):
        ops = {
            "constant": lambda v: v % P,
            "selector": lambda idx: (_ for _ in ()).throw(
                AssertionError("uncompressed selector in verify")
            ),
            "fixed": lambda q, c, r: fixed_evals[q],
            "advice": lambda q, c, r: advice_evals[q],
            "instance": lambda q, c, r: instance_evals[
                0 if not cs.instance_queries else cs.instance_queries[q][0]
            ],
            "negated": lambda a: (-a) % P,
            "sum": lambda a, b: (a + b) % P,
            "product": lambda a, b: a * b % P,
            "scaled": lambda a, k: a * k % P,
        }
        return expr.evaluate(ops)

    terms: list[int] = []
    for gate in cs.gates:
        for poly in gate.polys:
            terms.append(eval_expr(poly))

    # permutation argument
    terms.append(l_0 * (1 - perm_z_evals[0][0]) % P)
    terms.append(
        l_last
        * ((perm_z_evals[-1][0] * perm_z_evals[-1][0] - perm_z_evals[-1][0]) % P)
        % P
    )
    for s in range(1, nperm):
        terms.append(l_0 * (perm_z_evals[s][0] - perm_z_evals[s - 1][2]) % P)

    def column_eval(col):
        if col.kind == "advice":
            q = cs.advice_queries.index((col.index, 0))
            return advice_evals[q]
        if col.kind == "fixed":
            q = cs.fixed_queries.index((col.index, 0))
            return fixed_evals[q]
        return instance_evals[col.index]

    active = (1 - (l_last + l_blind)) % P
    delta_power = beta * x % P
    for s in range(nperm):
        cols = cs.permutation_columns[s * chunk : (s + 1) * chunk]
        lhs = perm_z_evals[s][1]
        rhs = perm_z_evals[s][0]
        for i, col in enumerate(cols):
            ev = column_eval(col)
            sig = sigma_evals[s * chunk + i]
            lhs = lhs * ((ev + beta * sig + gamma) % P) % P
            rhs = rhs * ((ev + delta_power + gamma) % P) % P
            delta_power = delta_power * DELTA % P
        terms.append((lhs - rhs) * active % P)

    # lookup argument
    for li, lk in enumerate(cs.lookups):
        z_x, z_wx, a_x, a_prev, s_x = lookup_evals[li]
        compressed_input = 0
        for expr in lk.input_exprs:
            compressed_input = (compressed_input * theta + eval_expr(expr)) % P
        compressed_table = 0
        for expr in lk.table_exprs:
            compressed_table = (compressed_table * theta + eval_expr(expr)) % P
        terms.append(l_0 * (1 - z_x) % P)
        terms.append(l_last * ((z_x * z_x - z_x) % P) % P)
        lhs = z_wx * ((a_x + beta) % P) % P * ((s_x + gamma) % P) % P
        rhs = (
            z_x
            * ((compressed_input + beta) % P)
            % P
            * ((compressed_table + gamma) % P)
            % P
        )
        terms.append(active * ((lhs - rhs) % P) % P)
        terms.append(l_0 * (a_x - s_x) % P)
        terms.append(active * ((a_x - s_x) % P) % P * ((a_x - a_prev) % P) % P)

    numer = 0
    for term in terms:
        numer = (numer * y + term) % P
    quotient_eval = numer * F.fr_inv((x_n - 1) % P) % P

    if t.offset != len(proof):
        raise ValueError(f"{len(proof) - t.offset} bytes after the last read")

    # ---- SHPLONK multiopen check -----------------------------------------
    sets = rotation_sets(cs)

    def poly_commitment(poly):
        kind = poly[0]
        if kind == "advice":
            return advice_comms[poly[1]]
        if kind == "fixed":
            return vk.fixed_commitments[poly[1]]
        if kind == "sigma":
            return vk.permutation_commitments[poly[1]]
        if kind == "perm_z":
            return perm_z_comms[poly[1]]
        if kind == "lookup_z":
            return lookup_z_comms[poly[1]]
        if kind == "lookup_a":
            return lookup_comms[poly[1]][0]
        if kind == "lookup_s":
            return lookup_comms[poly[1]][1]
        if kind == "quotient":
            return "quotient"
        if kind == "random":
            return random_comm
        raise KeyError(poly)

    def poly_eval(poly, rot):
        kind = poly[0]
        if kind == "advice":
            return advice_evals[cs.advice_queries.index((poly[1], rot))]
        if kind == "fixed":
            return fixed_evals[cs.fixed_queries.index((poly[1], rot))]
        if kind == "sigma":
            return sigma_evals[poly[1]]
        if kind == "perm_z":
            z_x, z_wx, z_last = perm_z_evals[poly[1]]
            return {0: z_x, 1: z_wx, last_rot: z_last}[rot]
        if kind == "lookup_z":
            z_x, z_wx, _, _, _ = lookup_evals[poly[1]]
            return {0: z_x, 1: z_wx}[rot]
        if kind == "lookup_a":
            _, _, a_x, a_prev, _ = lookup_evals[poly[1]]
            return {0: a_x, -1: a_prev}[rot]
        if kind == "lookup_s":
            return lookup_evals[poly[1]][4]
        if kind == "quotient":
            return quotient_eval
        if kind == "random":
            return random_eval
        raise KeyError(poly)

    point_of = {}
    universe = set()
    for rots, _ in sets:
        for rot in rots:
            if rot not in point_of:
                point_of[rot] = x * F.fr_pow(omega, rot % n) % P
                universe.add(rot)

    # r_j(mu) per set via Lagrange through set points
    set_data = []
    for rots, polys in sets:
        pts = [point_of[r] for r in rots]
        z_mu = 1
        for pt in pts:
            z_mu = z_mu * ((mu - pt) % P) % P
        # Lagrange basis at mu
        r_mu_total = 0
        zeta_pow = 1
        for poly in polys:
            r_mu = 0
            for i, (rot, pt) in enumerate(zip(rots, pts)):
                li = 1
                for jj, other in enumerate(pts):
                    if jj != i:
                        li = li * ((mu - other) * F.fr_inv((pt - other) % P) % P) % P
                # li = prod (mu - other)/(pt - other)
                r_mu = (r_mu + poly_eval(poly, rot) * li) % P
            r_mu_total = (r_mu_total + zeta_pow * r_mu) % P
            zeta_pow = zeta_pow * zeta % P
        diff = 1
        for rot in universe:
            if rot not in rots:
                diff = diff * ((mu - point_of[rot]) % P) % P
        set_data.append({"z_mu": z_mu, "r_mu": r_mu_total, "diff": diff, "polys": polys})

    diff0_inv = F.fr_inv(set_data[0]["diff"])
    points: dict = {}  # id -> [point, scalar]
    gen = 0

    def add(comm, scalar):
        nonlocal gen
        if isinstance(comm, tuple) and comm and comm[0] in ("fixed", "sigma"):
            dlogs = vk.fixed_dlogs if comm[0] == "fixed" else vk.permutation_dlogs
            gen = (gen + scalar * dlogs[comm[1]]) % P
        elif comm == "quotient":  # Horner over the pieces with x^n
            power = 1
            for h in h_comms:
                add(h, scalar * power % P)
                power = power * x_n % P
        else:
            entry = points.setdefault(id(comm), [comm, 0])
            entry[1] = (entry[1] + scalar) % P

    def poly_term(poly):
        if poly[0] in ("fixed", "sigma"):
            return poly
        return poly_commitment(poly)

    r_total = 0
    nu_pow = 1
    for sd in set_data:
        norm = sd["diff"] * diff0_inv % P
        zeta_pow = 1
        for poly in sd["polys"]:
            add(poly_term(poly), nu_pow * norm % P * zeta_pow % P)
            zeta_pow = zeta_pow * zeta % P
        r_total = (r_total + nu_pow * norm % P * sd["r_mu"]) % P
        nu_pow = nu_pow * nu % P

    gen = (gen - r_total) % P
    add(w_comm, (-set_data[0]["z_mu"]) % P)
    add(w_prime_comm, (mu - srs_secret(vk.k)) % P)
    return [(pt, c) for pt, c in points.values() if pt is not None and c], gen


def check(combinations, rng: random.Random) -> bool:
    """Whether every ``verify`` result is the point at infinity: their sum,
    each weighted by a random non-zero scalar from ``rng``, is (a forged
    proof passes with probability about 1/r)."""
    pts, scs, gen = [], [], 0
    for terms, g in combinations:
        w = rng.randrange(1, P)
        gen = (gen + w * g) % P
        for pt, c in terms:
            pts.append(pt)
            scs.append(w * c % P)
    pts.append(C.G1_GEN)
    scs.append(gen)
    return C.g1_msm_pippenger(pts, scs) is None
