"""PLONKish prover -- KZG commitments + SHPLONK multiopen
(``circuits_halo2_tpu/models/prover.py::prove``, phases 1-6).

1. witness synthesis -> blinded advice commitments          -> theta
2. permuted lookup columns A', S' (host sort)                -> beta, gamma
3. permutation and lookup grand products, random poly        -> y
4. quotient h(X) on the extended coset domain                -> x
5. evaluations at x·omega^rot                                -> zeta, nu
6. SHPLONK: W = commit(h_x), then W'                         -> proof

Every polynomial lives as a (16, U, B, n) Montgomery limb tensor on the
domain's device -- U users' proofs at once, U = 1 for ``prove`` and U for
``models/prover_batch.prove_batch``, both through ``prove_users`` -- and
runs eagerly through torch ops; commitments go through the device
Pippenger (``ops/msm``, kernel K3). The host touches only scalars: the
transcripts, the blinding draws (same order as the reference, so proofs
are byte-identical) and the small r_j interpolations.
``CIRCUITS_PROVE_TRACE=1`` prints each phase's wall time to stderr.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import torch

from ..ops import field as F
from ..ops import field_torch as FT
from ..ops import msm as MSM
from ..utils import poly_device as PD
from ..utils.srs import ParamsKZG
from ..utils.transcript import KeccakTranscript
from .assignment import Assignment
from .keygen import DELTA, ProvingKey
from .verifier import num_perm_sets, perm_chunk_len, rotation_sets

P = F.FR_MOD


class BlindingRng:
    """Deterministic blinding source (blake2b counter mode)."""

    def __init__(self, seed: bytes = b"circuits-halo2-tpu"):
        self.seed = seed
        self.counter = 0

    def next_field(self) -> int:
        h = hashlib.blake2b(self.seed + self.counter.to_bytes(8, "little"), digest_size=64).digest()
        self.counter += 1
        return int.from_bytes(h, "little") % P


def _permute_expression_pair(a_comp, s_comp, usable):
    """halo2's lookup permute_expression_pair on the usable rows."""
    a_perm = sorted(a_comp[:usable])
    table_counts: dict[int, int] = {}
    for v in s_comp[:usable]:
        table_counts[v] = table_counts.get(v, 0) + 1
    s_perm = [0] * usable
    repeated_rows = []
    for row, v in enumerate(a_perm):
        if row == 0 or v != a_perm[row - 1]:
            s_perm[row] = v
            cnt = table_counts.get(v, 0)
            if cnt <= 0:
                raise ValueError("lookup input value not in table")
            table_counts[v] = cnt - 1
        else:
            repeated_rows.append(row)
    for v in sorted(table_counts):
        for _ in range(table_counts[v]):
            s_perm[repeated_rows.pop()] = v
    return a_perm, s_perm


def prove(
    params: ParamsKZG,
    pk: ProvingKey,
    circuit,
    config,
    instances: list[list[int]],
    device="cuda:0",
    rng: BlindingRng | None = None,
    transcript_cls=KeccakTranscript,
    vk_digest: int | None = None,
) -> bytes:
    """One proof: ``circuit`` with its ``instances`` under ``pk``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return prove_users(params, pk, [circuit], config, [instances], [rng or BlindingRng()],
                       transcript_cls, vk_digest, device)[0]


class _Clock:
    """Per-phase wall clock, on when ``CIRCUITS_PROVE_TRACE`` is set: each
    mark prints the time since the last one to stderr, after a
    ``torch.cuda.synchronize()`` on a CUDA domain so the phase's queued
    work is counted in it."""

    def __init__(self, device: torch.device):
        self.on = bool(os.environ.get("CIRCUITS_PROVE_TRACE"))
        self.cuda = device.type == "cuda"
        self.t0 = time.perf_counter()

    def mark(self, label: str) -> None:
        if not self.on:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[prove] {label}: {now - self.t0:.3f}s", file=sys.stderr, flush=True)
        self.t0 = now


def _opening_points(cs, sets, x, omega, n, blinders):
    """x's rotations: (x_next, x_prev, x_last, point_of rotation, index of
    every distinct opening point)."""
    x_next = x * omega % P
    x_prev = x * F.fr_inv(omega) % P
    x_last = x * F.fr_pow(F.fr_inv(omega), blinders + 1) % P
    point_of = {}
    for rots, _ in sets:
        for r in rots:
            point_of.setdefault(r, x * F.fr_pow(omega, r % n) % P)
    pt_idx: dict[int, int] = {}
    for p in [x, x_next, x_prev, x_last, *point_of.values()]:
        pt_idx.setdefault(p, len(pt_idx))
    for _, rot_i in cs.advice_queries + cs.fixed_queries:
        pt_idx.setdefault(x * F.fr_pow(omega, rot_i % n) % P, len(pt_idx))
    return x_next, x_prev, x_last, point_of, pt_idx


def _write_evaluations(t, cs, ev, x, omega, n, nperm, x_next, x_prev, x_last):
    """Phase 5's transcript writes, in halo2's order; ``ev(poly, point)``."""
    for col, rot_i in cs.advice_queries:
        t.write_scalar(ev(("advice", col), x * F.fr_pow(omega, rot_i % n) % P))
    for col, rot_i in cs.fixed_queries:
        t.write_scalar(ev(("fixed", col), x * F.fr_pow(omega, rot_i % n) % P))
    t.write_scalar(ev(("random",), x))
    for i in range(len(cs.permutation_columns)):
        t.write_scalar(ev(("sigma", i), x))
    for s in range(nperm):
        t.write_scalar(ev(("perm_z", s), x))
        t.write_scalar(ev(("perm_z", s), x_next))
        if s < nperm - 1:
            t.write_scalar(ev(("perm_z", s), x_last))
    for li in range(len(cs.lookups)):
        t.write_scalar(ev(("lookup_z", li), x))
        t.write_scalar(ev(("lookup_z", li), x_next))
        t.write_scalar(ev(("lookup_a", li), x))
        t.write_scalar(ev(("lookup_a", li), x_prev))
        t.write_scalar(ev(("lookup_s", li), x))


def _set_interpolations(sets, point_of, ev, zeta_pows, max_rots):
    """Per rotation set: the zeta-combined evaluations of its polys at its
    points, and the coefficients of their interpolant r_j (padded)."""
    set_evals = []
    r_rows = []
    for rots, polys in sets:
        pts_j = [point_of[r] for r in rots]
        evals = [0] * len(rots)
        for i, poly in enumerate(polys):
            for ri, r in enumerate(rots):
                evals[ri] = (evals[ri] + zeta_pows[i] * ev(poly, point_of[r])) % P
        set_evals.append(evals)
        r_coeffs = [0] * len(pts_j)
        for i, (pt, ev_i) in enumerate(zip(pts_j, evals)):
            basis = [1]
            denom = 1
            for jj, other in enumerate(pts_j):
                if jj == i:
                    continue
                basis = [((basis[kk - 1] if kk > 0 else 0)
                          - other * (basis[kk] if kk < len(basis) else 0)) % P
                         for kk in range(len(basis) + 1)]
                denom = denom * (pt - other) % P
            scale = ev_i * F.fr_inv(denom) % P
            for kk, b in enumerate(basis):
                r_coeffs[kk] = (r_coeffs[kk] + scale * b) % P
        r_rows.append(r_coeffs + [0] * (max_rots - len(r_coeffs)))
    return set_evals, r_rows


def _wprime_scalars(sets, point_of, set_evals, nu_pows, mu):
    """W' = L(X)/(X - mu)'s scalars: the per-set coefficients, Z_0(mu) and
    sum_j coeff_j · r_j(mu)."""
    diffs = []
    for rots, _ in sets:
        d = 1
        for r, pt in point_of.items():
            if r not in rots:
                d = d * ((mu - pt) % P) % P
        diffs.append(d)
    diff0_inv = F.fr_inv(diffs[0])
    z0_mu = 1
    for r in sets[0][0]:
        z0_mu = z0_mu * ((mu - point_of[r]) % P) % P
    total_rmu = 0
    coeffs = []
    for j, (rots, _) in enumerate(sets):
        pts_j = [point_of[r] for r in rots]
        r_mu = 0  # r_j(mu), barycentric through the set points
        for i, (pt, ev_i) in enumerate(zip(pts_j, set_evals[j])):
            li = 1
            for jj, other in enumerate(pts_j):
                if jj != i:
                    li = li * ((mu - other) * F.fr_inv((pt - other) % P) % P) % P
            r_mu = (r_mu + ev_i * li) % P
        coeff = nu_pows[j] * (diffs[j] * diff0_inv % P) % P
        total_rmu = (total_rmu + coeff * r_mu) % P
        coeffs.append(coeff)
    return coeffs, z0_mu, total_rmu


def prove_users(params, pk, circuits, config, instances_list, rngs, transcript_cls,
                vk_digest, device) -> list[bytes]:
    """Phases 1-6 for U users at once, one transcript and one rng each.

    Every per-user tensor carries a user axis after the limb axis --
    columns (16, U, B, n), scalars (16, U, k) -- and the columns all users
    share are (16, 1, B, n) views of the per-key cache; each commitment
    batch is one ``msm_commit_dev`` call over every user's columns."""
    U = len(circuits)
    vk = pk.vk
    cs = vk.cs
    n = 1 << vk.k
    omega = vk.omega
    blinders = cs.blinding_factors()
    usable = n - (blinders + 1)
    nperm = num_perm_sets(cs)
    chunk = perm_chunk_len(cs)
    nlk = len(cs.lookups)
    nz = nperm + nlk
    num_h = cs.degree() - 1
    sets = rotation_sets(cs)
    dom = PD.domain(vk.k, cs.degree(), str(torch.device(device)))
    NL = FT.NLIMBS
    clock = _Clock(dom.device)

    def cols(per_user) -> torch.Tensor:
        """Per user, equal-length host columns -> (16, U, B, len)."""
        t = dom.cols_to_device([col for user_cols in per_user for col in user_cols])
        return t.reshape(NL, U, len(per_user[0]), t.shape[-1])

    def scalars(per_user) -> torch.Tensor:
        """Per user, a list of host scalars -> (16, U, k)."""
        t = dom.to_device([v for row in per_user for v in row])
        return t.reshape(NL, U, len(per_user[0]))

    def commit(bases, t, per_user: int):
        """Commit every (16, n) row of ``t``; the points, per user."""
        pts = MSM.msm_commit_dev(bases, t.reshape(NL, -1, n))
        return [pts[u * per_user : (u + 1) * per_user] for u in range(U)]

    def absorb(points_per_user, squeezes: int = 1):
        out = []
        for t, pts in zip(ts, points_per_user):
            for pt in pts:
                t.write_point(pt)
            out.append([t.squeeze_challenge() for _ in range(squeezes)])
        return out

    ts = []
    for instances in instances_list:
        t = transcript_cls()
        t.common_scalar(vk_digest if vk_digest is not None else vk.transcript_repr)
        for col in instances:
            for v in col:
                t.common_scalar(v)
        ts.append(t)

    # ---- phase 1: witness synthesis + advice commitments ------------------
    advice_rows, inst_rows = [], []
    for circuit, instances, rng in zip(circuits, instances_list, rngs):
        asn = Assignment(cs, n, instances)
        circuit.synthesize(config, asn)
        advice = [list(col) for col in asn.advice]
        for col in advice:
            for row in range(usable, n):
                col[row] = rng.next_field()
        advice_rows.append(advice)
        inst_rows.append([list(col) for col in asn.instance])
    advice_dev = cols(advice_rows)
    inst_dev = cols(inst_rows)
    fixed_dev, sigma_dev, st_coeff, st_ext, st_offsets = _static_transform(pk, dom, usable)
    # shared by every user: a size-1 user axis, never a copy
    fixed_dev, sigma_dev, st_coeff, st_ext = (
        a.unsqueeze(1) for a in (fixed_dev, sigma_dev, st_coeff, st_ext))
    thetas = absorb(commit(params.g_lagrange, advice_dev, advice_dev.shape[2]))
    clock.mark("phase1 synth+advice commits")

    # ---- phase 2: permuted lookup columns ---------------------------------
    ph = _phase23_fns(cs, dom, usable, nperm, chunk)
    theta_m = scalars(thetas)
    a_stack = s_stack = ap_stack = sp_stack = None
    if nlk:
        a_stack, s_stack = ph.compress(advice_dev, fixed_dev, inst_dev, theta_m)
        flat = dom.from_device(torch.cat([a_stack, s_stack], dim=2).reshape(NL, -1))
        ap_rows, sp_rows = [], []
        for u, rng in enumerate(rngs):
            base = u * 2 * nlk * n
            a_perms, s_perms = [], []
            for li in range(nlk):
                a_perm, s_perm = _permute_expression_pair(
                    flat[base + li * n : base + (li + 1) * n],
                    flat[base + (nlk + li) * n : base + (nlk + li + 1) * n], usable)
                a_perms.append(a_perm + [rng.next_field() for _ in range(blinders + 1)])
                s_perms.append(s_perm + [rng.next_field() for _ in range(blinders + 1)])
            ap_rows.append(a_perms)
            sp_rows.append(s_perms)
        ap_stack = cols(ap_rows)
        sp_stack = cols(sp_rows)
        # per user, per lookup: A' then S'
        beta_gamma = absorb(commit(params.g_lagrange, torch.stack([ap_stack, sp_stack], dim=3),
                                   2 * nlk), squeezes=2)
    else:
        beta_gamma = absorb([[] for _ in range(U)], squeezes=2)
    clock.mark("phase2 lookup permute+commit")

    # ---- phase 3: grand products + random poly ----------------------------
    beta_m = scalars([[b] for b, _ in beta_gamma])
    gamma_m = scalars([[g] for _, g in beta_gamma])
    lk = (a_stack, s_stack, ap_stack, sp_stack) if nlk else None
    z_stack = ph.grand(advice_dev, fixed_dev, inst_dev, sigma_dev, beta_m, gamma_m, lk)
    # blinding rows splice in on device (same rng draw order as the reference)
    blind = cols([[[rng.next_field() for _ in range(blinders)] for _ in range(nz)]
                  for rng in rngs])
    z_stack = torch.cat([z_stack[..., : usable + 1], blind], dim=-1)
    finish_z = MSM.msm_commit_dev_async(params.g_lagrange, z_stack.reshape(NL, -1, n))
    random_dev = scalars([[rng.next_field() for _ in range(n)] for rng in rngs])  # coefficients
    finish_r = MSM.msm_commit_dev_async(params.g, random_dev.reshape(NL, -1, n))

    # per-proof columns: one batched Lagrange -> coeff -> extended transform,
    # issued before the phase-3 commitments are read back
    group_tensors = [advice_dev, inst_dev, z_stack[:, :, :nperm]]
    group_names = ["advice", "instance", "perm_z"]
    if nlk:
        group_tensors += [z_stack[:, :, nperm:], ap_stack, sp_stack]
        group_names += ["lookup_z", "lookup_a", "lookup_s"]
    offsets = {}
    ptr = 0
    for name, tensor in zip(group_names, group_tensors):
        offsets[name] = ptr
        ptr += tensor.shape[2]
    transform, gates = _split_quotient_fns(cs, dom, dict(offsets), st_offsets, nperm, chunk,
                                           blinders)
    dyn_coeff, dyn_ext = transform(torch.cat(group_tensors, dim=2))
    for name, off in st_offsets.items():  # the split layout: per-proof, then static
        offsets[name] = ptr + off

    zpts, rpts = finish_z(), finish_r()
    ys = absorb([zpts[u * nz : (u + 1) * nz] + [rpts[u]] for u in range(U)])
    clock.mark("phase3 grand products+commits")

    # ---- phase 4: quotient on the extended domain -------------------------
    h_coeff_dev = gates(dyn_ext, st_ext, theta_m, beta_m, gamma_m, scalars(ys))
    xs = [x for (x,) in absorb(commit(params.g, h_coeff_dev[..., : num_h * n], num_h))]
    clock.mark("phase4 quotient+commit")

    # ---- phase 5: evaluations ---------------------------------------------
    opened = [_opening_points(cs, sets, x, omega, n, blinders) for x in xs]
    points = [list(pt_idx) for *_, pt_idx in opened]
    npts = len(points[0])
    if any(len(row) != npts for row in points):
        raise ValueError("opening-point collision")
    xn_m = scalars([[F.fr_pow(F.fr_pow(x, n), i) for i in range(num_h)] for x in xs])
    pts_m = scalars(points)
    p56 = _phase56_fns(dom, offsets, num_h, sets)
    evs_dev, rand_evals, quot_evals, tail_zero = p56.eval_all(
        dyn_coeff, st_coeff, h_coeff_dev, random_dev, xn_m, pts_m)
    if not bool(tail_zero):
        raise ValueError("quotient degree overflow")
    ncols_total = evs_dev.shape[2]
    allv = dom.from_device(torch.cat([evs_dev.reshape(NL, U, -1), rand_evals, quot_evals],
                                     dim=-1).reshape(NL, -1))
    ustride = (ncols_total + 2) * npts

    def evaluator(u):
        pt_idx, base = opened[u][-1], u * ustride

        def ev(poly, point) -> int:
            if poly[0] == "random":
                col = ncols_total
            elif poly[0] == "quotient":
                col = ncols_total + 1
            else:
                col = offsets[poly[0]] + poly[1]
            return allv[base + col * npts + pt_idx[point]]
        return ev

    evs = [evaluator(u) for u in range(U)]
    for t, ev, x, (x_next, x_prev, x_last, _, _) in zip(ts, evs, xs, opened):
        _write_evaluations(t, cs, ev, x, omega, n, nperm, x_next, x_prev, x_last)
    zeta_nu = [(t.squeeze_challenge(), t.squeeze_challenge()) for t in ts]
    clock.mark("phase5 evaluations")

    # ---- phase 6: SHPLONK multiopen ---------------------------------------
    max_polys = max(len(polys) for _, polys in sets)
    max_rots = max(len(rots) for rots, _ in sets)
    zeta_rows = [[pow(zeta, i, P) for i in range(max_polys)] for zeta, _ in zeta_nu]
    nu_rows = [[pow(nu, j, P) for j in range(len(sets))] for _, nu in zeta_nu]
    interp = [_set_interpolations(sets, point_of, ev, zr, max_rots)
              for (*_, point_of, _), ev, zr in zip(opened, evs, zeta_rows)]
    set_pt_idx = {tuple(tuple(pt_idx[point_of[r]] for r in rots) for rots, _ in sets)
                  for _, _, _, point_of, pt_idx in opened}
    if len(set_pt_idx) != 1:
        raise ValueError("set/point structure diverged across users")
    h_x_dev, f_stack = p56.open_w(
        dyn_coeff, st_coeff, h_coeff_dev, random_dev, xn_m, scalars(zeta_rows),
        scalars(nu_rows), cols([r_rows for _, r_rows in interp]), pts_m,
        scalars([[pow(p, -1, P) for p in row] for row in points]), set_pt_idx.pop())
    mus = [mu for (mu,) in absorb(commit(params.g, h_x_dev, 1))]
    clock.mark("phase6a shplonk W")

    wp = [_wprime_scalars(sets, point_of, set_evals, nu_pows, mu)
          for (*_, point_of, _), (set_evals, _), nu_pows, mu in zip(opened, interp, nu_rows, mus)]
    w_prime_dev = p56.open_wprime(
        f_stack, h_x_dev, scalars([c for c, _, _ in wp]), scalars([[z0] for _, z0, _ in wp]),
        scalars([[tr] for _, _, tr in wp]), scalars([[mu] for mu in mus]),
        scalars([[pow(mu, -1, P)] for mu in mus]))
    proofs = []
    for t, (pt,) in zip(ts, commit(params.g, w_prime_dev, 1)):
        t.write_point(pt)
        proofs.append(t.finalize())
    clock.mark("phase6b shplonk W'")
    return proofs


class _Phase23:
    def __init__(self, compress, grand):
        self.compress = compress
        self.grand = grand


class _Phase56:
    def __init__(self, eval_all, open_w, open_wprime):
        self.eval_all = eval_all
        self.open_w = open_w
        self.open_wprime = open_wprime


# The evaluators below take (16, U, B, n) column groups and (16, U, k)
# scalars; a column is read as ``group[:, :, idx]`` -> (16, U, n), and a
# constant (16, 1, 1) or a lane table (16, 1, n) broadcasts over the users.
ND = 3  # axes of one column: limbs, users, lanes


def _expr_ops(dom, column):
    """Evaluation ops for ``Expression.evaluate`` over device tensors;
    ``column(kind, idx, rot)`` resolves a (rotated) column query."""
    return {
        "constant": lambda v: dom.const_dev(v, ND),
        "fixed": lambda q, c, r: column("fixed", c, r),
        "advice": lambda q, c, r: column("advice", c, r),
        "instance": lambda q, c, r: column("instance", c, r),
        "negated": FT.neg_mod,
        "sum": FT.add_mod,
        "product": FT.mont_mul,
        "scaled": lambda a, k: FT.mont_mul(a, dom.const_dev(k, ND)),
        "selector": None,
    }


def _phase23_fns(cs, dom, usable, nperm, chunk):
    """Phase-2/3 evaluators: ``compress`` theta-compresses every lookup's
    input and table expressions; ``grand`` computes every permutation-set
    and lookup grand product (16, U, nperm + nlk, n)."""
    n = dom.n
    omega_pows = dom._lanes(dom.omega_pows, ND)

    def base_cols(advice_dev, fixed_dev, inst_dev):
        groups = {"advice": advice_dev, "fixed": fixed_dev, "instance": inst_dev}
        return lambda kind, idx, r: dom.rotate_base(groups[kind][:, :, idx], r)

    def compress(advice_dev, fixed_dev, inst_dev, theta_m):
        ops = _expr_ops(dom, base_cols(advice_dev, fixed_dev, inst_dev))
        col_shape = (FT.NLIMBS, advice_dev.shape[1], n)

        def one_lookup(exprs):
            acc = None
            for expr in exprs:
                v = expr.evaluate(ops).expand(col_shape)
                acc = v if acc is None else FT.add_mod(FT.mont_mul(acc, theta_m), v)
            return acc

        a_stack = torch.stack([one_lookup(lk.input_exprs) for lk in cs.lookups], dim=2)
        s_stack = torch.stack([one_lookup(lk.table_exprs) for lk in cs.lookups], dim=2)
        return a_stack, s_stack

    def grand(advice_dev, fixed_dev, inst_dev, sigma_dev, beta_m, gamma_m, lk_tensors):
        column = base_cols(advice_dev, fixed_dev, inst_dev)
        one_t = dom.const_dev(1, ND).expand(FT.NLIMBS, advice_dev.shape[1], n)
        active = torch.arange(n, device=dom.device) < usable

        def masked_ratio(numer, denom):
            numer = torch.where(active, numer, one_t)
            denom = torch.where(active, denom, one_t)
            return FT.mont_mul(numer, PD.batch_inv_dev(denom))

        def running_product(ratio, start):
            pre = PD.mont_cumprod(ratio)
            return FT.mont_mul(torch.cat([one_t[..., :1], pre[..., :-1]], dim=-1), start)

        zs = []
        last_z = dom.const_dev(1, ND)  # sets chain: z_s(0) = z_{s-1}(omega^usable)
        col_idx = 0
        for s in range(nperm):
            numer = denom = None
            for col in cs.permutation_columns[s * chunk : (s + 1) * chunk]:
                vals = column(col.kind, col.index, 0)
                bd = FT.mont_mul(beta_m, dom.const_dev(pow(DELTA, col_idx, P), ND))
                nt = FT.add_mod(FT.add_mod(vals, FT.mont_mul(bd, omega_pows)), gamma_m)
                dt = FT.add_mod(FT.add_mod(vals, FT.mont_mul(beta_m, sigma_dev[:, :, col_idx])),
                                gamma_m)
                numer = nt if numer is None else FT.mont_mul(numer, nt)
                denom = dt if denom is None else FT.mont_mul(denom, dt)
                col_idx += 1
            z = running_product(masked_ratio(numer, denom), last_z)
            last_z = z[..., usable : usable + 1]
            zs.append(z)
        if lk_tensors is not None:
            a_stack, s_stack, ap_stack, sp_stack = lk_tensors
            for li in range(len(cs.lookups)):
                numer = FT.mont_mul(FT.add_mod(a_stack[:, :, li], beta_m),
                                    FT.add_mod(s_stack[:, :, li], gamma_m))
                denom = FT.mont_mul(FT.add_mod(ap_stack[:, :, li], beta_m),
                                    FT.add_mod(sp_stack[:, :, li], gamma_m))
                zs.append(running_product(masked_ratio(numer, denom), dom.const_dev(1, ND)))
        return torch.stack(zs, dim=2)

    return _Phase23(compress, grand)


def _gate_terms(cs, dom, ext_slice, theta_m, beta_m, gamma_m, nperm, chunk, blinders):
    """Every quotient-identity tensor (gates, permutation and lookup
    arguments) on the extended coset grid, as labelled terms.
    ``ext_slice(name, idx)`` resolves a column group to its extended form."""
    last_rot = -(blinders + 1)
    one = dom.const_dev(1, ND)
    rot_cache: dict = {}

    def rot(kind, idx, r):
        key = (kind, idx, r)
        if key not in rot_cache:
            base = ext_slice(kind, idx)
            rot_cache[key] = base if r == 0 else dom.rotate_ext(base, r)
        return rot_cache[key]

    ops = _expr_ops(dom, rot)
    l0_ext = ext_slice("special", 0)
    llast_ext = ext_slice("special", 1)
    lactive_ext = ext_slice("special", 2)
    permz_ext = [ext_slice("perm_z", s) for s in range(nperm)]

    terms = []
    for gate in cs.gates:
        for gi, polyexpr in enumerate(gate.polys):
            terms.append((f"gate:{gate.name}:{gi}", polyexpr.evaluate(ops)))

    z0 = permz_ext[0]
    terms.append(("perm:l0", FT.mont_mul(l0_ext, FT.sub_mod(one, z0))))
    zl = permz_ext[-1]
    terms.append(("perm:llast", FT.mont_mul(llast_ext, FT.sub_mod(FT.mont_mul(zl, zl), zl))))
    for s in range(1, nperm):
        prev_last = dom.rotate_ext(permz_ext[s - 1], last_rot)
        terms.append(("perm:cont", FT.mont_mul(l0_ext, FT.sub_mod(permz_ext[s], prev_last))))

    bx = FT.mont_mul(beta_m, dom._lanes(dom.x_ext, ND))
    col_idx = 0
    for s in range(nperm):
        lhs = dom.rotate_ext(permz_ext[s], 1)
        rhs = permz_ext[s]
        for col in cs.permutation_columns[s * chunk : (s + 1) * chunk]:
            vals = rot(col.kind, col.index, 0)
            sig = ext_slice("sigma", col_idx)
            lhs = FT.mont_mul(lhs, FT.add_mod(FT.add_mod(vals, FT.mont_mul(beta_m, sig)), gamma_m))
            dp = dom.const_dev(pow(DELTA, col_idx, P), ND)
            rhs = FT.mont_mul(rhs, FT.add_mod(FT.add_mod(vals, FT.mont_mul(dp, bx)), gamma_m))
            col_idx += 1
        terms.append((f"perm:set{s}", FT.mont_mul(FT.sub_mod(lhs, rhs), lactive_ext)))

    for li, lk in enumerate(cs.lookups):
        z = ext_slice("lookup_z", li)
        a_p = ext_slice("lookup_a", li)
        s_p = ext_slice("lookup_s", li)
        comp = []
        for exprs in (lk.input_exprs, lk.table_exprs):
            acc = None
            for expr in exprs:
                v = expr.evaluate(ops)
                acc = v if acc is None else FT.add_mod(FT.mont_mul(acc, theta_m), v)
            comp.append(acc)
        comp_in, comp_tab = comp
        terms.append(("lookup:l0z", FT.mont_mul(l0_ext, FT.sub_mod(one, z))))
        terms.append(("lookup:llast", FT.mont_mul(llast_ext, FT.sub_mod(FT.mont_mul(z, z), z))))
        lhs = FT.mont_mul(dom.rotate_ext(z, 1),
                          FT.mont_mul(FT.add_mod(a_p, beta_m), FT.add_mod(s_p, gamma_m)))
        rhs = FT.mont_mul(z, FT.mont_mul(FT.add_mod(comp_in, beta_m),
                                         FT.add_mod(comp_tab, gamma_m)))
        terms.append(("lookup:main", FT.mont_mul(lactive_ext, FT.sub_mod(lhs, rhs))))
        diff = FT.sub_mod(a_p, s_p)
        terms.append(("lookup:l0as", FT.mont_mul(l0_ext, diff)))
        a_prev = dom.rotate_ext(a_p, -1)
        terms.append(("lookup:shuffle",
                      FT.mont_mul(lactive_ext, FT.mont_mul(diff, FT.sub_mod(a_p, a_prev)))))
    return terms


def _fold_terms(dom, terms, y_m):
    """y-Horner fold of the identities, vanishing division and the inverse
    extended transform -> h(X) coefficients (16, U, n_ext); ``y_m`` is
    (16, U, 1)."""
    shape = y_m.shape[:-1] + (dom.n_ext,)
    numer = None
    for _, term in terms:
        term = term.expand(shape)
        numer = term if numer is None else FT.add_mod(FT.mont_mul(numer, y_m), term)
    return dom.vanishing_to_coeff(numer)


def transform_cols(dom, lagr):
    """Lagrange -> (coefficient, extended) forms of (16, *batch, n) columns."""
    coeff = dom.lagrange_to_coeff(lagr)
    return coeff, dom.coeff_to_extended(coeff)


def _static_transform(pk, dom, usable):
    """The proof-independent columns (fixed, sigma, L0 / L_last / L_active),
    computed once per proving key and domain and reused by every proof:
    (fixed and sigma in Lagrange form, all of them in coefficient and
    extended form, their offsets in those two)."""
    cached = pk.__dict__.get("_static_transform_cache")
    if cached is not None and cached[0] is dom:
        return cached[1]
    vk = pk.vk
    n = dom.n
    l0_vals = [1] + [0] * (n - 1)
    llast_vals = [0] * n
    llast_vals[usable] = 1
    lactive_vals = [1] * usable + [0] * (n - usable)
    fixed_dev = dom.cols_to_device(vk.fixed_values)
    sigma_dev = dom.cols_to_device(vk.sigma_values)
    special = dom.cols_to_device([l0_vals, llast_vals, lactive_vals])
    st_offsets = {
        "fixed": 0,
        "sigma": fixed_dev.shape[1],
        "special": fixed_dev.shape[1] + sigma_dev.shape[1],
    }
    st_coeff, st_ext = transform_cols(dom, torch.cat([fixed_dev, sigma_dev, special], dim=1))
    out = (fixed_dev, sigma_dev, st_coeff, st_ext, st_offsets)
    pk._static_transform_cache = (dom, out)
    return out


def _split_quotient_fns(cs, dom, dyn_offsets, st_offsets, nperm, chunk, blinders):
    """The quotient phase in two pieces: ``transform(big_dyn)`` (the
    challenge-independent transforms of the per-proof columns, issued before
    the phase-3 commitments are read back) and ``gates(dyn_ext, st_ext,
    theta, beta, gamma, y) -> h_coeff`` once y is known."""

    def gates(dyn_ext, st_ext, theta_m, beta_m, gamma_m, y_m):
        def ext_slice(name, idx):
            if name in st_offsets:
                return st_ext[:, :, st_offsets[name] + idx]
            return dyn_ext[:, :, dyn_offsets[name] + idx]

        terms = _gate_terms(cs, dom, ext_slice, theta_m, beta_m, gamma_m, nperm, chunk, blinders)
        return _fold_terms(dom, terms, y_m)

    return (lambda big_dyn: transform_cols(dom, big_dyn)), gates


def _combine_h(h_coeff, xn_pows, num_h, n):
    """The x^n-combined quotient: sum_i h_i(X)·x^(n·i)."""
    pieces = h_coeff[..., : num_h * n].reshape(h_coeff.shape[:-1] + (num_h, n))
    acc = None
    for i in range(num_h):
        piece = FT.mont_mul(pieces[:, :, i], xn_pows[..., i : i + 1])
        acc = piece if acc is None else FT.add_mod(acc, piece)
    return acc


def _phase56_fns(dom, offsets, num_h, sets):
    """Phase-5/6 evaluators over the split column layout (the per-proof
    ``dyn_coeff`` columns, then the shared ``st_coeff`` ones; ``offsets``
    index that layout). ``eval_all`` evaluates every committed column, the
    random poly and the quotient at every opening point; ``open_w`` builds
    the SHPLONK h(X) with the chained linear divisions; ``open_wprime``
    builds L(X)/(X - mu)."""
    n = dom.n

    def eval_all(dyn_coeff, st_coeff, h_coeff, random_dev, xn_pows, pts_m):
        h_combined = _combine_h(h_coeff, xn_pows, num_h, n)
        evs, rnd, quot = [], [], []
        for i in range(pts_m.shape[-1]):  # one point at a time bounds the temporaries
            pw = PD._powers_dev(pts_m[..., i : i + 1], n)
            cols = [PD.tree_sum_mod(FT.mont_mul(c, pw.unsqueeze(2)))[..., 0]
                    for c in (dyn_coeff, st_coeff)]
            evs.append(torch.cat(cols, dim=-1))
            rnd.append(PD.tree_sum_mod(FT.mont_mul(random_dev, pw))[..., 0])
            quot.append(PD.tree_sum_mod(FT.mont_mul(h_combined, pw))[..., 0])
        tail_zero = (h_coeff[..., num_h * n :] == 0).all()
        return (torch.stack(evs, dim=-1), torch.stack(rnd, dim=-1), torch.stack(quot, dim=-1),
                tail_zero)

    def open_w(dyn_coeff, st_coeff, h_coeff, random_dev, xn_pows, zeta_pows, nu_pows, r_tensor,
               pts_m, ipts_m, set_pt_idx):
        h_combined = _combine_h(h_coeff, xn_pows, num_h, n)
        n_dyn = dyn_coeff.shape[2]

        def poly_coeff(poly):
            if poly[0] == "quotient":
                return h_combined
            if poly[0] == "random":
                return random_dev
            col = offsets[poly[0]] + poly[1]
            return dyn_coeff[:, :, col] if col < n_dyn else st_coeff[:, :, col - n_dyn]

        pw_cache: dict = {}

        def pws(idx):
            if idx not in pw_cache:
                pw_cache[idx] = (PD._powers_dev(pts_m[..., idx : idx + 1], n),
                                 PD._powers_dev(ipts_m[..., idx : idx + 1], n))
            return pw_cache[idx]

        h_x = None
        f_list = []
        for j, (_, polys) in enumerate(sets):
            f = None
            for i, poly in enumerate(polys):
                pc = FT.mont_mul(poly_coeff(poly), zeta_pows[..., i : i + 1])
                f = pc if f is None else FT.add_mod(f, pc)
            f_list.append(f)
            r_pad = torch.nn.functional.pad(r_tensor[:, :, j], (0, n - r_tensor.shape[-1]))
            q = FT.sub_mod(f, r_pad)
            for idx in set_pt_idx[j]:
                q = PD._divide_linear_dev(q, *pws(idx))
            q = FT.mont_mul(q, nu_pows[..., j : j + 1])
            h_x = q if h_x is None else FT.add_mod(h_x, q)
        return h_x, torch.stack(f_list, dim=2)

    def open_wprime(f_stack, h_x, coeffs_m, z0mu_m, totalrmu_m, mu_m, imu_m):
        l_dev = None
        for j in range(len(sets)):
            fc = FT.mont_mul(f_stack[:, :, j], coeffs_m[..., j : j + 1])
            l_dev = fc if l_dev is None else FT.add_mod(l_dev, fc)
        l_dev = FT.sub_mod(l_dev, FT.mont_mul(h_x, z0mu_m))
        l_dev = torch.cat([FT.sub_mod(l_dev[..., :1], totalrmu_m), l_dev[..., 1:]], dim=-1)
        return PD._divide_linear_dev(l_dev, PD._powers_dev(mu_m, n), PD._powers_dev(imu_m, n))

    return _Phase56(eval_all, open_w, open_wprime)
