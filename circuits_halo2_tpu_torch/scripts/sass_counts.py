"""Count the SASS instructions of the kernels' field arithmetic and of K4's
reduction.

    python -m circuits_halo2_tpu_torch.scripts.sass_counts [--roots DIR ...]

Needs the CUDA toolkit (``nvcc`` and ``cuobjdump``), not a card. For each
``--roots`` checkout (default: the one that holds this file), so that two
checkouts compare side by side:

- Probes. A small source is compiled against the checkout's ``csrc/`` with
  the library's flags. Each probe kernel loads its operands from global
  memory, runs one operation and stores the result apart from them; a
  probe that only loads and stores is subtracted. In every checkout: the
  canonical CIOS product and add of ``bn254.cuh`` (K4's), ``pos_pow5`` of
  ``poseidon.cu`` and ``jac_madd`` and ``jac_double`` of ``msm_scan.cu``.
  Where the checkout has ``bn254_fast.cuh``, also its lazy product,
  squaring, two-product sum, add and sub, and one full and one partial
  Poseidon round (``pos_round``). One permutation runs 8 full and 56
  partial rounds, so its count is taken as 8 full + 56 partial.
- K4's probes, where the checkout has ``poseidon_mxu.cu``: one warp
  reduction, taken as the probe of two reductions less the probe of one
  (so the reducer's set-up, the loads of W and any shared-memory copy of
  it, cancels), and ``pow5`` (three products, three reductions). Where the
  checkout has K4's round function (``mxu::perm_round``), also one full and
  one partial round and the permutation. These and ``pow5`` are less the
  set-up: one reduction's probe less the base and one reduction.
- Kernels. The checkout's ``csrc/*.cu`` are compiled the same way and
  every ``__global__`` function's static instruction count is listed (a
  loop body counts once).

Counts are of instructions in the compiled code: ``IMAD`` counts every
``IMAD*`` form (the integer multiply pipe), ``IMMA`` the tensor-core
integer products, ``SHFL`` the warp shuffles, ``shared`` every
shared-memory load, store or atomic (``LDS*``, ``STS*``, ``ATOMS``),
``total`` all instructions.
Prints a table of the probes, then everything as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
ROUNDS_FULL, ROUNDS_PARTIAL = 8, 56

# Each probe loads its operands, runs its body and stores them apart.
PRELUDE = r"""
#define IN(v, k) uint32_t v[8]; for (int w = 0; w < 8; ++w) v[w] = io[(k) * 8 + w + threadIdx.x * 128]
#define OUT(v, k) for (int w = 0; w < 8; ++w) io[(k) * 8 + w + 64 + threadIdx.x * 128] = v[w]
#define PROBE(name, body) extern "C" __global__ void probe_##name(uint32_t* io, int r) { body }
#define IO3(body) IN(a, 0); IN(b, 1); IN(c, 2); body; OUT(a, 0); OUT(b, 1); OUT(c, 2);
#define IO5(body) IN(a, 0); IN(b, 1); IN(c, 2); IN(d, 3); IN(e, 4); body; \
    OUT(a, 0); OUT(b, 1); OUT(c, 2); OUT(d, 3); OUT(e, 4);

PROBE(base, IO3())
"""

PROBES = r"""
#include "poseidon.cu"
#include "msm_scan.cu"
""" + PRELUDE + r"""
PROBE(madd_base, IO5())
PROBE(cios_mul, IO3(bn254::mul<bn254::Fr>(a, a, b)))
PROBE(cios_add, IO3(bn254::add<bn254::Fr>(a, a, b)))
PROBE(pow5, IO3(pos_pow5(a)))
PROBE(madd, IO5(jac_madd(a, b, c, d, e, r & 1)))
PROBE(double, IO3(jac_double(a, b, c, a, b, c)))
"""

LAZY_PROBES = r"""
PROBE(lazy_mul, IO3(bnf::mul<bn254::Fr>(a, a, b)))
PROBE(lazy_sqr, IO3(bnf::sqr<bn254::Fr>(a, a)))
PROBE(lazy_mul2, IO3(bnf::mul2<bn254::Fr>(a, a, POS_MDS[0][0], b, POS_MDS[0][1])))
PROBE(lazy_add, IO3(bnf::add<bn254::Fr>(a, a, b)))
PROBE(lazy_sub, IO3(bnf::sub<bn254::Fr>(a, a, b)))
PROBE(round_full, IO3(pos_round<true>(a, b, POS_RC[r], POS_MDS)))
PROBE(round_partial, IO3(pos_round<false>(a, b, POS_RC[r], POS_MDS)))
"""

# K4's probes are a source of their own: poseidon_mxu.cu shares names with
# poseidon.cu.
MXU_PROBES = r"""
#include "poseidon_mxu.cu"
""" + PRELUDE + r"""
static __device__ void cat16(uint32_t t[16], const uint32_t x[8], const uint32_t y[8]) {
    for (int w = 0; w < 8; ++w) {
        t[w] = x[w];
        t[w + 8] = y[w];
    }
}

PROBE(mxu_reduce1, IO3(MXU_RED; uint32_t t[16]; cat16(t, a, b); red.reduce(a, t)))
PROBE(mxu_reduce2, IO3(MXU_RED; uint32_t t[16]; cat16(t, a, b); red.reduce(a, t);
                       cat16(t, b, a); red.reduce(b, t)))
PROBE(mxu_pow5, IO3(MXU_RED; mxu::pow5(red, a)))
"""

MXU_ROUND_PROBES = r"""
PROBE(mxu_round_full, IO3(MXU_RED; mxu::perm_round<true>(red, a, b, MXU_RC[r], MXU_MDS)))
PROBE(mxu_round_partial, IO3(MXU_RED; mxu::perm_round<false>(red, a, b, MXU_RC[r], MXU_MDS)))
"""

# How a probe gets K4's reducer: in registers, or (the first K4) with W
# copied into shared memory by the block.
MXU_RED_REGISTERS = "#define MXU_RED const RegisterReducer red\n"
MXU_RED_SHARED = ("#define MXU_RED __shared__ MxuShared sh; "
                  "const TensorCoreReducer red = block_reducer(sh)\n")

_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_FUNC = re.compile(r"Function : (\S+)")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if path.exists():
        return str(path)
    raise RuntimeError(f"{name} not found: needs the CUDA toolkit")


def _sass(src: Path, include: Path, out: Path) -> dict[str, Counter]:
    """Compile ``src`` to a cubin and count each function's opcodes."""
    subprocess.run([_tool("nvcc"), *FLAGS, "-I", str(include), "-cubin", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True, timeout=900)
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(out)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    funcs: dict[str, Counter] = {}
    current = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            mangled = re.match(r"_Z(\d+)", name)
            current = name[len(mangled.group(0)):][: int(mangled.group(1))] if mangled else name
            funcs[current] = Counter()
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            funcs[current][m.group(1)] += 1
    return funcs


_KINDS = {"IMAD": ("IMAD",), "IMMA": ("IMMA",), "SHFL": ("SHFL",),
          "shared": ("LDS", "STS", "ATOMS")}  # LDS covers LDSM


def _summary(ops: Counter, base: Counter | None = None) -> dict:
    """Counts of ``ops`` less those of ``base``, by kind."""
    base = base or Counter()

    def count(c: Counter, prefixes) -> int:
        return sum(v for k, v in c.items() if k.startswith(prefixes))

    out = {kind: count(ops, p) - count(base, p) for kind, p in _KINDS.items()}
    out["total"] = sum(ops.values()) - sum(base.values())
    out["other"] = out["total"] - out["IMAD"]
    out["top"] = dict((ops - base).most_common(8))
    return out


def _less(a: dict, b: dict) -> dict:
    """Summary ``a`` less summary ``b``, kind by kind."""
    return {k: a[k] - b[k] for k in a if k != "top"}


def _permutation(full: dict, part: dict) -> dict:
    return {k: ROUNDS_FULL * full[k] + ROUNDS_PARTIAL * part[k] for k in full if k != "top"}


def _probes(funcs: dict[str, Counter]) -> dict[str, Counter]:
    return {k[len("probe_"):]: v for k, v in funcs.items() if k.startswith("probe_")}


def probe_counts(csrc: Path, work: Path) -> dict:
    src = work / "probes.cu"
    lazy = (csrc / "bn254_fast.cuh").exists()
    mxu_src = csrc / "poseidon_mxu.cu"
    mxu = mxu_src.exists()
    src.write_text(PROBES + (LAZY_PROBES if lazy else ""))
    probes = _probes(_sass(src, csrc, work / "probes.cubin"))
    out = {}
    for name, ops in probes.items():
        if name in ("base", "madd_base"):
            continue
        out[name] = _summary(ops, probes["madd_base" if name == "madd" else "base"])
    if lazy:
        out["permutation"] = _permutation(out["round_full"], out["round_partial"])
    if mxu:
        mxu_text = mxu_src.read_text()
        rounds = "perm_round" in mxu_text
        src = work / "probes_mxu.cu"
        src.write_text((MXU_RED_SHARED if "TensorCoreReducer" in mxu_text else MXU_RED_REGISTERS)
                       + MXU_PROBES + (MXU_ROUND_PROBES if rounds else ""))
        probes = _probes(_sass(src, csrc, work / "probes_mxu.cubin"))
        red = _summary(probes["mxu_reduce2"], probes["mxu_reduce1"])
        setup = _less(_summary(probes["mxu_reduce1"], probes["base"]), red)
        out["mxu_reduction"], out["mxu_setup"] = red, setup
        names = ["mxu_pow5"] + (["mxu_round_full", "mxu_round_partial"] if rounds else [])
        for name in names:
            out[name] = _less(_summary(probes[name], probes["base"]), setup)
        if rounds:
            out["mxu_permutation"] = _permutation(out["mxu_round_full"],
                                                  out["mxu_round_partial"])
    return out


def kernel_counts(csrc: Path, work: Path) -> dict:
    out = {}
    for src in sorted(csrc.glob("*.cu")):
        for name, ops in _sass(src, csrc, work / f"{src.stem}.cubin").items():
            out[name] = _summary(ops)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[str(PKG.parent)])
    args = ap.parse_args()
    work = PKG / "_build" / "sass"
    shutil.rmtree(work, ignore_errors=True)
    result = {}
    for i, root in enumerate(args.roots):
        d = work / str(i)
        d.mkdir(parents=True)
        csrc = Path(root).resolve() / "circuits_halo2_tpu_torch" / "csrc"
        result[root] = {"probes": probe_counts(csrc, d), "kernels": kernel_counts(csrc, d)}
        for name, c in result[root]["probes"].items():
            print(f"{root}: {name:18s} IMAD {c['IMAD']:7d}  other {c['other']:7d}  "
                  f"total {c['total']:7d}  IMMA {c['IMMA']:4d}  SHFL {c['SHFL']:4d}  "
                  f"shared {c['shared']:4d}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
