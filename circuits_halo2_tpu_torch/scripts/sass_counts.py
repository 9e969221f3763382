"""Count the SASS instructions of K1's, K2's and K3's field arithmetic.

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
- Kernels. The checkout's ``csrc/*.cu`` are compiled the same way and
  every ``__global__`` function's static instruction count is listed (a
  loop body counts once).

Counts are of instructions in the compiled code: ``IMAD`` counts every
``IMAD*`` form (the integer multiply pipe), ``total`` all instructions.
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

PROBES = r"""
#include "poseidon.cu"
#include "msm_scan.cu"

#define IN(v, k) uint32_t v[8]; for (int w = 0; w < 8; ++w) v[w] = io[(k) * 8 + w + threadIdx.x * 128]
#define OUT(v, k) for (int w = 0; w < 8; ++w) io[(k) * 8 + w + 64 + threadIdx.x * 128] = v[w]
#define PROBE(name, body) extern "C" __global__ void probe_##name(uint32_t* io, int r) { body }
#define IO3(body) IN(a, 0); IN(b, 1); IN(c, 2); body; OUT(a, 0); OUT(b, 1); OUT(c, 2);
#define IO5(body) IN(a, 0); IN(b, 1); IN(c, 2); IN(d, 3); IN(e, 4); body; \
    OUT(a, 0); OUT(b, 1); OUT(c, 2); OUT(d, 3); OUT(e, 4);

PROBE(base, IO3())
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


def _summary(ops: Counter, base: Counter | None = None) -> dict:
    """IMAD and total counts of ``ops`` less those of ``base``."""
    base = base or Counter()
    imad = sum(v for k, v in ops.items() if k.startswith("IMAD")) - sum(
        v for k, v in base.items() if k.startswith("IMAD"))
    total = sum(ops.values()) - sum(base.values())
    return {"IMAD": imad, "other": total - imad, "total": total,
            "top": dict((ops - base).most_common(8))}


def probe_counts(csrc: Path, work: Path) -> dict:
    src = work / "probes.cu"
    lazy = (csrc / "bn254_fast.cuh").exists()
    src.write_text(PROBES + (LAZY_PROBES if lazy else ""))
    funcs = _sass(src, csrc, work / "probes.cubin")
    probes = {k[len("probe_"):]: v for k, v in funcs.items() if k.startswith("probe_")}
    out = {}
    for name, ops in probes.items():
        if name in ("base", "madd_base"):
            continue
        out[name] = _summary(ops, probes["madd_base" if name == "madd" else "base"])
    if lazy:
        full, part = out["round_full"], out["round_partial"]
        out["permutation"] = {key: ROUNDS_FULL * full[key] + ROUNDS_PARTIAL * part[key]
                              for key in ("IMAD", "other", "total")}
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
            print(f"{root}: {name:16s} IMAD {c['IMAD']:7d}  other {c['other']:7d}  "
                  f"total {c['total']:7d}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
