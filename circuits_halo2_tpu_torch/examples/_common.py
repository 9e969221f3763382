"""What the examples share: the repository's fixture files, their default
output directory and their command-line flags."""

from __future__ import annotations

import argparse
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests"
CSV_DIR = FIXTURES / "fixtures_csv"
PTAU = FIXTURES / "fixtures_ptau_hermez-raw-11"  # k parsed from the "-11" suffix
OUT = Path(__file__).resolve().parent / "_out"  # gitignored
LEVELS, N_CURRENCIES, N_BYTES = 4, 2, 8
K = 11


def parser(description: str) -> argparse.ArgumentParser:
    """``--device`` (the card unless the caller asks for the CPU) and
    ``--out`` (the directory the outputs are written to)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda:0", help="torch device (default cuda:0)")
    p.add_argument("--out", default=str(OUT), help=f"output directory (default {OUT.name}/)")
    return p


def out_dir(args) -> Path:
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    return out
