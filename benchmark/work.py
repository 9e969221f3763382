"""The work a kernel's arguments need, the card's peaks, and the least time.

Every roofline share here counts what the operation needs at the port's
public layout, (16, *batch, N) int64 limbs (128 bytes an element): each
input read once (an operand's own elements, not its broadcast) and each
output written once, whatever a kernel reads again. Operations are 32 x 32
-> 64-bit "wide" multiplies, counted for the fewest-multiply field
operations the port has (``csrc/bn254_fast.cuh``), as ``chip_smoke.py``
counts them (copied here so the port cannot move the yardstick).

Peaks. Memory: 3.35 TB/s, the H100 SXM data sheet. Multiplies: the CUDA C++
Programming Guide's table of arithmetic-instruction throughput gives 64
results per clock per multiprocessor for 32-bit integer multiply and
multiply-add at compute capability 9.0; a wide multiply is two of them (the
low and the high half). The rate is that times the card's multiprocessors
(``torch.cuda.get_device_properties``) and its maximum SM clock, read from
``nvidia-smi`` in the run, beside the power limit.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

import numpy as np

BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
IMADS_PER_WIDE = 2
LIMB_FE = 16 * 8  # an element of the int64-limb layout
# a Montgomery reduction 68 wide multiplies (64 word products and 8 quotient
# words, each a low half), so a product 132, a squaring 104, and a
# two-product MDS row s0·m0 + s1·m1 with one reduction 196
MUL, SQR, MUL2 = 132, 104, 196
PERM_WIDE = 72 * (2 * SQR + MUL) + 128 * MUL2  # a permutation: 72 x^5, 64 rounds x 2 MDS rows
# K3 per point: the px and py limbs, the digit and the flag in, three limb outputs
K3_BYTES = 2 * 16 * 8 + 8 + 1 + 3 * 16 * 8


@dataclass
class Card:
    name: str
    sms: int
    max_sm_mhz: float
    power_limit_w: float

    @property
    def wide_per_s(self) -> float:
        return self.sms * IMAD_PER_CLOCK_PER_SM * self.max_sm_mhz * 1e6 / IMADS_PER_WIDE


def card(index: int = 0) -> Card:
    import torch

    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    name, mhz, watts = [s.strip() for s in out.rsplit(",", 2)]
    props = torch.cuda.get_device_properties(index)
    return Card(name, props.multi_processor_count, float(mhz), float(watts))


def least_s(wide: float, nbytes: float, wide_per_s: float) -> tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    ops_s = wide / wide_per_s
    mem_s = nbytes / BYTES_PER_S
    return (ops_s, "operations") if ops_s >= mem_s else (mem_s, "bytes")


def own_elements(x) -> int:
    """Elements of an operand's batch axes, broadcast axes (stride 0) once."""
    return int(np.prod([s for s, st in zip(x.shape[1:], x.stride()[1:]) if st]))


def x0_work(wide_per_element: int, out, *inputs) -> tuple[int, int]:
    """(wide multiplies, bytes) of one X0 call: its multiplies on every
    output element, each input's own limbs read once, the output written once."""
    n = out[0].numel()
    return n * wide_per_element, LIMB_FE * (n + sum(own_elements(x) for x in inputs))


def k3_work(points: int) -> tuple[int, int]:
    """(wide multiplies, bytes) of K3: every input and output once. Its
    bytes bound it: a point needs at most one mixed add (1,340 wide
    multiplies, madd-2007-bl), 0.16 ns at 8.36e12/s, under its 649 bytes'
    0.19 ns at 3.35 TB/s, so its multiplies are not counted."""
    return 0, points * K3_BYTES


def k1_work(length: int, n: int) -> tuple[int, int]:
    """(wide multiplies, bytes) of K1 hashing n messages of ``length``
    elements: ``length`` permutations a message; the messages read and the
    digests written once."""
    return n * length * PERM_WIDE, n * (length + 1) * LIMB_FE
