"""The benchmark's plain reference: Python ints, plain torch, hashlib.

It imports nothing of the port nor of the JAX package, and takes nothing
the program made: it works the Merkle sum tree (``tree.py``), the verifying
key (``keygen.py``, from the circuit's frozen copy and the unsafe setup's
known secret) and each proof's check (``verifier.py``) out again from the
seeded inputs and the configuration. The circuit, constraint system,
transcript, curve and field modules are frozen copies of the port's host
code, so a later change to the port does not move them.
"""
