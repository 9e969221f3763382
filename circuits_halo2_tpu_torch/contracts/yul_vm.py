"""Minimal Yul/EVM-assembly interpreter for verifier contracts.

Stands in for the reference's in-process revm harness
(`zk_prover/examples/gen_inclusion_proof.rs:87-92` deploys the generated
verifier into an embedded EVM and calls ``verifyProof``). This interpreter
executes the ``assembly { ... }`` block of a generated verifier directly:
word-addressed memory, calldata, keccak256, modular arithmetic opcodes and
the four precompiles the verifier uses (modexp 0x05, ecadd 0x06, ecmul
0x07, pairing 0x08 — backed by the framework's own curve/pairing ops).

This lets tests run the *reference-generated* InclusionVerifier.sol against
proofs produced by this framework — EVM-level behavioral parity without an
EVM node.
"""

from __future__ import annotations

import re

from ..ops import curve as C
from ..ops import pairing as PAIR
from ..ops.keccak import keccak256

WORD = (1 << 256) - 1


class Revert(Exception):
    pass


class Return(Exception):
    def __init__(self, data: bytes):
        self.data = data


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$.]*)
  | (?P<assign>:=)
  | (?P<arrow>->)
  | (?P<punct>[(){},])
    """,
    re.VERBOSE | re.DOTALL,
)


def tokenize(src: str) -> list[str]:
    tokens = []
    for m in _TOKEN_RE.finditer(src):
        if m.lastgroup == "comment":
            continue
        tokens.append(m.group())
    return tokens


class Parser:
    def __init__(self, tokens: list[str]):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self):
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def expect(self, tok):
        got = self.next()
        assert got == tok, f"expected {tok!r}, got {got!r} at {self.pos}"

    def parse_block(self):
        self.expect("{")
        stmts = []
        while self.peek() != "}":
            stmts.append(self.parse_statement())
        self.expect("}")
        return ("block", stmts)

    def parse_statement(self):
        tok = self.peek()
        if tok == "{":
            return self.parse_block()
        if tok == "let":
            self.next()
            names = [self.next()]
            while self.peek() == ",":
                self.next()
                names.append(self.next())
            if self.peek() == ":=":
                self.next()
                value = self.parse_expr()
                return ("let", names, value)
            return ("let", names, None)
        if tok == "if":
            self.next()
            cond = self.parse_expr()
            body = self.parse_block()
            return ("if", cond, body)
        if tok == "for":
            self.next()
            init = self.parse_block()
            cond = self.parse_expr()
            post = self.parse_block()
            body = self.parse_block()
            return ("for", init, cond, post, body)
        if tok == "function":
            self.next()
            name = self.next()
            self.expect("(")
            params = []
            while self.peek() != ")":
                params.append(self.next())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            rets = []
            if self.peek() == "->":
                self.next()
                rets.append(self.next())
                while self.peek() == ",":
                    self.next()
                    rets.append(self.next())
            body = self.parse_block()
            return ("function", name, params, rets, body)
        if tok in ("break", "continue", "leave"):
            self.next()
            return (tok,)
        # assignment or expression statement
        save = self.pos
        first = self.next()
        if self.peek() in (":=", ","):
            names = [first]
            while self.peek() == ",":
                self.next()
                names.append(self.next())
            self.expect(":=")
            value = self.parse_expr()
            return ("assign", names, value)
        self.pos = save
        return ("expr", self.parse_expr())

    def parse_expr(self):
        tok = self.next()
        if tok.startswith("0x"):
            return ("const", int(tok, 16))
        if tok.isdigit():
            return ("const", int(tok))
        if self.peek() == "(":
            self.next()
            args = []
            while self.peek() != ")":
                args.append(self.parse_expr())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            return ("call", tok, args)
        return ("var", tok)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Leave(Exception):
    pass


# Per-builtin EVM gas schedule (Shanghai). Stack traffic (PUSH/DUP/SWAP) is
# approximated by charging GAS_VERYLOW for every const/var operand evaluation
# — an AST interpreter cannot see the compiler's exact stack schedule, but
# the approximation is applied identically to every contract run in this VM,
# so RELATIVE comparisons (our generated verifier vs the reference-generated
# one on the same proof) are meaningful; absolute figures are estimates.
GAS_VERYLOW = 3
GAS_LOW = 5
GAS_MID = 8
_GAS_TABLE = {
    "add": 3, "sub": 3, "lt": 3, "gt": 3, "slt": 3, "sgt": 3, "eq": 3,
    "and": 3, "or": 3, "xor": 3, "not": 3, "shl": 3, "shr": 3, "sar": 3,
    "byte": 3, "iszero": 3, "pop": 2, "calldataload": 3,
    "mul": 5, "div": 5, "sdiv": 5, "mod": 5, "smod": 5, "signextend": 5,
    "addmod": 8, "mulmod": 8, "jump": 8,
    "mload": 3, "mstore": 3, "mstore8": 3,
    "gas": 2, "callvalue": 2, "calldatasize": 2, "returndatasize": 2,
}


class YulVM:
    def __init__(self, calldata: bytes, constants: dict | None = None):
        self.calldata = calldata
        self.memory = bytearray(1 << 16)
        self.functions: dict[str, tuple] = {}
        self.constants = dict(constants or {})
        self.gas_used = 0
        self._mem_words = 0

    # -- gas ------------------------------------------------------------

    def _touch(self, end: int) -> None:
        """Charge quadratic memory-expansion gas up to byte offset ``end``."""
        words = (end + 31) // 32
        if words > self._mem_words:
            new = 3 * words + words * words // 512
            old = 3 * self._mem_words + self._mem_words * self._mem_words // 512
            self.gas_used += new - old
            self._mem_words = words

    # -- memory helpers -----------------------------------------------------

    def mload(self, ofs: int) -> int:
        self._grow(ofs + 32)
        self._touch(ofs + 32)
        return int.from_bytes(self.memory[ofs : ofs + 32], "big")

    def mstore(self, ofs: int, value: int):
        self._grow(ofs + 32)
        self._touch(ofs + 32)
        self.memory[ofs : ofs + 32] = (value & WORD).to_bytes(32, "big")

    def _grow(self, size: int):
        if size > len(self.memory):
            self.memory.extend(b"\x00" * (size - len(self.memory)))

    def calldataload(self, ofs: int) -> int:
        chunk = self.calldata[ofs : ofs + 32]
        return int.from_bytes(chunk.ljust(32, b"\x00"), "big")

    # -- precompiles --------------------------------------------------------

    def _precompile_gas(self, addr: int, data: bytes, in_size: int) -> int:
        if addr == 0x05:  # modexp, EIP-2565
            blen = int.from_bytes(data[0:32], "big")
            elen = int.from_bytes(data[32:64], "big")
            mlen = int.from_bytes(data[64:96], "big")
            words = (max(blen, mlen) + 7) // 8
            mult = words * words
            exp_head = int.from_bytes(data[96 + blen : 96 + blen + min(32, elen)], "big")
            iters = max(1, (8 * max(0, elen - 32)) + max(0, exp_head.bit_length() - 1))
            return max(200, mult * iters // 3)
        if addr == 0x06:
            return 150  # ecadd (EIP-1108)
        if addr == 0x07:
            return 6000  # ecmul
        if addr == 0x08:
            return 45000 + 34000 * (in_size // 192)  # pairing
        return 0

    def staticcall(self, addr, in_ofs, in_size, out_ofs, out_size) -> int:
        self._touch(in_ofs + in_size)
        self._touch(out_ofs + out_size)
        self.gas_used += 100  # warm account access (EIP-2929)
        data = bytes(self.memory[in_ofs : in_ofs + in_size])
        self.gas_used += self._precompile_gas(addr, data, in_size)
        if addr == 0x05:  # modexp
            blen = int.from_bytes(data[0:32], "big")
            elen = int.from_bytes(data[32:64], "big")
            mlen = int.from_bytes(data[64:96], "big")
            base = int.from_bytes(data[96 : 96 + blen], "big")
            exp = int.from_bytes(data[96 + blen : 96 + blen + elen], "big")
            mod = int.from_bytes(
                data[96 + blen + elen : 96 + blen + elen + mlen], "big"
            )
            out = pow(base, exp, mod) if mod else 0
            result = out.to_bytes(mlen, "big")
        elif addr == 0x06:  # ecadd
            p1 = self._point(data[0:64])
            p2 = self._point(data[64:128])
            s = C.g1_add(p1, p2)
            result = self._enc_point(s)
        elif addr == 0x07:  # ecmul
            p1 = self._point(data[0:64])
            k = int.from_bytes(data[64:96], "big")
            s = C.g1_mul(p1, k) if p1 else None
            result = self._enc_point(s)
        elif addr == 0x08:  # pairing
            assert in_size % 192 == 0
            pairs = []
            for i in range(in_size // 192):
                chunk = data[i * 192 : (i + 1) * 192]
                g1 = self._point(chunk[0:64])
                x1 = int.from_bytes(chunk[64:96], "big")
                x0 = int.from_bytes(chunk[96:128], "big")
                y1 = int.from_bytes(chunk[128:160], "big")
                y0 = int.from_bytes(chunk[160:192], "big")
                g2 = None if (x0 | x1 | y0 | y1) == 0 else ((x0, x1), (y0, y1))
                if g1 is not None and g2 is not None:
                    pairs.append((g1, g2))
            ok = PAIR.pairing_check(pairs)
            result = (1 if ok else 0).to_bytes(32, "big")
        else:
            return 0
        self._grow(out_ofs + out_size)
        self.memory[out_ofs : out_ofs + out_size] = result[:out_size]
        return 1

    @staticmethod
    def _point(data: bytes):
        x = int.from_bytes(data[0:32], "big")
        y = int.from_bytes(data[32:64], "big")
        return None if x == 0 and y == 0 else (x, y)

    @staticmethod
    def _enc_point(p) -> bytes:
        if p is None:
            return b"\x00" * 64
        return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")

    # -- interpreter --------------------------------------------------------

    def run(self, block, env: dict | None = None):
        env = env or {}
        # hoist function definitions
        self._hoist(block)
        try:
            self.exec_block(block, env)
        except Return as r:
            return r.data
        return b""

    def _hoist(self, block):
        for stmt in block[1]:
            if stmt[0] == "function":
                self.functions[stmt[1]] = stmt
            elif stmt[0] == "block":
                self._hoist(stmt)

    def exec_block(self, block, env):
        for stmt in block[1]:
            self.exec_stmt(stmt, env)

    def exec_stmt(self, stmt, env):
        kind = stmt[0]
        if kind == "block":
            self.exec_block(stmt, env)
        elif kind == "let":
            _, names, value = stmt
            if value is None:
                for n in names:
                    env[n] = 0
            else:
                vals = self.eval_multi(value, env, len(names))
                for n, v in zip(names, vals):
                    env[n] = v
        elif kind == "assign":
            _, names, value = stmt
            vals = self.eval_multi(value, env, len(names))
            for n, v in zip(names, vals):
                env[n] = v
        elif kind == "if":
            if self.eval(stmt[1], env):
                self.exec_block(stmt[2], env)
        elif kind == "for":
            _, init, cond, post, body = stmt
            scope = dict(env)
            self.exec_block(init, scope)
            while self.eval(cond, scope):
                try:
                    self.exec_block(body, scope)
                except _Break:
                    break
                except _Continue:
                    pass
                self.exec_block(post, scope)
            # propagate updates of pre-existing names
            for k in env:
                if k in scope:
                    env[k] = scope[k]
        elif kind == "function":
            self.functions[stmt[1]] = stmt
        elif kind == "expr":
            self.eval(stmt[1], env)
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()
        elif kind == "leave":
            raise _Leave()
        else:
            raise ValueError(kind)

    def eval_multi(self, expr, env, n):
        v = self.eval(expr, env, multi=n > 1)
        if n == 1:
            return [v]
        assert isinstance(v, tuple) and len(v) == n, (expr, v)
        return list(v)

    def eval(self, expr, env, multi=False):
        kind = expr[0]
        if kind == "const":
            self.gas_used += GAS_VERYLOW  # PUSH
            return expr[1]
        if kind == "var":
            self.gas_used += GAS_VERYLOW  # DUP/SWAP traffic
            if expr[1] == "true":
                return 1
            if expr[1] == "false":
                return 0
            return env[expr[1]]
        _, name, args = expr
        a = [self.eval(x, env) for x in args]
        return self.call(name, a, multi)

    def call(self, name, a, multi=False):
        M = WORD
        self.gas_used += _GAS_TABLE.get(name, 0)
        if name == "add":
            return (a[0] + a[1]) & M
        if name == "sub":
            return (a[0] - a[1]) & M
        if name == "mul":
            return (a[0] * a[1]) & M
        if name == "div":
            return a[0] // a[1] if a[1] else 0
        if name == "mod":
            return a[0] % a[1] if a[1] else 0
        if name == "addmod":
            return (a[0] + a[1]) % a[2]
        if name == "mulmod":
            return (a[0] * a[1]) % a[2]
        if name == "lt":
            return 1 if a[0] < a[1] else 0
        if name == "gt":
            return 1 if a[0] > a[1] else 0
        if name == "eq":
            return 1 if a[0] == a[1] else 0
        if name == "iszero":
            return 1 if a[0] == 0 else 0
        if name == "and":
            return a[0] & a[1]
        if name == "or":
            return a[0] | a[1]
        if name == "xor":
            return a[0] ^ a[1]
        if name == "not":
            return a[0] ^ M
        if name == "shl":
            return (a[1] << a[0]) & M
        if name == "shr":
            return a[1] >> a[0]
        if name == "mload":
            return self.mload(a[0])
        if name == "mstore":
            self.mstore(a[0], a[1])
            return None
        if name == "mstore8":
            self._grow(a[0] + 1)
            self._touch(a[0] + 1)
            self.memory[a[0]] = a[1] & 0xFF
            return None
        if name == "calldataload":
            return self.calldataload(a[0])
        if name == "keccak256":
            self._grow(a[0] + a[1])
            self._touch(a[0] + a[1])
            self.gas_used += 30 + 6 * ((a[1] + 31) // 32)
            return int.from_bytes(
                keccak256(bytes(self.memory[a[0] : a[0] + a[1]])), "big"
            )
        if name == "staticcall":
            return self.staticcall(a[1], a[2], a[3], a[4], a[5])
        if name == "gas":
            return 10**9
        if name == "pop":
            return None
        if name == "revert":
            raise Revert()
        if name == "return":
            raise Return(bytes(self.memory[a[0] : a[0] + a[1]]))
        if name in self.functions:
            self.gas_used += 2 * GAS_MID + 1  # JUMP in/out + JUMPDEST
            _, _, params, rets, body = self.functions[name]
            scope = dict(self.constants)
            scope.update({p: v for p, v in zip(params, a)})
            for r in rets:
                scope[r] = 0
            try:
                self.exec_block(body, scope)
            except _Leave:
                pass
            out = tuple(scope[r] for r in rets)
            if not rets:
                return None
            if len(rets) == 1:
                return out[0]
            return out
        raise ValueError(f"unknown builtin {name}")


# ---------------------------------------------------------------------------
# Contract driver
# ---------------------------------------------------------------------------

def extract_assembly(sol_source: str) -> str:
    """Pull the body of the (single) assembly block out of a contract."""
    idx = sol_source.index("assembly {")
    start = sol_source.index("{", idx)
    depth = 0
    for i in range(start, len(sol_source)):
        if sol_source[i] == "{":
            depth += 1
        elif sol_source[i] == "}":
            depth -= 1
            if depth == 0:
                return sol_source[start : i + 1]
    raise ValueError("unterminated assembly block")


def encode_verify_calldata(proof: bytes, instances: list[int]) -> bytes:
    """ABI-encode verifyProof(bytes,uint256[]) calldata."""
    selector = keccak256(b"verifyProof(bytes,uint256[])")[:4]
    head = (
        (0x40).to_bytes(32, "big")
        + (0x40 + 32 + len(proof)).to_bytes(32, "big")
    )
    proof_part = len(proof).to_bytes(32, "big") + proof
    inst_part = len(instances).to_bytes(32, "big") + b"".join(
        v.to_bytes(32, "big") for v in instances
    )
    return selector + head + proof_part + inst_part


_CONST_RE = re.compile(
    r"uint256\s+internal\s+constant\s+(\w+)\s*=\s*(0x[0-9a-fA-F]+|\d+)\s*;"
)


def contract_constants(sol_source: str) -> dict[str, int]:
    """Solidity-level constants referenced from the assembly block."""
    return {
        name: int(value, 16) if value.startswith("0x") else int(value)
        for name, value in _CONST_RE.findall(sol_source)
    }


def intrinsic_gas(calldata: bytes) -> int:
    """21000 base + EIP-2028 calldata cost."""
    nz = sum(1 for b in calldata if b)
    return 21000 + 16 * nz + 4 * (len(calldata) - nz)


def run_verifier(
    sol_source: str, proof: bytes, instances: list[int]
) -> bool:
    """Execute a verifier contract's assembly on (proof, instances)."""
    ok, _ = run_verifier_gas(sol_source, proof, instances)
    return ok


def run_verifier_gas(
    sol_source: str, proof: bytes, instances: list[int]
) -> tuple[bool, int]:
    """Like run_verifier, also returning estimated transaction gas
    (intrinsic + execution under the VM's gas model — see _GAS_TABLE note;
    the reference prints the same figure from revm,
    `gen_inclusion_proof.rs:87-92`)."""
    asm = extract_assembly(sol_source)
    tokens = tokenize(asm)
    block = Parser(tokens).parse_block()
    consts = contract_constants(sol_source)
    calldata = encode_verify_calldata(proof, instances)
    vm = YulVM(calldata, constants=consts)
    vm.gas_used += intrinsic_gas(calldata)
    try:
        out = vm.run(block, env=dict(consts))
    except Revert:
        return False, vm.gas_used
    ok = len(out) == 32 and int.from_bytes(out, "big") == 1
    return ok, vm.gas_used


# ---------------------------------------------------------------------------
# Code-size estimation (no solc in this environment)
# ---------------------------------------------------------------------------

def _size_expr(expr) -> int:
    kind = expr[0]
    if kind == "const":
        v = expr[1]
        return 1 + max(1, (v.bit_length() + 7) // 8)  # PUSHn + immediate
    if kind == "var":
        return 1  # DUPn
    _, name, args = expr
    n = sum(_size_expr(a) for a in args)
    return n + (1 if name in _GAS_TABLE else 4)  # builtin op vs call seq


def _size_block(block) -> int:
    assert block[0] == "block"
    return sum(_size_stmt(st) for st in block[1])


def _size_stmt(stmt) -> int:
    kind = stmt[0]
    if kind in ("let", "assign"):
        names = stmt[1]
        val = stmt[2]
        return (
            (_size_expr(val) if val is not None else len(names))
            + len(names)
        )
    if kind == "expr":
        return _size_expr(stmt[1])
    if kind == "if":
        return _size_expr(stmt[1]) + 4 + _size_block(stmt[2])
    if kind == "for":
        return (
            _size_block(stmt[1]) + _size_expr(stmt[2]) + 6
            + _size_block(stmt[3]) + _size_block(stmt[4])
        )
    if kind == "function":
        return 3 + _size_block(stmt[4])  # JUMPDEST + return jump
    if kind == "block":
        return _size_block(stmt)
    if kind in ("break", "continue", "leave"):
        return 4
    return 1


def estimate_code_size(sol_source: str) -> int:
    """Estimated runtime bytecode size of a verifier contract's assembly
    block — a deterministic instruction-count model (PUSH immediates, one
    byte per op, jump sequences for control flow). No solc exists in this
    environment, so absolute accuracy is NOT claimed; the estimator is
    applied identically to our generated verifier and the reference-
    generated one, making relative comparisons meaningful. Reference prints
    the real figure via compile_solidity (gen_inclusion_verifier.rs:39-40).
    """
    asm = extract_assembly(sol_source)
    block = Parser(tokenize(asm)).parse_block()
    return _size_block(block)
