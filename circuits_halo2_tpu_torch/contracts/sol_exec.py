"""Solidity-subset executor — runs the SHIPPED ``Summa.sol`` source.

The reference executes the real registrar contract on an Anvil devnet for
every hardhat behavior test (`contracts/test/Summa.ts:11-528`); this
module gives the TPU framework the same property without an EVM node: a
recursive-descent parser + tree-walking interpreter for the Solidity
subset the registrar uses (state vars, structs, mappings, dynamic arrays,
modifiers, events, require/revert strings, for/if, delete/push, try-catch
on an external interface call, keccak256(abi.encodePacked(...))).

``SolSummaContract`` adapts the interpreted contract to the same duck
interface as ``contracts/summa_sim.SummaContractSim`` so the behavior
suite and the JSON-RPC transport can drive EITHER — with the .sol source
as the executed artifact, the Python sim is reduced to a cross-check.

This is a semantic executor, not an EVM: uint256 wrap-around, gas, and
ABI re-encoding are out of scope (the generated *verifier* runs as real
Yul with full gas metering in contracts/yul_vm.py; the registrar's state
machine has no arithmetic that can overflow with honest inputs).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable

from ..ops.keccak import keccak256

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>\d+)
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<punct>\+\+|--|&&|\|\||==|!=|<=|>=|=>|[-+*/%<>=!&|^~(){}\[\];,.?:])
  | (?P<ws>\s+)
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(src: str) -> list[str]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"lex error at {src[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("comment", "ws"):
            continue
        out.append(m.group())
    return out


class SolRevert(ValueError):
    """Revert with a reason string (require/revert)."""


_ELEM_TYPES = {
    "uint256", "uint16", "uint8", "uint", "bytes32", "bytes", "string",
    "address", "bool",
}


@dataclass
class _Func:
    name: str
    params: list[tuple[str, str]]     # (type, name)
    modifiers: list[str]
    returns: list[tuple[str, str]]
    body: list
    is_view: bool


@dataclass
class _Modifier:
    name: str
    params: list[tuple[str, str]]
    body: list


# ---------------------------------------------------------------------------
# Parser — contract level + statements + expressions (Pratt-style)
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: list[str]):
        self.t = tokens
        self.i = 0

    def peek(self, k=0):
        return self.t[self.i + k] if self.i + k < len(self.t) else None

    def next(self):
        tok = self.t[self.i]
        self.i += 1
        return tok

    def expect(self, tok):
        got = self.next()
        if got != tok:
            raise SyntaxError(f"expected {tok!r}, got {got!r} near {self.t[self.i-3:self.i+3]}")
        return got

    def accept(self, tok):
        if self.peek() == tok:
            self.next()
            return True
        return False

    # -- contract level -----------------------------------------------------

    def parse_file(self):
        contracts = {}
        interfaces = set()
        while self.peek() is not None:
            tok = self.peek()
            if tok == "pragma":
                while self.next() != ";":
                    pass
            elif tok == "import":
                while self.next() != ";":
                    pass
            elif tok in ("contract", "interface"):
                kind = self.next()
                name = self.next()
                if kind == "interface":
                    interfaces.add(name)
                depth = 0
                body_start = self.i
                self.expect("{")
                depth = 1
                while depth:
                    t = self.next()
                    if t == "{":
                        depth += 1
                    elif t == "}":
                        depth -= 1
                if kind == "contract":
                    sub = _Parser(self.t[body_start + 1 : self.i - 1])
                    contracts[name] = sub.parse_contract_body(interfaces)
            else:
                raise SyntaxError(f"unexpected top-level token {tok!r}")
        return contracts

    def parse_contract_body(self, interfaces):
        item = {
            "structs": {}, "state": [], "events": {}, "modifiers": {},
            "functions": {}, "constructor": None, "interfaces": interfaces,
        }
        while self.peek() is not None:
            tok = self.peek()
            if tok == "struct":
                self.next()
                name = self.next()
                self.expect("{")
                fields = []
                while self.peek() != "}":
                    ftype = self._parse_type()
                    fname = self.next()
                    self.expect(";")
                    fields.append((ftype, fname))
                self.expect("}")
                item["structs"][name] = fields
            elif tok == "event":
                self.next()
                name = self.next()
                self.expect("(")
                params = []
                while self.peek() != ")":
                    ptype = self._parse_type()
                    while self.peek() in ("indexed",):
                        self.next()
                    pname = None
                    if self.peek() not in (",", ")"):
                        pname = self.next()
                    params.append((ptype, pname))
                    if not self.accept(","):
                        break
                self.expect(")")
                self.expect(";")
                item["events"][name] = params
            elif tok == "modifier":
                self.next()
                name = self.next()
                params = []
                if self.accept("("):
                    while self.peek() != ")":
                        ptype = self._parse_type()
                        params.append((ptype, self.next()))
                        if not self.accept(","):
                            break
                    self.expect(")")
                body = self._parse_block()
                item["modifiers"][name] = _Modifier(name, params, body)
            elif tok == "constructor":
                self.next()
                params = self._parse_params()
                while self.peek() != "{":
                    self.next()  # visibility etc.
                body = self._parse_block()
                item["constructor"] = _Func("constructor", params, [], [], body, False)
            elif tok == "function":
                self.next()
                name = self.next()
                params = self._parse_params()
                mods, rets, is_view = [], [], False
                while self.peek() != "{" and self.peek() != ";":
                    t = self.next()
                    if t in ("public", "external", "internal", "private",
                             "payable"):
                        continue
                    if t in ("view", "pure"):
                        is_view = True
                    elif t == "returns":
                        self.expect("(")
                        while self.peek() != ")":
                            rtype = self._parse_type()
                            while self.peek() in ("memory", "storage", "calldata"):
                                self.next()
                            rname = None
                            if self.peek() not in (",", ")"):
                                rname = self.next()
                            rets.append((rtype, rname))
                            if not self.accept(","):
                                break
                        self.expect(")")
                    else:
                        mods.append(t)  # modifier invocation
                if self.peek() == ";":
                    self.next()
                    continue  # unimplemented/abstract
                body = self._parse_block()
                item["functions"][name] = _Func(name, params, mods, rets, body, is_view)
            else:
                # state variable: Type [visibility|immutable...]* name [= expr] ;
                vtype = self._parse_type()
                visibility = []
                while self.peek() in ("public", "private", "internal",
                                      "immutable", "constant"):
                    visibility.append(self.next())
                name = self.next()
                init = None
                if self.accept("="):
                    init = self._parse_expr()
                self.expect(";")
                item["state"].append((vtype, name, init))
        return item

    def _parse_params(self):
        self.expect("(")
        params = []
        while self.peek() != ")":
            ptype = self._parse_type()
            while self.peek() in ("memory", "storage", "calldata"):
                self.next()
            pname = self.next()
            params.append((ptype, pname))
            if not self.accept(","):
                break
        self.expect(")")
        return params

    def _parse_type(self):
        base = self.next()
        if base == "mapping":
            self.expect("(")
            key = self._parse_type()
            self.expect("=>")
            val = self._parse_type()
            self.expect(")")
            base = ("mapping", key, val)
        while self.peek() == "[":
            self.next()
            self.expect("]")
            base = ("array", base)
        return base

    # -- statements ---------------------------------------------------------

    def _parse_block(self):
        self.expect("{")
        stmts = []
        while self.peek() != "}":
            stmts.append(self._parse_stmt())
        self.expect("}")
        return stmts

    def _parse_stmt(self):
        tok = self.peek()
        if tok == "{":
            return ("block", self._parse_block())
        if tok == "require":
            self.next()
            self.expect("(")
            cond = self._parse_expr()
            msg = None
            if self.accept(","):
                msg = self._parse_expr()
            self.expect(")")
            self.expect(";")
            return ("require", cond, msg)
        if tok == "revert":
            self.next()
            self.expect("(")
            msg = self._parse_expr() if self.peek() != ")" else None
            self.expect(")")
            self.expect(";")
            return ("revert", msg)
        if tok == "emit":
            self.next()
            name = self.next()
            args = self._parse_call_args()
            self.expect(";")
            return ("emit", name, args)
        if tok == "delete":
            self.next()
            target = self._parse_expr()
            self.expect(";")
            return ("delete", target)
        if tok == "return":
            self.next()
            val = None if self.peek() == ";" else self._parse_expr()
            self.expect(";")
            return ("return", val)
        if tok == "if":
            self.next()
            self.expect("(")
            cond = self._parse_expr()
            self.expect(")")
            then = self._parse_stmt()
            other = None
            if self.accept("else"):
                other = self._parse_stmt()
            return ("if", cond, then, other)
        if tok == "for":
            self.next()
            self.expect("(")
            init = self._parse_stmt()  # consumes its ';'
            cond = self._parse_expr()
            self.expect(";")
            post = self._parse_simple()
            self.expect(")")
            body = self._parse_stmt()
            return ("for", init, cond, post, body)
        if tok == "try":
            self.next()
            call = self._parse_expr()
            rets = []
            if self.accept("returns"):
                self.expect("(")
                while self.peek() != ")":
                    rtype = self._parse_type()
                    while self.peek() in ("memory", "storage", "calldata"):
                        self.next()
                    rets.append((rtype, self.next()))
                    if not self.accept(","):
                        break
                self.expect(")")
            ok_body = self._parse_block()
            self.expect("catch")
            # optional catch params: catch Error(string memory reason) / catch { }
            if self.peek() != "{":
                while self.peek() != "{":
                    self.next()
            catch_body = self._parse_block()
            return ("try", call, rets, ok_body, catch_body)
        if tok == "_":
            self.next()
            self.expect(";")
            return ("placeholder",)
        # declaration:  Type [memory|storage] name [= expr] ;
        save = self.i
        try:
            vtype = self._parse_type()
            if self.peek() in ("memory", "storage", "calldata"):
                self.next()
            if (isinstance(vtype, tuple) or vtype in _ELEM_TYPES
                    or self.peek() not in ("=", ";", "(", ".", "[")):
                name = self.next()
                if not re.match(r"[A-Za-z_$]", name):
                    raise SyntaxError("not a declaration")
                init = None
                if self.accept("="):
                    init = self._parse_expr()
                self.expect(";")
                return ("declare", vtype, name, init)
            raise SyntaxError("not a declaration")
        except SyntaxError:
            self.i = save
        stmt = self._parse_simple()
        self.expect(";")
        return stmt

    def _parse_simple(self):
        """assignment / increment / bare call, NO trailing ';'."""
        expr = self._parse_expr()
        if self.peek() == "=":
            self.next()
            rhs = self._parse_expr()
            return ("assign", expr, rhs)
        if self.peek() in ("++", "--"):
            op = self.next()
            return ("incdec", expr, op)
        return ("expr", expr)

    # -- expressions (precedence climbing) ----------------------------------

    _BINOPS = [
        ("||",), ("&&",), ("==", "!="), ("<", ">", "<=", ">="),
        ("+", "-"), ("*", "/", "%"),
    ]

    def _parse_expr(self, level=0):
        if level == len(self._BINOPS):
            return self._parse_unary()
        lhs = self._parse_expr(level + 1)
        while self.peek() in self._BINOPS[level]:
            op = self.next()
            rhs = self._parse_expr(level + 1)
            lhs = ("bin", op, lhs, rhs)
        return lhs

    def _parse_unary(self):
        if self.peek() == "!":
            self.next()
            return ("not", self._parse_unary())
        if self.peek() == "-":
            self.next()
            return ("neg", self._parse_unary())
        return self._parse_postfix()

    def _parse_postfix(self):
        expr = self._parse_primary()
        while True:
            if self.peek() == ".":
                self.next()
                member = self.next()
                if self.peek() == "(":
                    args = self._parse_call_args()
                    expr = ("mcall", expr, member, args)
                else:
                    expr = ("member", expr, member)
            elif self.peek() == "[":
                self.next()
                idx = self._parse_expr()
                self.expect("]")
                expr = ("index", expr, idx)
            elif self.peek() == "(":
                args = self._parse_call_args()
                expr = ("call", expr, args)
            else:
                return expr

    def _parse_call_args(self):
        self.expect("(")
        args = []
        while self.peek() != ")":
            args.append(self._parse_expr())
            if not self.accept(","):
                break
        self.expect(")")
        return args

    def _parse_primary(self):
        tok = self.next()
        if tok == "(":
            e = self._parse_expr()
            self.expect(")")
            return e
        if tok.isdigit():
            return ("lit", int(tok))
        if tok.startswith('"'):
            return ("lit", tok[1:-1].replace('\\"', '"'))
        if tok in ("true", "false"):
            return ("lit", tok == "true")
        return ("name", tok)


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class SolContract:
    """An instantiated, interpreted contract."""

    def __init__(self, source: str, name: str,
                 externals: dict[str, Any] | None = None):
        contracts = _Parser(_tokenize(source)).parse_file()
        if name not in contracts:
            raise KeyError(f"contract {name} not in source ({list(contracts)})")
        self.decl = contracts[name]
        self.externals = externals or {}
        self.storage: dict[str, Any] = {}
        self.events: list[tuple] = []

    # -- construction -------------------------------------------------------

    def construct(self, sender: str, *args):
        for vtype, name, init in self.decl["state"]:
            self.storage[name] = self._default(vtype)
            if init is not None:
                self.storage[name] = self._eval(init, {"msg_sender": sender})
        ctor = self.decl["constructor"]
        if ctor:
            env = {"msg_sender": sender}
            for (ptype, pname), val in zip(ctor.params, args):
                env[pname] = val
            self._exec_block(ctor.body, env)
        return self

    def _default(self, vtype):
        if isinstance(vtype, tuple):
            if vtype[0] == "mapping":
                return {}
            if vtype[0] == "array":
                return []
        if vtype in ("uint256", "uint16", "uint8", "uint"):
            return 0
        if vtype == "bool":
            return False
        if vtype in ("string",):
            return ""
        if vtype in ("bytes",):
            return b""
        if vtype == "bytes32":
            return b"\x00" * 32
        if vtype == "address":
            return "0x" + "00" * 20
        if vtype in self.decl["structs"]:
            return {f: self._default(t) for t, f in self.decl["structs"][vtype]}
        return None  # interface/contract reference

    # -- public API ---------------------------------------------------------

    def call(self, fn_name: str, sender: str, *args):
        fn = self.decl["functions"][fn_name]
        env = {"msg_sender": sender}
        for (ptype, pname), val in zip(fn.params, args):
            env[pname] = val
        body = fn.body
        # inline modifiers around the body (each `_;` runs the next layer)
        for mod_name in reversed(fn.modifiers):
            mod = self.decl["modifiers"][mod_name]
            body = self._splice_placeholder(mod.body, body)
        try:
            self._exec_block(body, env)
        except _Return as r:
            return r.value
        return None

    def _splice_placeholder(self, mod_body, inner):
        out = []
        for stmt in mod_body:
            if stmt == ("placeholder",):
                out.append(("block", inner))
            else:
                out.append(stmt)
        return out

    # -- statement execution ------------------------------------------------

    def _exec_block(self, stmts, env):
        for stmt in stmts:
            self._exec(stmt, env)

    def _exec(self, stmt, env):
        op = stmt[0]
        if op == "block":
            self._exec_block(stmt[1], env)
        elif op == "require":
            if not self._eval(stmt[1], env):
                msg = self._eval(stmt[2], env) if stmt[2] is not None else ""
                raise SolRevert(msg)
        elif op == "revert":
            msg = self._eval(stmt[1], env) if stmt[1] is not None else ""
            raise SolRevert(msg)
        elif op == "emit":
            args = [self._eval(a, env) for a in stmt[2]]
            self.events.append((stmt[1], *args))
        elif op == "delete":
            self._assign(stmt[1], None, env, delete=True)
        elif op == "return":
            raise _Return(self._eval(stmt[1], env) if stmt[1] else None)
        elif op == "if":
            if self._eval(stmt[1], env):
                self._exec(stmt[2], env)
            elif stmt[3] is not None:
                self._exec(stmt[3], env)
        elif op == "for":
            _, init, cond, post, body = stmt
            self._exec(init, env)
            while self._eval(cond, env):
                self._exec(body, env)
                self._exec(post, env)
        elif op == "try":
            _, call, rets, ok_body, catch_body = stmt
            try:
                val = self._eval(call, env)
            except Exception:
                self._exec_block(catch_body, env)
            else:
                if rets:
                    env[rets[0][1]] = val
                self._exec_block(ok_body, env)
        elif op == "declare":
            _, vtype, name, init = stmt
            env[name] = (
                self._eval(init, env) if init is not None
                else self._default(vtype)
            )
        elif op == "assign":
            self._assign(stmt[1], self._eval(stmt[2], env), env)
        elif op == "incdec":
            cur = self._eval(stmt[1], env)
            self._assign(stmt[1], cur + (1 if stmt[2] == "++" else -1), env)
        elif op == "expr":
            self._eval(stmt[1], env)
        elif op == "placeholder":
            raise RuntimeError("orphan modifier placeholder")
        else:
            raise RuntimeError(f"unknown stmt {op}")

    # -- lvalues ------------------------------------------------------------

    def _assign(self, target, value, env, delete=False):
        kind = target[0]
        if kind == "name":
            name = target[1]
            container = env if name in env else self.storage
            if delete:
                container[name] = self._default_of_current(container[name])
            else:
                container[name] = value
        elif kind == "member":
            obj = self._eval(target[1], env)
            if delete:
                cur = obj[target[2]]
                obj[target[2]] = self._default_of_current(cur)
            else:
                obj[target[2]] = value
        elif kind == "index":
            obj = self._eval(target[1], env)
            idx = self._eval(target[2], env)
            if delete:
                if isinstance(obj, dict):
                    obj.pop(idx, None)
                else:
                    obj[idx] = self._default_of_current(obj[idx])
            else:
                obj[idx] = value
        else:
            raise RuntimeError(f"bad lvalue {kind}")

    @staticmethod
    def _default_of_current(cur):
        if isinstance(cur, list):
            return []
        if isinstance(cur, dict):
            return {k: SolContract._default_of_current(v) for k, v in cur.items()}
        if isinstance(cur, bool):
            return False
        if isinstance(cur, int):
            return 0
        if isinstance(cur, str):
            return ""
        if isinstance(cur, bytes):
            return b""
        return None

    # -- expression evaluation ----------------------------------------------

    def _eval(self, expr, env):
        kind = expr[0]
        if kind == "lit":
            return expr[1]
        if kind == "name":
            name = expr[1]
            if name in env:
                return env[name]
            if name in self.storage:
                return self.storage[name]
            if name == "msg":
                return {"sender": env.get("msg_sender")}
            raise NameError(name)
        if kind == "bin":
            op = expr[1]
            if op == "&&":
                return bool(self._eval(expr[2], env)) and bool(self._eval(expr[3], env))
            if op == "||":
                return bool(self._eval(expr[2], env)) or bool(self._eval(expr[3], env))
            a = self._eval(expr[2], env)
            b = self._eval(expr[3], env)
            return {
                "==": lambda: a == b, "!=": lambda: a != b,
                "<": lambda: a < b, ">": lambda: a > b,
                "<=": lambda: a <= b, ">=": lambda: a >= b,
                "+": lambda: a + b, "-": lambda: a - b,
                "*": lambda: a * b, "/": lambda: a // b,
                "%": lambda: a % b,
            }[op]()
        if kind == "not":
            return not self._eval(expr[1], env)
        if kind == "neg":
            return -self._eval(expr[1], env)
        if kind == "member":
            base = self._eval(expr[1], env)
            member = expr[2]
            if member == "length":
                return len(base)
            if member == "sender" and isinstance(base, dict) and "sender" in base:
                return base["sender"]
            return base[member]
        if kind == "index":
            base_expr = expr[1]
            idx = self._eval(expr[2], env)
            base = self._eval(base_expr, env)
            if isinstance(base, dict):  # mapping: auto-default on miss
                if idx not in base:
                    base[idx] = self._mapping_default(base_expr)
                return base[idx]
            return base[idx]
        if kind == "mcall":
            obj_expr, member, arg_exprs = expr[1], expr[2], expr[3]
            args = [self._eval(a, env) for a in arg_exprs]
            # array.push(x)
            if member == "push":
                arr = self._eval(obj_expr, env)
                arr.append(args[0] if args else None)
                return None
            # abi.encodePacked(...)
            if obj_expr == ("name", "abi") and member == "encodePacked":
                out = b""
                for a in args:
                    out += a.encode("utf-8") if isinstance(a, str) else bytes(a)
                return out
            # external interface call → injected python callable
            obj = self._eval(obj_expr, env)
            if callable(obj):
                return obj(member, *args)
            if isinstance(obj, dict) and callable(obj.get(member)):
                return obj[member](*args)
            raise RuntimeError(f"cannot call {member} on {obj!r}")
        if kind == "call":
            callee, arg_exprs = expr[1], expr[2]
            args = [self._eval(a, env) for a in arg_exprs]
            if callee == ("name", "keccak256"):
                return keccak256(args[0])
            if callee[0] == "name":
                name = callee[1]
                if name in ("bytes", "bytes32", "uint256", "uint16", "uint8",
                            "address", "string"):
                    v = args[0]
                    if name == "bytes" and isinstance(v, str):
                        return v.encode("utf-8")
                    return v
                if name in self.decl["structs"]:
                    fields = self.decl["structs"][name]
                    return {f: v for (t, f), v in zip(fields, args)}
                if name in self.decl["interfaces"]:
                    return args[0]  # interface cast
                if name in self.decl["functions"]:
                    return self.call(name, env.get("msg_sender"), *args)
            raise RuntimeError(f"cannot evaluate call {callee}")
        raise RuntimeError(f"unknown expr {kind}")

    def _mapping_default(self, base_expr):
        """Default value for a missing mapping key, from the declared type."""
        if base_expr[0] == "name":
            for vtype, name, _ in self.decl["state"]:
                if name == base_expr[1] and isinstance(vtype, tuple) \
                        and vtype[0] == "mapping":
                    return self._default(vtype[2])
        return 0


# ---------------------------------------------------------------------------
# Summa adapter — duck-compatible with contracts/summa_sim.SummaContractSim
# ---------------------------------------------------------------------------


class SolSummaContract:
    """The shipped Summa.sol, interpreted — same interface as the sim."""

    def __init__(self, verifier: Callable, mst_levels: int,
                 currencies_count: int, balance_byte_range: int,
                 owner: str = "0xowner", source_path: str | None = None,
                 source_text: str | None = None):
        import os

        from .summa_sim import AddressOwnershipProof, Commitment, Cryptocurrency

        self._AOP = AddressOwnershipProof
        self._Cmt = Commitment
        self._Cur = Cryptocurrency
        if source_text is not None:
            src = source_text
        else:
            if source_path is None:
                source_path = os.path.join(
                    os.path.dirname(os.path.abspath(__file__)), "solidity", "Summa.sol"
                )
            src = open(source_path).read()

        def _verifier_iface(method, *args):
            assert method == "verifyProof", method
            return bool(verifier(args[0], args[1]))

        self.c = SolContract(src, "Summa")
        self.c.construct(owner, _verifier_iface, mst_levels,
                         currencies_count, balance_byte_range)
        self.owner = owner
        self.verifier = verifier

    # -- sim-compatible surface --------------------------------------------

    @property
    def config(self):
        cfg = self.c.storage["config"]
        return (cfg["mstLevels"], cfg["currenciesCount"], cfg["balanceByteRange"])

    @property
    def events(self):
        out = []
        for name, *args in self.c.events:
            if name == "AddressOwnershipProofSubmitted":
                out.append((name, [self._aop(p) for p in args[0]]))
            elif name == "LiabilitiesCommitmentSubmitted":
                ts, root, balances, _cryptos = args
                out.append((name, ts, root, list(balances)))
            else:
                out.append((name, *args))
        return out

    @property
    def address_ownership_proofs(self):
        return [self._aop(p) for p in self.c.storage["addressOwnershipProofs"]]

    @property
    def commitments(self):
        out = {}
        for ts, c in self.c.storage["commitments"].items():
            if c["mstRoot"] == 0:
                continue
            out[ts] = self._Cmt(
                c["mstRoot"], list(c["rootBalances"]),
                [self._Cur(x["name"], x["chain"]) for x in c["cryptocurrencies"]],
                ts,
            )
        return out

    def _aop(self, p: dict):
        return self._AOP(p["cexAddress"], p["chain"], p["signature"], p["message"])

    def _raw_proof(self, proof):
        return {
            "cexAddress": proof.cex_address, "chain": proof.chain,
            "signature": proof.signature, "message": proof.message,
        }

    def submit_proof_of_address_ownership(self, sender, proofs):
        try:
            self.c.call("submitProofOfAddressOwnership", sender,
                        [self._raw_proof(p) for p in proofs])
        except SolRevert as e:
            if "Ownable" in str(e):
                raise PermissionError(str(e)) from None
            raise ValueError(str(e)) from None

    def get_address_ownership_proof(self, address_hash: bytes):
        try:
            raw = self.c.call("getAddressOwnershipProof", self.owner, address_hash)
        except SolRevert as e:
            raise ValueError(str(e)) from None
        return self._aop(raw)

    def submit_commitment(self, sender, mst_root, root_balances,
                          cryptocurrencies, timestamp):
        try:
            self.c.call(
                "submitCommitment", sender, mst_root, list(root_balances),
                [{"name": c.name, "chain": c.chain} for c in cryptocurrencies],
                timestamp,
            )
        except SolRevert as e:
            if "Ownable" in str(e):
                raise PermissionError(str(e)) from None
            raise ValueError(str(e)) from None

    def verify_inclusion_proof(self, proof, public_inputs, timestamp):
        try:
            return bool(self.c.call(
                "verifyInclusionProof", self.owner, bytes(proof),
                list(public_inputs), timestamp,
            ))
        except SolRevert as e:
            raise ValueError(str(e)) from None
        except IndexError:
            raise ValueError("out-of-bounds") from None
