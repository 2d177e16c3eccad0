"""Sparse R1CS builder + gadget library (replaces the reference's CirC stack).

The reference compiles a term DSL through CirC's optimizer into R1CS
(reference src/backend/r1cs.rs:693-727) and re-synthesizes it inside
bellperson (nova.rs:868-1399).  Here constraints are emitted directly: a
linear combination (LC) is a dict {var_index: coeff} (index 0 is the constant
ONE wire), a constraint is (A, B, C) meaning <A,z>*<B,z> = <C,z>, and every
auxiliary variable registers a compute closure so witnesses evaluate in one
ordered pass (replacing CirC's StagedWitCompEvaluator, framework.rs:561-572).

Gadgets: mul/ite/eq-zero/booleans, bit decomposition + range checks, Horner
chains, and an in-circuit SAFE Poseidon sponge whose semantics mirror
ops.poseidon.HostSponge exactly — prover-side Fiat-Shamir and the
in-circuit replay agree by construction (the reference's hard part #1,
r1cs.rs:2260-2310 vs nova.rs:549-681).

Boolean convention: "bool LCs" are LCs guaranteed by construction/constraint
to evaluate to 0/1.  and/or/not compose multiplicatively; assertions are
pushed with `assert_true`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..ops import field as F
from ..ops.poseidon import IOPattern
from ..ops.poseidon_constants import (FULL_ROUNDS, PARTIAL_ROUNDS,
                                      poseidon_params)

LC = Dict[int, int]


class ConstraintList:
    """Ordered constraint store: plain (A,B,C) dict rows interleaved with
    stamped template segments kept SYMBOLIC (template + wire map).

    Iteration materializes every row as dict triples (slow path: tests,
    check_all, to_sparse); the folding layer instead walks `items()` and
    renumbers each segment's packed numpy arrays in one vectorized shot
    (nova.R1CSShape) — per-entry python loops over the ~1M matrix entries
    of the augmented circuit were a top setup cost."""

    __slots__ = ("_items", "_len")

    def __init__(self):
        self._items: list = []      # ("c", a, b, c) | ("s", tpl, m, m_np)
        self._len = 0

    def append(self, abc):
        a, b, c = abc
        self._items.append(("c", a, b, c))
        self._len += 1

    def append_stamp(self, tpl, m: List[int], m_np):
        self._items.append(("s", tpl, m, m_np))
        self._len += len(tpl.constraints)

    def items(self):
        return self._items

    def __len__(self):
        return self._len

    def __getitem__(self, i: int):
        if i < 0:
            i += self._len
        pos = 0
        for it in self._items:
            n = 1 if it[0] == "c" else len(it[1].constraints)
            if i < pos + n:
                if it[0] == "c":
                    return it[1], it[2], it[3]
                _, tpl, m, _m_np = it
                ak, av, bk, bv, ck, cv = tpl.constraints[i - pos]
                return (dict(zip([m[k] for k in ak], av)),
                        dict(zip([m[k] for k in bk], bv)),
                        dict(zip([m[k] for k in ck], cv)))
            pos += n
        raise IndexError(i)

    def __iter__(self):
        for it in self._items:
            if it[0] == "c":
                yield it[1], it[2], it[3]
            else:
                _, tpl, m, _m_np = it
                for ak, av, bk, bv, ck, cv in tpl.constraints:
                    yield (dict(zip([m[k] for k in ak], av)),
                           dict(zip([m[k] for k in bk], bv)),
                           dict(zip([m[k] for k in ck], cv)))


class ComputerList:
    """Ordered witness-computer store; stamped template segments stay
    SYMBOLIC (template + wire map) like ConstraintList.

    Iteration materializes (wire, closure, op-dict) triples for the pure-
    python fallback; the native witness interpreter walks `items()` and
    splices each template's precompiled op block in one vectorized shot
    (ops/native_fieldvec.WitnessProgram)."""

    __slots__ = ("_items", "_len")

    def __init__(self):
        self._items: list = []      # ("c", idx, fn, op) | ("s", tpl, m, m_np, cs)
        self._len = 0

    def append(self, entry):
        idx, fn, op = entry
        self._items.append(("c", idx, fn, op))
        self._len += 1

    def append_stamp(self, tpl, m: List[int], m_np, cs):
        self._items.append(("s", tpl, m, m_np, cs))
        self._len += len(tpl.computers)

    def items(self):
        return self._items

    def __len__(self):
        return self._len

    def __iter__(self):
        for it in self._items:
            if it[0] == "c":
                yield it[1], it[2], it[3]
            else:
                _, tpl, m, _m_np, cs = it
                p = cs.f.p
                for idx, op in tpl.computers:
                    if op[0] == "mul":
                        a = {m[k]: v for k, v in op[1].items()}
                        b = {m[k]: v for k, v in op[2].items()}
                        yield (m[idx],
                               lambda z, a=a, b=b: cs.eval_lc(a, z)
                               * cs.eval_lc(b, z) % p, ("mul", a, b))
                    else:
                        lc = {m[k]: v for k, v in op[1].items()}
                        yield (m[idx],
                               lambda z, lc=lc: cs.eval_lc(lc, z),
                               ("lc", lc))


def lc_const(c: int) -> LC:
    return {0: c} if c else {}


def lc_add(*lcs: LC) -> LC:
    """Merge linear combinations (drops zero coefficients in place — the
    augmented-circuit build issues ~22k of these; a second zero-filter
    pass was ~0.3s of every cold pub_setup)."""
    out: LC = dict(lcs[0]) if lcs else {}
    for lc in lcs[1:]:
        for k, v in lc.items():
            nv = out.get(k, 0) + v
            if nv:
                out[k] = nv
            elif k in out:
                del out[k]
    return out


def lc_scale(lc: LC, c: int) -> LC:
    if c == 0:
        return {}
    return {k: v * c for k, v in lc.items()}


def lc_sub(a: LC, b: LC) -> LC:
    out = dict(a)
    for k, v in b.items():
        nv = out.get(k, 0) - v
        if nv:
            out[k] = nv
        elif k in out:
            del out[k]
    return out


class ConstraintSystem:
    """R1CS over a prime field with ordered witness computation."""

    def __init__(self, field: F.HostField):
        self.f = field
        self.n_vars = 1  # index 0 = ONE
        self.names: Dict[str, int] = {}
        self.input_names: List[str] = []
        self.constraints = ConstraintList()
        # ordered witness computers: (var_idx, fn(assignment_list) -> int,
        # op) where op is an optional structured descriptor the native
        # witness interpreter can execute (("lc", lc) / ("mul", a, b) /
        # ("bit", x, j) / ("inv0", a) / ("eq0", a)); op=None falls back to
        # the python closure.
        self.computers = ComputerList()

    # -- variables ---------------------------------------------------------

    def input(self, name: str) -> LC:
        """Declare an externally-provided witness input wire."""
        assert name not in self.names, f"duplicate input {name}"
        idx = self.n_vars
        self.n_vars += 1
        self.names[name] = idx
        self.input_names.append(name)
        return {idx: 1}

    def aux(self, name: str, compute: Callable, op=None) -> LC:
        """New auxiliary wire with a compute closure fn(z)->value; `op` is
        the optional native-interpreter descriptor (see computers)."""
        idx = self.n_vars
        self.n_vars += 1
        if name:
            self.names.setdefault(name, idx)
        self.computers.append((idx, compute, op))
        return {idx: 1}

    def eval_lc(self, lc: LC, z: List[int]) -> int:
        p = self.f.p
        return sum(c * z[k] for k, c in lc.items()) % p

    def mark(self) -> Tuple[int, int, int]:
        """(constraint items, rows, computer items) so far: where
        `binding_of` starts to search."""
        return (len(self.constraints.items()), len(self.constraints),
                len(self.computers.items()))

    def binding_of(self, lc: LC, since: Tuple[int, int, int]
                   ) -> Tuple[int, int, int]:
        """(row, constraint item, computer item) of the aux wire that a
        gadget added after `since` bound to the LC object `lc` (a
        Poseidon stamp's input binding: the wire's ("lc", lc) computer and
        its enforce_eq row)."""
        c_item, row, k_item = since
        comps = self.computers.items()
        for k in range(k_item, len(comps)):
            it = comps[k]
            if it[0] == "c" and it[3] is not None and it[3][1] is lc:
                w = it[1]
                break
        else:
            raise ValueError("no wire bound to this LC")
        cons = self.constraints.items()
        for j in range(c_item, len(cons)):
            it = cons[j]
            if it[0] == "s":
                row += len(it[1].constraints)
            elif w in it[1]:
                return row, j, k
            else:
                row += 1
        raise ValueError("no binding row")

    # -- constraints -------------------------------------------------------

    def enforce(self, a: LC, b: LC, c: LC):
        self.constraints.append((a, b, c))

    def enforce_eq(self, a: LC, b: LC):
        self.enforce(lc_sub(a, b), {0: 1}, {})

    def enforce_zero(self, a: LC):
        self.enforce(a, {0: 1}, {})

    def assert_true(self, b: LC):
        """b is a bool LC; require b == 1."""
        self.enforce_eq(b, {0: 1})

    # -- core gadgets ------------------------------------------------------

    def mul(self, a: LC, b: LC, name: str = "") -> LC:
        p = self.f.p
        out = self.aux(name, lambda z, a=a, b=b: self.eval_lc(a, z)
                       * self.eval_lc(b, z) % p, op=("mul", a, b))
        self.enforce(a, b, out)
        return out

    def is_zero(self, a: LC, name: str = "") -> LC:
        """bool LC: 1 if <a,z> == 0 else 0 (2 constraints)."""
        p = self.f.p

        def compute_inv(z, a=a):
            v = self.eval_lc(a, z)
            return pow(v, p - 2, p) if v != 0 else 0

        inv = self.aux(name + "_inv", compute_inv, op=("inv0", a))
        out = self.aux(name, lambda z, a=a: 1 if self.eval_lc(a, z) == 0
                       else 0, op=("eq0", a))
        # out = 1 - a*inv ;  out * a = 0
        self.enforce(a, inv, lc_sub({0: 1}, out))
        self.enforce(out, a, {})
        return out

    def is_eq(self, a: LC, b: LC, name: str = "") -> LC:
        return self.is_zero(lc_sub(a, b), name)

    def ite(self, cond: LC, t: LC, fls: LC, name: str = "") -> LC:
        """cond bool LC: cond ? t : f  (1 constraint)."""
        return lc_add(fls, self.mul(cond, lc_sub(t, fls), name))

    def and_(self, a: LC, b: LC) -> LC:
        return self.mul(a, b)

    def or_(self, a: LC, b: LC) -> LC:
        # a + b - ab
        return lc_sub(lc_add(a, b), self.mul(a, b))

    def not_(self, a: LC) -> LC:
        return lc_sub({0: 1}, a)

    def all_(self, bools: List[LC]) -> LC:
        if not bools:
            return {0: 1}
        out = bools[0]
        for b in bools[1:]:
            out = self.and_(out, b)
        return out

    def assert_bool(self, b: LC):
        self.enforce(b, lc_sub(b, {0: 1}), {})

    # -- bits & ranges -----------------------------------------------------

    def bits(self, x: LC, n: int, name: str = "") -> List[LC]:
        """Decompose x into n bits (LSB first); asserts x < 2^n."""
        out = []
        acc: LC = {}
        for j in range(n):
            bj = self.aux(f"{name}_b{j}",
                          lambda z, x=x, j=j: (self.eval_lc(x, z) >> j) & 1,
                          op=("bit", x, j))
            self.assert_bool(bj)
            acc = lc_add(acc, lc_scale(bj, 1 << j))
            out.append(bj)
        self.enforce_eq(acc, x)
        return out

    def assert_fits(self, x: LC, n: int, name: str = ""):
        """Assert 0 <= x < 2^n."""
        self.bits(x, n, name)

    def assert_geq(self, a: LC, b: LC, n: int, name: str = ""):
        """Assert a >= b given both < 2^n (mirrors the reference's
        BvBinPred::Uge range idiom)."""
        self.assert_fits(lc_sub(a, b), n, name)

    def horner(self, coeffs: List[LC], x: LC) -> LC:
        """coeffs[0] + x*(coeffs[1] + x*(...)) — len-2 muls + wiring."""
        if len(coeffs) == 1:
            return coeffs[0]
        acc = self.mul(coeffs[-1], x)
        for c in reversed(coeffs[1:-1]):
            acc = self.mul(lc_add(acc, c), x)
        return lc_add(acc, coeffs[0])

    # -- Poseidon ----------------------------------------------------------

    def poseidon_perm(self, state: List[LC], t: int = 5) -> List[LC]:
        """In-circuit Poseidon permutation; ARC+MDS folded into LCs, 3
        constraints per S-box (288 for t=5, matching costs.rs:115-138).

        Instances are stamped from a per-(field, t) template (one symbolic
        build, then pure wire renumbering): permutation gadgets dominated
        circuit BUILD time (~3s/process of big-int LC mixing for the
        augmented step circuit's ~112 permutations)."""
        tpl = _poseidon_template(self.f, t)
        return tpl.stamp(self, state)

    def _poseidon_perm_build(self, state: List[LC], t: int = 5) -> List[LC]:
        """Direct gadget construction (used once per (field, t) to build the
        stamping template)."""
        p = self.f.p
        rc, mds = poseidon_params(p, t)
        r_f, r_p = FULL_ROUNDS, PARTIAL_ROUNDS[t]
        half = r_f // 2
        ci = 0
        s = list(state)

        def sbox(x: LC) -> LC:
            x2 = self.mul(x, x)
            x4 = self.mul(x2, x2)
            return self.mul(x4, x)

        def mix(s: List[LC]) -> List[LC]:
            # merged scale+add with coefficients reduced mod p: without the
            # reduction, partial-round lanes re-scale by 255-bit MDS entries
            # every round and coefficients grow ~255 bits/round — big-int
            # blowup that dominated circuit BUILD time (and bloated the
            # constraint matrices R1CSShape then reduces anyway)
            out = []
            for i in range(t):
                row = mds[i]
                acc: LC = {}
                for j in range(t):
                    m = row[j]
                    for k, v in s[j].items():
                        acc[k] = (acc.get(k, 0) + v * m) % p
                out.append({k: v for k, v in acc.items() if v})
            return out

        def rebind(lc: LC) -> LC:
            # cap LC support growth: untouched lanes accumulate wide linear
            # combinations across partial rounds, making constraint-matrix
            # rows (and build time) quadratic; a periodic fresh wire keeps
            # them sparse for ~40 extra constraints per permutation
            if len(lc) <= 24:
                return lc
            w = self.aux("", lambda z, lc=lc: self.eval_lc(lc, z),
                         op=("lc", lc))
            self.enforce_eq(w, lc)
            return w

        for rnd in range(r_f + r_p):
            full = rnd < half or rnd >= half + r_p
            s = [lc_add(x, lc_const(rc[ci + i])) for i, x in enumerate(s)]
            ci += t
            if full:
                s = [sbox(x) for x in s]
            else:
                s = [sbox(s[0])] + s[1:]
            s = mix(s)
            if rnd % 8 == 7:
                s = [rebind(x) for x in s]
        return s


class _PoseidonTemplate:
    """One symbolic build of the t-wide permutation gadget, stampable into
    any ConstraintSystem over the same field by wire renumbering.

    Template wire layout: 0 = ONE, 1..t = inputs, t+1.. = aux in computer
    order.  Every aux wire carries a native op descriptor (("mul", a, b) or
    ("lc", lc)), so stamped witness closures are regenerated generically —
    the stamped instance is wire-for-wire identical to a direct build (plus
    one binding wire per input LC that is not already a bare wire)."""

    def __init__(self, field: F.HostField, t: int):
        cs = ConstraintSystem(field)
        ins = [cs.input(f"in{i}") for i in range(t)]
        outs = cs._poseidon_perm_build(ins, t)
        self.f = field
        self.t = t
        self.n_vars = cs.n_vars
        self.n_aux = cs.n_vars - 1 - t
        self.constraints = [
            (tuple(a.keys()), tuple(a.values()), tuple(b.keys()),
             tuple(b.values()), tuple(c.keys()), tuple(c.values()))
            for a, b, c in cs.constraints]
        self.computers = []
        for idx, _fn, op in cs.computers:
            assert op is not None and op[0] in ("mul", "lc"), \
                "poseidon template requires native op descriptors"
            self.computers.append((idx, op))
        self.outs = [(tuple(o.keys()), tuple(o.values())) for o in outs]

        # packed per-matrix views (relative row, TEMPLATE wire id, reduced
        # 32B-LE coeff) for vectorized renumbering in nova.R1CSShape —
        # entry order matches dict-materialized iteration exactly, so the
        # shape digest is unchanged
        import numpy as _np
        p = field.p
        packed = []
        for k in range(3):
            rows, wires, vals = [], [], bytearray()
            for i, row6 in enumerate(self.constraints):
                ks, vs = row6[2 * k], row6[2 * k + 1]
                for w, v in zip(ks, vs):
                    rows.append(i)
                    wires.append(w)
                    vals += (v % p).to_bytes(32, "little")
            packed.append((_np.asarray(rows, dtype=_np.int64),
                           _np.asarray(wires, dtype=_np.int64),
                           bytes(vals)))
        self.packed = tuple(packed)

    def stamp(self, cs: ConstraintSystem, state: List[LC]) -> List[LC]:
        p = self.f.p
        assert cs.f.p == p and len(state) == self.t
        m = [0] * self.n_vars
        seen = set()        # two inputs mapped to the SAME wire would make
        for i, lc in enumerate(state):   # dict(zip(..)) drop coefficients
            if len(lc) == 1:
                (k, v), = lc.items()
                if v % p == 1 and k != 0 and k not in seen:
                    m[1 + i] = k
                    seen.add(k)
                    continue
            w = cs.aux("", lambda z, lc=lc: cs.eval_lc(lc, z),
                       op=("lc", lc))
            cs.enforce_eq(w, lc)
            (m[1 + i],) = w
            seen.add(m[1 + i])
        base = cs.n_vars
        cs.n_vars += self.n_aux
        for j in range(self.n_aux):
            m[1 + self.t + j] = base + j

        import numpy as _np
        m_np = _np.asarray(m, dtype=_np.int64)
        cs.constraints.append_stamp(self, m, m_np)
        cs.computers.append_stamp(self, m, m_np, cs)

        return [dict(zip([m[k] for k in ok], ov)) for ok, ov in self.outs]


_POSEIDON_TEMPLATES: Dict[Tuple[int, int], _PoseidonTemplate] = {}


def _poseidon_template(field: F.HostField, t: int) -> _PoseidonTemplate:
    key = (field.p, t)
    tpl = _POSEIDON_TEMPLATES.get(key)
    if tpl is None:
        tpl = _PoseidonTemplate(field, t)
        _POSEIDON_TEMPLATES[key] = tpl
    return tpl


class CircuitSponge:
    """In-circuit SAFE sponge over LCs; mirrors HostSponge exactly."""

    RATE = 4
    T = 5

    def __init__(self, cs: ConstraintSystem, io: IOPattern,
                 rate: int = None):
        self.cs = cs
        if rate is not None:
            self.RATE = rate            # instance override (t = rate + 1)
            self.T = rate + 1
        self.state: List[LC] = [lc_const(io.tag_int() % cs.f.p)] + \
            [{} for _ in range(self.RATE)]
        self.pos = 0
        self.squeezing = False

    def _permute(self):
        self.state = self.cs.poseidon_perm(self.state, self.T)
        self.pos = 0

    def absorb(self, lcs: List[LC]):
        if self.squeezing:
            self.pos = 0
            self.squeezing = False
        for lc in lcs:
            if self.pos == self.RATE:
                self._permute()
            self.state[1 + self.pos] = lc_add(self.state[1 + self.pos], lc)
            self.pos += 1

    def squeeze(self, n: int) -> List[LC]:
        if not self.squeezing:
            self._permute()
            self.squeezing = True
        out = []
        for _ in range(n):
            if self.pos == self.RATE:
                self._permute()
            out.append(self.state[1 + self.pos])
            self.pos += 1
        return out


class CompiledCircuit:
    """Frozen circuit: witness evaluation + constraint checking."""

    def __init__(self, cs: ConstraintSystem,
                 output_lcs: Optional[List[LC]] = None):
        self.cs = cs
        self.f = cs.f
        self.output_lcs = output_lcs or []

    def witness(self, inputs: Dict[str, int]) -> List[int]:
        z, prog = self._witness_prologue(inputs)
        if prog is not None:
            return prog.run(z, inputs)
        for idx, fn, _op in self.cs.computers:
            z[idx] = fn(z) % self.cs.f.p
        return z

    def _witness_prologue(self, inputs: Dict[str, int]):
        """(input-filled z vector, native program or None)."""
        cs = self.cs
        z = [0] * cs.n_vars
        z[0] = 1
        missing = [n for n in cs.input_names if n not in inputs]
        assert not missing, f"missing inputs: {missing[:10]}"
        for name in cs.input_names:
            z[cs.names[name]] = inputs[name] % cs.f.p
        from ..ops import native_fieldvec as FV
        prog = FV.witness_program(cs) if FV.available() else None
        return z, prog

    def witness_packed(self, inputs: Dict[str, int]):
        """witness() returning a PackedVec when the native program is
        available (skips the full int round-trip; see run_packed), a plain
        int list otherwise."""
        z, prog = self._witness_prologue(inputs)
        if prog is not None:
            return prog.run_packed(z, inputs)
        for idx, fn, _op in self.cs.computers:
            z[idx] = fn(z) % self.cs.f.p
        return z

    def outputs(self, z: List[int]) -> List[int]:
        return [self.cs.eval_lc(lc, z) for lc in self.output_lcs]

    def check_all(self, z: List[int]) -> Optional[int]:
        """Az*Bz==Cz for all rows; returns first failing row index or None."""
        p = self.f.p
        ev = self.cs.eval_lc
        for i, (a, b, c) in enumerate(self.cs.constraints):
            if ev(a, z) * ev(b, z) % p != ev(c, z):
                return i
        return None

    @property
    def num_constraints(self) -> int:
        return len(self.cs.constraints)

    def to_sparse(self):
        """(A, B, C) as COO triples (row, col, coeff) for the folding layer."""
        A, B, C = [], [], []
        p = self.f.p
        for i, (a, b, c) in enumerate(self.cs.constraints):
            for col, v in a.items():
                A.append((i, col, v % p))
            for col, v in b.items():
                B.append((i, col, v % p))
            for col, v in c.items():
                C.append((i, col, v % p))
        return A, B, C
