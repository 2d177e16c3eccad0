"""Pasta-curve prime fields: host-side reference arithmetic + constants.

The Pasta cycle (reference: pasta_curves crate, used at
reference src/backend/framework.rs:1-2 `G1 = pallas::Point,
G2 = vesta::Point`):

  Pallas: y^2 = x^3 + 5 over F_P  with group order Q
  Vesta:  y^2 = x^3 + 5 over F_Q  with group order P

so scalar(Pallas) = F_Q = base(Vesta) and vice versa.  The constraint field of
the step circuit is the Pallas *scalar* field F_Q — the reference pins exactly
this modulus into CirC (reference src/backend/r1cs_helper.rs:33-41,
custom_modulus = 2894...8097 = Q below).

Host arithmetic here is plain Python ints (correctness oracle + frontend/table
building); the batched tensor arithmetic lives in `ops.limb`.
"""

from __future__ import annotations

# Pallas base field modulus = Vesta scalar field order.
P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
# Vesta base field modulus = Pallas scalar field order = circuit field.
Q = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

assert P.bit_length() == 255 and Q.bit_length() == 255

# Number of 16-bit limbs in the device representation (256 bits).
N_LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def inv_mod(a: int, m: int) -> int:
    """Modular inverse of a mod m (m prime or a coprime to m)."""
    return pow(a, -1, m)


def to_limbs(x: int, n: int = N_LIMBS) -> list[int]:
    """Little-endian 16-bit limb decomposition of a non-negative int."""
    assert 0 <= x < (1 << (n * LIMB_BITS))
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


def from_limbs(limbs) -> int:
    """Inverse of `to_limbs` (accepts any iterable of ints)."""
    x = 0
    for i, l in enumerate(limbs):
        x |= (int(l) & LIMB_MASK) << (LIMB_BITS * i)
    return x


class HostField:
    """Host-side field context for a prime modulus (python-int arithmetic).

    Used by the frontend/table layers and as the oracle the jnp limb kernels
    are tested against (the reference's analogous trick: do math in rug
    Integers, reduce mod the field, reference src/backend/
    r1cs_helper.rs:472-503).
    """

    def __init__(self, modulus: int, name: str):
        self.p = modulus
        self.name = name
        self.R = (1 << (N_LIMBS * LIMB_BITS)) % modulus          # 2^256 mod p
        self.R2 = (self.R * self.R) % modulus                    # 2^512 mod p
        # -p^-1 mod 2^16 (Montgomery per-limb factor)
        self.n0inv = (-inv_mod(modulus, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def __repr__(self):
        return f"HostField({self.name})"


FP = HostField(P, "Fp")  # pallas base / vesta scalar
FQ = HostField(Q, "Fq")  # vesta base / pallas scalar == circuit field
