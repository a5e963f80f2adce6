"""Lane-major 256-bit field arithmetic in plain PyTorch.

Counterpart of fisco_bcos_tpu/ops/fp.py. Values are 16 limbs of 16 bits,
little-endian, on axis -2 of a `[..., 16, B]` tensor (the batch axis is
minor-most, as in the JAX package). The limbs are held in int64: PyTorch on
the CPU has no uint32 arithmetic, and int64 leaves room for redundant
column sums (16 products of two 16-bit limbs stay below 2^37). No value
here ever has bit 63 set, so `>>` is a plain logical shift.

This is the plain version of the field layer: the CPU tests hold it
bit-exact against the JAX package, and `chip_smoke.py` holds the CUDA
kernels (whose field code is `csrc/field.cuh` and `csrc/bigint.cuh`)
against it on the card. A field built with `kernels=True` (the Poseidon
field, zk/poseidon_torch.py) sends its CUDA multiplies to the standalone
kernels of `csrc/fp.cu` (ops/cuda_fp.py) instead, as the JAX package's
`_FieldBase.mul` sends them to pallas_fp; the curve fields are built
without, so the plain EC paths stay plain on the card.

Every method keeps the JAX package's canonical invariant: what it returns
is fully carried and below the modulus, so equality is limb equality.
"""

from __future__ import annotations

import numpy as np
import torch

from .bigint import LIMB_BITS, LIMB_RADIX, NLIMBS, to_limbs

BITS = NLIMBS * LIMB_BITS  # 256
MASK = LIMB_RADIX - 1
I64 = torch.int64

__all__ = ["NLIMBS", "LIMB_BITS", "BITS", "SolinasField", "MontField",
           "mul_wide", "carry_prop", "add_limbs", "sub_limbs", "geq",
           "select", "window_digits", "msb_digits", "is_zero", "eq", "col"]


def col(c, like: torch.Tensor) -> torch.Tensor:
    """Constant limb vector [L] -> [L, 1] int64 column on like's device."""
    return torch.as_tensor(np.asarray(c, np.int64), device=like.device)[:, None]


def _pad(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad along the limb axis (-2)."""
    if lo == 0 and hi == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, lo, hi))


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """Along the limb axis: out[i] = x[i - k], zero-filled below."""
    return _pad(x, k, 0)[..., : x.shape[-2], :]


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full 512-bit product as 32 redundant columns (each < 2^37)."""
    a, b = torch.broadcast_tensors(a, b)
    p = a[..., :, None, :] * b[..., None, :, :]  # [..., 16, 16, B] < 2^32
    R, J = p.shape[-3], p.shape[-2]
    width = 2 * NLIMBS
    # shear: pad each row to width+1 and re-view at stride width, which
    # shifts row i right by i; one sum over rows gives every column
    flat = torch.nn.functional.pad(p, (0, 0, 0, width + 1 - J))
    flat = flat.reshape(p.shape[:-3] + (R * (width + 1), p.shape[-1]))
    sheared = flat[..., : R * width, :].reshape(
        p.shape[:-3] + (R, width, p.shape[-1]))
    return sheared.sum(dim=-3)


def carry_prop(cols: torch.Tensor, nout: int, bits: int = 48):
    """Redundant columns (each < 2^bits, bits <= 48) -> exact 16-bit limbs.

    Returns (limbs [..., nout, B], carry_out [..., B]) where carry_out is
    the value overflowing limb nout-1. Collapse passes bring every column
    to <= 2^16 (a pass maps < 2^b to < 2^16 + 2^(b-16)), then a
    Kogge-Stone carry-lookahead resolves the remaining single-bit ripple
    in log depth.
    """
    assert bits <= 48
    ncols = cols.shape[-2]
    assert ncols <= nout, (ncols, nout)
    m = nout + 3
    w = _pad(cols, 0, m - ncols)
    passes = 1 if bits <= 17 else 2 if bits <= 31 else 3 if bits <= 32 else 4
    for _ in range(passes):
        w = (w & MASK) + _shift_up(w >> LIMB_BITS, 1)
    r = w & MASK
    G = w >> LIMB_BITS  # generate, in {0, 1}
    P = (r == MASK).to(I64)  # propagate
    k = 1
    while k < m:
        G = G | (P & _shift_up(G, k))
        P = P & _shift_up(P, k)
        k *= 2
    limbs = (r + _shift_up(G, 1)) & MASK
    carry = (limbs[..., nout, :] | (limbs[..., nout + 1, :] << LIMB_BITS)
             | (limbs[..., nout + 2, :] << (2 * LIMB_BITS)))
    return limbs[..., :nout, :], carry


def add_limbs(a, b):
    """Exact-limb add -> (limbs mod 2^256, carry bit)."""
    a, b = torch.broadcast_tensors(a, b)
    return carry_prop(a + b, NLIMBS, bits=17)


def sub_limbs(a, b):
    """Exact-limb subtract -> (limbs mod 2^256, borrow bit in {0, 1})."""
    a, b = torch.broadcast_tensors(a, b)
    cols = a + (MASK - b)  # a + ~b + 1 over 16-bit limbs
    cols = cols.clone()
    cols[..., 0, :] += 1
    limbs, carry = carry_prop(cols, NLIMBS, bits=17)
    return limbs, 1 - carry


def is_zero(a):
    return (a == 0).all(dim=-2)


def eq(a, b):
    return (a == b).all(dim=-2)


def select(cond, a, b):
    """cond ? a : b with cond shaped [..., B] (broadcast over limbs)."""
    return torch.where(cond[..., None, :], a, b)


def geq(a, b):
    """a >= b over exact limb vectors."""
    _, brw = sub_limbs(a, b)
    return brw == 0


def msb_digits(e: int, window: int = 4) -> np.ndarray:
    """Static exponent -> MSB-first window digits."""
    nd = max(1, (e.bit_length() + window - 1) // window)
    return np.array(
        [(e >> (window * i)) & ((1 << window) - 1) for i in range(nd)][::-1],
        dtype=np.int32)


def window_digits(a, w: int):
    """[..., 16, B] -> [..., 256//w, B] little-endian w-bit digits."""
    assert LIMB_BITS % w == 0
    per = LIMB_BITS // w
    m = (1 << w) - 1
    digs = []
    for i in range(NLIMBS):
        limb = a[..., i, :]
        for j in range(per):
            digs.append((limb >> (w * j)) & m)
    return torch.stack(digs, dim=-2)


def _route(kernel: str, field, a, b):
    """One product by the named fp kernel: for CUDA tensors the csrc/fp.cu
    launch (ops/cuda_fp), on the CPU its plain version, `mul_plain`."""
    if a.is_cuda or b.is_cuda:
        from . import cuda_fp

        return getattr(cuda_fp, kernel)(field, a.contiguous(), b.contiguous())
    return field.mul_plain(a, b)


class _FieldBase:
    """Shared modulus plumbing; subclasses define the multiply domain
    (`mul_plain`), `mul` dispatches it."""

    def __init__(self, n: int, name: str, kernels: bool = False):
        self.name = name
        self.n_int = n
        self.limbs = to_limbs(n)
        self.kernels = kernels
        self._cols: dict = {}
        # Every op here is right for any n > 2^253, as in the JAX package
        # (fisco_bcos_tpu/ops/fp.py:266-277): canonical inputs keep
        # a + b < 2n < 2^255, and a Montgomery product stays below 2n, so
        # one conditional subtract makes it canonical, whenever at least
        # one operand is canonical. Only `reduce_loose` is weaker when
        # 2n < 2^256 (BN254 r); see there.
        assert n > 1 << (BITS - 3), "modulus must exceed 2^253"

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"

    def _c(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The limb vector attribute `name` as an int64 [16, 1] column on
        like's device, copied there once per device: a copy from host
        memory waits for the device's queue, so one per op would
        serialize the card."""
        key = (name, like.device)
        c = self._cols.get(key)
        if c is None:
            c = self._cols[key] = col(getattr(self, name), like)
        return c

    def _n(self, like):
        return self._c("limbs", like)

    def mul(self, a, b):
        """a * b in the field's domain. A field built with kernels=True
        routes by shape as fisco_bcos_tpu/ops/fp.py:280-309 routes to
        pallas_fp: a 2-D [16, B] against a [16, 1] column, in either
        order, to `mul_const`; otherwise both operands broadcast to one
        shape, and a 2-D result goes to `mul`, a stacked [..., 16, B] one
        to `mul_stacked` with its leading axes collapsed. CUDA tensors
        launch the csrc/fp.cu kernels (any B, where the TPU kernels need
        a multiple of 128); CPU tensors run `mul_plain`. Every other field
        runs `mul_plain`."""
        if not self.kernels:
            return self.mul_plain(a, b)
        if a.dim() == 2 and b.dim() == 2:
            if tuple(b.shape) == (NLIMBS, 1):
                return _route("mul_const", self, a, b)
            if tuple(a.shape) == (NLIMBS, 1):
                return _route("mul_const", self, b, a)
        if a.shape != b.shape:
            a, b = torch.broadcast_tensors(a, b)
        if a.dim() == 2:
            return _route("mul", self, a, b)
        tail = tuple(a.shape[-2:])
        out = _route("mul_stacked", self, a.reshape((-1,) + tail),
                     b.reshape((-1,) + tail))
        return out.reshape(a.shape)

    def add(self, a, b):
        s, c = add_limbs(a, b)
        d, brw = sub_limbs(s, self._n(s))
        return select((c == 1) | (brw == 0), d, s)

    def sub(self, a, b):
        d, brw = sub_limbs(a, b)
        d2, _ = add_limbs(d, self._n(d))
        return select(brw == 1, d2, d)

    def neg(self, a):
        d, _ = sub_limbs(self._n(a).expand_as(a), a)
        return select(is_zero(a), a, d)

    def reduce_loose(self, a):
        """One conditional subtract of n from an exact-limb value < 2^256.
        When 2n > 2^256 (every curve field) the result is canonical (< n).
        For a smaller modulus (BN254 r ~ 2^253.8) it is merely below
        2^256 - n, which may still exceed n, up to about 4.3n: callers
        there must take a loose value, as MontField.to_rep does (its one
        product against the canonical R^2 mod n is canonical)."""
        d, brw = sub_limbs(a, self._n(a))
        return select(brw == 0, d, a)

    def sqr(self, a):
        return self.mul(a, a)

    def pow_const(self, a, e: int, window: int = 4):
        """a^e in the internal domain (e a Python int), fixed 4-bit window."""
        if e == 0:
            return self.one_rep(a)
        table = [self.one_rep(a), a]
        for _ in range((1 << window) - 2):
            table.append(self.mul(table[-1], a))
        digits = msb_digits(e, window)
        acc = table[int(digits[0])]
        for d in digits[1:]:
            for _ in range(window):
                acc = self.sqr(acc)
            acc = self.mul(acc, table[int(d)])
        return acc

    def inv(self, a):
        """a^(n-2) in the internal domain (n prime); zero maps to zero."""
        return self.pow_const(a, self.n_int - 2)

    def inv_batch(self, a):
        """Batched inversion via a product tree over the lane axis
        (Montgomery's trick), as fp.inv_batch in the JAX package. Zero
        lanes pass through as zero. Needs a power-of-two B and a 2-D
        input; falls back to `inv` otherwise."""
        B = a.shape[-1]
        if B & (B - 1) or a.dim() != 2:
            return self.inv(a)
        zero = is_zero(a)
        safe = select(zero, self.one_rep(a), a)
        levels = []
        cur = safe
        while cur.shape[-1] > 1:
            w = cur.shape[-1] // 2
            left, right = cur[..., :w], cur[..., w:]
            levels.append((left, right))
            cur = self.mul(left, right)
        invp = self.inv(cur)
        for left, right in reversed(levels):
            invp = torch.cat([self.mul(invp, right), self.mul(invp, left)],
                             dim=-1)
        return select(zero, torch.zeros_like(a), invp)


class SolinasField(_FieldBase):
    """p = 2^256 - c for small c (secp256k1: c = 2^32 + 977). Plain domain.

    The high half folds back as H*c, twice, then a last fold of the carry
    bit and one conditional subtract.
    """

    def __init__(self, p: int, name: str = "solinas", kernels: bool = False):
        super().__init__(p, name, kernels)
        c = (1 << BITS) - p
        assert 0 < c < 1 << (3 * LIMB_BITS)
        self.c_int = c
        self.terms: list[tuple[int, int]] = []
        for sh in range((c.bit_length() + LIMB_BITS - 1) // LIMB_BITS):
            coef = (c >> (LIMB_BITS * sh)) & MASK
            if coef:
                self.terms.append((coef, sh))

    def _fold(self, low_cols, top, ntop: int):
        """low_cols (16 redundant) += top * c (top: ntop exact limbs)."""
        out = low_cols
        for coef, sh in self.terms:
            out = out + _pad(top * coef, sh, NLIMBS - ntop - sh)
        return out

    def mul_plain(self, a, b):
        cols = mul_wide(a, b)
        low, high = cols[..., :NLIMBS, :], cols[..., NLIMBS:, :]
        t = _pad(low, 0, 2)
        for coef, sh in self.terms:  # coef < 2^11, high < 2^37: < 2^48
            t = t + _pad(high * coef, sh, 2 - sh)
        t_limbs, topc = carry_prop(t, NLIMBS + 2)
        top = torch.cat([t_limbs[..., NLIMBS:, :], topc[..., None, :]],
                        dim=-2)
        r_limbs, o = carry_prop(self._fold(t_limbs[..., :NLIMBS, :], top, 3),
                                NLIMBS)
        r2_limbs, _ = carry_prop(self._fold(r_limbs, o[..., None, :], 1),
                                 NLIMBS)
        return self.reduce_loose(r2_limbs)

    def one_rep(self, like):
        one = torch.zeros_like(like)
        one[..., 0, :] = 1
        return one

    def encode_int(self, v: int) -> np.ndarray:
        return to_limbs(v % self.n_int)

    def to_rep(self, a):
        return self.reduce_loose(a)

    def from_rep(self, a):
        return a


class MontField(_FieldBase):
    """Generic odd 256-bit modulus; Montgomery domain with R = 2^256."""

    def __init__(self, n: int, name: str = "mont", kernels: bool = False):
        super().__init__(n, name, kernels)
        assert n % 2 == 1
        self.r_int = (1 << BITS) % n
        self.r2 = to_limbs(pow(self.r_int, 2, n))
        self.nprime = to_limbs((-pow(n, -1, 1 << BITS)) % (1 << BITS))
        self.one_m = to_limbs(self.r_int)
        self.unit = to_limbs(1)

    def mul_plain(self, a, b):
        """REDC(a*b) for Montgomery-domain inputs, one of them canonical
        (the other need only be < 2^256)."""
        n = self._n(a)
        z, _ = carry_prop(mul_wide(a, b), 2 * NLIMBS)
        m, _ = carry_prop(mul_wide(z[..., :NLIMBS, :],
                                   self._c("nprime", a))[..., :NLIMBS, :],
                          NLIMBS)
        s, o = carry_prop(mul_wide(m, n) + z, 2 * NLIMBS)
        hi = s[..., NLIMBS:, :]
        d, brw = sub_limbs(hi, n)
        return select((o == 1) | (brw == 0), d, hi)

    def one_rep(self, like):
        return self._c("one_m", like).expand_as(like).clone()

    def encode_int(self, v: int) -> np.ndarray:
        return to_limbs(v % self.n_int * self.r_int % self.n_int)

    def to_rep(self, a):
        """Exact-limb value < 2^256 -> Montgomery domain (canonical, also
        when reduce_loose leaves it loose: R^2 mod n is canonical)."""
        return self.mul(self.reduce_loose(a), self._c("r2", a))

    def from_rep(self, a):
        """Montgomery domain -> plain canonical integer limbs."""
        return self.mul(a, self._c("unit", a))
