"""EN-T data encodings (paper §3.2-3.3) in PyTorch, bit-exact with the
reference (port of ``repro/core/encoding.py``).

Two encodings of an n-bit multiplicand A, both turning A x B into
shift/negate/add of B:

* **MBE** (Modified Booth Encoding, radix-4): digits m_i in {-2,-1,0,1,2},
  A = sum m_i 4^i over the 2's-complement bits.  n-bit -> ceil(n/2) digits,
  each needing 3 control bits (NEG/SE/CE), i.e. encoded width 1.5n.

* **EN-T modified encoding** (the paper's contribution): a carry-chain
  digit-set conversion of the radix-4 digits a_i in {0,1,2,3} of the
  *unsigned magnitude* into w_i in {-1,0,1,2} plus one final carry bit:

      a'_i = a_i + cin_i            (cin_0 = 0)
      w_i  = a'_i,     cin_{i+1} = 0    if a'_i in {0,1,2}
      w_i  = a'_i - 4, cin_{i+1} = 1    if a'_i in {3,4}

  so  Q = sum_i w_i 4^i + cin_N 4^N  and every w_i*B is a shift/negate of
  B.  Encoded width n+1 bits (n/2 2-bit digits + 1 carry); n/2 - 1
  encoders (digit 0 passes through).  Signed numbers encode |A| and carry
  the sign out-of-band; hardware selects -B when A < 0 (paper §3.3.1).

The encoders work on int32 tensors on the input's own device (a Python
int or numpy array becomes a CPU tensor), shape-polymorphic over leading
batch dims; the decoders are host-side numpy int64 helpers, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "radix4_digits",
    "ent_encode_unsigned",
    "ent_decode_unsigned",
    "ent_encode_signed",
    "ent_decode_signed",
    "ent_encode_bitlevel",
    "mbe_encode",
    "mbe_decode",
    "mbe_control_lines",
    "ent_encoded_bits",
    "mbe_encoded_bits",
    "ent_num_encoders",
    "mbe_num_encoders",
    "pack_ent_digits",
    "unpack_ent_digits",
]


def _num_digits(n_bits: int) -> int:
    if n_bits % 2 != 0:
        raise ValueError(f"n_bits must be even, got {n_bits}")
    return n_bits // 2


def _int32(x) -> torch.Tensor:
    """``x`` as an int32 tensor (on its own device when a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def radix4_digits(x, n_bits: int):
    """Radix-4 digits a_i in {0,1,2,3} of unsigned ``x`` (Eq. 4). [..., N] LE."""
    n = _num_digits(n_bits)
    x = _int32(x)
    return torch.stack([(x >> (2 * i)) & 3 for i in range(n)], dim=-1)


def ent_encode_unsigned(x, n_bits: int):
    """EN-T encode unsigned x (< 2**n_bits) per Eq. 7/16.

    Returns ``(w, carry)``: w int32 [..., N] with values in {-1,0,1,2}
    (little-endian digit order), carry int32 [...] in {0,1} with weight
    4**N.  Identity: x == sum_i w[...,i]*4**i + carry*4**N.
    """
    a = radix4_digits(x, n_bits)
    cin = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    ws = []
    for i in range(a.shape[-1]):   # the carry chain (paper Fig. 5)
        ap = a[..., i] + cin
        hi = ap >= 3
        ws.append(torch.where(hi, ap - 4, ap))
        cin = hi.to(torch.int32)
    return torch.stack(ws, dim=-1), cin


def ent_decode_unsigned(w, carry):
    """Inverse of :func:`ent_encode_unsigned`, on the host in numpy int64
    (the carry weight 4**N overflows int32 at n_bits >= 32)."""
    w = np.asarray(_host(w), np.int64)
    carry = np.asarray(_host(carry), np.int64)
    n = w.shape[-1]
    weights = np.array([4**i for i in range(n)], np.int64)
    return np.sum(w * weights, axis=-1) + carry * (4**n)


def ent_encode_signed(x, n_bits: int):
    """EN-T encode a signed (2's complement) value via magnitude + sign.

    Returns ``(sign, w, carry)`` with sign in {0,1} (1 = negative) so that
    x == (-1)**sign * (sum w_i 4^i + carry 4^N).  For n=8 the carry is
    provably 0 (magnitude <= 128 < 192).
    """
    x = _int32(x)
    sign = (x < 0).to(torch.int32)
    w, carry = ent_encode_unsigned(torch.abs(x), n_bits)
    return sign, w, carry


def ent_decode_signed(sign, w, carry):
    mag = ent_decode_unsigned(w, carry)
    return np.where(np.asarray(_host(sign)) == 1, -mag, mag)


def ent_encode_bitlevel(x, n_bits: int):
    """The paper's gate-level recurrence (Eq. 8/17), bit-for-bit.

        Encode(w_i) = ([a_i]_2 + cin_i) mod 4
        cin_{i+1}   = (a_i[1] & a_i[0]) | (a_i[1] & cin_i)

    Returns ``(enc, carry)`` where enc[..., i] in {0,1,2,3} is the 2-bit
    *encoding* of w_i under the map {0,1,2,-1} -> {00,01,10,11}.
    """
    a = radix4_digits(x, n_bits)
    cin = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    encs = []
    for i in range(a.shape[-1]):
        a1 = (a[..., i] >> 1) & 1
        a0 = a[..., i] & 1
        encs.append((a[..., i] + cin) & 3)           # 2-bit add, no carry-out
        cin = (a1 & a0) | (a1 & cin)                 # Eq. 17 carry logic
    return torch.stack(encs, dim=-1), cin


def pack_ent_digits(w):
    """Map digits {0,1,2,-1} -> 2-bit codes {0,1,2,3} (wire representation)."""
    w = _int32(w)
    return torch.where(w < 0, w + 4, w)


def unpack_ent_digits(enc):
    """Inverse of :func:`pack_ent_digits`: codes {0,1,2,3} -> {0,1,2,-1}."""
    enc = _int32(enc)
    return torch.where(enc == 3, -1, enc)


# ----------------------------------------------------------------------------
# Modified Booth Encoding (radix-4), the baseline the paper compares against.
# ----------------------------------------------------------------------------

def mbe_encode(x, n_bits: int):
    """MBE digits m_i = -2 a_{2i+1} + a_{2i} + a_{2i-1} (Eq. 2), a_{-1}=0.

    Operates on the 2's-complement bit pattern of signed ``x``; exact:
    x == sum m_i 4^i.  Returns int32 [..., N] in {-2,-1,0,1,2}, LE order.
    """
    n = _num_digits(n_bits)
    x = _int32(x)
    u = x & ((1 << n_bits) - 1)  # bit pattern
    ms = []
    for i in range(n):
        b_hi = (u >> (2 * i + 1)) & 1
        b_mid = (u >> (2 * i)) & 1
        b_lo = (u >> (2 * i - 1)) & 1 if i > 0 else torch.zeros_like(u)
        ms.append(-2 * b_hi + b_mid + b_lo)
    return torch.stack(ms, dim=-1)


def mbe_decode(m):
    """Host-side validation helper (numpy int64, see ent_decode_unsigned)."""
    m = np.asarray(_host(m), np.int64)
    n = m.shape[-1]
    weights = np.array([4**i for i in range(n)], np.int64)
    return np.sum(m * weights, axis=-1)


def mbe_control_lines(x, n_bits: int):
    """The NEG/SE/CE control encoding of Eq. 3 — 3 bits per digit.

    NEG: select a negative multiple; SE ("select two"): |m|==2;
    CE ("component enable"): m != 0.  Returns (neg, se, ce) each [..., N].
    """
    m = mbe_encode(x, n_bits)
    neg = (m < 0).to(torch.int32)
    se = (torch.abs(m) == 2).to(torch.int32)
    ce = (m != 0).to(torch.int32)
    return neg, se, ce


# ----------------------------------------------------------------------------
# Wire-width / encoder-count bookkeeping (paper §3.3, Table 1 right columns).
# ----------------------------------------------------------------------------

def ent_encoded_bits(n_bits: int) -> int:
    """EN-T encoded width: n+1 (n/2 two-bit digits + 1 carry)."""
    return n_bits + 1


def mbe_encoded_bits(n_bits: int) -> int:
    """MBE encoded width: 3 control bits per radix-4 digit."""
    return -(-n_bits // 2) * 3


def ent_num_encoders(n_bits: int) -> int:
    """(n/2 - 1): the lowest 2 bits pass through unencoded (cin_0 = 0)."""
    return _num_digits(n_bits) - 1


def mbe_num_encoders(n_bits: int) -> int:
    return _num_digits(n_bits)


# Convenience: numpy oracle used by property tests ---------------------------

def np_ent_encode_unsigned(x: np.ndarray, n_bits: int):
    """Pure-numpy oracle of the EN-T encoding (independent implementation)."""
    x = np.asarray(x, np.int64)
    n = _num_digits(n_bits)
    w = np.zeros(x.shape + (n,), np.int64)
    cin = np.zeros_like(x)
    for i in range(n):
        ap = ((x >> (2 * i)) & 3) + cin
        hi = ap >= 3
        w[..., i] = np.where(hi, ap - 4, ap)
        cin = hi.astype(np.int64)
    return w, cin
