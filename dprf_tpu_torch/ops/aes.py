"""AES (FIPS-197) for the Kerberos AES verdict: the counterpart of the
JAX package's ops/aes.py.

Scalar ``aes_encrypt_block`` / ``aes_decrypt_block`` serve the CPU
oracle (engines/cpu/krb5aes.py) and the tests.  The batch forms run on
torch tensors with per-candidate keys, by table lookups: the key
schedule, ECB encryption of one block per candidate (the RFC 3961 DK
chain) and ECB decryption of constant blocks.  A Kerberos AES check
runs one to three of them per candidate after 4,096 PBKDF2 iterations,
so they are a small part of its work; on the card they are the
verdict's torch path after the KDF kernel, as in the reference, which
runs them in XLA outside its kernel.  Bytes are uint8 tensors.

The S-box is specification data; the inverse box, the GF(2^8) products
and the round constants are derived from it here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: FIPS-197 S-box
SBOX = bytes.fromhex(
    "637c777bf26b6fc53001672bfed7ab76ca82c97dfa5947f0add4a2af9ca472c0"
    "b7fd9326363ff7cc34a5e5f171d8311504c723c31896059a071280e2eb27b275"
    "09832c1a1b6e5aa0523bd6b329e32f8453d100ed20fcb15b6acbbe394a4c58cf"
    "d0efaafb434d338545f9027f503c9fa851a3408f929d38f5bcb6da2110fff3d2"
    "cd0c13ec5f974417c4a77e3d645d197360814fdc222a908846eeb814de5e0bdb"
    "e0323a0a4906245cc2d3ac629195e479e7c8376d8dd54ea96c56f4ea657aae08"
    "ba78252e1ca6b4c6e8dd741f4bbd8b8a703eb5664803f60e613557b986c11d9e"
    "e1f8981169d98e949b1e87e9ce5528df8ca1890dbfe6426841992d0fb054bb16")

_inv = bytearray(256)
for _i, _v in enumerate(SBOX):
    _inv[_v] = _i
INV_SBOX = bytes(_inv)


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def _gmul(a: int, b: int) -> int:
    out = 0
    for _ in range(8):
        if b & 1:
            out ^= a
        a = _xtime(a)
        b >>= 1
    return out


RCON = []
_r = 1
for _ in range(10):
    RCON.append(_r)
    _r = _xtime(_r)

#: ShiftRows and its inverse as byte permutations of the column-major
#: state (out[k] = in[perm[k]])
SHIFT = np.array([0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11])
INV_SHIFT = np.array([0, 13, 10, 7, 4, 1, 14, 11, 8, 5, 2, 15, 12, 9, 6,
                      3])


def key_schedule(key: bytes) -> list[bytes]:
    """Expanded round keys: 11 x 16 bytes for a 16-byte key, 15 x 16
    for a 32-byte key."""
    nk = len(key) // 4
    if nk not in (4, 8) or len(key) % 4:
        raise ValueError("AES-128 or AES-256 keys only")
    rounds = {4: 10, 8: 14}[nk]
    w = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (rounds + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = [SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= RCON[i // nk - 1]
        elif nk == 8 and i % nk == 4:
            t = [SBOX[b] for b in t]
        w.append([a ^ b for a, b in zip(w[i - nk], t)])
    return [bytes(sum(w[4 * r:4 * r + 4], [])) for r in range(rounds + 1)]


#: GF(2^8) products by the (Inv)MixColumns coefficients
_MUL = {c: [_gmul(c, x) for x in range(256)] for c in (2, 3, 9, 11, 13, 14)}
_MUL[1] = list(range(256))


def _mix(s: list, m) -> list:
    out = [0] * 16
    for c in range(4):
        col = s[4 * c:4 * c + 4]
        for r in range(4):
            out[4 * c + r] = (_MUL[m[r][0]][col[0]] ^ _MUL[m[r][1]][col[1]]
                              ^ _MUL[m[r][2]][col[2]]
                              ^ _MUL[m[r][3]][col[3]])
    return out


_MIX = [[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]]
_INV_MIX = [[14, 11, 13, 9], [9, 14, 11, 13], [13, 9, 14, 11],
            [11, 13, 9, 14]]


def aes_encrypt_block(key: bytes, block16: bytes) -> bytes:
    rks = key_schedule(key)
    s = [b ^ k for b, k in zip(block16, rks[0])]
    for rnd in range(1, len(rks)):
        s = [SBOX[s[p]] for p in SHIFT]
        if rnd < len(rks) - 1:
            s = _mix(s, _MIX)
        s = [b ^ k for b, k in zip(s, rks[rnd])]
    return bytes(s)


def aes_decrypt_block(key: bytes, block16: bytes) -> bytes:
    rks = key_schedule(key)
    last = len(rks) - 1
    s = [b ^ k for b, k in zip(block16, rks[last])]
    for rnd in range(last - 1, -1, -1):
        s = [INV_SBOX[s[p]] for p in INV_SHIFT]
        s = [b ^ k for b, k in zip(s, rks[rnd])]
        if rnd > 0:
            s = _mix(s, _INV_MIX)
    return bytes(s)


# ---- the batch forms on torch tensors ---------------------------------------

def _table(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.uint8), device=device)


@functools.lru_cache(maxsize=None)
def _tables(device) -> dict:
    """The S-boxes and the products as uint8[256] tensors on ``device``,
    and the (inverse) ShiftRows permutations."""
    out = {"sbox": _table(bytearray(SBOX), device),
           "inv_sbox": _table(bytearray(INV_SBOX), device),
           "shift": torch.as_tensor(SHIFT, device=device),
           "inv_shift": torch.as_tensor(INV_SHIFT, device=device)}
    out.update({c: _table(v, device) for c, v in _MUL.items()})
    return out


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def aes_key_schedule_batch(key: torch.Tensor) -> torch.Tensor:
    """uint8[B, 16|32] keys -> uint8[B, rounds + 1, 16] round keys."""
    sbox = _tables(key.device)["sbox"]
    nk = key.shape[1] // 4
    rounds = {4: 10, 8: 14}[nk]
    w = [key[:, 4 * i:4 * i + 4] for i in range(nk)]
    for i in range(nk, 4 * (rounds + 1)):
        t = w[i - 1]
        if i % nk == 0:
            t = _take(sbox, torch.roll(t, -1, dims=1))
            t[:, 0] ^= RCON[i // nk - 1]
        elif nk == 8 and i % nk == 4:
            t = _take(sbox, t)
        w.append(w[i - nk] ^ t)
    return torch.stack(w, dim=1).reshape(key.shape[0], rounds + 1, 16)


def _mix_batch(s: torch.Tensor, tabs: dict, coefs) -> torch.Tensor:
    """(Inv)MixColumns of uint8[B, 16] column-major states."""
    cols = s.reshape(-1, 4, 4)
    prod = {c: _take(tabs[c], cols) for c in {c for row in coefs
                                              for c in row}}
    rows = []
    for r in range(4):
        acc = prod[coefs[r][0]][..., 0]
        for k in range(1, 4):
            acc = acc ^ prod[coefs[r][k]][..., k]
        rows.append(acc)
    return torch.stack(rows, dim=-1).reshape(-1, 16)


def aes_encrypt_block_batch(keys: torch.Tensor,
                            block: torch.Tensor) -> torch.Tensor:
    """Per-candidate keys uint8[B, 16|32] and plaintext blocks
    uint8[B, 16] -> ciphertext uint8[B, 16]."""
    tabs = _tables(keys.device)
    rks = aes_key_schedule_batch(keys)
    last = rks.shape[1] - 1
    shift = tabs["shift"]
    s = block ^ rks[:, 0]
    for rnd in range(1, last + 1):
        s = _take(tabs["sbox"], s)[:, shift]
        if rnd < last:
            s = _mix_batch(s, tabs, _MIX)
        s = s ^ rks[:, rnd]
    return s


def aes_decrypt_blocks(keys: torch.Tensor, blocks) -> torch.Tensor:
    """Per-candidate keys uint8[B, 16|32] and CONSTANT ciphertext blocks
    uint8[N, 16] (numpy, or a tensor already on the keys' device, which
    spares the copy) -> plaintext uint8[B, N, 16] (ECB; a CBC caller xors
    the previous ciphertext block itself)."""
    tabs = _tables(keys.device)
    rks = aes_key_schedule_batch(keys)
    last = rks.shape[1] - 1
    inv_shift = tabs["inv_shift"]
    if not isinstance(blocks, torch.Tensor):
        blocks = np.array(blocks, np.uint8)
    ct = torch.as_tensor(blocks, device=keys.device)
    out = []
    for n in range(ct.shape[0]):
        s = ct[n] ^ rks[:, last]
        for rnd in range(last - 1, -1, -1):
            s = _take(tabs["inv_sbox"], s)[:, inv_shift] ^ rks[:, rnd]
            if rnd > 0:
                s = _mix_batch(s, tabs, _INV_MIX)
        out.append(s)
    return torch.stack(out, dim=1)
