"""Kerberos 5 AES etypes 17/18 oracles: TGS-REP (hashcat 19600/19700),
Pre-Auth timestamp (19800/19900) and AS-REP (32100).  The counterpart
of the JAX package's engines/cpu/krb5aes.py.

RFC 3962 (AES-CTS) over the RFC 3961 simplified profile:

    base  = PBKDF2-HMAC-SHA1(password, salt, 4096, keylen)
    key   = DK(base, "kerberos")            # string-to-key, last step
    Ke    = DK(key, usage_be4 || 0xAA)      # encryption subkey
    Ki    = DK(key, usage_be4 || 0x55)      # integrity subkey
    plain = CBC-CS3-decrypt(Ke, edata2, IV=0)
    valid <=> HMAC-SHA1(Ki, plain)[:12] == checksum

keylen 16 (etype 17, AES-128) or 32 (etype 18, AES-256); DK n-folds the
constant to 16 bytes and chains AES-ECB encryptions under the deriving
key; usage 2 for a TGS-REP ticket, 1 for the AS-REQ PA-ENC-TIMESTAMP, 3
for the AS-REP enc-part.  The salt is realm || principal as the line
carries them (the MIT default salt; hashcat does the same).

The card's path (engines/device/krb5aes.py) prefilters on the decrypted
DER header and confirms each survivor here.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import math
from typing import Optional, Sequence

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import HashEngine, Target
from dprf_tpu_torch.ops.aes import aes_decrypt_block, aes_encrypt_block

#: RFC 3961 key-usage numbers for the three carried modes.
USAGE_PA_TIMESTAMP = 1       # AS-REQ PA-ENC-TIMESTAMP (krb5pa)
USAGE_TGS_REP_TICKET = 2     # TGS-REP ticket enc-part (krb5tgs)
USAGE_AS_REP = 3             # AS-REP enc-part (krb5asrep)

PBKDF2_ITERATIONS = 4096     # MIT/AD default (no s2kparams in lines)

#: ciphertext floor: 16-byte confounder block + at least one more
#: block for the CTS pair.
MIN_EDATA = 32


def nfold(data: bytes, nbytes: int) -> bytes:
    """RFC 3961 n-fold: stretch/compress `data` to `nbytes` with
    13-bit-rotation replication and ones'-complement addition."""
    def rot13(b: bytes, step: int) -> bytes:
        bits = int.from_bytes(b, "big")
        n = 8 * len(b)
        r = (13 * step) % n
        bits = ((bits >> r) | (bits << (n - r))) & ((1 << n) - 1)
        return bits.to_bytes(len(b), "big")

    lcm = len(data) * nbytes // math.gcd(len(data), nbytes)
    buf = b"".join(rot13(data, i) for i in range(lcm // len(data)))
    # ones'-complement add of the nbytes-sized chunks
    mask = (1 << (8 * nbytes)) - 1
    total = 0
    for i in range(0, lcm, nbytes):
        total += int.from_bytes(buf[i:i + nbytes], "big")
    while total >> (8 * nbytes):
        total = (total & mask) + (total >> (8 * nbytes))
    return total.to_bytes(nbytes, "big")


def dk(key: bytes, constant: bytes) -> bytes:
    """RFC 3961 DK for AES (random-to-key = identity): n-fold the
    constant to one block, then chain ECB encryptions under `key`
    until len(key) bytes of derived material exist."""
    block = constant if len(constant) == 16 else nfold(constant, 16)
    out = b""
    while len(out) < len(key):
        block = aes_encrypt_block(key, block)
        out += block
    return out[:len(key)]


def string_to_key(password: bytes, salt: bytes, key_len: int,
                  iterations: int = PBKDF2_ITERATIONS) -> bytes:
    """RFC 3962 string-to-key: PBKDF2 then DK with "kerberos"."""
    base = hashlib.pbkdf2_hmac("sha1", password, salt, iterations,
                               key_len)
    return dk(base, b"kerberos")


def usage_keys(key: bytes, usage: int) -> tuple[bytes, bytes]:
    """(Ke, Ki) for a key-usage number."""
    u = usage.to_bytes(4, "big")
    return dk(key, u + b"\xaa"), dk(key, u + b"\x55")


def cts_decrypt(key: bytes, data: bytes) -> bytes:
    """AES-CBC-CS3 (ciphertext stealing) decrypt with a zero IV —
    RFC 3962's ciphertext layout.  len(data) >= 16; a lone full block
    is plain CBC."""
    n = len(data)
    if n < 16:
        raise ValueError("CTS needs at least one block")
    if n == 16:
        return aes_decrypt_block(key, data)
    full, tail = divmod(n, 16)
    if tail == 0:
        # CS3 swaps the last two (full) blocks even when aligned
        blocks = [data[16 * i:16 * i + 16] for i in range(full)]
        blocks[-1], blocks[-2] = blocks[-2], blocks[-1]
        prev = bytes(16)
        out = b""
        for b in blocks:
            out += bytes(x ^ y for x, y in
                         zip(aes_decrypt_block(key, b), prev))
            prev = b
        return out
    # ragged tail: decrypt C_{n-1} (the LAST sent block, which is the
    # stolen full block) to recover the tail and rebuild C_n
    head = data[:16 * (full - 1)]
    c_last_full = data[16 * (full - 1):16 * full]      # swapped position
    c_tail = data[16 * full:]
    d = aes_decrypt_block(key, c_last_full)
    tail_plain = bytes(x ^ y for x, y in zip(d[:tail], c_tail))
    c_prev_rebuilt = c_tail + d[tail:]
    prev = bytes(16)
    out = b""
    for i in range(full - 1):
        b = head[16 * i:16 * i + 16]
        out += bytes(x ^ y for x, y in
                     zip(aes_decrypt_block(key, b), prev))
        prev = b
    out += bytes(x ^ y for x, y in
                 zip(aes_decrypt_block(key, c_prev_rebuilt), prev))
    return out + tail_plain


def cts_encrypt(key: bytes, plain: bytes) -> bytes:
    """Inverse of cts_decrypt (test/forward-construction helper)."""
    n = len(plain)
    if n < 16:
        raise ValueError("CTS needs at least one block")
    if n == 16:
        return aes_encrypt_block(key, plain)
    full, tail = divmod(n, 16)
    blocks = [plain[16 * i:16 * i + 16] for i in range(full)]
    prev = bytes(16)
    cts = []
    for b in blocks:
        prev = aes_encrypt_block(
            key, bytes(x ^ y for x, y in zip(b, prev)))
        cts.append(prev)
    if tail:
        last = plain[16 * full:] + bytes(16 - tail)
        cn = aes_encrypt_block(
            key, bytes(x ^ y for x, y in zip(last, prev)))
        return (b"".join(cts[:-1]) + cn + cts[-1][:tail])
    cts[-1], cts[-2] = cts[-2], cts[-1]
    return b"".join(cts)


def krb5_aes_checksum(password: bytes, salt: bytes, key_len: int,
                      usage: int, edata: bytes,
                      iterations: int = PBKDF2_ITERATIONS) -> bytes:
    """Recompute the 12-byte HMAC-SHA1-96 tag for one candidate."""
    key = string_to_key(password, salt, key_len, iterations)
    ke, ki = usage_keys(key, usage)
    plain = cts_decrypt(ke, edata)
    return _hmac.new(ki, plain, hashlib.sha1).digest()[:12]


def encrypt(password: bytes, salt: bytes, key_len: int, usage: int,
            plaintext: bytes,
            iterations: int = PBKDF2_ITERATIONS) -> tuple[bytes, bytes]:
    """(checksum12, edata2) of ``plaintext`` under ``password``: RFC 3962
    run forward, as a KDC encrypts a ticket (the check's inverse; used to
    make test lines)."""
    ke, ki = usage_keys(string_to_key(password, salt, key_len, iterations),
                        usage)
    return (_hmac.new(ki, plaintext, hashlib.sha1).digest()[:12],
            cts_encrypt(ke, plaintext))


# ---------------------------------------------------------------------------
# hash-line parsing: $krb5tgs$17|18$user$realm$checksum$edata2 and the
# krb5pa / krb5asrep variants (hashcat 19600/19700/19800/19900/32100)

def parse_krb5aes(text: str, tag: str) -> tuple[int, bytes, bytes, bytes]:
    """-> (etype, salt, checksum12, edata2).

    checksum/edata2 are parsed from the RIGHT and user/realm split at
    the last middle '$', so principals containing '$' (AD machine
    accounts like WS01$) parse; realm names cannot contain '$'."""
    text = text.strip()
    for et in ("17", "18"):
        prefix = f"${tag}${et}$"
        if text.startswith(prefix):
            etype = int(et)
            rest = text[len(prefix):]
            break
    else:
        raise ValueError(f"not a ${tag}$17/18 line")
    try:
        middle, chk_hex, edata_hex = rest.rsplit("$", 2)
        user, realm = middle.rsplit("$", 1)
    except ValueError:
        raise ValueError(f"${tag}$: expected user$realm$checksum$"
                         "edata2 fields") from None
    if not user or not realm or "*" in realm or "*" in user:
        # extra starred metadata fields (etype-23 style) would land in
        # the middle and silently corrupt the salt; reject loudly
        raise ValueError(f"${tag}$: malformed user/realm fields "
                         f"{middle!r}")
    checksum = bytes.fromhex(chk_hex)
    edata = bytes.fromhex(edata_hex)
    if len(checksum) != 12:
        raise ValueError(f"${tag}$: checksum must be 12 bytes")
    if len(edata) < MIN_EDATA:
        raise ValueError(f"${tag}$: edata2 shorter than {MIN_EDATA}")
    salt = (realm + user).encode()
    return etype, salt, checksum, edata


class _Krb5AesEngine(HashEngine):
    """Shared RFC 3962 oracle; subclasses fix usage + line tag."""

    digest_size = 12
    salted = True
    max_candidate_len = 55      # one PBKDF2 HMAC key block
    #: PBKDF2 iteration count; no deployed realm ships s2kparams, so
    #: this stays the MIT/AD default -- overridable (tests, dry runs)
    #: exactly like the PMKID engine's attribute
    iterations = PBKDF2_ITERATIONS
    _usage: int = 0
    _tag: str = ""

    def parse_target(self, text: str) -> Target:
        etype, salt, checksum, edata = parse_krb5aes(text, self._tag)
        return Target(raw=text.strip(), digest=checksum,
                      params={"etype": etype, "salt": salt,
                              "checksum": checksum, "edata": edata,
                              "usage": self._usage,
                              "key_len": 16 if etype == 17 else 32})

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError(f"{self.name} needs target params")
        return [krb5_aes_checksum(c, params["salt"], params["key_len"],
                                  params["usage"], params["edata"],
                                  self.iterations)
                for c in candidates]


@register("krb5tgs17")
@register("krb5tgs18")
@register("krb5tgs-aes")
class Krb5TgsAesEngine(_Krb5AesEngine):
    """TGS-REP etypes 17/18, modern Kerberoasting (hashcat
    19600/19700; the etype field of the line picks the width)."""

    name = "krb5tgs-aes"
    _usage = USAGE_TGS_REP_TICKET
    _tag = "krb5tgs"


@register("krb5pa17")
@register("krb5pa18")
@register("krb5pa")
class Krb5PaAesEngine(_Krb5AesEngine):
    """AS-REQ Pre-Auth timestamp etypes 17/18 (hashcat 19800/19900)."""

    name = "krb5pa"
    _usage = USAGE_PA_TIMESTAMP
    _tag = "krb5pa"


@register("krb5asrep17")
@register("krb5asrep18")
@register("krb5asrep-aes")
class Krb5AsRepAesEngine(_Krb5AesEngine):
    """AS-REP enc-part etypes 17/18 (hashcat 32100)."""

    name = "krb5asrep-aes"
    _usage = USAGE_AS_REP
    _tag = "krb5asrep"
