"""Kerberos 5 etype-23 (RC4-HMAC) oracles: TGS-REP and AS-REP tickets,
hashcat modes 13100 ("Kerberoasting") and 18200 ("AS-REP roasting").
The counterpart of the JAX package's engines/cpu/krb5.py.

RFC 4757:

    K  = NTLM(password) = MD4(UTF-16LE(password))
    K1 = HMAC-MD5(K, msg_type)      msg_type 4-byte LE: 2 TGS, 8 AS-REP
    K3 = HMAC-MD5(K1, checksum)
    plaintext = RC4(K3, edata2)
    valid  <=>  HMAC-MD5(K1, plaintext) == checksum

``hash_batch`` recomputes the checksum, so ``digest == target.digest``
is the compare.  The card's path (engines/device/krb5.py) checks the
DER header of the decrypted ticket instead and confirms each survivor
here.
"""

from __future__ import annotations

import hmac as _hmac
from typing import Optional, Sequence

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import HashEngine, Target
from dprf_tpu_torch.engines.cpu.md4 import md4

#: RFC 4757 message types (the 4-byte little-endian HMAC input)
TGS_MSG_TYPE = 2
ASREP_MSG_TYPE = 8

#: edata2 holds at least the 8-byte confounder, a DER header and content
MIN_EDATA = 24


def rc4(key: bytes, data: bytes) -> bytes:
    """Plain RC4 (KSA + PRGA), the oracle's stream cipher."""
    S = list(range(256))
    j = 0
    for i in range(256):
        j = (j + S[i] + key[i % len(key)]) & 0xFF
        S[i], S[j] = S[j], S[i]
    out = bytearray(len(data))
    i = j = 0
    for t, c in enumerate(data):
        i = (i + 1) & 0xFF
        j = (j + S[i]) & 0xFF
        S[i], S[j] = S[j], S[i]
        out[t] = c ^ S[(S[i] + S[j]) & 0xFF]
    return bytes(out)


def nt_hash(password: bytes) -> bytes:
    """MD4 over the UTF-16LE password (bytes read as latin-1), as the
    ntlm oracle computes it."""
    return md4(password.decode("latin-1").encode("utf-16-le"))


def krb5_rc4_checksum(password: bytes, msg_type: int, checksum: bytes,
                      edata: bytes) -> bytes:
    """The ticket's checksum recomputed for one candidate (RFC 4757)."""
    k1 = _hmac.new(nt_hash(password), msg_type.to_bytes(4, "little"),
                   "md5").digest()
    k3 = _hmac.new(k1, checksum, "md5").digest()
    return _hmac.new(k1, rc4(k3, edata), "md5").digest()


def der(tag: int, content: bytes) -> bytes:
    """A DER element: the tag, the minimal definite length, the
    content."""
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    if n <= 0xFF:
        return bytes([tag, 0x81, n]) + content
    if n <= 0xFFFF:
        return bytes([tag, 0x82, n >> 8, n & 0xFF]) + content
    return bytes([tag, 0x83, n >> 16, (n >> 8) & 0xFF, n & 0xFF]) + content


def encrypt(password: bytes, msg_type: int,
            plaintext: bytes) -> tuple[bytes, bytes]:
    """(checksum, edata2) of ``plaintext`` under ``password``: RFC 4757
    run forward, as a KDC encrypts a ticket (the check's inverse; used to
    make test lines)."""
    k1 = _hmac.new(nt_hash(password), msg_type.to_bytes(4, "little"),
                   "md5").digest()
    checksum = _hmac.new(k1, plaintext, "md5").digest()
    return checksum, rc4(_hmac.new(k1, checksum, "md5").digest(), plaintext)


def _checksum_edata(fields: list[str], what: str) -> tuple[bytes, bytes]:
    """Decode the trailing checksum and edata2 hex fields of a line."""
    chk_hex, edata_hex = fields
    checksum = bytes.fromhex(chk_hex)
    edata = bytes.fromhex(edata_hex)
    if len(checksum) != 16:
        raise ValueError(f"{what}: checksum must be 16 bytes, "
                         f"got {len(checksum)}")
    if len(edata) < MIN_EDATA:
        raise ValueError(f"{what}: edata2 is {len(edata)} bytes "
                         f"(< {MIN_EDATA}) — truncated line?")
    return checksum, edata


def parse_krb5tgs(text: str) -> tuple[bytes, bytes]:
    """``$krb5tgs$23$*user$realm$spn*$checksum$edata2`` (the starred
    account part is optional) -> (checksum, edata2)."""
    t = text.strip()
    if not t.startswith("$krb5tgs$23$"):
        if t.startswith(("$krb5tgs$17$", "$krb5tgs$18$")):
            raise ValueError("etype-17/18 ticket: use --engine "
                             "krb5tgs-aes (AES modes), not the "
                             "etype-23 RC4 engine")
        raise ValueError(f"not a $krb5tgs$23$ line: {text[:40]!r}")
    rest = t[len("$krb5tgs$23$"):]
    if rest.startswith("*"):
        _, sep, rest = rest[1:].partition("*$")
        if not sep:
            raise ValueError(f"unterminated account metadata: {text[:60]!r}")
    fields = rest.split("$")
    if len(fields) != 2:
        raise ValueError(f"expected checksum$edata2, got "
                         f"{len(fields)} fields: {text[:60]!r}")
    return _checksum_edata(fields, "krb5tgs")


def parse_krb5asrep(text: str) -> tuple[bytes, bytes]:
    """``$krb5asrep$23$user@realm:checksum$edata2`` (the account part
    before ':' is optional) -> (checksum, edata2)."""
    t = text.strip()
    if not t.startswith("$krb5asrep$"):
        raise ValueError(f"not a $krb5asrep$ line: {text[:40]!r}")
    rest = t[len("$krb5asrep$"):]
    etype, sep, after = rest.partition("$")
    # an etype field is 1-2 digits; an all-decimal 32-hex checksum is not
    if sep and etype.isdigit() and len(etype) <= 2:
        if etype != "23":
            raise ValueError(f"$krb5asrep$ etype {etype} is not "
                             "RC4-HMAC (23) — AES etypes need a "
                             "different engine")
        rest = after
    head, _, edata_hex = rest.rpartition("$")
    _, _, chk_hex = head.rpartition(":")
    return _checksum_edata([chk_hex, edata_hex], "krb5asrep")


class _Krb5Rc4Engine(HashEngine):
    """The RFC 4757 oracle; subclasses fix msg_type and the line form."""

    digest_size = 16
    salted = True
    max_candidate_len = 27      # NTLM's single-block UTF-16LE limit
    _msg_type: int = 0

    def _parse(self, text: str) -> tuple[bytes, bytes]:
        raise NotImplementedError

    def parse_target(self, text: str) -> Target:
        checksum, edata = self._parse(text)
        return Target(raw=text.strip(), digest=checksum,
                      params={"checksum": checksum, "edata": edata,
                              "msg_type": self._msg_type})

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError(f"{self.name} needs target params "
                             "(checksum + edata2)")
        return [krb5_rc4_checksum(c, params["msg_type"],
                                  params["checksum"], params["edata"])
                for c in candidates]


@register("krb5tgs")
class Krb5TgsEngine(_Krb5Rc4Engine):
    """Kerberos 5 TGS-REP etype 23, "Kerberoasting" (hashcat 13100)."""

    name = "krb5tgs"
    _msg_type = TGS_MSG_TYPE

    def _parse(self, text: str) -> tuple[bytes, bytes]:
        return parse_krb5tgs(text)


@register("krb5asrep")
class Krb5AsRepEngine(_Krb5Rc4Engine):
    """Kerberos 5 AS-REP etype 23, "AS-REP roasting" (hashcat 18200)."""

    name = "krb5asrep"
    _msg_type = ASREP_MSG_TYPE

    def _parse(self, text: str) -> tuple[bytes, bytes]:
        return parse_krb5asrep(text)
