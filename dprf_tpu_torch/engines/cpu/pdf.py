"""PDF standard-security-handler oracle (hashcat 10400 / 10500): the
counterpart of the JAX package's engines/cpu/pdf.py.

The classic PDF encryption user-password check (PDF 1.1-1.6, RC4):

  key = MD5( pad32(password) || O || P_le32 || ID
             [|| 0xFFFFFFFF if R >= 4 and metadata unencrypted] )
  R2 (40-bit):   key = digest[:5];   U = RC4(key, PAD)
  R3+ (128-bit): 50 x digest = MD5(digest[:n]); key = digest[:n]
                 U = RC4(key, MD5(PAD || ID)), then 19 more passes
                 with key bytes xored by the pass number; compare
                 the first 16 bytes.

Line format (the hashcat one):
  $pdf$V*R*bits*P*enc_metadata*id_len*id*u_len*u*o_len*o

The oracle recomputes U; ``Target.digest`` is the stored U prefix that
the comparison uses (32 bytes for R2, 16 for R3+).  ``make_line`` runs
the format forward (what a PDF writer stores), to make test lines; the
algorithm follows the published PDF spec (ISO 32000 7.6.3).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional, Sequence

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import HashEngine, Target
from dprf_tpu_torch.engines.cpu.krb5 import rc4

#: the 32-byte password padding string from the PDF spec (7.6.3.3).
PAD = bytes([
    0x28, 0xBF, 0x4E, 0x5E, 0x4E, 0x75, 0x8A, 0x41,
    0x64, 0x00, 0x4E, 0x56, 0xFF, 0xFA, 0x01, 0x08,
    0x2E, 0x2E, 0x00, 0xB6, 0xD0, 0x68, 0x3E, 0x80,
    0x2F, 0x0C, 0xA9, 0xFE, 0x64, 0x53, 0x69, 0x7A])


def pdf_key(password: bytes, o: bytes, p: int, doc_id: bytes,
            rev: int, key_len: int, enc_metadata: bool = True) -> bytes:
    """Algorithm 2: the RC4 file-encryption key for one candidate."""
    msg = (password + PAD)[:32] + o[:32] + \
        struct.pack("<i", p) + doc_id
    if rev >= 4 and not enc_metadata:
        msg += b"\xff\xff\xff\xff"
    digest = hashlib.md5(msg).digest()
    if rev >= 3:
        for _ in range(50):
            digest = hashlib.md5(digest[:key_len]).digest()
    return digest[:key_len]


def pdf_user_check(password: bytes, o: bytes, p: int, doc_id: bytes,
                   rev: int, key_len: int,
                   enc_metadata: bool = True) -> bytes:
    """Algorithms 4/5: the recomputed U value (32 bytes R2, 16 R3+)."""
    key = pdf_key(password, o, p, doc_id, rev, key_len, enc_metadata)
    if rev == 2:
        return rc4(key, PAD)
    u = rc4(key, hashlib.md5(PAD + doc_id).digest())
    for i in range(1, 20):
        u = rc4(bytes(b ^ i for b in key), u)
    return u


def parse_pdf(text: str) -> dict:
    """hashcat $pdf$ line -> params dict."""
    t = text.strip()
    if not t.startswith("$pdf$"):
        raise ValueError(f"not a $pdf$ line: {text[:40]!r}")
    f = t[len("$pdf$"):].split("*")
    if len(f) < 10:
        raise ValueError(f"malformed $pdf$ line ({len(f)} fields)")
    ver, rev, bits, p = int(f[0]), int(f[1]), int(f[2]), int(f[3])
    enc_metadata = f[4] not in ("0", "false")
    id_len, doc_id = int(f[5]), bytes.fromhex(f[6])
    u_len, u = int(f[7]), bytes.fromhex(f[8])
    o_len, o = int(f[9]), bytes.fromhex(f[10]) if len(f) > 10 else b""
    if len(doc_id) != id_len or len(u) != u_len or len(o) != o_len:
        raise ValueError("field length mismatch in $pdf$ line")
    if rev not in (2, 3, 4):
        raise ValueError(f"unsupported $pdf$ revision {rev} (R2-R4 "
                         "RC4 only; R5/R6 are SHA-based AES)")
    if bits not in (40, 128):
        raise ValueError(f"unsupported key size {bits}")
    if rev == 2 and bits != 40:
        raise ValueError("R2 implies 40-bit keys (spec 7.6.3.2)")
    if len(o) != 32 or len(u) < 16:
        raise ValueError("$pdf$ O must be 32 bytes, U at least 16")
    return {"ver": ver, "rev": rev, "key_len": bits // 8, "p": p,
            "enc_metadata": enc_metadata, "id": doc_id, "u": u,
            "o": o}


def make_line(password: bytes, rev: int, bits: int, o: bytes, p: int,
              doc_id: bytes, enc_metadata: bool = True) -> str:
    """The $pdf$ line of a document whose user password is
    ``password``: U recomputed forward (R3+ U is 16 bytes of result and
    16 arbitrary ones, here zeros, as a writer pads it)."""
    u = pdf_user_check(password, o, p, doc_id, rev, bits // 8, enc_metadata)
    u = (u + bytes(16))[:32]
    ver = 1 if rev == 2 else 2 if rev == 3 else 4
    return (f"$pdf${ver}*{rev}*{bits}*{p}*{int(enc_metadata)}*{len(doc_id)}*"
            f"{doc_id.hex()}*{len(u)}*{u.hex()}*{len(o)}*{o.hex()}")


@register("pdf")
class PdfEngine(HashEngine):
    """PDF RC4 user-password check (hashcat 10400/10500; revision is
    read per target from the $pdf$ line)."""

    name = "pdf"
    digest_size = 16            # R3+ compare width; R2 targets carry 32
    salted = True
    max_candidate_len = 27

    def parse_target(self, text: str) -> Target:
        params = parse_pdf(text)
        width = 32 if params["rev"] == 2 else 16
        return Target(raw=text.strip(),
                      digest=params["u"][:width], params=params)

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError("pdf needs target params ($pdf$ fields)")
        width = 32 if params["rev"] == 2 else 16
        return [pdf_user_check(c, params["o"], params["p"],
                               params["id"], params["rev"],
                               params["key_len"],
                               params["enc_metadata"])[:width]
                for c in candidates]
