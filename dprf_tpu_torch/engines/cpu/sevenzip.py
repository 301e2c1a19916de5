"""7-Zip AES-256 oracle (hashcat 11600), stored-coder entries: the
counterpart of the JAX package's engines/cpu/sevenzip.py.

The 7z password check (AES-256 + iterated SHA-256 KDF):

  key = SHA-256( concat_{i=0}^{2^cycles - 1} (salt || UTF-16LE(pw)
                                              || LE64(i)) )
  plaintext = AES-256-CBC-decrypt(key, iv, data)
  valid <=> CRC32(plaintext[:unpacked_len]) == stored crc

Line format (the 7z2hashcat one):
  $7z$p$cycles$salt_len$salt$iv_len$iv$crc$data_len$unpacked_len$data
p = 0 means the encrypted stream holds the STORED (uncompressed) file,
which this engine verifies end to end.  p != 0 entries need the
archive's LZMA coder chain to check the CRC; they are rejected at parse
time rather than half-checked.

``encrypt`` runs the format forward (what 7-Zip does when it stores a
file under a password), to make test lines.
"""

from __future__ import annotations

import hashlib
import struct
import zlib
from typing import Optional, Sequence

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import HashEngine, Target
from dprf_tpu_torch.ops.aes import aes_decrypt_block, aes_encrypt_block

#: 7-Zip's default NumCyclesPower
DEFAULT_CYCLES = 19


def sevenzip_key(password: bytes, salt: bytes, cycles: int) -> bytes:
    """The iterated-SHA-256 file key (UTF-16LE password)."""
    pw = password.decode("latin-1").encode("utf-16-le")
    unit = salt + pw
    h = hashlib.sha256()
    # the 2^cycles counter units in chunks (2^19 units of an 8-character
    # password are ~12 MB)
    step = 4096
    n = 1 << cycles
    for start in range(0, n, step):
        h.update(b"".join(unit + struct.pack("<Q", i)
                          for i in range(start, min(start + step, n))))
    return h.digest()


def sevenzip_decrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-256-CBC (iv zero-padded to 16 bytes, the 7z convention)."""
    iv = (iv + bytes(16))[:16]
    out = bytearray()
    prev = iv
    for off in range(0, len(data), 16):
        block = data[off:off + 16]
        plain = aes_decrypt_block(key, block)
        out += bytes(p ^ v for p, v in zip(plain, prev))
        prev = block
    return bytes(out)


def parse_7z(text: str) -> dict:
    t = text.strip()
    if not t.startswith("$7z$"):
        raise ValueError(f"not a $7z$ line: {text[:40]!r}")
    f = t[len("$7z$"):].split("$")
    if len(f) != 10:
        raise ValueError(f"malformed $7z$ line ({len(f)} fields, "
                         "expected 10)")
    p, cycles = int(f[0]), int(f[1])
    salt_len, salt = int(f[2]), bytes.fromhex(f[3])
    iv_len, iv = int(f[4]), bytes.fromhex(f[5])
    crc = int(f[6]) & 0xFFFFFFFF
    data_len, unpacked_len = int(f[7]), int(f[8])
    data = bytes.fromhex(f[9])
    if p != 0:
        raise ValueError(
            f"$7z$ coder type {p} is compressed; only stored (type 0) "
            "entries are verifiable without the archive's LZMA chain")
    # 7z2hashcat zero-pads the IV hex field to 16 bytes while iv_len
    # records the true length (p7zip commonly uses 8-byte IVs): accept
    # the padded field and keep the true prefix (decrypt re-pads)
    if len(iv) < iv_len:
        raise ValueError("IV field shorter than iv_len in $7z$ line")
    iv = iv[:iv_len]
    if len(salt) != salt_len or len(data) != data_len:
        raise ValueError("field length mismatch in $7z$ line")
    if not 0 < cycles <= 24:
        raise ValueError(f"unsupported cycles power {cycles}")
    if data_len % 16 or not 0 < unpacked_len <= data_len:
        raise ValueError("$7z$ data must be 16-byte blocks covering "
                         "unpacked_len")
    return {"cycles": cycles, "salt": salt, "iv": iv, "crc": crc,
            "unpacked_len": unpacked_len, "data": data}


def encrypt(password: bytes, plain: bytes, cycles: int = DEFAULT_CYCLES,
            salt: bytes = b"", iv: bytes = bytes(range(16))) -> str:
    """The $7z$ line of a stored entry holding ``plain`` under
    ``password``: the key, AES-256-CBC over ``plain`` zero-padded to
    whole blocks, its CRC32 (the check's inverse; used to make test
    lines)."""
    key = sevenzip_key(password, salt, cycles)
    data = plain + bytes(-len(plain) % 16)
    prev = (iv + bytes(16))[:16]
    out = bytearray()
    for off in range(0, len(data), 16):
        prev = aes_encrypt_block(
            key, bytes(a ^ b for a, b in zip(data[off:off + 16], prev)))
        out += prev
    crc = zlib.crc32(plain) & 0xFFFFFFFF
    return (f"$7z$0${cycles}${len(salt)}${salt.hex()}${len(iv)}${iv.hex()}"
            f"${crc}${len(out)}${len(plain)}${bytes(out).hex()}")


@register("7z")
@register("sevenzip")
class SevenZipEngine(HashEngine):
    """7-Zip stored-entry password check (hashcat 11600)."""

    name = "7z"
    digest_size = 4            # the CRC32 is the compared value
    salted = True
    max_candidate_len = 27

    def parse_target(self, text: str) -> Target:
        params = parse_7z(text)
        return Target(raw=text.strip(),
                      digest=struct.pack("<I", params["crc"]),
                      params=params)

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError("7z needs target params ($7z$ fields)")
        out = []
        for c in candidates:
            key = sevenzip_key(c, params["salt"], params["cycles"])
            plain = sevenzip_decrypt(key, params["iv"], params["data"])
            out.append(struct.pack(
                "<I", zlib.crc32(plain[:params["unpacked_len"]])
                & 0xFFFFFFFF))
        return out
