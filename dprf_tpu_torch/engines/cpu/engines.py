"""CPU reference HashEngines -- the bit-exact oracles.

Every device engine must match them exactly; they are the
``--device cpu`` execution path of the CLI and verify every device hit
before it reaches the potfile.
"""

from __future__ import annotations

import hashlib
import hmac
from typing import Optional, Sequence

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import HashEngine, Target
from dprf_tpu_torch.engines.cpu import bcrypt as _bcrypt
from dprf_tpu_torch.engines.cpu.md4 import md4


class _HashlibEngine(HashEngine):
    _algo: str

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        algo = self._algo
        return [hashlib.new(algo, c).digest() for c in candidates]


@register("md5")
class Md5Engine(_HashlibEngine):
    name = "md5"
    digest_size = 16
    _algo = "md5"


@register("sha1")
@register("sha-1")
class Sha1Engine(_HashlibEngine):
    name = "sha1"
    digest_size = 20
    _algo = "sha1"


@register("sha256")
@register("sha-256")
class Sha256Engine(_HashlibEngine):
    name = "sha256"
    digest_size = 32
    _algo = "sha256"


@register("ntlm")
class NtlmEngine(HashEngine):
    """NTLM: MD4 over the UTF-16LE encoding of the password."""

    name = "ntlm"
    digest_size = 16
    # 27 chars -> 54 UTF-16LE bytes, still a single MD4 block after padding
    max_candidate_len = 27

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        # candidates are raw bytes read as latin-1 text, so the UTF-16LE
        # widening is the byte interleave NTLM expects for ASCII masks
        return [md4(c.decode("latin-1").encode("utf-16-le"))
                for c in candidates]


@register("bcrypt")
class BcryptEngine(HashEngine):
    """bcrypt (EksBlowfish), ``$2a$`` / ``$2b$`` / ``$2y$`` lines, cost
    4..31.  Salted: digests are per (candidate, target)."""

    name = "bcrypt"
    digest_size = 23
    salted = True
    max_candidate_len = 72

    def parse_target(self, text: str) -> Target:
        variant, cost, salt, digest = _bcrypt.parse_hash(text)
        if not 4 <= cost <= 31:
            raise ValueError(f"bcrypt cost out of range 4..31: {cost}")
        return Target(raw=text.strip(), digest=digest,
                      params={"variant": variant, "cost": cost, "salt": salt})

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError("bcrypt needs target params (salt, cost)")
        salt, cost = params["salt"], params["cost"]
        return [_bcrypt.bcrypt_raw(c, salt, cost) for c in candidates]


@register("wpa2-pmkid")
@register("pmkid")
class Pmkid2Engine(HashEngine):
    """WPA2-PMKID: PMK = PBKDF2-HMAC-SHA1(pass, essid, 4096, 32);
    PMKID = HMAC-SHA1(PMK, "PMK Name" | MAC_AP | MAC_STA)[:16].

    Target lines use the hashcat 16800 format:
    ``pmkid*mac_ap*mac_sta*essid_hex`` (macs as 12 hex chars, no colons).
    """

    name = "wpa2-pmkid"
    digest_size = 16
    salted = True
    max_candidate_len = 63    # WPA passphrase limit
    iterations = 4096         # PBKDF2 rounds; tests lower it for speed

    def parse_target(self, text: str) -> Target:
        parts = text.strip().split("*")
        if len(parts) != 4:
            raise ValueError(f"expected pmkid*mac_ap*mac_sta*essid, "
                             f"got {text!r}")
        pmkid, mac_ap, mac_sta, essid_hex = parts
        digest = bytes.fromhex(pmkid)
        ap, sta = bytes.fromhex(mac_ap), bytes.fromhex(mac_sta)
        if len(digest) != self.digest_size:
            raise ValueError(f"PMKID must be {self.digest_size} bytes, "
                             f"got {len(digest)} from {text!r}")
        if len(ap) != 6 or len(sta) != 6:
            raise ValueError(f"MACs must be 6 bytes each in {text!r}")
        return Target(raw=text.strip(), digest=digest,
                      params={"essid": bytes.fromhex(essid_hex),
                              "mac_ap": ap, "mac_sta": sta})

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError("wpa2-pmkid needs target params (essid, macs)")
        message = b"PMK Name" + params["mac_ap"] + params["mac_sta"]
        out = []
        for c in candidates:
            pmk = hashlib.pbkdf2_hmac("sha1", c, params["essid"],
                                      self.iterations, 32)
            out.append(hmac.new(pmk, message, hashlib.sha1).digest()[:16])
        return out
