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


@register("sha512")
@register("sha-512")
class Sha512Engine(_HashlibEngine):
    name = "sha512"
    digest_size = 64
    max_candidate_len = 111    # single-block limit of the device engine
    _algo = "sha512"


@register("sha384")
@register("sha-384")
class Sha384Engine(_HashlibEngine):
    name = "sha384"
    digest_size = 48
    max_candidate_len = 111
    _algo = "sha384"


@register("sha224")
class Sha224Engine(_HashlibEngine):
    name = "sha224"
    digest_size = 28
    _algo = "sha224"


#: (bits, sponge rate) of the SHA3/Keccak family; rate = 200 - bits/4
KECCAK_SIZES = [(224, 144), (256, 136), (384, 104), (512, 72)]


class _KeccakCpuBase(HashEngine):
    """The SHA3/Keccak family: bare hex-digest lines.  ``_pad_byte``
    0x06 (SHA3, hashlib) or 0x01 (the original Keccak, the scalar
    sponge of ops/keccak.py); ``_rate`` the sponge's rate in bytes."""

    _pad_byte: int
    _rate: int

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if self._pad_byte == 0x06:
            algo = f"sha3_{8 * self.digest_size}"
            return [hashlib.new(algo, c).digest() for c in candidates]
        from dprf_tpu_torch.ops.keccak import keccak_digest
        return [keccak_digest(c, 0x01, self._rate, self.digest_size)
                for c in candidates]


def _register_keccak_family():
    """sha3-224/256/384/512 (hashcat 17300/17400/17500/17600; ``sha3``
    is sha3-256) and keccak-224/256/384/512 (17700/17800/17900/18000;
    also ``keccak224`` ...).  The 256 variants keep the 55-byte word
    limit of the other fast hashes, as the reference's do; the others
    take their rate block less the pad byte."""
    for bits, rate in KECCAK_SIZES:
        for kind, pad in (("sha3", 0x06), ("keccak", 0x01)):
            name = f"{kind}-{bits}"
            title = "SHA3" if kind == "sha3" else "Original Keccak (0x01 " \
                "padding)"
            cls = type(f"{kind.title()}{bits}Engine", (_KeccakCpuBase,),
                       {"name": name, "digest_size": bits // 8,
                        "max_candidate_len": 55 if bits == 256 else rate - 1,
                        "_pad_byte": pad, "_rate": rate,
                        "__doc__": f"{title}-{bits}: bare hex-digest lines."})
            aliases = {"sha3-256": ["sha3"], f"keccak-{bits}":
                       [f"keccak{bits}"]}.get(name, [])
            for n in (name, *aliases):
                register(n)(cls)


_register_keccak_family()


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


# ---- salted fast hashes: hexdigest:salt, LDAP, Oracle 11g, PostgreSQL ----

#: fixed device salt buffer width; also bounds parseable salt length
SALT_MAX = 32

_SALT_HEX_RE = None


def parse_salted_line(text: str, digest_size: int):
    """hashcat-convention 'hexdigest:salt' -> (digest, salt bytes);
    '$HEX[..]' decodes hex salts.  Shared by CPU and device engines."""
    import re
    global _SALT_HEX_RE
    if _SALT_HEX_RE is None:
        _SALT_HEX_RE = re.compile(r"^\$HEX\[([0-9a-fA-F]*)\]$")
    digest_hex, sep, salt_text = text.strip().partition(":")
    if not sep:
        raise ValueError(f"expected 'digest:salt', got {text!r}")
    digest = bytes.fromhex(digest_hex)
    if len(digest) != digest_size:
        raise ValueError(f"expected {digest_size}-byte digest in {text!r}")
    m = _SALT_HEX_RE.match(salt_text)
    salt = bytes.fromhex(m.group(1)) if m else salt_text.encode("latin-1")
    if len(salt) > SALT_MAX:
        raise ValueError(f"salt longer than {SALT_MAX} bytes in {text!r}")
    return digest, salt


class _SaltedCpuMixin(HashEngine):
    """CPU oracle for the salted fast modes: md5/sha1/sha256 over
    $pass.$salt ('ps', hashcat 10/110/1410) and $salt.$pass ('sp',
    hashcat 20/120/1420)."""

    salted = True
    _order: str

    def parse_target(self, text: str) -> Target:
        digest, salt = parse_salted_line(text, self.digest_size)
        return Target(raw=text.strip(), digest=digest,
                      params={"salt": salt})

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError(f"{self.name} needs target params (salt)")
        salt = params["salt"]
        if self._order == "ps":
            return [hashlib.new(self._algo, c + salt).digest()
                    for c in candidates]
        return [hashlib.new(self._algo, salt + c).digest()
                for c in candidates]


def _register_salted_cpu(algo: str, digest_size: int,
                         block_limit: int = 55):
    for order in ("ps", "sp"):
        name = f"{algo}-{order}"
        cls = type(f"{algo.title()}{order.title()}Engine",
                   (_SaltedCpuMixin,),
                   {"name": name, "digest_size": digest_size,
                    "_algo": algo, "_order": order,
                    "__doc__": (f"Salted {algo}: "
                                + ("$pass.$salt" if order == "ps"
                                   else "$salt.$pass")
                                + " ('hexdigest:salt' lines)."),
                    # leave headroom for any parseable salt in the
                    # single block
                    "max_candidate_len": block_limit - SALT_MAX})
        register(name, device="cpu")(cls)


_register_salted_cpu("md5", 16)
_register_salted_cpu("sha1", 20)
_register_salted_cpu("sha256", 32)
_register_salted_cpu("sha512", 64, block_limit=111)


def parse_ldap_line(text: str, scheme: str, digest_size: int):
    """LDAP userPassword line '{SCHEME}base64(digest + salt)' ->
    (digest, salt).  The salt is whatever follows the digest in the
    decoded blob (typically 4-8 bytes; empty for the unsalted {SHA}/
    {MD5} schemes)."""
    import base64

    t = text.strip()
    tag = "{" + scheme + "}"
    if not t[:len(tag)].upper() == tag:
        raise ValueError(f"not an LDAP {tag} line: {text!r}")
    try:
        blob = base64.b64decode(t[len(tag):], validate=True)
    except Exception as e:
        raise ValueError(f"bad base64 in LDAP line {text!r}: {e}")
    if len(blob) < digest_size:
        raise ValueError(f"LDAP {tag} blob shorter than the "
                         f"{digest_size}-byte digest: {text!r}")
    digest, salt = blob[:digest_size], blob[digest_size:]
    if len(salt) > SALT_MAX:
        raise ValueError(f"salt longer than {SALT_MAX} bytes in {text!r}")
    return digest, salt


class _LdapSaltedEngine(_SaltedCpuMixin):
    """LDAP {SSHA}-style schemes: digest(pass + salt), digest and salt
    packed together in one base64 blob -- the salted 'ps' computation
    with LDAP's line format."""

    _order = "ps"
    _scheme: str

    def parse_target(self, text: str) -> Target:
        digest, salt = parse_ldap_line(text, self._scheme,
                                       self.digest_size)
        return Target(raw=text.strip(), digest=digest,
                      params={"salt": salt})


@register("ldap-ssha")
@register("ssha")
class LdapSshaEngine(_LdapSaltedEngine):
    """LDAP {SSHA} (hashcat 111): sha1($pass.$salt), base64 blob."""

    name = "ldap-ssha"
    digest_size = 20
    _algo = "sha1"
    _scheme = "SSHA"
    max_candidate_len = 55 - SALT_MAX


@register("ldap-ssha512")
@register("ssha512")
class LdapSsha512Engine(_LdapSaltedEngine):
    """LDAP {SSHA512} (hashcat 1711): sha512($pass.$salt)."""

    name = "ldap-ssha512"
    digest_size = 64
    _algo = "sha512"
    _scheme = "SSHA512"
    max_candidate_len = 111 - SALT_MAX


@register("ldap-smd5")
class LdapSmd5Engine(_LdapSaltedEngine):
    """LDAP {SMD5}: md5($pass.$salt), base64 blob."""

    name = "ldap-smd5"
    digest_size = 16
    _algo = "md5"
    _scheme = "SMD5"
    max_candidate_len = 55 - SALT_MAX


class _LdapPlainMixin(HashEngine):
    """Unsalted LDAP schemes ({SHA}, {MD5}): the plain fast hash with
    the base64 line format, so the multi-target fast path applies."""

    _scheme: str

    def parse_target(self, text: str) -> Target:
        digest, salt = parse_ldap_line(text, self._scheme,
                                       self.digest_size)
        if salt:
            raise ValueError(f"unexpected salt bytes after the digest "
                             f"in unsalted {{{self._scheme}}} line: "
                             f"{text!r}")
        return Target(raw=text.strip(), digest=digest)


@register("ldap-sha")
class LdapShaEngine(_LdapPlainMixin, Sha1Engine):
    """LDAP {SHA} (hashcat 101): raw sha1, base64 line format."""

    name = "ldap-sha"
    _scheme = "SHA"


@register("ldap-md5")
class LdapMd5Engine(_LdapPlainMixin, Md5Engine):
    """LDAP {MD5}: raw md5, base64 line format."""

    name = "ldap-md5"
    _scheme = "MD5"


@register("oracle11")
@register("oracle-11g")
class Oracle11Engine(_SaltedCpuMixin):
    """Oracle 11g (hashcat 112): sha1($pass.$salt) with a 10-byte
    salt.  Accepts Oracle's native 'S:<40-hex digest><20-hex salt>'
    and hashcat's 'hexdigest:salt' lines."""

    name = "oracle11"
    digest_size = 20
    _algo = "sha1"
    _order = "ps"
    #: the 11g salt is fixed at 10 raw bytes, so candidates get the
    #: rest of the single block (cf. the generic 55 - SALT_MAX cap)
    max_candidate_len = 55 - 10

    def parse_target(self, text: str) -> Target:
        t = text.strip()
        if t[:2].upper() == "S:" and len(t) == 62:
            try:
                digest = bytes.fromhex(t[2:42])
                salt = bytes.fromhex(t[42:])
            except ValueError:
                raise ValueError(f"bad hex in oracle11 line: {text!r}")
            return Target(raw=t, digest=digest, params={"salt": salt})
        tgt = super().parse_target(text)
        salt = tgt.params["salt"]
        # hashcat -m 112 lines carry the salt HEX-ENCODED (ST_HEX):
        # a 20-hex-char field is the 10-byte salt, not literal bytes
        if len(salt) == 20:
            try:
                salt = bytes.fromhex(salt.decode("ascii"))
            except (ValueError, UnicodeDecodeError):
                pass
        if len(salt) != 10:
            raise ValueError(
                f"oracle11 salts are exactly 10 bytes (20 hex chars); "
                f"got {len(salt)} in {text!r}")
        return Target(raw=tgt.raw, digest=tgt.digest,
                      params={"salt": salt})


@register("postgres")
@register("postgres-md5")
class PostgresMd5Engine(_SaltedCpuMixin):
    """PostgreSQL MD5 auth hashes (hashcat 12): stored as
    ``md5<hex(md5(password || username))>``; target lines are
    ``md5<hex>:username`` or ``<hex>:username`` (``$HEX[..]`` decodes
    non-latin-1 usernames, the shared salted-line convention).  The
    hash itself is the salted-md5 'ps' oracle with the username as
    the salt."""

    name = "postgres"
    digest_size = 16
    _algo = "md5"
    _order = "ps"
    max_candidate_len = 55 - SALT_MAX

    def parse_target(self, text: str) -> Target:
        body = text.strip()
        if body.startswith("md5"):
            body = body[3:]
        digest, salt = parse_salted_line(body, self.digest_size)
        return Target(raw=text.strip(), digest=digest,
                      params={"salt": salt,
                              "user": salt.decode("latin-1")})


# ---- nested fast hashes and MySQL 4.1+ ----------------------------------

#: nested double-hash combinations (outer, inner) with their hashcat
#: modes -- the one list device/nested.py and the oracles share
NESTED_COMBOS = [
    ("md5", "md5"),        # 2600
    ("sha1", "sha1"),      # 4500
    ("md5", "sha1"),       # 4400
    ("sha1", "md5"),       # 4700
    ("sha256", "md5"),     # 20800
    ("sha256", "sha1"),    # 20700
]
NESTED_DIGEST_SIZE = {"md5": 16, "sha1": 20, "sha256": 32}


class _NestedCpuMixin(HashEngine):
    """CPU oracle for nested modes: outer(hex(inner(password)))."""

    _outer: str
    _inner: str

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        return [hashlib.new(
            self._outer,
            hashlib.new(self._inner, c).hexdigest().encode()).digest()
            for c in candidates]


def _register_nested_cpu():
    for outer, inner in NESTED_COMBOS:
        name = f"{outer}({inner})"
        cls = type(f"{outer.title()}Of{inner.title()}Engine",
                   (_NestedCpuMixin,),
                   {"name": name,
                    "digest_size": NESTED_DIGEST_SIZE[outer],
                    "__doc__": f"Nested {outer}(hex({inner}(password))).",
                    "_outer": outer, "_inner": inner})
        register(name, device="cpu")(cls)


_register_nested_cpu()


def parse_mysql41(text: str) -> Target:
    """MySQL 4.1+ hash line: '*' + 40 uppercase hex chars (the '*' is
    part of the stored format; bare hex is accepted too)."""
    t = text.strip()
    hexpart = t[1:] if t.startswith("*") else t
    digest = bytes.fromhex(hexpart)
    if len(digest) != 20:
        raise ValueError(f"mysql41 wants 20 digest bytes, got {text!r}")
    return Target(raw=t, digest=digest)


@register("mysql41")
class Mysql41Engine(HashEngine):
    """MySQL 4.1+ PASSWORD() = sha1(sha1(password)), raw inner digest."""

    name = "mysql41"
    digest_size = 20

    def parse_target(self, text: str) -> Target:
        return parse_mysql41(text)

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        return [hashlib.sha1(hashlib.sha1(c).digest()).digest()
                for c in candidates]


# ---- MySQL pre-4.1 and MSSQL -------------------------------------------

def mysql323_words(password: bytes) -> tuple:
    """MySQL pre-4.1 OLD_PASSWORD(): two 31-bit words from an
    add/xor/shift scan over the password bytes (space and tab are
    skipped, as the server does).  All arithmetic is u32."""
    M = 0xFFFFFFFF
    nr, nr2, add = 1345345333, 0x12345671, 7
    for c in password:
        if c in (0x20, 0x09):
            continue
        nr ^= ((((nr & 63) + add) * c) + ((nr << 8) & M)) & M
        nr2 = (nr2 + (((nr2 << 8) & M) ^ nr)) & M
        add = (add + c) & M
    return nr & 0x7FFFFFFF, nr2 & 0x7FFFFFFF


@register("mysql323")
@register("mysql-old")
class Mysql323Engine(HashEngine):
    """MySQL pre-4.1 OLD_PASSWORD (hashcat 200): 16 hex chars = two
    big-endian 31-bit words."""

    name = "mysql323"
    digest_size = 8
    max_candidate_len = 55

    def parse_target(self, text: str) -> Target:
        t = text.strip()
        digest = bytes.fromhex(t)
        if len(digest) != 8:
            raise ValueError(f"mysql323 wants 16 hex chars: {text!r}")
        return Target(raw=t, digest=digest)

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        out = []
        for c in candidates:
            a, b = mysql323_words(c)
            out.append(a.to_bytes(4, "big") + b.to_bytes(4, "big"))
        return out


def parse_mssql_line(text: str, version_tag: str, digest_hex: int):
    """MSSQL '0x<ver><8-hex salt><hex digest[s]>' -> (salt, digests).
    2000 lines carry TWO 40-hex sha1 digests (case-sensitive then
    upper-cased); 2005 carry one 40-hex; 2012/2014 one 128-hex."""
    t = text.strip()
    if not t.lower().startswith("0x" + version_tag):
        raise ValueError(f"not an MSSQL 0x{version_tag} line: {text!r}")
    body = t[2 + len(version_tag):]
    if len(body) < 8 + digest_hex or (len(body) - 8) % digest_hex:
        raise ValueError(f"malformed MSSQL line (want 8-hex salt + "
                         f"k x {digest_hex}-hex digest): {text!r}")
    try:
        salt = bytes.fromhex(body[:8])
        digests = [bytes.fromhex(body[8 + i * digest_hex:
                                      8 + (i + 1) * digest_hex])
                   for i in range((len(body) - 8) // digest_hex)]
    except ValueError:
        raise ValueError(f"bad hex in MSSQL line: {text!r}")
    return salt, digests


class _MssqlCpuBase(HashEngine):
    """sha-family over utf16le($pass) . $salt (4-byte salt)."""

    salted = True
    _algo: str
    _tag: str
    _upper = False
    #: digests per line: 2000 stores [case-sensitive, upper-cased],
    #: 2005/2012 exactly one.  Enforced so a 2000-format line fed to
    #: the 2005 engine (or vice versa) is rejected instead of silently
    #: cracking against the wrong digest.
    _ndigests = 1

    def parse_target(self, text: str) -> Target:
        salt, digests = parse_mssql_line(text, self._tag,
                                         2 * self.digest_size)
        if len(digests) != self._ndigests:
            raise ValueError(
                f"{self.name} wants {self._ndigests} digest(s) per "
                f"line, got {len(digests)} -- wrong MSSQL version? "
                f"{text!r}")
        # 2000 lines: [case-sensitive, upper]; crack the LAST digest
        # (the case-insensitive one).
        return Target(raw=text.strip(), digest=digests[-1],
                      params={"salt": salt})

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        if not params:
            raise ValueError(f"{self.name} needs target params (salt)")
        salt = params["salt"]
        out = []
        for c in candidates:
            if self._upper:
                c = c.upper()          # ASCII-only, like the device path
            wide = bytes(b for ch in c for b in (ch, 0))
            out.append(hashlib.new(self._algo, wide + salt).digest())
        return out


@register("mssql2000")
class Mssql2000Engine(_MssqlCpuBase):
    """MSSQL 2000 (hashcat 131): sha1(utf16le(upper($pass)) . $salt) --
    the case-insensitive second digest of the 0x0100 line."""

    name = "mssql2000"
    digest_size = 20
    _algo = "sha1"
    _tag = "0100"
    _upper = True
    _ndigests = 2
    max_candidate_len = (55 - 4) // 2


@register("mssql2005")
class Mssql2005Engine(_MssqlCpuBase):
    """MSSQL 2005 (hashcat 132): sha1(utf16le($pass) . $salt)."""

    name = "mssql2005"
    digest_size = 20
    _algo = "sha1"
    _tag = "0100"
    max_candidate_len = (55 - 4) // 2


@register("mssql2012")
@register("mssql2014")
class Mssql2012Engine(_MssqlCpuBase):
    """MSSQL 2012/2014 (hashcat 1731): sha512(utf16le($pass) . $salt),
    0x0200 lines."""

    name = "mssql2012"
    digest_size = 64
    _algo = "sha512"
    _tag = "0200"
    max_candidate_len = (111 - 4) // 2
