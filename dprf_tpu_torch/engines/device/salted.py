"""Salted fast-hash engines on the card: md5, sha1, sha256 and sha512
over $pass.$salt (``-ps``) and $salt.$pass (``-sp``), hashcat modes
10/20, 110/120, 1410/1420, 1710/1720, and the line formats that ride on
them: PostgreSQL MD5 (12), LDAP {SSHA} (111), {SSHA512} (1711) and
{SMD5}, Oracle 11g (112); and MSSQL 2000/2005 (131/132) and 2012/2014
(1731), sha1 or sha512 over the UTF-16LE candidate and a 4-byte salt.

Target lines use the hashcat convention ``hexdigest:salt`` (the salt is
the literal bytes after the first colon; ``$HEX[..]`` decodes hex
salts).  Each salt reshapes the digest of every candidate, so every
candidate is hashed once per target; the worker sweeps the keyspace
once per group of targets (``cuda_ext.salted_groups``: all ``ps``
targets, the ``sp`` targets of one salt length, up to 256 a group), one
launch of the salted kernel (ops/cuda_ext.py, csrc/salted.cuh) per
(group, batch), which decodes each candidate once and hashes it with
each target's salt.  The sha512 engines run its wide variants and the
MSSQL engines its UTF-16LE ones, which the reference runs on XLA only.

A wordlist+rules job runs the rules kernel's salted tail
(ops/cuda_rules.py; csrc/rules_group.cu for the 64-byte cores and MSSQL
2000/2005, csrc/rules_wide.cu for sha512 and MSSQL 2012/2014) over the
same groups: one launch per (group, word window), each rule output
hashed once per target of the group (``CudaSaltedWordlistWorker``).  A
job the kernels do not take raises, naming ``--device cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.engines.cpu.engines import (LdapSmd5Engine,
                                                LdapSsha512Engine,
                                                LdapSshaEngine,
                                                Mssql2000Engine,
                                                Mssql2005Engine,
                                                Mssql2012Engine,
                                                Oracle11Engine,
                                                PostgresMd5Engine, SALT_MAX,
                                                parse_salted_line)
from dprf_tpu_torch.engines.device.engines import (TorchMd5Engine,
                                                   TorchSha1Engine,
                                                   TorchSha256Engine,
                                                   TorchSha512Engine)
from dprf_tpu_torch.ops import cuda_ext, cuda_rules
from dprf_tpu_torch.ops.compare import digest_rows
from dprf_tpu_torch.runtime.worker import (GroupedSweepWorker,
                                           GroupedWordlistWorker)


def _target_args(engine, targets) -> list:
    """Each target's (salt bytes, digest uint32 words)."""
    return [(t.params["salt"],
             [int(w) for w in digest_rows([t.digest],
                                          engine.little_endian)[0]])
            for t in targets]


class CudaSaltedMaskWorker(GroupedSweepWorker):
    """Salted mask worker over the salted kernel, the counterpart of the
    reference's PallasSaltedMaskWorker and of SaltedMaskWorker's
    per-target sweep: one launch per (group, batch), each group's salts
    and digest words its rows (runtime/worker.GroupedSweepWorker), its
    hit buffer ``hit_capacity`` a target of the group.  A single target
    is a group of one.  On a card the kernel builds at construction, so
    a build failure raises here; with ``device="cpu"`` each launch runs
    the kernel's plain version."""

    def __init__(self, engine, gen, targets: Sequence[Target],
                 batch: int = 1 << 24, hit_capacity: int = 64,
                 oracle=None, device="cuda"):
        super().__init__(engine, gen, targets, batch, hit_capacity, oracle)
        device = torch.device(device)
        if device.type == "cuda":
            cuda_ext.load_kernel()
        self.variant = engine.variant
        targs = _target_args(engine, self.targets)
        self.groups = [
            (idx, cuda_ext.make_salted_crack_step(
                self.variant, gen, [targs[i] for i in idx], batch,
                hit_capacity * len(idx), device=device,
                byte_map=engine.byte_map))
            for idx in cuda_ext.salted_groups(self.variant,
                                              [s for s, _ in targs])]


class CudaSaltedWordlistWorker(GroupedWordlistWorker):
    """Salted wordlist+rules worker over the rules kernel's salted tail,
    the counterpart of the reference's SaltedWordlistWorker: the job's
    words and rules go to the device once, each group its rows
    (``cuda_ext.salted_rule_rows``); one launch per (group, word window)
    (runtime/worker.GroupedWordlistWorker), its hit buffer
    ``hit_capacity`` a target of the group.  MSSQL 2000's rule outputs
    are uppercased on the card before they are widened; its hits'
    plaintexts are the rule outputs.  On a card the kernel builds at
    construction; with ``device="cpu"`` each launch runs the kernel's
    plain version."""

    def __init__(self, engine, gen, targets: Sequence[Target],
                 batch: int = 1 << 24, hit_capacity: int = 64,
                 oracle=None, device="cuda"):
        super().__init__(engine, gen, targets, batch, hit_capacity, oracle)
        device = torch.device(device)
        variant = engine.variant
        if device.type == "cuda":
            cuda_rules.load_kernel(cuda_rules.source_of(variant))
        sp = engine.order == "sp"
        tables = cuda_rules.job_tables(gen, device)
        targs = _target_args(engine, self.targets)
        self.groups = []
        for idx in cuda_ext.salted_groups(variant, [s for s, _ in targs]):
            group = [targs[i] for i in idx]
            rows = cuda_ext.salted_rule_rows(variant, group, gen.max_len)
            self.groups.append((idx, cuda_rules.make_rules_group_step(
                variant, tables, gen.max_len,
                torch.as_tensor(rows.view(np.int32), device=device),
                self.word_batch, hit_capacity * len(idx),
                shift=len(group[0][0]) if sp else 0,
                upper=engine.byte_map is not None)))


class _SaltedDeviceMixin:
    """Device engine for one (algo, order): the base engine's digest,
    the salted kernel's mask worker."""

    salted = True
    #: the kernel core and order (``cuda_ext.SALTED_VARIANTS``)
    algo: str
    order: str
    #: MSSQL: the candidate is UTF-16LE before the salt, which is not
    widen = False
    #: a map of the candidate's bytes before it is hashed (MSSQL 2000's
    #: uppercase, ``cuda_ext.UPPER``), applied to the charset tables
    byte_map = None
    #: leave headroom for any parseable salt in the single block; the
    #: worker factory checks the job's actual salts
    max_candidate_len = cuda_ext.BLOCK_LIMIT - SALT_MAX
    _block_limit = cuda_ext.BLOCK_LIMIT

    @property
    def variant(self) -> str:
        """The salted kernel's variant this engine runs."""
        return f"{self.algo}-{self.order}" + ("-utf16" if self.widen else "")

    def parse_target(self, text: str) -> Target:
        digest, salt = parse_salted_line(text, self.digest_size)
        return Target(raw=text.strip(), digest=digest,
                      params={"salt": salt})

    def hash_batch(self, candidates: Sequence[bytes],
                   params: Optional[dict] = None) -> list[bytes]:
        """The salted digests on the engine's device, one target's
        params (its salt) for every candidate."""
        if not params:
            raise ValueError(f"{self.name} needs target params (salt)")
        salt = params["salt"]
        if self.byte_map is not None:
            candidates = [bytes(self.byte_map[list(c)]) for c in candidates]
        if self.widen:
            candidates = [bytes(b for ch in c for b in (ch, 0))
                          for c in candidates]
        msgs = [c + salt if self.order == "ps" else salt + c
                for c in candidates]
        return self._hash_messages(msgs, self._block_limit)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The salted kernel's worker; a job the kernel does not take is
        refused, never moved to another path."""
        self._check_lengths(gen.length, targets)
        lens = [len(t.params["salt"]) for t in targets]
        width = 2 if self.widen else 1
        if not cuda_ext.variant_eligible(self.variant, gen, lens):
            raise ValueError(
                f"{self.name}: no salted kernel for this job (it takes "
                f"masks of 1..{self._block_limit // width} positions with "
                f"1..256 bytes each and salts of 0..{SALT_MAX} bytes); use "
                "--device cpu")
        return CudaSaltedMaskWorker(self, gen, targets, batch=batch,
                                    hit_capacity=hit_capacity,
                                    oracle=oracle, device=self.torch_device)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        """The rules kernel's salted worker; a job it does not take is
        refused, never moved to another path."""
        if self.variant not in cuda_rules.GROUP_TAILS:
            raise ValueError(f"{self.name}: the rules kernel has no "
                             f"{self.variant} tail; use --device cpu for a "
                             "wordlist")
        self._check_lengths(gen.max_len, targets)
        if not cuda_rules.rules_supported(gen.rules):
            raise ValueError(
                f"{self.name}: no rules kernel for this job (it takes rules "
                f"of at most {cuda_rules.MAX_STEPS} ops without @, E or e); "
                "use --device cpu")
        return CudaSaltedWordlistWorker(self, gen, targets, batch=batch,
                                        hit_capacity=hit_capacity,
                                        oracle=oracle,
                                        device=self.torch_device)

    def _check_lengths(self, cand_len: int, targets) -> None:
        worst = cand_len * (2 if self.widen else 1) + \
            max(len(t.params["salt"]) for t in targets)
        if worst > self._block_limit:
            raise ValueError(
                f"candidate+salt can reach {worst} bytes, over the "
                f"{self._block_limit}-byte single-block limit; "
                "shorten the mask/words or use --device cpu")


_BASES = {"md5": TorchMd5Engine, "sha1": TorchSha1Engine,
          "sha256": TorchSha256Engine, "sha512": TorchSha512Engine}


def _limits(base) -> dict:
    """A base engine's single-block limit and the candidate length that
    leaves room for any parseable salt (sha512: 111 and 79)."""
    limit = cuda_ext.WIDE_BLOCK_LIMIT if base is TorchSha512Engine \
        else cuda_ext.BLOCK_LIMIT
    return {"_block_limit": limit, "max_candidate_len": limit - SALT_MAX}


for _algo, _base in _BASES.items():
    for _order in cuda_ext.ORDERS:
        _name = f"{_algo}-{_order}"
        register(_name, device="cuda")(type(
            f"Torch{_algo.title()}{_order.title()}Engine",
            (_SaltedDeviceMixin, _base),
            {"name": _name, "algo": _algo, "order": _order,
             "__doc__": (f"Salted {_algo}: "
                         + ("$pass.$salt" if _order == "ps"
                            else "$salt.$pass")
                         + " through the salted kernel."),
             **_limits(_base)}))


def _register_line_format(names, base, cpu_cls, doc: str, **attrs):
    """A salted 'ps' engine with another line format: parsing is the
    CPU oracle's."""

    def parse_target(self, text: str) -> Target:
        return cpu_cls().parse_target(text)

    cls = type(f"Torch{cpu_cls.__name__}", (_SaltedDeviceMixin, base),
               {"name": names[0], "algo": base.name, "order": "ps",
                "__doc__": doc, "parse_target": parse_target,
                **_limits(base), **attrs})
    for n in names:
        register(n, device="cuda")(cls)
    return cls


_register_line_format(
    ("postgres", "postgres-md5"), TorchMd5Engine, PostgresMd5Engine,
    "PostgreSQL MD5 auth (hashcat 12): md5($pass.$username), "
    "``md5<hex>:user`` lines.")
_register_line_format(
    ("ldap-ssha", "ssha"), TorchSha1Engine, LdapSshaEngine,
    "LDAP {SSHA} (hashcat 111): sha1($pass.$salt), a base64 blob.")
_register_line_format(
    ("ldap-smd5",), TorchMd5Engine, LdapSmd5Engine,
    "LDAP {SMD5}: md5($pass.$salt), a base64 blob.")
_register_line_format(
    ("oracle11", "oracle-11g"), TorchSha1Engine, Oracle11Engine,
    "Oracle 11g (hashcat 112): sha1($pass.$salt) with a 10-byte salt, "
    "``S:<40 hex><20 hex>`` lines.",
    max_candidate_len=cuda_ext.BLOCK_LIMIT - 10)
_register_line_format(
    ("ldap-ssha512", "ssha512"), TorchSha512Engine, LdapSsha512Engine,
    "LDAP {SSHA512} (hashcat 1711): sha512($pass.$salt), a base64 blob.")

# MSSQL: the candidate as UTF-16LE (uppercased first for 2000), then the
# 4-byte salt unwidened; sha1 or sha512 (the kernel's UTF-16LE variants)
_MSSQL = {"widen": True, "max_candidate_len": (cuda_ext.BLOCK_LIMIT - 4) // 2}
_register_line_format(
    ("mssql2000",), TorchSha1Engine, Mssql2000Engine,
    "MSSQL 2000 (hashcat 131): sha1(utf16le(upper($pass)) . $salt), the "
    "case-insensitive second digest of a 0x0100 line; the uppercase maps "
    "the job's charset tables.", **_MSSQL, byte_map=cuda_ext.UPPER)
_register_line_format(
    ("mssql2005",), TorchSha1Engine, Mssql2005Engine,
    "MSSQL 2005 (hashcat 132): sha1(utf16le($pass) . $salt).", **_MSSQL)
_register_line_format(
    ("mssql2012", "mssql2014"), TorchSha512Engine, Mssql2012Engine,
    "MSSQL 2012/2014 (hashcat 1731): sha512(utf16le($pass) . $salt), "
    "0x0200 lines.", widen=True,
    max_candidate_len=(cuda_ext.WIDE_BLOCK_LIMIT - 4) // 2)
