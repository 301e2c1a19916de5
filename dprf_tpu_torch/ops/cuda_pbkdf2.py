"""The PBKDF2-HMAC-SHA1 kernels of csrc/pbkdf2.cu: the fused WPA2-PMKID
kernel and the generic KDF kernel, the counterparts of the JAX package's
ops/pallas_pbkdf2.py (``make_pmkid_pallas_fn`` / ``pmkid_lanes`` and
``make_pbkdf2_kdf_pallas_fn`` / ``pbkdf2_lanes``).

Per candidate the kernel (csrc/pbkdf2.cu) decodes the mask index into a
passphrase, runs PBKDF2-HMAC-SHA1(passphrase, ESSID, iters) to the
32-byte PMK, then for every target of one ESSID group the PMKID HMAC
and a 4-word compare.  The PMK is computed once per candidate and
group, whatever the group's size.

Outputs: ``count int32[1]``, the exact number of (lane, target) hits;
``lanes int32[hit_capacity]`` and ``tidx int32[hit_capacity]``, the
first ``hit_capacity`` hits (batch lane, target index in the group) in
no fixed order, -1 where unused.  A lane that matches two targets gives
two hits.  ``count > hit_capacity`` sends the batch to the worker's
exact oracle rescan.

Three functions carry it: the kernel's wrapper ``pmkid_kernel`` (CUDA
tensors only, launches on the current stream without synchronising,
counts its launches in ``launches``), the same function in plain
PyTorch ``pmkid_plain`` (ops/hmac_sha1.py; hits in ascending (lane,
target) order), and the dispatcher ``pmkid_crack``: the kernel for CUDA
tensors, the plain version for CPU tensors.  ``make_pmkid_step`` builds
the worker's step on the dispatcher.

The KDF kernel writes, per candidate, the first ``n_words`` big-endian
words of PBKDF2-HMAC-SHA1(passphrase, salt, iters) (T1 || T2): 4 for a
Kerberos etype-17 key, 8 for etype 18.  Its wrapper ``kdf_kernel``
counts its launches in ``launches["pbkdf2_kdf"]``; ``kdf_plain`` is the
same function on ops/hmac_sha1.py, and ``kdf`` the dispatcher.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from dprf_tpu_torch.generators.mask import decode_lut
from dprf_tpu_torch.ops import hmac_sha1
from dprf_tpu_torch.ops.pack import pack_raw

#: longest passphrase the decode holds (a WPA passphrase, 63 bytes)
MAX_LENGTH = 63
#: longest ESSID (802.11)
MAX_ESSID = 32
#: threads per block (kThreads in the source)
THREADS = 256
#: words of one target in the kernel's table: the 20-byte PMKID
#: message, then the 4-word PMKID
TARGET_WORDS = 9

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_pbkdf2.py:261"
SOURCE = "dprf_tpu_torch/csrc/pbkdf2.cu"
KERNEL = "pmkid"

#: the KDF kernel: the TPU kernel it replaces, its name
KDF_REPLACES = "dprf_tpu/ops/pallas_pbkdf2.py:169"
KDF_KERNEL = "pbkdf2_kdf"
#: longest salt: salt || INT32BE(i), the 0x80 marker and the 8-byte bit
#: length in one block after the key block (hmac_sha1.salt_block)
MAX_SALT = 51

#: launches of each kernel in this process (tests and chip_smoke.py
#: reset and read them)
launches = {KERNEL: 0, KDF_KERNEL: 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pmkid_kernel_eligible(gen, essid_lens: Sequence[int]) -> bool:
    """Whether the kernel takes this job: a mask of 1..63 positions of
    1..256 bytes each, and every ESSID 1..32 bytes."""
    return (hasattr(gen, "charsets") and 1 <= gen.length <= MAX_LENGTH
            and all(1 <= len(cs) <= 256 for cs in gen.charsets)
            and all(1 <= n <= MAX_ESSID for n in essid_lens))


def target_kernel_args(target):
    """Target -> (essid_len, essid bytes, msg5 uint32[5], pmkid
    uint32[4])."""
    essid = target.params["essid"]
    return (len(essid), essid,
            hmac_sha1.pmkid_message(target.params["mac_ap"],
                                    target.params["mac_sta"]),
            np.frombuffer(target.digest, ">u4").astype(np.uint32))


def target_table(targets: Sequence, device) -> torch.Tensor:
    """The kernel's table of one ESSID group: int32[T, 9], each row the
    target's message words then its PMKID words."""
    rows = [np.concatenate(target_kernel_args(t)[2:]) for t in targets]
    return torch.as_tensor(np.stack(rows).view(np.int32), device=device)


def _check_mask(lut: torch.Tensor, radices: Sequence[int],
                base_digits: Sequence[int], n_valid: int, batch: int) -> None:
    """The decode's arguments, shared by both kernels."""
    if lut.dtype != torch.uint8 or lut.dim() != 2 or lut.shape[1] != 256:
        raise ValueError(f"lut must be uint8[length, 256], got "
                         f"{lut.dtype}{list(lut.shape)}")
    length = lut.shape[0]
    if not 1 <= length <= MAX_LENGTH:
        raise ValueError(f"mask length {length} outside 1..{MAX_LENGTH}")
    if len(radices) != length or len(base_digits) != length:
        raise ValueError("radices and base digits need one entry per "
                         "mask position")
    if not all(1 <= r <= 256 for r in radices) or \
            not all(0 <= d < r for d, r in zip(base_digits, radices)):
        raise ValueError("radices must be 1..256 and base digits below them")
    if not 1 <= batch <= (1 << 31) - 256:
        raise ValueError(f"batch {batch} outside 1..2**31-256")
    if not 0 <= n_valid <= batch:
        raise ValueError(f"n_valid {n_valid} outside 0..{batch}")


def _check_iters(iters: int) -> None:
    if not 1 <= iters < 1 << 31:
        raise ValueError(f"iterations {iters} outside 1..2**31-1")


def _check_job(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, essid: bytes,
               iters: int, table: torch.Tensor, hit_capacity: int,
               batch: int) -> None:
    _check_mask(lut, radices, base_digits, n_valid, batch)
    if not 1 <= len(essid) <= MAX_ESSID:
        raise ValueError(f"ESSID of {len(essid)} bytes outside "
                         f"1..{MAX_ESSID}")
    _check_iters(iters)
    if table.dtype != torch.int32 or table.dim() != 2 or \
            table.shape[1] != TARGET_WORDS or table.shape[0] < 1:
        raise ValueError(f"target table must be int32[T >= 1, "
                         f"{TARGET_WORDS}], got {table.dtype}"
                         f"{list(table.shape)}")
    if table.device != lut.device or not table.is_contiguous():
        raise ValueError("target table must be contiguous, on the lut's "
                         "device")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


class _Args(ctypes.Structure):
    """``struct PmkidArgs`` of csrc/pbkdf2.cu."""
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * MAX_LENGTH),
                ("base", ctypes.c_int32 * MAX_LENGTH),
                ("salt", (ctypes.c_uint32 * 16) * 2),
                ("iters", ctypes.c_int32), ("n_targets", ctypes.c_int32)]


def kernel_args(radices: Sequence[int], base_digits: Sequence[int],
                essid: bytes, iters: int, n_targets: int) -> _Args:
    """The launch's parameters: the decode's radices and base digits,
    the ESSID's two first-message blocks, iters, the group's size."""
    return _Args(len(radices), (ctypes.c_int32 * MAX_LENGTH)(*radices),
                 (ctypes.c_int32 * MAX_LENGTH)(*base_digits),
                 _salt_blocks(essid), int(iters), int(n_targets))


class _KdfArgs(ctypes.Structure):
    """``struct KdfArgs`` of csrc/pbkdf2.cu."""
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * MAX_LENGTH),
                ("base", ctypes.c_int32 * MAX_LENGTH),
                ("salt", (ctypes.c_uint32 * 16) * 2),
                ("iters", ctypes.c_int32), ("n_words", ctypes.c_int32)]


def _salt_blocks(salt: bytes):
    """The two first-message blocks salt || INT32BE(i), i = 1, 2."""
    return ((ctypes.c_uint32 * 16) * 2)(
        *((ctypes.c_uint32 * 16)(*(int(w) for w in
                                   hmac_sha1.salt_block(salt, i)))
          for i in (1, 2)))


@functools.cache
def _library():
    """The C entry points, built from csrc/pbkdf2.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("pbkdf2")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_pmkid_launch.argtypes = [
        i32, ptr, ctypes.POINTER(_Args), ptr, ctypes.c_uint32, ptr, ptr,
        ptr, i32, i32, i32, ptr]
    lib.dprf_pmkid_launch.restype = i32
    lib.dprf_kdf_launch.argtypes = [
        i32, ptr, ctypes.POINTER(_KdfArgs), ctypes.c_uint32, ptr, i32, i32,
        ptr]
    lib.dprf_kdf_launch.restype = i32
    for fn in (lib.dprf_pmkid_blocks_per_sm, lib.dprf_kdf_blocks_per_sm):
        fn.argtypes = [i32, ctypes.POINTER(i32)]
        fn.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernel now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


def shared_bytes(length: int) -> int:
    """Dynamic shared memory of one block: the charset tables."""
    return length * 256


@functools.cache
def blocks_per_sm(smem: int, kernel: str = KERNEL) -> int:
    """Resident blocks per SM of ``kernel`` (pmkid or pbkdf2_kdf) at
    ``smem`` bytes, from the CUDA occupancy calculator (registers, not
    shared memory, limit these kernels)."""
    lib = _library()
    query = lib.dprf_pmkid_blocks_per_sm if kernel == KERNEL \
        else lib.dprf_kdf_blocks_per_sm
    blocks = ctypes.c_int(0)
    rc = query(smem, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


def grid_size(n_valid: int, smem: int, device, kernel: str = KERNEL) -> int:
    """Blocks of the grid-stride grid: one resident wave, or fewer for
    a short batch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n_valid // THREADS),
                      sms * blocks_per_sm(smem, kernel)))


def pmkid_kernel(lut: torch.Tensor, radices: Sequence[int],
                 base_digits: Sequence[int], n_valid: int, essid: bytes,
                 iters: int, table: torch.Tensor, hit_capacity: int,
                 batch: int):
    """Launch the kernel over lanes [0, n_valid) of a ``batch``-lane
    step: lut uint8[L, 256] (``MaskGenerator.charset_lut``) and the
    group's target table (``target_table``) on the card, the radices and
    the base digits of the batch's first candidate as ints.  Returns
    (count int32[1], lanes int32[cap], tidx int32[cap]) on the card,
    still being computed."""
    if lut.device.type != "cuda":
        raise ValueError(f"the CUDA PMKID kernel takes CUDA tensors, got "
                         f"a lut on {lut.device}")
    _check_job(lut, radices, base_digits, n_valid, essid, iters, table,
               hit_capacity, batch)
    if not lut.is_contiguous():
        raise ValueError("lut must be contiguous")
    device = lut.device
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    tidx = torch.full((hit_capacity,), -1, dtype=torch.int32,
                      device=device)
    args = kernel_args(radices, base_digits, essid, iters, table.shape[0])
    smem = shared_bytes(lut.shape[0])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().dprf_pmkid_launch(
        device.index, lut.data_ptr(), ctypes.byref(args), table.data_ptr(),
        n_valid, count.data_ptr(), lanes.data_ptr(), tidx.data_ptr(),
        hit_capacity, grid_size(n_valid, smem, device), THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {rc}")
    launches[KERNEL] += 1
    return count, lanes, tidx


def pmkid_plain(lut: torch.Tensor, radices: Sequence[int],
                base_digits: Sequence[int], n_valid: int, essid: bytes,
                iters: int, table: torch.Tensor, hit_capacity: int,
                batch: int):
    """``pmkid_kernel``'s function in plain PyTorch on the lut's device;
    hits come back in ascending (lane, target) order."""
    _check_job(lut, radices, base_digits, n_valid, essid, iters, table,
               hit_capacity, batch)
    device = lut.device
    cand = decode_lut(lut, radices, base_digits, batch)
    pmk = hmac_sha1.pbkdf2_sha1_pmk(pack_raw(cand), essid, iters)
    key = torch.zeros((batch, 16), dtype=torch.int32, device=device)
    key[:, :8] = pmk
    istate, ostate = hmac_sha1.hmac_key_states(key)
    valid = torch.arange(batch, device=device) < n_valid
    found = torch.stack([
        (hmac_sha1.hmac_sha1_20(istate, ostate, row[:5].expand(batch, 5))
         [:, :4] == row[5:]).all(dim=1) & valid
        for row in table], dim=1)                       # [batch, T]
    hits = found.nonzero().to(torch.int32)              # (lane, t) order
    count = torch.tensor([hits.shape[0]], dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    tidx = torch.full((hit_capacity,), -1, dtype=torch.int32,
                      device=device)
    n = min(hit_capacity, hits.shape[0])
    lanes[:n], tidx[:n] = hits[:n, 0], hits[:n, 1]
    return count, lanes, tidx


def pmkid_crack(lut: torch.Tensor, *args):
    """The kernel on CUDA tensors, its plain version on CPU tensors
    (arguments as ``pmkid_kernel``)."""
    if lut.device.type == "cuda":
        return pmkid_kernel(lut, *args)
    if lut.device.type == "cpu":
        return pmkid_plain(lut, *args)
    raise ValueError(f"no PMKID kernel for device {lut.device}")


def make_pmkid_step(gen, essid: bytes, targets: Sequence, iters: int,
                    batch: int, hit_capacity: int = 64, device="cuda"):
    """The worker's step for one ESSID group: step(base_digits, n_valid)
    -> (count int32[1], lanes int32[cap], tidx int32[cap]), tidx
    indexing ``targets``.  The charset tables and the group's target
    table go to ``device`` once, here."""
    if not pmkid_kernel_eligible(gen, [len(essid)]):
        raise ValueError(
            f"PMKID job not eligible for the kernel: masks of 1.."
            f"{MAX_LENGTH} positions and ESSIDs of 1..{MAX_ESSID} bytes, "
            f"got {getattr(gen, 'length', None)} positions and "
            f"{len(essid)} bytes")
    device = torch.device(device)
    lut = gen.charset_lut(device)
    radices = gen.radices
    table = target_table(targets, device)

    def step(base_digits: Sequence[int], n_valid: int):
        return pmkid_crack(lut, radices, base_digits, n_valid, essid, iters,
                           table, hit_capacity, batch)

    return step


# ---- the KDF kernel ---------------------------------------------------------

def _check_kdf(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, salt: bytes,
               iters: int, n_words: int, batch: int) -> None:
    _check_mask(lut, radices, base_digits, n_valid, batch)
    if not 1 <= len(salt) <= MAX_SALT:
        raise ValueError(f"salt of {len(salt)} bytes outside 1..{MAX_SALT}")
    _check_iters(iters)
    if not 1 <= n_words <= 10:
        raise ValueError(f"n_words {n_words} outside 1..10 (T1 || T2)")


def kdf_kernel(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, salt: bytes,
               iters: int, n_words: int, batch: int) -> torch.Tensor:
    """Launch the KDF kernel over lanes [0, n_valid) of a ``batch``-lane
    step: lut uint8[L, 256] on the card, the radices and the base digits
    of the batch's first candidate as ints.  Returns int32[n_valid,
    n_words] on the card (the uint32 words' bit patterns), still being
    computed."""
    if lut.device.type != "cuda":
        raise ValueError(f"the CUDA KDF kernel takes CUDA tensors, got a "
                         f"lut on {lut.device}")
    _check_kdf(lut, radices, base_digits, n_valid, salt, iters, n_words,
               batch)
    if not lut.is_contiguous():
        raise ValueError("lut must be contiguous")
    device = lut.device
    out = torch.empty((n_valid, n_words), dtype=torch.int32, device=device)
    if n_valid == 0:
        return out
    args = _KdfArgs(len(radices), (ctypes.c_int32 * MAX_LENGTH)(*radices),
                    (ctypes.c_int32 * MAX_LENGTH)(*base_digits),
                    _salt_blocks(salt), int(iters), int(n_words))
    smem = shared_bytes(lut.shape[0])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().dprf_kdf_launch(
        device.index, lut.data_ptr(), ctypes.byref(args), n_valid,
        out.data_ptr(), grid_size(n_valid, smem, device, KDF_KERNEL),
        THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"{KDF_KERNEL} kernel launch failed: CUDA error "
                           f"{rc}")
    launches[KDF_KERNEL] += 1
    return out


def kdf_plain(lut: torch.Tensor, radices: Sequence[int],
              base_digits: Sequence[int], n_valid: int, salt: bytes,
              iters: int, n_words: int, batch: int) -> torch.Tensor:
    """``kdf_kernel``'s function in plain PyTorch on the lut's device."""
    _check_kdf(lut, radices, base_digits, n_valid, salt, iters, n_words,
               batch)
    cand = decode_lut(lut, radices, base_digits, n_valid)
    istate, ostate = hmac_sha1.hmac_key_states(pack_raw(cand))
    blocks = [hmac_sha1.pbkdf2_sha1_block(istate, ostate, salt, i, iters)
              for i in range(1, 1 + (n_words > 5) + 1)]
    return torch.cat(blocks, dim=-1)[:, :n_words].contiguous()


def kdf(lut: torch.Tensor, *args) -> torch.Tensor:
    """The KDF kernel on CUDA tensors, its plain version on CPU tensors
    (arguments as ``kdf_kernel``)."""
    if lut.device.type == "cuda":
        return kdf_kernel(lut, *args)
    if lut.device.type == "cpu":
        return kdf_plain(lut, *args)
    raise ValueError(f"no KDF kernel for device {lut.device}")
