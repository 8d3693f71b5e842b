"""Counter-based Philox4x32-10 in plain torch: the random bits of every
dropout in the port.

The TPU kernels draw their keep masks from the TPU's hardware PRNG, seeded
per grid tile (``_dropout_mask`` in ``paddle_tpu/kernels/pallas/
flash_attention.py``, ``_keep_mask`` in ``fused_residual.py``, the
``dropout.py`` kernel). The port's kernels cannot have those bits, and
their tiles are not the Pallas tiles (the flash forward walks 64-row q
tiles, its backward 64-row kv tiles), so the port keys its bits on the
element instead: the keep decision for an element is a pure function of
(seed, op salt, the element's logical coordinates), the same in every
kernel that touches it and in every plain version. ``csrc/philox.cuh``
computes the same words on the card; these functions are its plain
version, in int64 arithmetic masked to 32 bits.

Layout of one Philox call (Random123's ``philox4x32_R`` with R = 10): the
key is the 63-bit seed as two 32-bit words (low, high); the counter is
``(column // 4, row word 0, row word 1, salt)``, and the four output words
serve four consecutive columns ``4 * (column // 4) + w``. Rows are

* attention: column = key position j, row words = (q position i, b * H +
  h) (``attention_keep``);
* row kernels (dropout, fused add-dropout-LayerNorm) on an ``[N, C]``
  view: column = c, row words = (low and high 32 bits of the row index n)
  (``row_keep``);
* token sampling (``sample_uniform``, no kernel: plain torch on the card
  and the CPU alike): column = vocabulary index, row words = (batch row,
  draw step), under the key of a seed held as device data.

No coordinate of a LLaMA-7B or BERT shape comes near 2^32, so no word
overflows.

A seed is an int, or a ``DeviceSeed``: one int64 element of a buffer of
staged seeds (``core.random``'s seed slots, inside a training program). A
launch then passes the element's address in place of the seed's words,
with the threshold's top bit set (``SEED_IN_MEMORY``; a threshold is below
2^31), and the kernel reads the two words there (``csrc/philox.cuh``
``resolved``), so a CUDA graph that recorded the launch draws under
whatever seed the host staged before each replay; the plain versions take
the words as int64 tensors. An element is kept iff ``(word & 0x7FFFFFFF) >= int(rate *
2^31)``: the JAX package's threshold (``flash_attention.py:45-59``,
``dropout.py:24-27``, ``fused_residual.py:29-33``); a kept element is
scaled by ``keep_scale(rate)``, 1 / (1 - rate) rounded to fp32.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["SALT_ATTENTION", "SALT_DROPOUT", "SALT_FUSED_LN", "philox4x32",
           "SALT_SAMPLE", "DeviceSeed", "check_seed", "seed_words",
           "threshold", "keep_scale", "SEED_IN_MEMORY",
           "KERNEL_ARGTYPES", "kernel_args", "row_keep", "attention_keep",
           "sample_uniform"]

# op salts: the fourth counter word, one per kind of op
SALT_ATTENTION = 1
SALT_DROPOUT = 2
SALT_FUSED_LN = 3
SALT_SAMPLE = 4

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
_MASK = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of ``m * x`` for 32-bit ``m`` and ``x``,
    without overflowing int64: ``x`` is split into 16-bit halves."""
    a = m * (x & 0xFFFF)                # < 2^48
    b = m * (x >> 16)                   # < 2^48
    t = a + ((b & 0xFFFF) << 16)        # < 2^49
    return (b >> 16) + (t >> 32), t & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32-``rounds`` on int64 tensors holding 32-bit counter words
    (broadcast against each other) under the key ``(k0, k1)``: the four
    output words as int64 tensors in [0, 2^32). The key words are ints or
    int64 tensors (0-d, on the counters' device): a key that is device
    data lets a captured program draw under a seed it reads at replay."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    k0, k1 = ((k & _MASK) if torch.is_tensor(k) else int(k) & _MASK
              for k in (k0, k1))
    for r in range(rounds):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


class DeviceSeed:
    """A seed held as device data: element ``index`` of ``buf``, a 1-d
    int64 tensor of non-negative seeds. On the CPU it reads as an int
    (``int(seed)``); on the card a host read would see the value of the
    moment, not the one a replay stages, so it refuses: the kernels take
    its address (``ptr``) and the plain versions its words as tensors."""

    __slots__ = ("buf", "index")

    def __init__(self, buf: torch.Tensor, index: int):
        self.buf = buf
        self.index = int(index)

    @property
    def device(self) -> torch.device:
        return self.buf.device

    def ptr(self) -> int:
        """The address of the seed's (low, high) words."""
        return self.buf.data_ptr() + 8 * self.index

    def words(self):
        """The seed's (low, high) words: ints on the CPU, 0-d int64 tensors
        on the card."""
        if self.buf.device.type == "cpu":
            return seed_words(int(self))
        t = self.buf[self.index]
        return t & _MASK, t >> 32

    def __int__(self) -> int:
        if self.buf.device.type != "cpu":
            raise TypeError("a staged seed on the card is device data; its "
                            "value is read by the kernels at replay")
        return int(self.buf[self.index])

    __index__ = __int__

    def __repr__(self):
        return f"DeviceSeed({self.buf.device}, index={self.index})"


def check_seed(seed) -> None:
    """Raise unless ``seed`` is a 64-bit unsigned int or a ``DeviceSeed``."""
    if not isinstance(seed, DeviceSeed):
        seed_words(seed)


def seed_words(seed):
    """The Philox key of ``seed``: its (low, high) 32-bit words (int64
    tensors for a ``DeviceSeed`` on the card)."""
    if isinstance(seed, DeviceSeed):
        return seed.words()
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned integer")
    return seed & _MASK, seed >> 32


def threshold(rate: float) -> int:
    """Keep iff ``(word & 0x7FFFFFFF) >=`` this (the JAX package's
    ``int(rate * 2147483648.0)``)."""
    rate = float(rate)
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate {rate} is not in [0, 1]")
    return int(rate * 2147483648.0)


def keep_scale(rate: float) -> float:
    """The factor of a kept element, ``1 / (1 - rate)`` rounded to fp32 (0
    at rate 1, where nothing is kept)."""
    rate = float(rate)
    if rate >= 1.0:
        return 0.0
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()


# a launcher's dropout arguments as ctypes declares them (csrc/philox.cuh
# DropParams, after an "on" flag): on, seed low word, seed high word, keep
# threshold, keep scale
KERNEL_ARGTYPES = (ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_float)

# the threshold's flag of a seed staged in device memory (csrc/philox.cuh
# kSeedInMemory): the two words then hold its address
SEED_IN_MEMORY = 0x80000000


def kernel_args(rate: float, seed):
    """The values of ``KERNEL_ARGTYPES`` for a launch at ``rate`` (all 0 at
    rate 0, where ``seed`` is not read). An int seed travels by value; a
    ``DeviceSeed`` by its address in the two words, flagged in the
    threshold."""
    if rate <= 0.0:
        return 0, 0, 0, 0, 0.0
    if isinstance(seed, DeviceSeed):
        if seed.device.type != "cuda":
            raise ValueError(f"a kernel launch reads its seed on the card; "
                             f"this one lies on {seed.device}")
        ptr = seed.ptr()
        return (1, ptr & _MASK, ptr >> 32, threshold(rate) | SEED_IN_MEMORY,
                keep_scale(rate))
    lo, hi = seed_words(seed)
    return 1, lo, hi, threshold(rate), keep_scale(rate)


def _keep(words, cols: int, rate: float):
    """Stack four ``[..., G]`` word tensors into ``[..., 4G]`` columns, cut
    to ``cols``, and threshold them."""
    bits = torch.stack(words, dim=-1).flatten(-2)[..., :cols]
    return (bits & 0x7FFFFFFF) >= threshold(rate)


def row_keep(seed: int, salt: int, rows: int, cols: int, rate: float,
             device="cpu", row0: int = 0) -> torch.Tensor:
    """Keep mask ``[rows, cols]`` (bool) of rows ``row0 .. row0 + rows`` of
    an ``[N, cols]`` view, as the row kernels draw it."""
    k0, k1 = seed_words(seed)
    groups = torch.arange((cols + 3) // 4, device=device)[None, :]
    r = torch.arange(row0, row0 + rows, device=device)[:, None]
    return _keep(philox4x32(groups, r & _MASK, r >> 32, salt, k0, k1), cols,
                 rate)


def attention_keep(seed: int, batch: int, heads: int, lq: int, lk: int,
                   rate: float, device="cpu") -> torch.Tensor:
    """Keep mask ``[batch, heads, lq, lk]`` (bool) of the attention
    probabilities, keyed on (b, h, q position, key position)."""
    k0, k1 = seed_words(seed)
    groups = torch.arange((lk + 3) // 4, device=device)
    i = torch.arange(lq, device=device)[:, None]
    bh = torch.arange(batch * heads, device=device).reshape(batch, heads,
                                                             1, 1)
    return _keep(philox4x32(groups, i, bh, SALT_ATTENTION, k0, k1), lk, rate)


def sample_uniform(key: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Uniforms ``[rows, cols]`` (float64) in the open interval (0, 1) for
    one sampling draw. ``key`` is an int64 tensor ``(seed, step)`` on the
    device the draw runs on; the seed (a non-negative int64) keys Philox,
    the counter is ``(column // 4, row, step, SALT_SAMPLE)``. A word maps
    to its top 24 bits plus a half, times 2^-24: never 0 or 1, so
    ``-log(-log(u))`` is finite."""
    seed, step = key[0], key[1]
    groups = torch.arange((cols + 3) // 4, device=key.device)[None, :]
    r = torch.arange(rows, device=key.device)[:, None]
    words = philox4x32(groups, r, step & _MASK, SALT_SAMPLE, seed, seed >> 32)
    bits = torch.stack(words, dim=-1).flatten(-2)[:, :cols]
    return ((bits >> 8).double() + 0.5) * 2.0 ** -24
