"""Counter-based RNG streams: Threefry2x32 with identical host (numpy) and
device (jax) bit streams.

Reference parity: the wgpu Philox RNG with host-mirrored state
(crates/runmat-accelerate/src/backend/wgpu/provider/ops/random.rs:6-119): the
session holds (key, counter); every draw consumes a deterministic number of
counter blocks, so gather parity holds regardless of where a draw executed,
and chunked generation advances the same counter. `rng(seed)` resets the
stream.

Design decisions:
  * **Threefry2x32-20, not Philox4x32.** Threefry is add/xor/rotate only;
    Philox needs 32x32->64 integer multiplies, which the runtime's first
    accelerator emulated. Same counter-based stream contract. (Whether
    Philox pays on a GPU is open; switching changes every stream.)
  * **No strided ops anywhere.** Every transform here uses whole-array or
    contiguous-half operations only. One block yields two u32 words,
    exposed in BLOCKED order [all w0 | all w1].
  * The counter can be a pair of traced u32 scalars, so draws jit cleanly
    with the counter as a runtime parameter (loop iterations reuse one
    compiled kernel — see accel/loops.py).

Stream contract (host vs device parity):
  * uniform draws (rand/randi/randperm) are BIT-EXACT across numpy and every
    jax backend — pure integer ops + exact float scaling.
  * normal draws (randn) consume the identical block budget, but Box-Muller
    goes through each backend's libm (log/cos/sin), so values agree across
    backends only to a few ULPs (like the reference, whose WGSL Box-Muller
    is not bit-identical to its host libm).
  * the (key, counter) state advance is identical everywhere, so draws can
    migrate between host and device mid-stream without desync.
"""

from __future__ import annotations

import numpy as np

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def _rotl(xp, x, r: int):
    return (x << xp.uint32(r)) | (x >> xp.uint32(32 - r))


def threefry2x32(xp, k0, k1, c0, c1, rounds: int = 20):
    """The Threefry-2x32 bijection (standard 20 rounds). k*: u32 scalars
    (python ints or xp scalars); c*: u32 arrays. Returns two u32 arrays."""
    k0 = xp.uint32(k0) if isinstance(k0, int) else k0
    k1 = xp.uint32(k1) if isinstance(k1, int) else k1
    ks2 = k0 ^ k1 ^ xp.uint32(_PARITY)
    with np.errstate(over="ignore"):
        x0 = c0 + k0
        x1 = c1 + k1
        ks = (k1, ks2, k0)
        for chunk in range(rounds // 4):
            for r in _ROT[(chunk % 2) * 4:(chunk % 2) * 4 + 4]:
                x0 = x0 + x1
                x1 = _rotl(xp, x1, r)
                x1 = x0 ^ x1
            x0 = x0 + ks[chunk % 3]
            x1 = x1 + ks[(chunk + 1) % 3] + xp.uint32(chunk + 1)
    return x0, x1


def raw_words(xp, key: tuple, counter, n_blocks: int):
    """n_blocks counter blocks -> two u32 arrays (w0, w1) of length n_blocks.

    counter: python int (64-bit block index) or a (lo, hi) pair of u32 values
    (possibly traced jax scalars — the device path needs no 64-bit ints)."""
    if isinstance(counter, tuple):
        lo0, hi0 = counter
    else:
        lo0 = counter & _MASK
        hi0 = (counter >> 32) & _MASK
    if xp is np:
        i = np.arange(n_blocks, dtype=np.uint32)
    else:
        import jax
        i = jax.lax.iota(xp.uint32, n_blocks)
    with np.errstate(over="ignore"):
        c0 = xp.uint32(lo0) + i if not hasattr(lo0, "dtype") else lo0 + i
        carry = (c0 < i).astype(xp.uint32)
        c1 = (xp.uint32(hi0) if not hasattr(hi0, "dtype") else hi0) + carry
        return threefry2x32(xp, key[0], key[1], c0, c1)


def blocks_for(kind: str, n: int, mclass) -> int:
    """Counter blocks consumed by a draw of n values (single source of truth
    for host, engine, and loop-idiom accounting)."""
    single = mclass in (np.float32, "float32", "single")
    if kind == "randn":
        m = (n + 1) // 2
        return m if single else 2 * m
    # uniform-based draws
    return (n + 1) // 2 if single else n


def uniform_u32(xp, key, counter, n: int):
    """n u32 values in blocked word order. Returns (vals, blocks)."""
    nb = (n + 1) // 2
    w0, w1 = raw_words(xp, key, counter, nb)
    return xp.concatenate([w0, w1])[:n], nb


def _to_f64_exact(xp, w):
    """u32 -> f64 via 16-bit halves. A direct astype is exact on host
    numpy but a backend with emulated f64 may convert >24-bit integers
    through f32 (a 2-ulp error in the uniform stream on the runtime's first
    accelerator); 16-bit pieces convert exactly everywhere and reassemble
    exactly."""
    hi = (w >> xp.uint32(16)).astype(xp.float64)
    lo = (w & xp.uint32(0xFFFF)).astype(xp.float64)
    return hi * np.float64(65536.0) + lo


def uniform(xp, key, counter, n: int, dtype):
    """n uniforms in [0,1). f32: one word each (2 per block); f64: one block
    each (53 bits from the block's two words)."""
    if dtype in (np.float32, "float32", "single"):
        bits, nb = uniform_u32(xp, key, counter, n)
        return (bits >> xp.uint32(8)).astype(xp.float32) * xp.float32(2.0 ** -24), nb
    w0, w1 = raw_words(xp, key, counter, n)
    v = _to_f64_exact(xp, w0 >> xp.uint32(5)) * np.float64(2 ** 26) \
        + _to_f64_exact(xp, w1 >> xp.uint32(6))
    return v * np.float64(2.0 ** -53), n


def normal(xp, key, counter, n: int, dtype):
    """n standard normals via Box-Muller over contiguous half-pairs (no
    strided interleave). Consumes blocks_for('randn', ...)."""
    single = dtype in (np.float32, "float32", "single")
    m = (n + 1) // 2
    if single:
        w0, w1 = raw_words(xp, key, counter, m)
        f = xp.float32
        u1 = f(1.0) - (w0 >> xp.uint32(8)).astype(f) * f(2.0 ** -24)
        u2 = (w1 >> xp.uint32(8)).astype(f) * f(2.0 ** -24)
        nb = m
    else:
        w0, w1 = raw_words(xp, key, counter, 2 * m)
        f = xp.float64
        v = _to_f64_exact(xp, w0 >> xp.uint32(5)) * np.float64(2 ** 26) \
            + _to_f64_exact(xp, w1 >> xp.uint32(6))
        u = v * np.float64(2.0 ** -53)
        u1 = f(1.0) - u[:m]
        u2 = u[m:]
        nb = 2 * m
    r = xp.sqrt(f(-2.0) * xp.log(u1))
    th = f(2.0 * np.pi) * u2
    z = xp.concatenate([r * xp.cos(th), r * xp.sin(th)])[:n]
    return z, nb


class PhiloxState:
    """Session RNG state: (key, counter). The name is kept from the reference
    contract (host-mirrored counter-based state); the generator underneath is
    Threefry2x32 — see module docstring for why."""

    __slots__ = ("seed", "key", "counter", "generator")

    def __init__(self, seed: int = 0):
        self.reseed(seed)
        self.generator = "threefry2x32"

    def reseed(self, seed: int) -> None:
        self.seed = int(seed) & ((1 << 64) - 1)
        s0 = np.array([self.seed & _MASK], dtype=np.uint32)
        s1 = np.array([(self.seed >> 32) & _MASK], dtype=np.uint32)
        k0, k1 = threefry2x32(np, 0x9E3779B9, 0xBB67AE85, s0, s1)
        self.key = (int(k0[0]), int(k1[0]))
        self.counter = 0

    def advance(self, blocks: int) -> int:
        """Reserve `blocks` counter blocks; returns the starting counter."""
        start = self.counter
        self.counter += int(blocks)
        return start

    def state_tuple(self):
        return (self.seed, self.key, self.counter)


# ---------------- host convenience wrappers (session RNG) -------------------- #

def host_rand(state: PhiloxState, n: int, dtype) -> np.ndarray:
    start = state.advance(blocks_for("rand", n, dtype))
    vals, _ = uniform(np, state.key, start, n, dtype)
    return vals


def host_randn(state: PhiloxState, n: int, dtype) -> np.ndarray:
    start = state.advance(blocks_for("randn", n, dtype))
    vals, _ = normal(np, state.key, start, n, dtype)
    return vals
