"""The int4 lab kernels' tensor-core operands (``csrc/int4_lab.cu``),
emulated in torch on the CPU, against ``run_bf16_plain``/``run_native_plain``
and the JAX lab's two Pallas kernels in interpret mode.

A kernel's A operand is the weight: each k-step covers 8 byte rows and
mma.sync m16n8k16's k index j is mapped onto them so that lane (g, t)'s
fragment (j = 2t, 2t + 1, 2t + 8, 2t + 9) comes from whole bytes of two byte
rows (split-half: j < 8 the low nibble of byte row r0 + j, j >= 8 the high
nibble of r0 + j - 8; native: byte row r0 + j // 2, nibble j % 2), and a
warp's WT m16 tiles take permuted columns (tile q's row i is column
(i % 8) * 2 WT + 2q + i // 8).  The emulation decodes every lane's bytes with
the kernel's bit operations (byte permute, mask, bias, bf16 minus 136),
scatters the fragments back to (k, column) and holds them equal to the
unpacked int4 values; splits x into three bf16 parts and holds
hi + mid + lo == x bit for bit (and finds where that range ends); and sums the
exact products per 128-byte-row slice in f32, the even and the odd slices
each folded in slice order and then added, within 1e-5 of max|ref| of the
plain versions and the JAX kernels (the tensor cores' own accumulation order
is not emulated).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from _torch_port import np_tree
from jaxlsq import QuantSpec as JSpec
from jaxlsq.serve import quantize_weight as jquantize_weight
from jaxlsq_torch.lab import int4_kernel_lab as lab
from jaxlsq_torch.serve.pack import PackedWeight, unpack_int4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
SLICE_ROWS = 128  # byte rows a slice (16 k-steps of 8)


@pytest.fixture(scope="module")
def jlab(tmp_path_factory):
    """The JAX lab module, imported by path; the compilation-cache settings
    it makes on import are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    os.environ["JAXLSQ_COMPILE_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        spec = importlib.util.spec_from_file_location(
            "_int4_kernel_lab", os.path.join(REPO, "examples", "_int4_kernel_lab.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.pop("JAXLSQ_COMPILE_CACHE", None)
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _draw(k, seed=1):
    """The JAX lab's draw (seed 1) at k x N: its split-half ``PackedWeight``,
    its int4 values and activations for M = 1 and 4."""
    r = np.random.RandomState(seed)
    spec4 = JSpec.make(4, signed=True, symmetric=True, per_channel=True, axis=1)
    w = jnp.asarray(0.02 * r.randn(k, N).astype(np.float32))
    scale = jnp.asarray(0.001 + 0.0005 * r.rand(N).astype(np.float32))
    p4 = jquantize_weight(w, scale, jnp.zeros((N,)), spec4, bits=4)
    w4 = jnp.round(jnp.clip(w / scale[None, :], -8, 7)).astype(jnp.int4)
    xs = {m: r.randn(m, k).astype(np.float32) for m in (1, 4)}
    return p4, w4, xs


# ---- the kernel's bit operations, on uint32 numpy arrays ----

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm with selector nibbles below 8."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _bf16_bits_to_f32(h):
    return (h.astype(np.uint32) << 16).view(np.float32)


def _nibbles_bf16x2(X):
    """(X & 0x000F000F) ^ 0x43084308 as bf16x2, less 136 (exact): the two
    values (bits 0-15, bits 16-31)."""
    h = (X & 0x000F000F) ^ 0x43084308
    return _bf16_bits_to_f32(h & 0xFFFF) - 136.0, _bf16_bits_to_f32(h >> 16) - 136.0


def _words(data, r, n):
    """The little-endian 32-bit word of bytes data[r, n .. n + 3] (0 past
    the rows or columns), for arrays r, n."""
    R, Nc = data.shape
    word = np.zeros(np.broadcast(r, n).shape, np.uint32)
    for j in range(4):
        c = n + j
        ok = (r < R) & (c < Nc)
        b = np.where(ok, data[np.minimum(r, R - 1), np.minimum(c, Nc - 1)], 0)
        word |= (b.astype(np.uint32) & 0xFF) << (8 * j)
    return word


def emulate_a(data, native, wt):
    """The A operand every lane of every warp decodes, scattered back to
    (k index of the padded k-steps, column): a (16 * steps, N) float
    array.  data: the (byte rows, N) uint8 bytes; wt: m16 tiles a warp."""
    R = data.shape[0]
    steps = -(-R // SLICE_ROWS) * (SLICE_ROWS // 8)
    cols = 16 * wt  # a warp's columns
    groups = -(-N // cols)
    out = np.full((16 * steps, groups * cols), np.nan, np.float32)
    ks, wg = np.meshgrid(np.arange(steps), np.arange(groups), indexing="ij")
    for g in range(8):
        for t in range(4):
            ra = 8 * ks + (t if native else 2 * t)
            rb = ra + (4 if native else 1)
            for v in range(wt // 2):
                n = wg * cols + g * 2 * wt + 4 * v  # the word's first column
                wa, wb = _words(data, ra, n), _words(data, rb, n)
                for c in range(4):
                    q, e = 2 * v + c // 2, c % 2
                    sel = c | (c + 4) << 8
                    if native:
                        regs = {e: _byte_perm(wa, wa >> 4, sel), 2 + e: _byte_perm(wb, wb >> 4, sel)}
                    else:
                        X = _byte_perm(wa, wb, sel)
                        regs = {e: X, 2 + e: X >> 4}
                    for reg, bits in regs.items():
                        # a0: row g, j 2t, 2t+1; a1: row g+8; a2 / a3: j + 8
                        i = g + 8 * (reg % 2)
                        j = 2 * t + 8 * (reg // 2)
                        col = wg * cols + (i % 8) * 2 * wt + 2 * q + i // 8
                        lo, hi = _nibbles_bf16x2(bits)
                        out[16 * ks + j, col] = lo
                        out[16 * ks + j + 1, col] = hi
    return out[:, :N]


def k_of(native, steps, KR):
    """The k and the byte row of each (k-step, j) position: split-half
    j < 8 -> k = 8 ks + j, j >= 8 -> KR + 8 ks + j - 8, byte row 8 ks + j % 8;
    native k = 16 ks + j, byte row k // 2."""
    ks, j = np.divmod(np.arange(16 * steps), 16)
    if native:
        return 16 * ks + j, (16 * ks + j) // 2
    return np.where(j < 8, 8 * ks + j, KR + 8 * ks + j - 8), 8 * ks + j % 8


def split3(x):
    """The kernel's three exact bf16 parts of f32 x."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    r = x - hi
    mid = r.to(torch.bfloat16).to(torch.float32)
    lo = (r - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


def emulate(x, data, scale, K, native, wt):
    """The kernel's result: staged x times the decoded A per slice (exact
    products, summed in f32); the even slices' partials left-folded from +0,
    the odd slices' likewise, the two added, times the scale."""
    R = data.shape[0]
    KR = (K + 1) // 2
    a = torch.from_numpy(emulate_a(data, native, wt))
    steps = a.shape[0] // 16
    k, rows = (torch.from_numpy(v) for v in k_of(native, steps, KR))
    live = (k < K) & (rows < R)
    xs = torch.zeros(x.shape[0], 16 * steps)
    xs[:, live] = x[:, k[live]]
    parts = split3(xs) if native else (xs.to(torch.bfloat16).to(torch.float32),)
    lanes = [torch.zeros(x.shape[0], N), torch.zeros(x.shape[0], N)]
    for s in range(steps // 16):
        sl = slice(256 * s, 256 * (s + 1))
        part = torch.zeros(x.shape[0], N)
        for p in parts:
            part = part + p[:, sl] @ a[sl]
        lanes[s % 2] = lanes[s % 2] + part
    total = lanes[0] + lanes[1]
    return total * scale


def _close(got, want):
    want = np.asarray(want)
    tol = 1e-5 * float(np.abs(want).max())
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol, (np.abs(got - want).max(), tol)


def _packed(p):
    return PackedWeight(**{k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v
                           for k, v in np_tree(p).items()})


@pytest.mark.parametrize("wt", [8, 2])
@pytest.mark.parametrize("native,k", [(False, 512), (True, 512), (False, 66), (True, 66),
                                      (False, 1023)])
def test_a_fragments_are_the_int4_values(native, wt, k):
    """Every lane's decoded fragment, scattered back through the k-step and
    column permutations, is the weight's int4 value at (k, column); padding
    (rows past the weight, odd K's dead high nibble) decodes to 0 or meets
    x = 0."""
    r = np.random.RandomState(k + wt)
    q = torch.from_numpy(r.randint(-8, 8, size=(k, N)).astype(np.int8))
    KR = (k + 1) // 2
    if native:
        data = lab.pack_native(q)
    else:
        qq = torch.cat([q, torch.zeros(2 * KR - k, N, dtype=torch.int8)])
        data = ((qq[:KR] & 0x0F) | (qq[KR:] << 4)).to(torch.int8)
        # odd K: a dead high nibble in the last byte row (any value)
        if k % 2:
            dead = torch.from_numpy(r.randint(-8, 8, size=N).astype(np.int8))
            data[-1] = (data[-1] & 0x0F) | (dead << 4)
    a = emulate_a(data.numpy().view(np.uint8), native, wt)
    steps = a.shape[0] // 16
    kk, rows = k_of(native, steps, KR)
    want = np.zeros_like(a)
    live = (kk < k) & (rows < data.shape[0])
    want[live] = q.numpy()[kk[live]]
    # every position is filled, and the live ones hold the weights
    assert not np.isnan(a).any()
    np.testing.assert_array_equal(a[live], want[live])
    # rows past the weight's decode to 0
    assert (a[rows >= data.shape[0]] == 0).all()


def test_nibble_decode_is_exact_for_all_sixteen_values():
    v = np.arange(16, dtype=np.uint32)  # the nibble's bits; signed value v - 16 (v >= 8)
    signed = np.where(v >= 8, v.astype(np.int32) - 16, v.astype(np.int32))
    X = v | (((v + 5) % 16) << 16) | np.uint32(0xF0F0F0F0)  # other bits are masked off
    lo, hi = _nibbles_bf16x2(X)
    np.testing.assert_array_equal(lo, signed.astype(np.float32))
    signed_hi = np.where((v + 5) % 16 >= 8, (v + 5) % 16 - 16.0, (v + 5) % 16)
    np.testing.assert_array_equal(hi, signed_hi.astype(np.float32))


def test_three_part_split_is_exact():
    r = np.random.RandomState(3)
    draws = [r.randn(4, 8192).astype(np.float32),
             np.array([0.0, -0.0, 2.0 ** -100, -2.0 ** -100, 2.0 ** 100, -2.0 ** 100],
                      np.float32),
             # significands with all 24 bits set, at every exponent of [-110, 126]
             np.array([(2 - 2.0 ** -23) * 2.0 ** e * s for e in range(-110, 127)
                       for s in (1, -1)], np.float32)]
    for d in draws:
        x = torch.from_numpy(d)
        hi, mid, lo = split3(x)
        assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
        # each part is a bf16 value
        for p in (hi, mid, lo):
            assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)
    # where the range ends: below 2^-110 the remainders need bf16 subnormals
    # finer than 2^-133; at 2^127 bf16_rn(x) overflows
    for e in (-111, 127):
        x = torch.tensor([(2 - 2.0 ** -23) * 2.0 ** e], dtype=torch.float32)
        hi, mid, lo = split3(x)
        assert not torch.equal(hi.double() + mid.double() + lo.double(), x.double())


@pytest.mark.parametrize("m", [1, 4])
def test_emulated_kernels_match_plain_and_jax(jlab, m):
    p4, w4, xs = _draw(512)
    x = xs[m]
    packed = _packed(p4)
    native = lab.pack_native(torch.from_numpy(np.array(w4.astype(jnp.int8))))
    scale = packed.scale.to(torch.float32)
    with pltpu.force_tpu_interpret_mode():
        want_bf16 = jlab.run_bf16(jnp.asarray(x), p4, 8, 256, 128)
        want_native = jlab.run_native(jnp.asarray(x), w4, p4.scale.astype(jnp.float32),
                                      8, 256, 128)
    tx = torch.from_numpy(x)
    data = packed.data.numpy().view(np.uint8)
    for wt in (8, 2):  # the decode form's warps, the tiled form's
        got = emulate(tx, data, scale, 512, False, wt)
        _close(got.numpy(), want_bf16)
        _close(got.numpy(), lab.run_bf16_plain(tx, packed).numpy())
        got = emulate(tx, native.numpy().view(np.uint8), scale, 512, True, wt)
        _close(got.numpy(), want_native)
        _close(got.numpy(), lab.run_native_plain(tx, native, scale).numpy())


def test_emulated_split_half_odd_k_matches_plain_and_jax(jlab):
    p4, _, xs = _draw(1023, seed=5)
    x = xs[4]
    packed = _packed(p4)
    with pltpu.force_tpu_interpret_mode():
        want = jlab.run_bf16(jnp.asarray(x), p4, 8, 256, 128)
    tx = torch.from_numpy(x)
    got = emulate(tx, packed.data.numpy().view(np.uint8), packed.scale.to(torch.float32),
                  1023, False, 8)
    _close(got.numpy(), want)
    _close(got.numpy(), lab.run_bf16_plain(tx, packed).numpy())
    # the plain version reads the same int4 values the emulation decodes
    q = unpack_int4(packed.data, 0)[:1023]
    assert q.shape == (1023, N)
