"""The device fills of cholesky_tpu_torch (rng/device.py over the CUDA
kernels of ops/kernels/prng.py) on the CPU, where each wrapper runs its
plain twin. The TPU kernels draw the TPU's hardware bits, which no other
machine reproduces, so the fills are held to the JAX package's contract
(cholesky_tpu/rng/pallas_prng.py and tests/test_pallas_prng.py):
determinism in (seed, shape), [0, 1) and the four intervals, the 2⁻⁵³
grid of the f64 fill, adjacent seeds sharing no row block, ragged shapes.
The per-block seed hash is the JAX package's bit for bit, and the twins'
Philox4x32-10 is checked against the generator's published known-answer
vectors. The kernels are held against the twins, bit for bit, on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from cholesky_tpu.rng import pallas_prng as jprng
from cholesky_tpu_torch.ops import kernels
from cholesky_tpu_torch.ops.kernels import prng as kprng
from cholesky_tpu_torch.rng import (Interval, uniform_device,
                                    uniform_device64)
from cholesky_tpu_torch.rng import device as rdev
from tests.torch_limits import module_time_limit, time_limit  # noqa: F401

MASK = 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 31 - 1, 2 ** 32 - 1])
@pytest.mark.parametrize("salt", [0, rdev.SALT_F64])
def test_mix_seeds_bit_for_bit_with_jax(seed, salt):
    for n in (1, 3, 40):
        got = rdev._mix_seeds(seed, n, salt)
        want = np.asarray(jprng._mix_seeds(seed, n, salt))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# Random123's known-answer vectors for philox4x32_10: (counter, key, out)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((MASK,) * 4, (MASK, MASK),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    c = tuple(torch.tensor([x], dtype=torch.int64) for x in counter)
    got = kprng.philox4x32_10(c, torch.tensor([key[0]]),
                              torch.tensor([key[1]]))
    assert tuple(int(w) for w in got) == want


def test_mulhilo_is_exact():
    rng = np.random.default_rng(0)
    b = np.concatenate([rng.integers(0, 2 ** 32, 1000, dtype=np.int64),
                        [0, 1, MASK, 2 ** 31, 2 ** 16 - 1, 2 ** 16]])
    for a in kprng.PHILOX_M + (MASK, 1):
        hi, lo = kprng.mulhilo(a, torch.from_numpy(b))
        full = [a * int(x) for x in b]
        assert hi.tolist() == [f >> 32 for f in full]
        assert lo.tolist() == [f & MASK for f in full]


def scalar_word(seeds, rows, cols, r, c, per_call, word):
    """Element (r, c)'s Philox word, one call at a time: the layout the
    kernel and the twin share, written out on its own."""
    rp = kprng.rows_per_block(rows)
    b, p = r // rp, (r % rp) * cols + c
    t = p // per_call
    w = kprng.philox4x32_10(
        (torch.tensor(t & MASK), torch.tensor(t >> 32), torch.tensor(0),
         torch.tensor(0)), int(seeds[b]) & MASK, 0)
    return int(w[(p % per_call) * (4 // per_call) + word])


@pytest.mark.parametrize("rows,cols", [(300, 57), (8, 1), (1, 5)])
def test_twins_follow_the_layout(rows, cols):
    seeds = rdev._mix_seeds(3, -(-rows // kprng.rows_per_block(rows)))
    u32 = kprng.uniform_fill_f32_plain(seeds, rows, cols)
    u64 = kprng.uniform_fill_f64_plain(seeds, rows, cols)
    assert u32.shape == u64.shape == (rows, cols)
    for r, c in {(0, 0), (rows - 1, cols - 1), (rows // 2, cols // 3),
                 (min(rows - 1, 257), cols - 1)}:
        w = scalar_word(seeds, rows, cols, r, c, 4, 0)
        want32 = np.array(0x3F800000 | (w >> 9), np.uint32).view(
            np.float32) - np.float32(1.0)
        assert u32[r, c].item() == want32
        hi = scalar_word(seeds, rows, cols, r, c, 2, 0)
        lo = scalar_word(seeds, rows, cols, r, c, 2, 1)
        assert u64[r, c].item() == ((hi << 21) | (lo >> 11)) * 2.0 ** -53


@pytest.mark.parametrize("fill,dtype", [(uniform_device, torch.float32),
                                        (uniform_device64, torch.float64)])
def test_deterministic_and_uniform(fill, dtype):
    a = fill(7, (512, 256), device="cpu")
    assert a.dtype == dtype and a.shape == (512, 256)
    assert torch.equal(a, fill(7, (512, 256), device="cpu"))
    assert not torch.equal(a, fill(8, (512, 256), device="cpu"))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    # moments of U(0, 1) over 2¹⁷ values, within 6 standard errors
    m = a.double().flatten()
    assert abs(float(m.mean()) - 0.5) < 6 * (1 / 12) ** 0.5 / len(m) ** 0.5
    assert abs(float(m.var()) - 1 / 12) < 6 * (1 / 180) ** 0.5 / len(m) ** 0.5


def test_f64_fill_is_on_the_53_bit_grid():
    u = uniform_device64(7, (256, 128), device="cpu")
    s = u * 2.0 ** 53
    assert torch.equal(s, torch.round(s)) and float(u.max()) < 1.0
    # the values use more than an f32's 24 bits
    assert float((u - u.float().double()).abs().max()) > 0
    # and are not the f32 fill's
    assert not torch.equal(u.float(), uniform_device(7, (256, 128),
                                                     device="cpu"))


@pytest.mark.parametrize("interval,lo_ok,hi_ok", [
    (Interval.CLOSED, lambda x: x >= 0, lambda x: x <= 1),
    (Interval.OPEN, lambda x: x > 0, lambda x: x < 1),
    (Interval.HALF_OPEN_01, lambda x: x >= 0, lambda x: x < 1),
    (Interval.HALF_OPEN_10, lambda x: x > 0, lambda x: x <= 1),
])
@pytest.mark.parametrize("fill", [uniform_device, uniform_device64])
def test_intervals(interval, lo_ok, hi_ok, fill):
    u = fill(3, (256, 256), interval, device="cpu")
    assert lo_ok(float(u.min())) and hi_ok(float(u.max()))


@pytest.mark.parametrize("fill", [uniform_device, uniform_device64])
def test_ragged_shapes(fill):
    for shape in ((100, 57), (1, 1), (257, 3)):
        u = fill(1, shape, device="cpu")
        assert u.shape == shape
    # a shape is not a window of a larger one's fill
    assert not torch.equal(fill(1, (100, 57), device="cpu"),
                           fill(1, (100, 58), device="cpu")[:, :57])


@pytest.mark.parametrize("fill", [uniform_device, uniform_device64])
def test_adjacent_seeds_share_no_row_block(fill):
    # the additive scheme the JAX package replaced made block i of seed s
    # block i - 1 of seed s + 1 (ADVICE r2)
    a = fill(41, (1024, 64), device="cpu")
    b = fill(42, (1024, 64), device="cpu")
    for i in range(4):
        for j in range(4):
            assert not torch.equal(a[256 * i:256 * (i + 1)],
                                   b[256 * j:256 * (j + 1)])
    c = np.corrcoef(a.double().flatten().numpy(),
                    b.double().flatten().numpy())[0, 1]
    assert abs(c) < 6 / (1024 * 64) ** 0.5


def test_cpu_seeds_take_the_twins():
    kernels.reset_launch_counts()
    seeds = rdev._mix_seeds(5, 2)
    assert torch.equal(kprng.uniform_fill_f32(seeds, 300, 9),
                       kprng.uniform_fill_f32_plain(seeds, 300, 9))
    assert torch.equal(kprng.uniform_fill_f64(seeds, 300, 9),
                       kprng.uniform_fill_f64_plain(seeds, 300, 9))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("fill", [kprng.uniform_fill_f32,
                                  kprng.uniform_fill_f64])
def test_fills_reject_what_the_kernels_do_not_take(fill):
    seeds = rdev._mix_seeds(5, 2)
    with pytest.raises(ValueError):
        fill(seeds, 100, 4)                        # one block, two seeds
    with pytest.raises(ValueError):
        fill(seeds.long(), 300, 4)                 # int64 seeds
    with pytest.raises(ValueError):
        fill(seeds, 300, 0)                        # an empty fill


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises((RuntimeError, AssertionError)):
        uniform_device(0, (8, 8))
