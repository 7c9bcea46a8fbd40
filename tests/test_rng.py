"""RNG bit-parity against a pure-python model of the reference's
FNV + TEA counter RNG (src/artic/core/random.art)."""

import numpy as np

from ignis_jax.core import rng

M = 0xFFFFFFFF


def fnv_py(h, d):
    for shift in (0, 8, 16, 24):
        h = ((h * 16777619) & M) ^ ((d >> shift) & 0xFF)
    return h


def seed_py(sample, it, frame, x, y, user):
    h = 0x811C9DC5
    for d in (sample, it, frame, x, y, user):
        h = fnv_py(h, d)
    return h


def tea_py(v0, v1):
    s = 0
    for _ in range(4):
        s = (s + 0x9E3779B9) & M
        v0 = (v0 + ((((v1 << 4) & M) + 0xA341316C) ^ ((v1 + s) & M)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & M
        v1 = (v1 + ((((v0 << 4) & M) + 0xAD90777D) ^ ((v0 + s) & M)
                    ^ ((v0 >> 5) + 0x7E95761E))) & M
    return v1


def f32_py(bits):
    mant = (bits & 0x7FFFFF) | 0x3F800000
    return float(np.frombuffer(np.uint32(mant).tobytes(), np.float32)[0]) - 1.0


def test_tea_matches_reference_model():
    rngs = np.random.default_rng(0)
    v0 = rngs.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    v1 = rngs.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    ours = np.asarray(rng.sample_tea_u32(v0, v1))
    ref = np.array([tea_py(int(a), int(b)) for a, b in zip(v0, v1)], np.uint32)
    np.testing.assert_array_equal(ours, ref)


def test_seed_matches_reference_model():
    ours = np.asarray(rng.create_seed(
        np.uint32([3]), np.uint32([7]), np.uint32([0]),
        np.uint32([11]), np.uint32([13]), np.uint32([42])))
    assert ours[0] == seed_py(3, 7, 0, 11, 13, 42)


def test_float_draw_sequence():
    seed = np.uint32([seed_py(0, 0, 0, 5, 9, 0)])
    counter = np.uint32([1])  # create_random_generator starts at 1
    fs = []
    for _ in range(8):
        f, counter = rng.next_f32(seed, counter)
        fs.append(float(f[0]))
    # python model
    ctr = 1
    ref = []
    for _ in range(8):
        bits = tea_py(int(seed[0]), ctr)
        ctr += 1
        ref.append(f32_py(bits))
    np.testing.assert_allclose(fs, ref, rtol=0, atol=0)
    assert all(0.0 <= f < 1.0 for f in fs)


def test_next_i32_range_small():
    seed = np.uint32([12345] * 1000)
    counter = np.uint32([1] * 1000)
    v, counter2 = rng.next_i32(seed, counter, 0, 4)
    v = np.asarray(v)
    assert v.min() >= 0 and v.max() <= 4
    # same seed+counter → deterministic
    v2, _ = rng.next_i32(seed, counter, 0, 4)
    np.testing.assert_array_equal(v, np.asarray(v2))


def test_masked_lanes_do_not_advance():
    seed = np.uint32([1, 1])
    counter = np.uint32([1, 1])
    active = np.array([True, False])
    v, c2 = rng.next_u32_range(seed, counter, np.uint32(10), active)
    c2 = np.asarray(c2)
    assert c2[0] >= 2 and c2[1] == 1
    assert np.asarray(v)[1] == 0
