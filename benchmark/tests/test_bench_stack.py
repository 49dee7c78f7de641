import numpy as np

from benchmark.data.stack import make_stack, stack_pool

DYN = {"diffusion": 1.5, "drift": [0.6, -0.4], "saturation": 0.3, "noise": 0.002, "ic_sigma": 24.0, "scale": 60000.0}


def test_shape_dtype_range_and_writable():
    U = make_stack(5, 64, 80, seed=2**40 + 3, device="cpu", **DYN)
    assert U.shape == (5, 64, 80) and U.dtype == np.uint16
    assert U.flags.writeable
    assert U.min() == 0 and U.max() in (59999, 60000)


def test_same_seed_same_stack_other_seed_other_stack():
    a = make_stack(4, 48, 48, seed=123, device="cpu", **DYN)
    b = make_stack(4, 48, 48, seed=123, device="cpu", **DYN)
    c = make_stack(4, 48, 48, seed=124, device="cpu", **DYN)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_pool_members_distinct_and_seeded():
    p = stack_pool(3, 3, 32, 32, seed=9, device="cpu", dynamics=DYN)
    q = stack_pool(3, 3, 32, 32, seed=9, device="cpu", dynamics=DYN)
    assert all(np.array_equal(x, y) for x, y in zip(p, q))
    assert not np.array_equal(p[0], p[1]) and not np.array_equal(p[1], p[2])


def test_frames_drift_as_stated():
    """The bright pattern moves by the drift: frame 1 matches frame 0 shifted
    by about (0.6, -0.4) px, better than unshifted."""
    U = make_stack(2, 96, 96, seed=5, device="cpu", **dict(DYN, noise=0.0, diffusion=0.0)).astype(float)
    k = np.fft.fftfreq(96) * 2 * np.pi
    F = np.fft.fft2(U[0]) * np.exp(-1j * (k[:, None] * 0.6 + k[None, :] * -0.4))
    moved = np.fft.ifft2(F).real
    assert np.abs(moved - U[1]).mean() < 0.2 * np.abs(U[0] - U[1]).mean()
