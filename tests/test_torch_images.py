"""pdx_torch.io_host (image loading, caches, device_stack, artifact writers)
against pdx.io_host: exact equality, since both are the same host numpy
code (decoders, cache keys, CSV and JSON text)."""

import gc
import json

import numpy as np
import pytest
import torch

from pdx.io_host import artifacts as jart
from pdx.io_host import images as jim
from pdx_torch.io_host import artifacts as tart
from pdx_torch.io_host import images as tim

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture()
def tiff_dir(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "tiffs"
    d.mkdir()
    frames = rng.integers(0, 65536, size=(4, 24, 30)).astype(np.uint16)
    for i, f in enumerate(frames):
        PIL.fromarray(f).save(d / f"frame_{i:03d}.tif")
    PIL.fromarray((frames[0] >> 8).astype(np.uint8)).save(d / "frame_999_u8.tif")  # an 8-bit frame
    return d, frames


def test_fast_tiff_decoder(tiff_dir):
    d, frames = tiff_dir
    for i, f in enumerate(frames):
        got = tim._fast_tiff_gray(d / f"frame_{i:03d}.tif")
        np.testing.assert_array_equal(got, f)
        np.testing.assert_array_equal(got, jim._fast_tiff_gray(d / f"frame_{i:03d}.tif"))
    assert tim._fast_tiff_gray(d / "missing.tif") is None


@pytest.mark.parametrize("mode,dtype", [("unchanged", np.uint16), ("unchanged", np.float32), ("grayscale_u8", np.float32)])
def test_load_images_matches_pdx(tiff_dir, mode, dtype):
    d, frames = tiff_dir
    got = tim.load_images(d, max_images=4, mode=mode, dtype=dtype, cache=False)
    want = jim.load_images(d, max_images=4, mode=mode, dtype=dtype, cache=False)
    assert got.dtype == want.dtype and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    if mode == "unchanged":
        np.testing.assert_array_equal(got, frames.astype(dtype))


def test_load_images_caches(tiff_dir, tmp_path):
    d, frames = tiff_dir
    cache_dir = tmp_path / "cache"
    tim.clear_stack_memcache()
    first = tim.load_images(d, max_images=4, dtype=np.uint16, cache_dir=cache_dir)
    assert not first.flags.writeable
    assert tim.load_images(d, max_images=4, dtype=np.uint16, cache_dir=cache_dir) is first  # in-process hit
    tim.flush_stack_cache_writes(timeout=30)
    tim.clear_stack_memcache()
    assert len(list(cache_dir.glob("*.npy"))) == 1
    again = tim.load_images(d, max_images=4, dtype=np.uint16, cache_dir=cache_dir)  # from disk, memory-mapped
    np.testing.assert_array_equal(again, frames)
    # a replaced frame changes the key: the stale entry is not returned
    new0 = frames[0] ^ np.uint16(1)
    PIL.fromarray(new0).save(d / "frame_000.tif")
    tim.clear_stack_memcache()
    fresh = tim.load_images(d, max_images=4, dtype=np.uint16, cache_dir=cache_dir)
    np.testing.assert_array_equal(fresh[0], new0)
    tim.flush_stack_cache_writes(timeout=30)
    tim.clear_stack_memcache()


def test_npy_fallback_and_errors(tmp_path):
    U = np.random.default_rng(1).normal(size=(5, 6, 7))
    np.save(tmp_path / "stack.npy", U)
    np.testing.assert_array_equal(tim.load_images(tmp_path, max_images=3), jim.load_images(tmp_path, max_images=3))
    with pytest.raises(FileNotFoundError):
        tim.load_images(tmp_path / "nowhere")


def test_list_image_resolutions(tiff_dir):
    d, _ = tiff_dir
    assert tim.list_image_resolutions(d) == jim.list_image_resolutions(d) == {(24, 30): 5}


def test_device_stack_ships_a_read_only_stack_once():
    U = np.arange(2 * 3 * 4, dtype=np.uint16).reshape(2, 3, 4)
    U.setflags(write=False)
    a = tim.device_stack(U)
    assert tim.device_stack(U) is a
    np.testing.assert_array_equal(a.numpy(), U)
    b = tim.device_stack(U, dtype=torch.float64)
    assert b.dtype == torch.float64 and b is not a
    tim.clear_stack_memcache()


def test_device_stack_never_returns_a_stale_buffer():
    """Fault F2 of pdx's device_stack: its key is (id, shape, dtype, a hash
    of every (5, 61, 67)-th element), so a new array that reuses a freed
    array's id and differs only off that stride could get the old buffer.
    The port holds the array it cached, so its id cannot be reused, and
    hits only the same object."""
    shape = (10, 130, 140)
    a = np.zeros(shape, dtype=np.uint16)
    a.setflags(write=False)
    tim.device_stack(a)
    del a
    gc.collect()
    b = np.zeros(shape, dtype=np.uint16)
    b[1, 1, 1] = 7  # off pdx's fingerprint stride
    np.testing.assert_array_equal(b[::5, ::61, ::67], np.zeros(shape, np.uint16)[::5, ::61, ::67])
    b.setflags(write=False)
    assert int(tim.device_stack(b)[1, 1, 1]) == 7
    tim.clear_stack_memcache()


def test_device_stack_does_not_cache_a_writable_array():
    U = np.zeros((2, 3, 4))
    first = tim.device_stack(U).clone()
    U[0, 0, 0] = 5.0
    assert float(tim.device_stack(U)[0, 0, 0]) == 5.0 and float(first[0, 0, 0]) == 0.0
    tim.clear_stack_memcache()


def test_artifact_writers_match_pdx(tmp_path):
    stats = {
        "median": np.array([0.1, -2.5e-5]), "q25": np.array([0.05, -3e-5]), "q75": np.array([0.2, 1e-6]),
        "freq": np.array([1.0, 0.5]), "sign_stability": np.array([1.0, 0.75]), "coeffs": np.array([0.1, 0.0]),
    }
    for mod, name in ((tart, "port.csv"), (jart, "pdx.csv")):
        mod.write_patch_csv(tmp_path / name, ["u", "lap(u)"], stats)
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "pdx.csv").read_text()
    payload = {"a": np.float64(1.5), "b": np.arange(3.0), "c": [np.int64(2), (1, 2)], "d": {"e": np.ones((2, 2))}}
    tart.write_json(tmp_path / "port.json", payload)
    jart.write_json(tmp_path / "pdx.json", payload)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "pdx.json").read_text()
    tart.write_json(tmp_path / "t.json", {"s": torch.tensor(2.5), "v": torch.arange(3.0)})
    assert json.loads((tmp_path / "t.json").read_text()) == {"s": 2.5, "v": [0.0, 1.0, 2.0]}


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_smoke_tiff_writer_decodes_through_both_readers(tmp_path, dtype):
    """write_tiff (for machines without PIL or cv2) writes what
    _fast_tiff_gray and PIL both read back as the written frame."""
    from pdx_torch.io_host.images import write_tiff

    frame = np.random.default_rng(1).integers(0, np.iinfo(dtype).max, size=(17, 23), dtype=dtype)
    path = tmp_path / "frame.tif"
    write_tiff(path, frame)
    with PIL.open(path) as im:
        by_pil = np.asarray(im)
    for got in (tim._fast_tiff_gray(path), jim._fast_tiff_gray(path), by_pil):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, frame)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        write_tiff(path, frame.astype(np.float32))
