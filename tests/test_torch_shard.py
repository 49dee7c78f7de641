"""pdx_torch.shard against pdx.shard and the sharded pipelines, on the
8-device virtual CPU mesh that conftest.py gives JAX and a mesh of 8 virtual
shards of the CPU (``make_mesh(devices=["cpu"] * 8)``) on the port's side.
Both packages get the same numpy inputs; shapes and limits are
tests/test_sharding.py's, and ``pdx`` runs once a configuration in a module
fixture.

Limits, and why:

* the sharded Gram against pdx's at rtol 1e-10, ``n`` exact: both sum the
  same rows in other orders;
* ``maybe_shard_leading``'s padded shards bit for bit: padding copies;
* ``ks2d_bench`` with the mesh on against off at rtol 1e-9 / atol 1e-12 (the
  sharded statistics differ from the single ones in the order of the sums);
* the patch ensemble at rtol 1e-10 / atol 1e-13, ``patch_sindy`` at rtol 1e-7
  / atol 1e-9 (a shard's batched solve rounds as a batch of its own size);
  against ``pdx``, the limits of test_torch_patch_discovery.py and
  test_torch_patch_sindy.py;
* ``comprehensive`` over 3 virtual shards equal to one device bit for bit:
  its batched ridge family is built so that batch size does not change the
  rounding.
"""

import numpy as np
import pytest
import torch

from pdx_torch.shard import dryrun as tdry
from pdx_torch.shard import mesh as tm

N_DEV = 8


@pytest.fixture(scope="module")
def jmesh():
    """pdx's mesh over every JAX device (imported here, so that the ``gpu``
    test runs on a machine without jax: ``pytest --noconftest -m gpu``)."""
    import jax

    from pdx.shard import mesh

    if len(jax.devices()) < N_DEV:
        pytest.skip("needs 8 virtual JAX devices (tests/conftest.py)")
    return mesh


@pytest.fixture(scope="module")
def cpu8():
    return tm.make_mesh(devices=["cpu"] * N_DEV)


def test_sharded_gram_stats_matches_pdx(jmesh, cpu8):
    """1003 rows (not a multiple of 8), zero-weight padded to 1008."""
    import jax.numpy as jnp

    from pdx_torch.ops.linalg import gram_stats

    rng = np.random.default_rng(0)
    n, p = 1003, 7
    X, y = rng.normal(size=(n, p)), rng.normal(size=n)
    pad = (-n) % N_DEV
    Xp, yp = np.concatenate([X, np.zeros((pad, p))]), np.concatenate([y, np.zeros(pad)])
    w = np.concatenate([np.ones(n), np.zeros(pad)])
    m = jmesh.make_mesh(N_DEV)
    want = jmesh.sharded_gram_stats(*(jmesh.shard_batch(jnp.asarray(a), m) for a in (Xp, yp)), m,
                                    weights=jmesh.shard_batch(jnp.asarray(w), m))
    shards = [tm.shard_batch(torch.from_numpy(a), cpu8) for a in (Xp, yp, w)]
    got = tm.sharded_gram_stats(*shards[:2], cpu8, weights=shards[2])
    again = tm.sharded_gram_stats(torch.from_numpy(Xp), torch.from_numpy(yp), cpu8, weights=torch.from_numpy(w))
    single = gram_stats(torch.from_numpy(X), torch.from_numpy(y))
    for k in ("G", "b", "sx", "n", "syy", "sy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-10, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), single[k].numpy(), rtol=1e-10, err_msg=k)
        assert torch.equal(got[k], again[k]), k  # the same sums in the same order
    assert float(got["n"]) == float(want["n"]) == n


def test_maybe_shard_leading_matches_pdx(jmesh, cpu8):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(13, 3, 2)), rng.integers(0, 9, size=13)
    (ja, jb), jP0 = jmesh.maybe_shard_leading((jnp.asarray(a), jnp.asarray(b)), "on")
    arrs = (torch.from_numpy(a), torch.from_numpy(b))
    (ta, tb), P0 = tm.maybe_shard_leading(arrs, "on", cpu8)
    assert P0 == jP0 == 13
    assert len(ta) == len(tb) == N_DEV and {t.shape[0] for t in ta} == {2}
    assert all(t.device == d for t, d in zip(ta, cpu8.devices))
    np.testing.assert_array_equal(torch.cat(ta).numpy(), np.asarray(ja))
    np.testing.assert_array_equal(torch.cat(tb).numpy(), np.asarray(jb))
    # the no-op: mesh off, or fewer than two devices even when on; no copy
    for mode, mesh in (("off", cpu8), ("on", tm.make_mesh(devices=["cpu"])), ("auto", tm.make_mesh(devices=["cpu"]))):
        same, P0 = tm.maybe_shard_leading(arrs, mode, mesh)
        assert same is arrs and P0 == 13


def test_mesh_construction():
    m = tm.make_mesh(devices=["cpu", "cpu", "cpu"], axis_name="patches")
    assert len(m) == 3 and m.axis_name == "patches" and [m.slot_name(i) for i in range(3)] == ["cpu#0", "cpu#1", "cpu#2"]
    assert tm.make_mesh(2, devices=["cpu"] * 4).devices == (torch.device("cpu"),) * 2
    assert tm.default_mesh("cpu").devices == (torch.device("cpu"),) and tm.default_mesh("cpu").slot_name(0) == "cpu"
    with pytest.raises(ValueError, match="does not divide"):
        tm.shard_batch(torch.zeros(5), m)
    with pytest.raises(ValueError, match="4 devices asked for"):
        tm.make_mesh(4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():  # a mesh that names the card without one raises, never falls back
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tm.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tm.make_mesh(devices=["cuda"] * 2)


def test_a_failing_shard_raises(cpu8):
    def fn(x):
        if x.device == cpu8.devices[0] and float(x[0]) >= 8:
            raise FloatingPointError("shard 4 failed")
        return x

    with pytest.raises(FloatingPointError):
        tm.map_shards(fn, (tm.shard_batch(torch.arange(16.0), cpu8),), cpu8)


KS = dict(Nx=32, Ny=32, n_seconds=0.1, dt=1e-3, n_sample=5_000, alpha=1e-6, threshold=1e-10, solver="gram")


def test_ks2d_bench_sharded_gram(jmesh, cpu8):
    """The standard single fit with its Gram sample-sharded over 8 shards."""
    from pdx.pipelines import ks2d_bench as jb

    from pdx_torch.pipelines import ks2d_bench as tb

    want = jb.run(jb.Ks2dBenchConfig(**KS, mesh="on"))
    on = tb.run(tb.Ks2dBenchConfig(**KS, mesh="on"), "cpu", cpu8)
    off = tb.run(tb.Ks2dBenchConfig(**KS, mesh="off"), "cpu", cpu8)
    np.testing.assert_allclose(on["coeffs"], off["coeffs"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(on["coeffs"], want["coeffs"], rtol=1e-9, atol=1e-12)
    for k in off["gt_errors"]:
        assert on["gt_errors"][k]["rel_err_pct"] < 1.0


PD = dict(data_dir="unused", registration=False, downsample=1, skip=6, subsample=2, patch=15, overlap=7,
          rs=2, rt=1, samples_per_patch=60, write_artifacts=False)


@pytest.fixture(scope="module")
def pd_stack():
    from tests.test_real_pipelines import make_synthetic_stack

    return make_synthetic_stack(T=16, N=120)


def test_patch_discovery_sharded(jmesh, cpu8, pd_stack):
    from pdx.pipelines import patch_discovery as jpd

    from pdx_torch.pipelines import patch_discovery as tpd

    want = jpd.run(jpd.PatchDiscoveryConfig(**PD, mesh="on"), U_raw=pd_stack)
    on = tpd.run(tpd.PatchDiscoveryConfig(**PD, mesh="on"), U_raw=pd_stack, device="cpu", mesh=cpu8)
    off = tpd.run(tpd.PatchDiscoveryConfig(**PD, mesh="off"), U_raw=pd_stack, device="cpu", mesh=cpu8)
    assert on["n_patches"] == off["n_patches"] == want["n_patches"] and on["n_patches"] % N_DEV  # padded
    np.testing.assert_allclose(on["patch_coeffs"], off["patch_coeffs"], rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(on["stats"]["coeffs"], off["stats"]["coeffs"], rtol=1e-10, atol=1e-13)
    Cj = np.asarray(want["patch_coeffs"])
    np.testing.assert_allclose(on["patch_coeffs"], Cj, rtol=0, atol=1e-10 * np.abs(Cj).max())
    assert on["n_shard_devices"] == want["n_shard_devices"] == N_DEV
    assert off["n_shard_devices"] == 1


PS = dict(data_dir="unused", patch_size=40, overlap=10, skip_boundary=2, subsample=2, min_patches=2,
          write_artifacts=False)


def test_patch_sindy_sharded(jmesh, cpu8, pd_stack):
    from pdx.pipelines import patch_sindy as jps

    from pdx_torch.pipelines import patch_sindy as tps
    from tests.test_real_pipelines import make_synthetic_stack

    U = make_synthetic_stack(T=12, N=96).astype(np.float64) / 60000.0
    want = jps.run(jps.PatchSindyConfig(**PS, mesh="on"), U_raw=U)
    on = tps.run(tps.PatchSindyConfig(**PS, mesh="on"), U_raw=U, device="cpu", mesh=cpu8)
    off = tps.run(tps.PatchSindyConfig(**PS, mesh="off"), U_raw=U, device="cpu", mesh=cpu8)
    assert on["n_patches"] == off["n_patches"] == want["n_patches"] and on["n_patches"] % N_DEV  # padded
    np.testing.assert_allclose(on["patch_coeffs"], off["patch_coeffs"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(on["coeffs"], off["coeffs"], rtol=1e-7, atol=1e-9)
    Cj = np.asarray(want["patch_coeffs"])
    scale = np.abs(Cj).max()  # column 0 (the constant) is round-off in both packages
    np.testing.assert_allclose(on["patch_coeffs"][:, 1:], Cj[:, 1:], rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(on["coeffs"][1:], np.asarray(want["coeffs"])[1:], rtol=0, atol=1e-10 * scale)
    assert on["n_shard_devices"] == want["n_shard_devices"] == N_DEV
    assert off["n_shard_devices"] == 1


CP = dict(Nx=32, Ny=32, n_seconds=0.05, save_every=25, n_subsample=2000, methods=("M01_baseline", "M02_gaussian"),
          noises=("N2_noise", "N3_blur"), dtype="float64", write_artifacts=False)


def test_comprehensive_round_robin(jmesh):
    """multi_device over 3 virtual shards: regime i on slot i, the ridge
    family split over the 3 slots; equal to one device bit for bit, and to
    pdx over its 8 devices."""
    from pdx.pipelines import comprehensive as jc

    from pdx_torch.pipelines import comprehensive as tc

    want = jc.run(jc.ComprehensiveConfig(**CP, multi_device=True))
    three = tc.run(tc.ComprehensiveConfig(**CP, multi_device=True), "cpu", mesh=tm.make_mesh(devices=["cpu"] * 3))
    one = tc.run(tc.ComprehensiveConfig(**CP, multi_device=True), "cpu")
    assert three["placement"] == {"N0_clean": "cpu#0", "N2_noise": "cpu#1", "N3_blur": "cpu#2"}
    assert set(one["placement"].values()) == {"cpu"}
    assert len(set(want["placement"].values())) == len(set(three["placement"].values())) == 3
    assert three["results"] == {n: {m: {**r, "time": three["results"][n][m]["time"]} for m, r in res.items()}
                                for n, res in one["results"].items()}
    for n, res in want["results"].items():
        for m, r in res.items():
            np.testing.assert_allclose(three["results"][n][m]["coef"], r["coef"], rtol=0,
                                       atol=1e-8 * np.abs(r["coef"]).max(), err_msg=f"{n}/{m}")


def test_dryrun_multichip_cpu():
    out = tdry.dryrun_multichip(N_DEV, "cpu")
    assert out["mesh"] == [f"cpu#{i}" for i in range(N_DEV)] and out["distinct_devices"] == 1
    assert out["patch_shards"] == N_DEV and len(set(out["placement"].values())) == 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_virtual_shards_match_one_device(cuda):
    """4 virtual shards of cuda:0 against the card alone: the sharded Gram
    of ks2d_bench and the patch ensemble's patch axis, at the CPU limits."""
    from pdx_torch.pipelines import ks2d_bench as tb
    from pdx_torch.pipelines import patch_discovery as tpd
    from tools.make_synth_stack import make_stack

    mesh4 = tm.make_mesh(devices=[cuda] * 4)
    on = tb.run(tb.Ks2dBenchConfig(**KS, mesh="on"), cuda, mesh4)
    off = tb.run(tb.Ks2dBenchConfig(**KS, mesh="off"), cuda, mesh4)
    np.testing.assert_allclose(on["coeffs"], off["coeffs"], rtol=1e-9, atol=1e-12)
    stack = make_stack(T=16, H=120, W=120)
    on = tpd.run(tpd.PatchDiscoveryConfig(**PD, mesh="on"), U_raw=stack, device=cuda, mesh=mesh4)
    off = tpd.run(tpd.PatchDiscoveryConfig(**PD, mesh="off"), U_raw=stack, device=cuda, mesh=mesh4)
    # cuBLAS and cuSOLVER round a batched product or solve by its batch size, so on the card a shard's
    # patches part from the whole batch's at round-off: held at the card-against-CPU limit of the patch
    # ensemble (test_torch_patch_discovery.py, chip_smoke.py), 1e-10 of max|coef|
    C = off["patch_coeffs"]
    np.testing.assert_allclose(on["patch_coeffs"], C, rtol=0, atol=1e-10 * np.abs(C).max())
    assert on["n_shard_devices"] == 4 and off["n_shard_devices"] == 1
    assert tdry.dryrun_multichip(4, cuda)["patch_shards"] == 4
