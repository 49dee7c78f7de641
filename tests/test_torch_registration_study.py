"""The registration study (``pdx_torch.pipelines.improved_registration``) in
its public stages, its spans and counts, and against the benchmark's plain
reference (``benchmark/reference/registration_study.py``), on the CPU in
float64, on one synthetic stack of 8 frames of 96 x 96 (``benchmark/data/
stack.py``'s dynamics, smaller). No JAX here, so the file collects on the
card's machine too.

Tolerances of the reference comparison, and why:

* the unregistered sweep, the DIS chain and its sweep are float64 on both
  sides, apart only by summation order and the bilinear blend (``lerp``
  against four products): mean flow magnitudes within 1e-12 relative and the
  DIS improvement within 1e-10 percentage points (measured ~1e-14);
* the Farnebäck chain's flow is float32 on the float64 stack on both sides,
  in another order: its mean flow magnitude parts by ~4e-7 relative and its
  improvement by ~4e-5 points, so 1e-5 relative and 1e-3 points;
* the same method is selected: on this stack DIS, by 69.7% against 4.5%;
* the fit runs on the selected stack, DIS's, float64 throughout: the
  coefficients within 1e-8 of max|coef| and R^2 within 1e-9 (measured 5e-12
  and 6e-13; the port standardises from the raw Gram, which cancels digits).
"""

import time

import numpy as np
import pytest
import torch

from benchmark.data.stack import make_stack
from benchmark.reference import registration_study as ref
from pdx_torch.pipelines import improved_registration as ir
from pdx_torch.utils.profiling import StageTimer, spans_between, total

T, H, W = 8, 96, 96
SETTINGS = dict(max_images=T, denoise_sigma=1.0, savgol_window=7, savgol_poly=3, skip=10, subsample=4, dx=0.1,
                dy=0.1, dt=1.0, alpha=0.01, threshold=1e-5, reference_compat_warp=False, dtype="float64")
CFG = ir.ImprovedRegistrationConfig(**SETTINGS, write_artifacts=False)
QUALITY = ("avg_flow_before", "avg_flow_after", "improvement_pct")
COUNTS = ("dis.flows", "dis.levels", "dis.iterations", "quality.sweeps", "quality.pair_flows")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many tiny operations: on one thread each, since in a parallel test run
    a thread team per operation waits on cores that other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def study():
    stack = make_stack(T, H, W, seed=3_000_000_019, device="cpu", diffusion=1.5, drift=(0.6, -0.4))
    return stack, ir.run(CFG, U_raw=stack, device="cpu"), ref.run(stack, SETTINGS, torch.float64, "cpu")


def test_the_public_stages_compose_run_bitwise(study):
    stack, out, _ = study
    U = ir.preprocess(CFG, stack, torch.device("cpu"))
    U_fb, U_dis = ir.register_farneback(CFG, U), ir.register_dis(CFG, U)
    m_fb, m_dis, method = ir.registration_quality(U, U_fb, U_dis)
    res = ir.fit_registered(CFG, U_dis if method == "DIS" else U_fb)
    assert (m_fb, m_dis, method) == (out["farneback_metrics"], out["dis_metrics"], out["selected_method"])
    assert np.array_equal(res["coeffs"], out["coeffs"]) and res["r2"] == out["r2"]
    assert res["working_shape"] == out["working_shape"]


def _counted(cfg, stack, monkeypatch):
    """``run`` under a timer: the totals it added, and the spans it recorded."""
    monkeypatch.setattr(ir, "_render_slides", lambda *a, **k: None)  # the drawing alone
    before = {c: total(c) for c in COUNTS}
    timer = StageTimer()
    t0 = time.time_ns()
    ir.run(cfg, U_raw=stack, timer=timer, device="cpu")
    spans = spans_between(t0, time.time_ns())
    return {c: total(c) - before[c] for c in COUNTS}, spans, timer


@pytest.mark.parametrize("artifacts", [False, True])
def test_spans_and_counts(study, artifacts, monkeypatch, tmp_path):
    stack = study[0]
    cfg = ir.ImprovedRegistrationConfig(**SETTINGS, write_artifacts=artifacts, output_dir=str(tmp_path))
    counts, spans, timer = _counted(cfg, stack, monkeypatch)
    flows = T - 1 + artifacts  # SLIDE2 flows one pair more
    levels = 3  # 96 -> 48 -> 24; 12 is under the pyramid's 16 px
    assert counts == {"dis.flows": flows, "dis.levels": flows * levels, "dis.iterations": flows * levels * 8,
                      "quality.sweeps": 3, "quality.pair_flows": 3 * (T - 1)}
    by_id = {s.id: s for s in spans}
    flow_spans = [s for s in spans if s.name == "dis.flow"]
    assert len(flow_spans) == flows and all(s.counts == {"dis.flows": 1} for s in flow_spans)
    level_spans = [s for s in spans if s.name == "dis.level"]
    assert len(level_spans) == flows * levels and all(by_id[s.parent].name == "dis.flow" for s in level_spans)
    sweeps = [s for s in spans if s.name == "quality.sweep"]
    assert [by_id[s.parent].name for s in sweeps] == ["quality_before", "quality_farneback", "quality_dis"]
    assert all(s.counts["quality.sweeps"] == 1 and s.counts["quality.pair_flows"] == T - 1 for s in sweeps)
    assert [by_id[s.parent].name for s in flow_spans[: T - 1]] == ["dis_chain"] * (T - 1)
    assert [by_id[s.parent].name for s in spans if s.name == "register"] == ["farneback_chain"]
    assert list(timer.stages)[:7] == ["denoise_normalize", "farneback_chain", "dis_chain", "quality_before",
                                      "quality_farneback", "quality_dis", "fit"]


@pytest.mark.parametrize("quantity", ["farneback_quality", "dis_quality", "selection", "coefficients", "r2"])
def test_the_port_matches_the_plain_reference(study, quantity):
    _, got, want = study
    if quantity == "farneback_quality":
        g = [got["farneback_metrics"][k] for k in QUALITY]
        np.testing.assert_allclose(g[:2], want["fb"][:2], rtol=1e-5)
        np.testing.assert_allclose(g[2], want["fb"][2], rtol=0, atol=1e-3)
    elif quantity == "dis_quality":
        g = [got["dis_metrics"][k] for k in QUALITY]
        np.testing.assert_allclose(g[:2], want["dis"][:2], rtol=1e-12)
        np.testing.assert_allclose(g[2], want["dis"][2], rtol=0, atol=1e-10)
    elif quantity == "selection":
        assert got["selected_method"] == want["method"]
    elif quantity == "coefficients":
        c = want["coefs"]
        np.testing.assert_allclose(got["coeffs"], c, rtol=0, atol=1e-8 * np.abs(c).max())
    else:
        assert abs(got["r2"] - want["r2"]) <= 1e-9
