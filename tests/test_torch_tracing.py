"""The program's tracer (``pdx_torch.utils.profiling``): spans, counts, when
it records, its clock against ``torch.profiler``'s, and the three benchmarked
entry points giving the same bits with a timer, under a profiler and with
neither. No JAX here, so that the ``gpu`` test runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_tracing.py``."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pdx_torch.pipelines import ks2d_bench, patch_discovery, transport
from pdx_torch.utils import profiling
from pdx_torch.utils.profiling import (
    Span, StageTimer, count, recording, report, span, span_tree, spans_between, total,
)
from tools.torch_span_idle import differences, split_by_span


def _window(fn):
    """(fn's result, the spans recorded while it ran)."""
    t0 = time.time_ns()
    out = fn()
    return out, spans_between(t0, time.time_ns())


def test_spans_nest_with_parent_and_run_id():
    timer = StageTimer()

    def work():
        with timer.stage("outer") as outer:
            with span("a") as a:
                with span("b") as b:
                    pass
            with span("c") as c:
                pass
        with timer.stage("second") as second:
            with span("d") as d:
                pass
        return outer, a, b, c, second, d

    (outer, a, b, c, second, d), spans = _window(work)
    assert [s.name for s in spans] == ["b", "a", "c", "outer", "d", "second"]
    assert outer.parent is None and a.parent == outer.id and b.parent == a.id and c.parent == outer.id
    assert {s.run for s in (outer, a, b, c)} == {outer.id}
    assert second.parent is None and d.parent == second.id and {second.run, d.run} == {second.id}
    assert second.run != outer.run
    assert outer.start_ns <= a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns <= c.end_ns <= outer.end_ns
    # stages keep their seconds; nested spans never become stages
    assert list(timer.stages) == ["outer", "second"]


def test_counts_land_on_the_innermost_span_and_the_total():
    timer = StageTimer()
    before = total("tracing_test.items")

    def work():
        with timer.stage("outer") as outer:
            count("tracing_test.items")
            with span("inner") as inner:
                count("tracing_test.items", 5)
            count("tracing_test.items", 2, into=inner)
        return outer, inner

    (outer, inner), _ = _window(work)
    assert outer.counts == {"tracing_test.items": 1}
    assert inner.counts == {"tracing_test.items": 7}
    count("tracing_test.items", 3)  # not recording: the total alone
    assert total("tracing_test.items") == before + 11


def test_held_counts_reach_neither_the_totals_nor_the_spans():
    timer = StageTimer()
    before = total("tracing_test.held")

    def work():
        with timer.stage("outer") as outer:
            with profiling.held_counts() as held:
                count("tracing_test.held", 4)
                with profiling.held_counts() as inner:  # nested: the innermost holder takes them
                    count("tracing_test.held")
                count("tracing_test.held", 2)
            count("tracing_test.held", 3)
        return outer, held, inner

    (outer, held, inner), _ = _window(work)
    assert held == {"tracing_test.held": 6} and inner == {"tracing_test.held": 1}
    assert outer.counts == {"tracing_test.held": 3}
    assert total("tracing_test.held") == before + 3


def test_nothing_is_recorded_outside_a_timer_and_a_profiler():
    assert not recording()

    def work():
        with span("off") as sp:
            count("tracing_test.off")
        return sp

    sp, spans = _window(work)
    assert sp is None and spans == []
    assert span("off") is span("other")  # one shared no-op context, nothing allocated
    assert profiling.null_stage("off") is span("off")


def test_a_profiler_session_turns_recording_on():
    def work():
        with span("on") as sp:
            count("tracing_test.on")
        return sp

    with profile(activities=[ProfilerActivity.CPU]):
        assert recording()
        sp, spans = _window(work)
    assert spans == [sp] and sp.counts == {"tracing_test.on": 1}
    assert not recording()


def test_the_oldest_spans_are_dropped_at_the_cap():
    timer = StageTimer()

    def work():
        with timer.stage("cap"):
            for i in range(profiling.SPAN_CAP + 10):
                with span("many"):
                    pass

    _, spans = _window(work)
    assert len(spans) == profiling.SPAN_CAP  # the 10 first "many" spans are gone
    assert spans[-1].name == "cap" and all(s.name == "many" for s in spans[:-1])


def test_report_gives_self_time_and_counts():
    timer = StageTimer()

    def work():
        with timer.stage("top"):
            with span("child"):
                count("tracing_test.report", 4)
                time.sleep(0.02)
            time.sleep(0.01)

    _, spans = _window(work)
    top, child = (next(s for s in spans if s.name == n) for n in ("top", "child"))
    lines = report(spans).splitlines()
    assert lines[1].split()[:2] == ["top", "1"] and lines[2].split()[:2] == ["child", "1"]
    assert lines[2].endswith("tracing_test.report=4")
    top_self = float(lines[1].split()[3])
    assert top_self == pytest.approx((top.end_ns - top.start_ns - (child.end_ns - child.start_ns)) / 1e9, abs=2e-4)
    assert "child" in timer.report() and "top" in timer.report().splitlines()[1]


def test_span_tree_gives_paths_and_self_intervals():
    def mk(name, sid, parent, a, b):
        s = Span(name, sid, parent, 1, a)
        s.end_ns = b
        return s

    spans = [mk("top", 1, None, 0, 100), mk("b", 3, 1, 60, 80), mk("a", 2, 1, 10, 30), mk("a.x", 4, 2, 12, 20),
             mk("stray", 5, 99, 40, 50)]
    tree = {s.name: (path, [tuple(iv) for iv in own]) for path, s, own in span_tree(spans)}
    assert [s.name for _, s, _ in span_tree(spans)] == ["top", "a", "a.x", "stray", "b"]
    assert tree["top"] == (("top",), [(0, 10), (30, 60), (80, 100)])
    assert tree["a"] == (("top", "a"), [(10, 12), (20, 30)])
    assert tree["a.x"] == (("top", "a", "a.x"), [(12, 20)])
    assert tree["stray"] == (("stray",), [(40, 50)])  # its parent is not among the spans


def test_split_by_span_puts_device_and_idle_time_on_the_innermost_span():
    from benchmark.tracing import DeviceTrace

    top, a = Span("top", 1, None, 1, 0), Span("a", 2, 1, 1, 10_000)
    top.end_ns, a.end_ns = 100_000, 30_000
    ops = [("k", 5_000, 15_000), ("k", 50_000, 60_000), ("k", 95_000, 120_000), ("k", 150_000, 160_000)]
    rows = {r["span"]: r for r in split_by_span(DeviceTrace(ops=ops, start_ns=0, end_ns=200_000), [top, a])}
    got = {k: (r["calls"], r["wall_s"] * 1e6, r["self_device_s"] * 1e6, r["self_idle_s"] * 1e6)
           for k, r in rows.items()}
    assert got == {"top": pytest.approx((1, 100, 20, 60)), "top > a": pytest.approx((1, 20, 5, 15)),
                   "(outside spans)": pytest.approx((0, 100, 30, 70))}
    assert list(rows)[-1] == "(outside spans)"


def _kineto(prof):
    for e in prof.profiler.kineto_results.events():
        yield e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.device_type()


def test_span_clock_brackets_a_record_function_on_the_same_line():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = []
        for i in range(5):
            with span(f"clock{i}") as sp, record_function(f"tracing_test.rf{i}"):
                torch.ones(1000).sum()
            got.append(sp)
    events = {n: (a, b) for n, a, b, _ in _kineto(prof)}
    for i, sp in enumerate(got):
        a, b = events[f"tracing_test.rf{i}"]
        assert sp.start_ns <= a and b <= sp.end_ns, (i, a - sp.start_ns, sp.end_ns - b)
        assert a - sp.start_ns < 5_000_000 and sp.end_ns - b < 5_000_000  # the same clock, not one far off


# --- the three benchmarked entry points at tiny sizes

KS = ks2d_bench.Ks2dBenchConfig(Nx=16, Ny=16, n_seconds=0.05, grid_search=True, solver="pallas")
PATCH = patch_discovery.PatchDiscoveryConfig(
    max_images=10, skip=4, subsample=2, patch=11, overlap=5, samples_per_patch=60, rt=1, rs=2, deg=2,
    write_artifacts=False)
TRANSPORT = transport.TransportConfig(max_images=8, downsample=4, flow_levels=2, write_artifacts=False)


def _stack(T, N, seed=0):
    """Drift and diffusion of a smooth random field, as uint16 frames."""
    rng = np.random.default_rng(seed)
    k = 2 * np.pi * np.fft.fftfreq(N)
    KX, KY = np.meshgrid(k, k, indexing="ij")
    F0 = np.fft.fft2(rng.normal(size=(N, N))) * np.exp(-40 * (KX**2 + KY**2))
    U = np.stack([np.fft.ifft2(F0 * np.exp(-2 * (KX**2 + KY**2) * t - 1j * (0.3 * KX - 0.2 * KY) * t)).real
                  for t in range(T)])
    return ((U - U.min()) / (U.max() - U.min()) * 60000).astype(np.uint16)


def _runs():
    patch_stack, transport_stack = _stack(10, 96), _stack(8, 64, seed=1)
    return {
        "ks2d_bench": lambda timer: ks2d_bench.run(KS, "cpu", timer=timer),
        "patch_discovery": lambda timer: patch_discovery.run(PATCH, U_raw=patch_stack, device="cpu", timer=timer),
        "transport": lambda timer: transport.run(TRANSPORT, U_raw=transport_stack, timer=timer, device="cpu"),
    }


@pytest.fixture(scope="module")
def traced():
    """Each entry point plain, with a timer, and under a CPU profiler: the
    results, the timers, the spans each recording made and the profiler's
    event names."""
    out = {}
    for name, fn in _runs().items():
        plain, off_spans = _window(lambda: fn(None))
        timer = StageTimer()
        timed, timer_spans = _window(lambda: fn(timer))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            profiled, prof_spans = _window(lambda: fn(None))
        out[name] = dict(plain=plain, timed=timed, profiled=profiled, timer=timer, off_spans=off_spans,
                         timer_spans=timer_spans, prof_spans=prof_spans,
                         events={n for n, *_ in _kineto(prof)})
    return out


@pytest.mark.parametrize("entry", ["ks2d_bench", "patch_discovery", "transport"])
def test_results_are_bitwise_the_same_with_a_timer_and_under_a_profiler(traced, entry):
    r = traced[entry]
    assert differences(r["plain"], r["timed"]) == []
    assert differences(r["plain"], r["profiled"]) == []
    assert r["off_spans"] == []
    assert r["timer_spans"] and r["prof_spans"]


@pytest.mark.parametrize("entry", ["ks2d_bench", "patch_discovery", "transport"])
def test_no_profiler_event_bears_a_program_span_name(traced, entry):
    names = {s.name for s in traced[entry]["prof_spans"]}
    assert names and not names & traced[entry]["events"]


@pytest.mark.parametrize("entry,want", [
    ("ks2d_bench", {"prepare_frames": None, "ks2d.sim": "prepare_frames", "ks2d.perturb_denoise": "prepare_frames",
                    "fit": None, "ks2d.stats": "fit", "ks2d.grid": "fit", "ks2d.select": "fit",
                    "ks2d.rollout": "fit"}),
    ("patch_discovery", {"preprocess": None, "patch.upload": "preprocess", "patch.resize_denoise": "preprocess",
                         "register": None, "farneback.chain_flow": "register",
                         "farneback.level": "farneback.chain_flow", "farneback.refine": "farneback.chain_flow",
                         "farneback.smooth_warp": "farneback.chain_flow", "discover": None,
                         "patch.datasets": "discover", "patch.fits": "discover", "patch.readback": "discover",
                         "patch.aggregate": "discover", "patch.heldout": "discover"}),
    ("transport", {"load_images": None, "ship_normalize_resize": None, "pair_flows": None,
                   "farneback.level": "pair_flows", "farneback.refine": "pair_flows", "discover_lasso_sweep": None,
                   "host_readback": None}),
])
def test_the_sites_nest_the_same_with_a_timer_and_under_a_profiler(traced, entry, want):
    for key in ("timer_spans", "prof_spans"):
        spans = traced[entry][key]
        by_id = {s.id: s for s in spans}
        parents = {s.name: (by_id[s.parent].name if s.parent in by_id else None) for s in spans}
        assert parents == want, key


def _counts(spans, span_name, count_name):
    return [s.counts.get(count_name, 0) for s in spans if s.name == span_name]


def test_the_sites_count_steps_flows_and_iterations(traced):
    for key in ("timer_spans", "prof_spans"):
        ks, patch, tr = (traced[e][key] for e in ("ks2d_bench", "patch_discovery", "transport"))
        assert _counts(ks, "ks2d.sim", "ks2d.euler_steps") == [50]
        assert _counts(ks, "ks2d.rollout", "rollout.steps") == [49]
        assert _counts(ks, "ks2d.grid", "stridge.iterations")[0] >= 1
        assert _counts(patch, "farneback.chain_flow", "farneback.flows") == [1] * (PATCH.max_images - 1)
        levels = _counts(patch, "farneback.level", "farneback.iterations")
        assert len(levels) % (PATCH.max_images - 1) == 0 and set(levels) == {5}
        assert _counts(patch, "farneback.refine", "farneback.iterations") == [2] * (PATCH.max_images - 1)
        assert _counts(tr, "pair_flows", "farneback.flows") == [TRANSPORT.max_images - 1]
        assert _counts(tr, "farneback.level", "farneback.iterations") == [3, 3]
        assert _counts(tr, "farneback.refine", "farneback.iterations") == [2, 2]
        sweep = next(s for s in tr if s.name == "discover_lasso_sweep")
        assert sweep.counts["fista.iterations"] >= len(TRANSPORT.alphas)
        assert sweep.counts["fista.host_syncs"] >= 1


def test_transport_keeps_its_stage_names(traced):
    assert list(traced["transport"]["timer"].stages) == [
        "load_images", "ship_normalize_resize", "pair_flows", "discover_lasso_sweep", "host_readback"]
    assert list(traced["transport"]["timed"]["stage_seconds"]) == list(traced["transport"]["timer"].stages)


@pytest.mark.gpu
def test_span_and_record_function_agree_on_the_card():
    """A program span and a ``record_function`` range opened on the same line
    agree within 100 us at both ends on the card's host clock; a profiler of
    CUDA activity alone (the benchmark's ``DeviceBusy``) turns recording on,
    and neither a span nor a count adds a device operation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("tracing_test.card_warm"):  # a session's first range pays its set-up
            (x * 2).sum()
        got = []
        for i in range(5):
            with span(f"card{i}") as sp, record_function(f"tracing_test.card_rf{i}"):
                (x * 2).sum()
            got.append(sp)
        torch.cuda.synchronize()
    events = {n: (a, b) for n, a, b, d in _kineto(prof) if d == torch.autograd.DeviceType.CPU}
    for i, sp in enumerate(got):
        a, b = events[f"tracing_test.card_rf{i}"]
        assert abs(a - sp.start_ns) < 100_000 and abs(b - sp.end_ns) < 100_000, (i, a - sp.start_ns, b - sp.end_ns)

    def n_device_ops(prof):
        return sum(1 for *_, d in _kineto(prof) if d == torch.autograd.DeviceType.CUDA)

    with profile(activities=[ProfilerActivity.CUDA]) as bare:
        (x * 2).sum()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as traced_prof:
        assert recording()
        with span("card.outer"):
            count("tracing_test.card")
            (x * 2).sum()
        torch.cuda.synchronize()
    assert n_device_ops(traced_prof) == n_device_ops(bare)
